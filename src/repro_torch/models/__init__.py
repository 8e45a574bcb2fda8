"""The unified LM on tensors: layers (norms, RoPE, GQA/SWA/MLA
attention with KV caches, MLPs, dense MoE), expert-parallel MoE
(:mod:`.moe_ep`, under a mesh context), the Mamba-2 SSD block and the
model over all ten architectures of :mod:`repro_torch.configs`.
Counterpart of :mod:`repro.models`."""
