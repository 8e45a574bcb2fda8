"""The unified LM on tensors: layers (norms, RoPE, GQA/SWA/MLA
attention with KV caches, MLPs, dense MoE), the Mamba-2 SSD block and
the model over all ten architectures of :mod:`repro_torch.configs`.
Counterpart of :mod:`repro.models`."""
