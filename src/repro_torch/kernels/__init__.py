"""Kernels: the bit-serial CIM MVM and the direct INT8 GEMM as one
hand-written CUDA source for Hopper (:mod:`.bitserial_mvm`), the direct
INT8 GEMM at decode shapes in its own CUDA source and the planner that
routes between the two (:mod:`.int8_matmul`), the LM decode attention in
CUDA (:mod:`.decode_attention`; the CUDA sources built by :mod:`.nvcc`
at first use), the grouped expert GEMM of expert-parallel MoE in CUDA
(:mod:`.grouped_gemm`), the attention core and the Mamba-2 SSD chunk
scan of training and prefill in CUDA (:mod:`.flash_attention`,
:mod:`.ssd_scan`), Mamba-2's whole decode mixer in CUDA
(:mod:`.ssm_decode`), the SSD decode step, Mamba-2's causal conv front and
gated output norm, the training loss's cross-entropy and the AdamW step
in Triton (:mod:`.ssd_decode`, :mod:`.causal_conv`, :mod:`.gated_norm`,
:mod:`.cross_entropy`, :mod:`.adamw`, their sources loaded by
:mod:`.triton_source`; sources under ``csrc/``), their plain
PyTorch versions (:mod:`.ref` and beside each wrapper) and the public
wrappers (:mod:`.ops`: ``cim_mvm``, ``int8_matmul``,
``quantized_linear``)."""
