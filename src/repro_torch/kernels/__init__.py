"""Kernels: the bit-serial CIM MVM and the direct INT8 GEMM as one
hand-written CUDA source for Hopper (:mod:`.bitserial_mvm`), the direct
INT8 GEMM at decode shapes in its own CUDA source and the planner that
routes between the two (:mod:`.int8_matmul`), the LM decode attention in
CUDA (:mod:`.decode_attention`; the CUDA sources built by :mod:`.nvcc`
at first use), the SSD decode step in Triton
(:mod:`.ssd_decode`, its source loaded by :mod:`.triton_source`;
sources under ``csrc/``), their plain
PyTorch versions (:mod:`.ref` and beside each wrapper) and the public
wrappers (:mod:`.ops`: ``cim_mvm``, ``int8_matmul``,
``quantized_linear``)."""
