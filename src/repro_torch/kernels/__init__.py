"""Kernels: the bit-serial CIM MVM and the direct INT8 GEMM as one
hand-written CUDA source for Hopper (:mod:`.bitserial_mvm`), the LM
decode attention in CUDA (:mod:`.decode_attention`; both CUDA sources
built by :mod:`.nvcc` at first use), the SSD decode step in Triton
(:mod:`.ssd_decode`, its source loaded by :mod:`.triton_source`;
sources under ``csrc/``), their plain
PyTorch versions (:mod:`.ref` and beside each wrapper) and the public
wrappers (:mod:`.ops`: ``cim_mvm``, ``int8_matmul``,
``quantized_linear``)."""
