"""Kernels: the bit-serial CIM MVM and the direct INT8 GEMM as one
hand-written CUDA source for Hopper (:mod:`.bitserial_mvm`), the LM
decode kernels in Triton (:mod:`.decode_attention`, :mod:`.ssd_decode`;
sources under ``csrc/``, loaded by :mod:`.triton_source`), their plain
PyTorch versions (:mod:`.ref` and beside each wrapper) and the public
wrappers (:mod:`.ops`: ``cim_mvm``, ``int8_matmul``,
``quantized_linear``)."""
