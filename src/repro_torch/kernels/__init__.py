"""CIM kernels: the bit-serial MVM as a hand-written CUDA kernel for
Hopper (:mod:`.bitserial_mvm`), its plain PyTorch version (:mod:`.ref`)
and the padding wrapper (:mod:`.ops`)."""
