"""Public wrappers around the CIM kernels.

* :func:`cim_mvm` — the bit-serial kernel on ragged shapes.  Dispatch is
  by the tensors' device: CUDA launches the hand-written kernel on the
  unpadded operands (it masks ragged edges itself); CPU zero-pads to the
  blocks, as the JAX wrapper does (exact for integer arithmetic), and
  runs the plain version.

Counterpart of :mod:`repro.kernels.ops`; ``int8_matmul`` and
``quantized_linear`` come with the quantization/models slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .bitserial_mvm import bitserial_mvm, bitserial_mvm_cuda, resolve_blocks

__all__ = ["cim_mvm", "pad_to"]


def pad_to(a: torch.Tensor, mults: Sequence[int]) -> torch.Tensor:
    """Zero-pad each dim of ``a`` up to a multiple of ``mults``."""
    shape = [dim + (-dim) % mult for dim, mult in zip(a.shape, mults)]
    if list(a.shape) == shape:
        return a.contiguous()
    out = a.new_zeros(shape)
    out[tuple(slice(0, d) for d in a.shape)] = a
    return out


def cim_mvm(x: torch.Tensor, w: torch.Tensor, *, act_bits: int = 8,
            block_m: Optional[int] = None, block_n: Optional[int] = None,
            block_k: Optional[int] = None,
            signed: bool = True) -> torch.Tensor:
    """Bit-serial CIM MVM, ragged shapes welcome: int8 x int8 -> int32.

    Blocks left ``None`` are chosen from the shape
    (``repro_torch.kernels.bitserial_mvm.choose_blocks``)."""
    if x.dtype != torch.int8:
        x = x.to(torch.int8)
    if w.dtype != torch.int8:
        w = w.to(torch.int8)
    if x.is_cuda:
        return bitserial_mvm_cuda(x.contiguous(), w.contiguous(),
                                  act_bits=act_bits, signed=signed,
                                  block_m=block_m, block_n=block_n,
                                  block_k=block_k)
    m, k = x.shape
    n = w.shape[1]
    bm, bn, bk = resolve_blocks(m, n, k, (block_m, block_n, block_k))
    xp = pad_to(x, (bm, bk))
    wp = pad_to(w, (bk, bn))
    out = bitserial_mvm(xp, wp, act_bits=act_bits, block_m=bm,
                        block_n=bn, block_k=bk, signed=signed)
    return out[:m, :n]
