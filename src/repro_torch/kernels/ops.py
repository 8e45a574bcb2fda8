"""Public wrappers around the CIM kernels.

* :func:`cim_mvm` — the bit-serial kernel with automatic zero-padding to
  its blocks (exact for integer arithmetic).  Dispatch is by the
  tensors' device: CUDA launches the hand-written kernel, CPU runs its
  plain version.

Counterpart of :mod:`repro.kernels.ops`; ``int8_matmul`` and
``quantized_linear`` come with the quantization/models slice.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .bitserial_mvm import bitserial_mvm

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
            block_m: int = 128, block_n: int = 128, block_k: int = 128,
            signed: bool = True) -> torch.Tensor:
    """Bit-serial CIM MVM, ragged shapes welcome: int8 x int8 -> int32."""
    m, _ = x.shape
    _, n = w.shape
    xp = pad_to(x.to(torch.int8), (block_m, block_k))
    wp = pad_to(w.to(torch.int8), (block_k, block_n))
    out = bitserial_mvm(xp, wp, act_bits=act_bits, block_m=block_m,
                        block_n=block_n, block_k=block_k, signed=signed)
    return out[:m, :n]
