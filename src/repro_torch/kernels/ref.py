"""Plain PyTorch versions of the CIM kernels.

Digital CIM is exact integer arithmetic, so these define the contract
the CUDA kernel is held to bit for bit.  They run on any device:

* ``torch.mm`` has no integer CUDA path and wraps int8 results on the
  CPU, so the contractions run in float64.  That is exact: an int8 x
  int8 product sum has ``|sum| <= K * 2**14``, far below ``2**53``.
* Results wrap to int32 as the reference's int32 arithmetic does
  (shift-add in int64, then a modular cast).

Counterpart of :mod:`repro.kernels.ref`; ``requant_ref`` computes in
true int64, as the ISS and :func:`repro.core.ref.quantize` do.
"""

from __future__ import annotations

import torch

__all__ = ["mvm_ref", "bitserial_mvm_ref", "requant_ref",
           "quantized_linear_ref"]

# float64 holds every partial sum exactly while K * 2**14 < 2**53
_MAX_EXACT_K = 1 << 38


def _exact_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer-valued ``a @ b`` (int64), exact for int8-ranged operands."""
    if a.shape[1] >= _MAX_EXACT_K:
        raise ValueError(f"K={a.shape[1]} too deep for an exact float64 "
                         f"contraction")
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def mvm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """INT32 ground truth: ``(M,K) int8 @ (K,N) int8 -> (M,N) int32``."""
    return _exact_mm(x, w).to(torch.int32)


def bitserial_mvm_ref(x: torch.Tensor, w: torch.Tensor, act_bits: int = 8,
                      signed: bool = True) -> torch.Tensor:
    """Bit-plane decomposition (mirrors the macro model): peel
    ``act_bits`` planes off the uint8 view of ``x``, one plane product
    each, shift-add plane ``b`` by ``b``; the MSB plane enters
    negatively when ``signed``."""
    xu = x.to(torch.int32) & 0xFF                  # uint8 reinterpretation
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64,
                      device=x.device)
    for b in range(act_bits):
        term = _exact_mm((xu >> b) & 1, w) << b
        acc = acc - term if (signed and b == act_bits - 1) else acc + term
    return acc.to(torch.int32)


def requant_ref(acc: torch.Tensor, scale: int, shift: int,
                div: int = 1) -> torch.Tensor:
    """Fixed-point requant, identical to the ISS / compiled semantics:
    ``clip((acc*scale + den/2) // den)`` with ``den = div << shift``."""
    den = div << shift
    q = (acc.to(torch.int64) * scale + (den >> 1)) // den
    return q.clamp(-128, 127).to(torch.int8)


def quantized_linear_ref(x: torch.Tensor, w_int8: torch.Tensor, w_scale,
                         act_scale) -> torch.Tensor:
    """Fake-quant linear: float in/out, INT8 CIM arithmetic inside."""
    xq = torch.clamp(torch.round(x / act_scale), -128, 127).to(torch.int8)
    acc = mvm_ref(xq, w_int8)
    return acc.to(torch.float32) * (act_scale * w_scale)
