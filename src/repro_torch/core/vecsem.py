"""Shared integer semantics for data-dependent vector ops, on tensors.

Counterpart of :mod:`repro.core.vecsem`, bit-exact with it:

* ``softmax_i8``  — per row segment: ``e = EXP2_LUT[max(x) - x]``
  (Q14 table of ``2^(-d/16)``), output ``round(127·e / Σe)``;
* ``layernorm_i8`` — per row: n-scaled deviations ``d = n·x - Σx``,
  integer RMS via exact ``isqrt``, output ``round(G·d / rms)`` with
  gain ``G = 48``;
* ``gelu_i8``     — 256-entry LUT at 1/16-unit input scale;
* :func:`dynamic_weight_matrix` — producer activations onto the
  block-diagonal ``(K_total, N_total)`` CIM layout, for a whole batch.

The LUTs are built in numpy exactly as the reference builds them and
moved to each device on first use.  All integer work is int64 (floor
division ``//`` on int64 tensors floors, as numpy's does).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

__all__ = ["softmax_i8", "layernorm_i8", "gelu_i8",
           "dynamic_weight_matrix", "EXP2_LUT", "GELU_LUT", "LN_GAIN"]

# EXP2_LUT[d] = round(2^14 · 2^(-d/16)) for d = max(x) - x in [0, 255]
EXP2_LUT = np.round(
    2.0 ** 14 * 2.0 ** (-np.arange(256, dtype=np.float64) / 16.0)
).astype(np.int64)

# GELU on int8 at 1/16-unit input scale: y = round(v · Φ(v/16))
# (tanh approximation), clipped to int8.
_v = np.arange(-128, 128, dtype=np.float64)
_t = _v / 16.0
_phi = 0.5 * (1.0 + np.tanh(0.7978845608028654
                            * (_t + 0.044715 * _t ** 3)))
GELU_LUT = np.clip(np.round(_v * _phi), -128, 127).astype(np.int8)
del _v, _t, _phi

LN_GAIN = 48          # layernorm output scale (target std in int8 units)

_LUTS: Dict[Tuple[str, torch.device], torch.Tensor] = {}


def _lut(name: str, device: torch.device) -> torch.Tensor:
    key = (name, device)
    if key not in _LUTS:
        table = EXP2_LUT if name == "exp2" else GELU_LUT
        _LUTS[key] = torch.from_numpy(table.copy()).to(device)
    return _LUTS[key]


def softmax_i8(x: torch.Tensor) -> torch.Tensor:
    """Row-wise integer softmax: int8 ``(..., n)`` → int8 in [0, 127]."""
    xi = x.to(torch.int64)
    d = (xi.amax(dim=-1, keepdim=True) - xi).clamp(0, 255)
    e = _lut("exp2", x.device)[d]
    s = e.sum(dim=-1, keepdim=True)
    y = (127 * e + (s >> 1)) // s
    return y.clamp(0, 127).to(torch.int8)


def _isqrt(v: torch.Tensor) -> torch.Tensor:
    """Exact elementwise floor-sqrt of non-negative int64."""
    r = torch.sqrt(v.to(torch.float64)).to(torch.int64)
    r = torch.where(r * r > v, r - 1, r)             # float64 sqrt is within
    r = torch.where((r + 1) * (r + 1) <= v, r + 1, r)    # ±1 of exact
    return r.clamp_min(0)


def layernorm_i8(x: torch.Tensor) -> torch.Tensor:
    """Row-wise integer layernorm: int8 ``(..., n)`` → int8."""
    xi = x.to(torch.int64)
    n = x.shape[-1]
    s = xi.sum(dim=-1, keepdim=True)
    d = n * xi - s                                   # n-scaled deviation
    ss = (d * d).sum(dim=-1, keepdim=True)
    r = _isqrt(ss // n) + 1                          # n-scaled RMS (+1: /0)
    y = (2 * LN_GAIN * d + r) // (2 * r)             # round-half-up
    return y.clamp(-128, 127).to(torch.int8)


def gelu_i8(x: torch.Tensor) -> torch.Tensor:
    """Elementwise int8 GELU through the shared LUT."""
    return _lut("gelu", x.device)[x.to(torch.int64) + 128]


def dynamic_weight_matrix(buf: torch.Tensor, gemm_k: int, gemm_n: int,
                          groups: int, transpose: bool) -> torch.Tensor:
    """Producer activations → block-diagonal ``(B, K_total, N_total)``.

    ``buf`` holds ``B`` samples of the weight producer's output in its
    natural row layout — ``(B, rows, groups·gemm_k)`` when ``transpose``
    (Q·Kᵀ) or ``(B, gemm_k, groups·gemm_n)`` otherwise (P·V), in any
    shape with those elements per sample.  A producer block narrower
    than its slot (a single row) broadcasts across it, as numpy slice
    assignment does in the reference.
    """
    w = gemm_k if transpose else gemm_n
    bsz = buf.shape[0]
    blocks = buf.reshape(bsz, -1, groups, w).permute(0, 2, 1, 3)
    if transpose:
        blocks = blocks.transpose(2, 3)
    W = buf.new_zeros((bsz, groups, gemm_k, groups, gemm_n),
                      dtype=torch.int8)
    gi = torch.arange(groups, device=buf.device)
    W[:, gi, :, gi, :] = blocks.to(torch.int8).expand(
        bsz, groups, gemm_k, gemm_n).permute(1, 0, 2, 3)
    return W.reshape(bsz, groups * gemm_k, groups * gemm_n)
