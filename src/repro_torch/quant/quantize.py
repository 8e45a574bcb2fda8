"""Symmetric INT8 quantization on tensors.

Counterpart of :mod:`repro.quant.quantize`: the same arithmetic in
float32, ``torch.round`` rounding half to even as ``jnp.round`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Optional

import torch

__all__ = ["QTensor", "quantize_tensor", "dequantize", "quantize_tree",
           "fake_quant"]


@dataclass
class QTensor:
    q: torch.Tensor            # int8
    scale: torch.Tensor        # () or (channels,) with kept dims
    axis: Optional[int]        # channel axis, None = per-tensor

    @property
    def shape(self):
        return self.q.shape


def quantize_tensor(x: torch.Tensor, axis: Optional[int] = None) -> QTensor:
    """Symmetric int8: scale = max|x| / 127 (per tensor or per channel)."""
    if axis is None:
        amax = x.abs().max()
    else:
        red = tuple(i for i in range(x.dim()) if i != axis)
        amax = x.abs().amax(dim=red, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(x / scale), -128, 127).to(torch.int8)
    return QTensor(q=q, scale=scale.squeeze() if axis is None else scale,
                   axis=axis)


def dequantize(t: QTensor) -> torch.Tensor:
    s = t.scale
    if t.axis is not None and s.dim() != t.q.dim():
        shape = [1] * t.q.dim()
        shape[t.axis] = -1
        s = s.reshape(shape)
    return t.q.to(torch.float32) * s


def fake_quant(x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
    """Straight-through quantize-dequantize (QAT forward): the value is
    the quantized one, the gradient that of the identity."""
    y = dequantize(quantize_tensor(x, axis))
    return x + (y - x).detach()


def quantize_tree(params: Any, axis: Optional[int] = None):
    """Quantize every float leaf of a nested mapping/sequence of tensors
    with 2+ dims; other leaves pass through."""
    if isinstance(params, Mapping):
        return {k: quantize_tree(v, axis) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_tree(v, axis) for v in params)
    if (isinstance(params, torch.Tensor) and params.is_floating_point()
            and params.dim() >= 2):
        return quantize_tensor(params, axis)
    return params
