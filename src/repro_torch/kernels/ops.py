"""Public wrappers around the CIM kernels.

* :func:`cim_mvm` — the bit-serial kernel on ragged shapes.  Dispatch is
  by the tensors' device: CUDA launches the hand-written kernel on the
  unpadded operands (it masks ragged edges itself); CPU zero-pads to the
  blocks, as the JAX wrapper does (exact for integer arithmetic), and
  runs the plain version.
* :func:`int8_matmul` — the direct single-pass INT8 GEMM (the
  *performance* path; bit-identical to :func:`cim_mvm`): CUDA launches
  the same kernel's one-pass instantiation, CPU runs ``mvm_ref``.
* :func:`quantized_linear` — float-in/float-out linear with INT8 CIM
  arithmetic inside and a straight-through-estimator backward
  (:func:`_ql_bwd`), used for quantization-aware training / INT8
  serving.

Counterpart of :mod:`repro.kernels.ops`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .bitserial_mvm import (bitserial_mvm, bitserial_mvm_cuda,
                            int8_matmul_cuda, resolve_blocks)
from .ref import mvm_ref

__all__ = ["cim_mvm", "int8_matmul", "quantized_linear", "pad_to"]


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


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Direct INT8 GEMM (performance path, bit-identical to
    :func:`cim_mvm`): ``(M,K) @ (K,N) -> (M,N)`` int32, operands cast to
    int8.  CUDA: the hand-written kernel (``int8_matmul_cuda``); CPU: the
    plain version ``mvm_ref``."""
    if x.dtype != torch.int8:
        x = x.to(torch.int8)
    if w.dtype != torch.int8:
        w = w.to(torch.int8)
    if x.device.type == "cpu":
        return mvm_ref(x, w)
    return int8_matmul_cuda(x.contiguous(), w.contiguous())


# ---------------------------------------------------------------------------
# Fake-quant linear with straight-through estimator
# ---------------------------------------------------------------------------


def _ql_bwd(use_pallas: bool, res, g: torch.Tensor):
    """The straight-through backward of the reference (ops.py:113):
    ``(dx, dw, (0, 0))`` for ``res = (x, w_int8, (act_scale, w_scale))``;
    ``dw`` is the gradient with respect to the int8 weight view."""
    x, w_int8, (act_scale, w_scale) = res
    w_deq = w_int8.to(torch.float32) * w_scale
    # straight-through: d/dx ignores the quantizer's staircase
    dx = g @ w_deq.T
    dw = x.T @ g / w_scale
    zero = torch.zeros((), dtype=torch.float32, device=g.device)
    return dx, dw, (zero, zero)


class _QuantizedLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_int8, act_scale, w_scale, use_pallas):
        xq = torch.clamp(torch.round(x / act_scale), -128, 127).to(
            torch.int8)
        acc = cim_mvm(xq, w_int8) if use_pallas else int8_matmul(xq, w_int8)
        ctx.save_for_backward(x, w_int8)
        ctx.scales = (act_scale, w_scale)
        ctx.use_pallas = use_pallas
        return acc.to(torch.float32) * (act_scale * w_scale)

    @staticmethod
    def backward(ctx, g):
        x, w_int8 = ctx.saved_tensors
        dx, dw, (da, dws) = _ql_bwd(ctx.use_pallas, (x, w_int8, ctx.scales),
                                    g)
        need = ctx.needs_input_grad
        return (dx if need[0] else None, dw if need[1] else None,
                da if need[2] else None, dws if need[3] else None, None)


def quantized_linear(x: torch.Tensor, w_int8: torch.Tensor, scales,
                     use_pallas: bool = False) -> torch.Tensor:
    """``y = dequant(int8(x) @ w_int8)``; float32 in/out.

    ``scales = (act_scale, w_scale)`` — per-tensor symmetric (floats or
    0-d tensors).  ``use_pallas`` keeps the reference's name for its
    route: ``True`` runs the bit-serial CIM kernel (:func:`cim_mvm`, the
    counterpart of the Pallas kernel), ``False`` the direct
    :func:`int8_matmul`.  Backward is the straight-through estimator on
    a dequantized weight view (:func:`_ql_bwd`), so the op drops into a
    standard training loop; an integer-typed ``w_int8`` gets no
    gradient.
    """
    act_scale, w_scale = scales
    return _QuantizedLinear.apply(x, w_int8, act_scale, w_scale,
                                  bool(use_pallas))
