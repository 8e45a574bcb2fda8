"""Mamba-2's causal conv front of training and prefill, forward and
backward: the Triton kernels' wrapper, its autograd and its plain
PyTorch versions.

Counterpart of ``_causal_conv`` in :func:`repro.models.ssm.ssm_apply`
(ssm.py:68-75, called at :89; XLA, not a Pallas kernel): a depth-wise
causal conv1d of ``w`` (K, C) over ``x`` (B, S, C), plus ``b`` (C,),
then SiLU.  :func:`causal_conv_silu` dispatches on the input's device:
CUDA tensors go through :class:`CausalConvSilu` to the kernels of
``csrc/causal_conv.py`` (one forward launch; a backward launch and the
fixed-order sum of its dw / db partials; a build or launch failure
raises and never falls back to the plain version); CPU and ``meta``
tensors (the dry run) run :func:`causal_conv_silu_ref`, the
reference's arithmetic, under autograd.

x is read where it lies: the layer hands the kernel its columns of the
``in_proj`` output (the last dim contiguous, any row stride), with no
concatenation and no padded copy.  The output is a new contiguous
(B, S, C) tensor in x's dtype (the scan reads x, B and C as views of
it).

:func:`causal_conv_silu_bwd_ref` is the backward kernel's algorithm as
plain fp32 tensor code (``dpre = dy * silu'(pre)``; dx from dpre shifted
forward by each tap; dw and db as column sums).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from . import triton_source

__all__ = ["causal_conv_silu", "causal_conv_silu_ref",
           "causal_conv_pre_ref", "causal_conv_silu_bwd_ref",
           "causal_conv_silu_fwd_cuda", "causal_conv_silu_bwd_cuda",
           "causal_conv_silu_cuda",
           "CausalConvSilu", "launches_by_pass", "reset_launches",
           "PLANT_OLDEST_TAP", "K", "plan"]

# the taps the kernels take: Mamba-2's d_conv
K = 4
# channels a program walks and its warps
BLOCK = (512, 4)
# the chunks of rows the programs walk, over the batch (one (K + 1, C)
# fp32 partial of dw and db each, backward)
PARTS = 128
# the partials' sum: (rows, columns) a step and warps
SUM_BLOCK = (64, 32, 4)
# a planted fault (chip_smoke.py): the forward drops the oldest tap
PLANT_OLDEST_TAP = 1
_DTYPES = (torch.bfloat16, torch.float32)

# calls by pass since the last reset (CPU calls excluded); the kernel
# launches in causal_conv_silu_cuda.launches (1 a forward, 2 a backward)
launches_by_pass: Dict[str, int] = {"fwd": 0, "bwd": 0}


def causal_conv_pre_ref(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The pre-activation as the reference computes it: depth-wise causal
    conv1d of ``x`` (B, S, C) by ``w`` (K, C), then the bias, in the
    activations' dtype, ``(((x[t-3] w0 + x[t-2] w1) + x[t-1] w2) + x[t] w3)
    + b`` with every tap's product and every partial sum rounded to it.
    The kernels compute this chain (at bf16) and their backward's ``pre``
    is it too."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):                      # tiny static unroll (K=4)
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    # the bias in the activations' dtype: the reference casts it with the
    # stacked block parameters (2-D there), so it is in the compute dtype
    return out + b.to(out.dtype)


def causal_conv_silu_ref(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version, the reference's arithmetic:
    ``silu(causal_conv_pre_ref(x, w, b))``, SiLU in the activations'
    dtype."""
    return F.silu(causal_conv_pre_ref(x, w, b))


def causal_conv_silu_bwd_ref(dy: torch.Tensor, x: torch.Tensor,
                             w: torch.Tensor, b: torch.Tensor
                             ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's algorithm as plain fp32 tensor code: ``(dx,
    dw, db)`` in x's, w's and b's dtypes.  ``pre`` recomputed as the
    forward computes it (:func:`causal_conv_pre_ref`, rounded as the
    reference rounds), the rest in fp32: ``dpre = dy * silu'(pre)``,
    ``dx[t] = sum_j dpre[t + j] w[K - 1 - j]``, ``dw[K - 1 - j] =
    sum_t x[t] dpre[t + j]``, ``db = sum_t dpre[t]``."""
    k = w.shape[0]
    S = x.shape[1]
    f32 = torch.float32
    xf, wf = x.to(f32), w.to(f32)
    pre = causal_conv_pre_ref(x, w, b).to(f32)
    sig = torch.sigmoid(pre)
    dpre = dy.to(f32) * sig * (1 + pre * (1 - sig))
    dp = F.pad(dpre, (0, 0, 0, k - 1))          # dpre at t + j, 0 past S
    dx = sum(dp[:, j:j + S] * wf[k - 1 - j] for j in range(k))
    dw = torch.stack([(xf * dp[:, k - 1 - i:k - 1 - i + S]).sum((0, 1))
                      for i in range(k)])
    return dx.to(x.dtype), dw.to(w.dtype), dpre.sum((0, 1)).to(b.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> None:
    """The kernels' contract, on any device (``meta`` included): raises
    on a shape, dtype or stride they do not take."""
    if x.dim() != 3 or w.dim() != 2 or tuple(b.shape) != (x.shape[2],) \
            or w.shape[1] != x.shape[2] or w.shape[0] != K:
        raise ValueError(f"need x (B, S, C), w ({K}, C) and b (C,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype \
            or not b.is_floating_point():
        raise TypeError(f"no causal-conv kernel for x {x.dtype}, w "
                        f"{w.dtype}, b {b.dtype} (x and w bf16 or fp32 "
                        f"alike)")
    if x.stride(2) != 1 and x.shape[2] > 1:
        raise ValueError(f"x strides {x.stride()}: the last dim must be "
                         f"contiguous")
    if not (w.is_contiguous() and b.is_contiguous()):
        raise ValueError("w and b must be contiguous")


def _on_card(*ts) -> None:
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("no causal-conv kernel for "
                         f"{sorted({str(t.device) for t in ts})}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(bsz: int, S: int) -> Tuple[int, int]:
    """``(chunk, chunks a sequence)``: each sequence cut into chunks of a
    multiple of 4 rows, at least 64, about :data:`PARTS` chunks over the
    batch."""
    chunk = -(-max(64, _cdiv(bsz * S, PARTS)) // 4) * 4
    return chunk, _cdiv(S, chunk)


def causal_conv_silu_fwd_cuda(x: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, plant: int = 0
                              ) -> torch.Tensor:
    """The forward kernel on CUDA tensors: one launch, a new contiguous
    (B, S, C) output in x's dtype.  ``plant`` (:data:`PLANT_OLDEST_TAP`)
    plants a fault."""
    _check(x, w, b)
    _on_card(x, w, b)
    bsz, S, C = x.shape
    out = torch.empty((bsz, S, C), dtype=x.dtype, device=x.device)
    chunk, n_chunks = plan(bsz, S)
    bc, warps = BLOCK
    mod = triton_source.load("causal_conv")
    with torch.cuda.device(x.get_device()):
        mod.conv_fwd_kernel[(bsz * n_chunks, _cdiv(C, bc))](
            x, w, b, out, S, C, x.stride(0), x.stride(1), chunk, n_chunks,
            BLOCK_C=bc, FIRST_TAP=1 if plant & PLANT_OLDEST_TAP else 0,
            num_warps=warps)
    causal_conv_silu_cuda.launches += 1
    launches_by_pass["fwd"] += 1
    return out


def colsum(part: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> None:
    """Launch ``csrc/causal_conv.py``'s ``colsum_kernel`` (the gate's
    backward sums its partials with it too): ``part`` (P, N) fp32 summed
    over its rows in order, the first ``a.numel()`` columns into ``a``,
    the rest into ``b``."""
    rows, n = part.shape
    bp, bn, warps = SUM_BLOCK
    triton_source.load("causal_conv").colsum_kernel[(_cdiv(n, bn),)](
        part, a, b, rows, n, a.numel(), BLOCK_P=bp, BLOCK=bn,
        num_warps=warps)


def causal_conv_silu_bwd_cuda(dy: torch.Tensor, x: torch.Tensor,
                              w: torch.Tensor, b: torch.Tensor
                              ) -> Tuple[torch.Tensor, ...]:
    """The backward on CUDA tensors: ``(dx, dw, db)`` (dx a contiguous
    (B, S, C) in x's dtype, dw and db in w's and b's) in two launches:
    dx and each program's fp32 dw / db partials, then their sum in a
    fixed order."""
    _check(x, w, b)
    _on_card(dy, x, w, b)
    if tuple(dy.shape) != tuple(x.shape) or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not fit x "
                         f"{tuple(x.shape)} {x.dtype}")
    if dy.stride(2) != 1 and dy.shape[2] > 1:
        dy = dy.contiguous()
    bsz, S, C = x.shape
    chunk, n_chunks = plan(bsz, S)
    bc, warps = BLOCK
    dx = torch.empty((bsz, S, C), dtype=x.dtype, device=x.device)
    part = torch.empty((bsz * n_chunks, (K + 1) * C), dtype=torch.float32,
                       device=x.device)
    dw = torch.empty_like(w)
    db = torch.empty_like(b)
    mod = triton_source.load("causal_conv")
    with torch.cuda.device(x.get_device()):
        mod.conv_bwd_kernel[(bsz * n_chunks, _cdiv(C, bc))](
            x, w, b, dy, dx, part, S, C, x.stride(0), x.stride(1),
            dy.stride(0), dy.stride(1), chunk, n_chunks, BLOCK_C=bc,
            num_warps=warps)
        colsum(part, dw, db)
    causal_conv_silu_cuda.launches += 2
    launches_by_pass["bwd"] += 1
    return dx, dw, db


class CausalConvSilu(torch.autograd.Function):
    """The kernels with their backward: the forward saves x (the view it
    was given), w and b, and the backward recomputes the pre-activation."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return causal_conv_silu_fwd_cuda(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        return causal_conv_silu_bwd_cuda(dy, x, w, b)


def causal_conv_silu_cuda(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """The conv front of CUDA tensors on the kernels, differentiable in
    x, w and b.  Raises on what the kernels do not take (:func:`_check`)."""
    return CausalConvSilu.apply(x, w, b)


# kernel launches since the last reset (CPU calls excluded)
causal_conv_silu_cuda.launches = 0


def reset_launches() -> None:
    """Set :attr:`causal_conv_silu_cuda.launches` and each pass's count
    to 0."""
    causal_conv_silu_cuda.launches = 0
    for k in launches_by_pass:
        launches_by_pass[k] = 0


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``silu(causal_conv1d(x, w) + b)``: the kernels for CUDA tensors,
    :func:`causal_conv_silu_ref` for CPU and ``meta`` tensors."""
    if x.device.type in ("cpu", "meta"):
        return causal_conv_silu_ref(x, w, b)
    return causal_conv_silu_cuda(x, w, b)
