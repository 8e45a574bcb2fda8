"""Grouped expert GEMM (``lax.ragged_dot``): the CUDA kernel's wrapper,
its autograd and its plain PyTorch versions.

Counterpart of ``lax.ragged_dot`` in
:func:`repro.models.moe_ep.moe_ep_apply_local` (moe_ep.py:114-116; XLA
compute, not a Pallas kernel) and of the two products its transpose rule
gives.  ``x`` (M, K) is cut into consecutive row groups, group g owning
``group_sizes[g]`` rows, and multiplied by ``w[g]`` (K, N):

* forward, rows ragged: ``y[rows of g] = x[rows of g] @ w[g]``;
* ``dx``, rows ragged: ``dy[rows of g] @ w[g]^T`` (the kernel reads
  ``w`` transposed where it lies; nothing is materialised);
* ``dw``, the reduction ragged: ``dw[g] = x[rows of g]^T @ dy[rows of g]``,
  zeros for an empty group.

Rows past ``sum(group_sizes)`` come out zero, as in ``lax.ragged_dot``.
:func:`ragged_dot` is the public entry, a :class:`RaggedDot` autograd
function: on CUDA tensors every product launches the kernel
(``csrc/grouped_gemm.cu``, built by ``nvcc`` at first use; a build or
launch failure raises), on CPU tensors it runs the plain versions
(:func:`ragged_dot_ref`, :func:`ragged_dot_dx_ref`,
:func:`ragged_dot_dw_ref`: a loop of ``torch.matmul`` over the groups,
which reads the group sizes on the host).  The kernel path reads nothing
back from the device: the group offsets are computed there.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import nvcc

__all__ = ["ragged_dot", "ragged_dot_ref", "ragged_dot_dx_ref",
           "ragged_dot_dw_ref", "ragged_dot_cuda", "RaggedDot",
           "build_library", "SOURCE", "MAX_GROUPS", "BM", "BN"]

SOURCE = nvcc.CSRC / "grouped_gemm.cu"
# must match the .cu: the output tile, and the most groups a launch takes
BM, BN = 64, 128
MAX_GROUPS = 1024
FWD, DX, DW = 0, 1, 2
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

_LIB: Optional[ctypes.CDLL] = None


def _bounds(group_sizes: torch.Tensor, rows: int) -> List[Tuple[int, int]]:
    """Each group's ``[lo, hi)`` rows (sizes below 0 count as 0, the sum
    cut at ``rows``): a host read of the sizes, for the plain versions."""
    out, start = [], 0
    for n in group_sizes.tolist():
        end = start + max(int(n), 0)
        out.append((min(start, rows), min(end, rows)))
        start = end
    return out


def ragged_dot_ref(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: ``x`` (M, K), ``w`` (G, K, N) ->
    (M, N) in x's dtype, rows past the groups' sum zero; differentiable
    by autograd."""
    m, n = x.shape[0], w.shape[2]
    parts, end = [], 0
    for g, (lo, hi) in enumerate(_bounds(group_sizes, m)):
        if hi > lo:
            parts.append(x[lo:hi] @ w[g])
        end = hi
    parts.append(x.new_zeros((m - end, n)))
    return torch.cat(parts)


def ragged_dot_dx_ref(dy: torch.Tensor, w: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dx``: ``dy`` (M, N), ``w`` (G, K, N) -> (M, K)."""
    return ragged_dot_ref(dy, w.transpose(1, 2), group_sizes)


def ragged_dot_dw_ref(x: torch.Tensor, dy: torch.Tensor,
                      group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of ``dw``: ``x`` (M, K), ``dy`` (M, N) -> (G, K, N),
    zeros for an empty group."""
    return torch.stack([x[lo:hi].transpose(0, 1) @ dy[lo:hi]
                        for lo, hi in _bounds(group_sizes, x.shape[0])])


def build_library():
    """Compile ``csrc/grouped_gemm.cu`` (if not built yet); return the
    shared library's path."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.grouped_gemm_launch.argtypes = (
            [c_int, c_int] + [c_ptr] * 4 + [c_int] * 5 + [c_ptr])
        lib.grouped_gemm_launch.restype = c_int
        lib.grouped_gemm_error_string.argtypes = [c_int]
        lib.grouped_gemm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, w: torch.Tensor,
           group_sizes: torch.Tensor) -> None:
    if x.dim() != 2 or w.dim() != 3 or x.shape[1] != w.shape[1]:
        raise ValueError(f"need x (M, K) and w (G, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if group_sizes.shape != (w.shape[0],):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} for "
                         f"{w.shape[0]} groups")
    if group_sizes.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"group_sizes must be int32 or int64, got "
                        f"{group_sizes.dtype}")
    if x.dtype != w.dtype or not x.is_floating_point():
        raise TypeError(f"x {x.dtype} and w {w.dtype} must share a float "
                        f"dtype")
    if not (x.device == w.device == group_sizes.device):
        raise ValueError(f"x, w and group_sizes on {x.device}, {w.device}, "
                         f"{group_sizes.device}")


def ragged_dot_cuda(mode: int, a: torch.Tensor, b: torch.Tensor,
                    group_sizes: torch.Tensor) -> torch.Tensor:
    """One kernel launch: ``mode`` ``FWD`` (a = x (M, K), b = w (G, K, N)
    -> (M, N)), ``DX`` (a = dy (M, N), b = w -> (M, K)) or ``DW`` (a = x,
    b = dy -> (G, K, N)).  bf16 (tensor cores, fp32 accumulation) or fp32
    (FFMA) operands, the output in their dtype."""
    if not (a.is_cuda and b.device == a.device
            and group_sizes.device == a.device):
        raise ValueError(f"no grouped-GEMM kernel for {a.device}, "
                         f"{b.device}, {group_sizes.device}")
    kind = _DTYPES.get(a.dtype)
    if kind is None or b.dtype != a.dtype:
        raise TypeError(f"no grouped-GEMM kernel for {a.dtype} x {b.dtype} "
                        f"(bf16 or fp32)")
    g = group_sizes.shape[0]
    if g > MAX_GROUPS:
        raise ValueError(f"{g} groups over the kernel's {MAX_GROUPS}")
    a = a.contiguous()
    b = b.contiguous()
    gs = group_sizes.to(torch.int32).contiguous()     # on the device
    m = a.shape[0]
    if mode == FWD:
        k, n = b.shape[1], b.shape[2]
        out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    elif mode == DX:
        k, n = b.shape[1], b.shape[2]
        out = torch.empty((m, k), dtype=a.dtype, device=a.device)
    else:
        k, n = a.shape[1], b.shape[1]
        out = torch.empty((g, k, n), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    if m == 0 or g == 0:
        return out.zero_()
    elem = a.element_size()
    vec = int(k * elem % 16 == 0 and n * elem % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (a, b, out)))
    index = a.get_device()
    lib = _LIB or _library()
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (mode, kind, a.data_ptr(), b.data_ptr(), out.data_ptr(),
            gs.data_ptr(), g, m, k, n, vec, stream)
    if index == torch.cuda.current_device():
        err = lib.grouped_gemm_launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.grouped_gemm_launch(*args)
    if err:
        raise RuntimeError("grouped_gemm_launch failed: "
                           f"{lib.grouped_gemm_error_string(err).decode()}")
    ragged_dot.launches += 1
    return out


def _fwd(x, w, gs):
    if x.device.type == "cpu":
        return ragged_dot_ref(x, w, gs)
    return ragged_dot_cuda(FWD, x, w, gs)


def _dx(dy, w, gs):
    if dy.device.type == "cpu":
        return ragged_dot_dx_ref(dy, w, gs)
    return ragged_dot_cuda(DX, dy, w, gs)


def _dw(x, dy, gs):
    if x.device.type == "cpu":
        return ragged_dot_dw_ref(x, dy, gs)
    return ragged_dot_cuda(DW, x, dy, gs)


class RaggedDot(torch.autograd.Function):
    """``ragged_dot`` with its transpose: one forward launch, and in the
    backward one ``dx`` and one ``dw`` launch (each only where its input
    needs a gradient)."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _fwd(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, gs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = _dx(dy, w, gs) if ctx.needs_input_grad[0] else None
        dw = _dw(x, dy, gs) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """``lax.ragged_dot(x, w, group_sizes)``: ``x`` (M, K), ``w``
    (G, K, N), ``group_sizes`` (G,) integer -> (M, N) in x's dtype,
    differentiable in ``x`` and ``w``.  CUDA: the kernel; CPU: the plain
    versions."""
    _check(x, w, group_sizes)
    return RaggedDot.apply(x, w, group_sizes)


# kernel launches since the last reset (forward, dx and dw each count one;
# CPU calls excluded)
ragged_dot.launches = 0
