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
function: on CUDA tensors every product launches one of two hand
kernels (built by ``nvcc`` at first use; a build or launch failure
raises), on CPU tensors it runs the plain versions
(:func:`ragged_dot_ref`, :func:`ragged_dot_dx_ref`,
:func:`ragged_dot_dw_ref`: a loop of ``torch.matmul`` over the groups,
which reads the group sizes on the host).  The kernel path reads nothing
back from the device: the group offsets are computed there.

:func:`route`, pure Python, picks a product's kernel by shape, and each
launch is counted in :data:`launches_by_route`:

* ``"wgmma"`` and ``"stream"``: ``csrc/grouped_gemm_sm90.cu`` (CUDA C++
  for ``sm_90a``) for bf16 operands with K and N multiples of 8 and
  16-byte aligned rows, the strides a TMA tensor map needs.  ``"wgmma"``
  (training buffers, every ``dx`` and ``dw``): 128 x 256 output tiles on
  ``wgmma`` fed by TMA, over a persistent grid.  ``"stream"`` (``fwd``
  with M up to :data:`STREAM_MAX_M` rows, the decode buffers): the
  touched experts' weights streamed once, in units of 8 rows x 32 (or,
  where the units are many, 64) columns spread over the SMs.
* ``"tile"``: ``csrc/grouped_gemm.cu``'s ``mma.sync`` / FFMA tiles for
  fp32 and unaligned operands.

It is a dispatch by shape, not a fallback.  :func:`tile_schedule` and
:func:`ragged_dot_tiles_ref` are the new kernel's work list and
algorithm as plain tensor code (boxes that run into the next group,
masked at the store; ``dw``'s last step zeroed in both operands; zero
tiles past the sum): the CPU tests hold them to ``lax.ragged_dot``, and
nothing on the CUDA path calls them.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from . import nvcc

__all__ = ["ragged_dot", "ragged_dot_ref", "ragged_dot_dx_ref",
           "ragged_dot_dw_ref", "ragged_dot_cuda", "RaggedDot", "route",
           "operands_aligned", "tile_schedule", "ragged_dot_tiles_ref",
           "Tile", "build_library", "build_sm90_library", "SOURCE",
           "SM90_SOURCE", "MAX_GROUPS", "BM", "BN", "ROUTES",
           "STREAM_MAX_M", "launches_by_route", "reset_launches"]

SOURCE = nvcc.CSRC / "grouped_gemm.cu"
SM90_SOURCE = nvcc.CSRC / "grouped_gemm_sm90.cu"
# must match grouped_gemm.cu (the "tile" route): the output tile, and the
# most groups a launch takes (either source)
BM, BN = 64, 128
MAX_GROUPS = 1024
# must match grouped_gemm_sm90.cu: the "wgmma" route's output tile and
# reduction step, the "stream" route's unit (rows of a group x output
# columns: STREAM_BN, or twice that where each block gets 6 or more such
# units)
WG_BM, WG_BN, WG_BK = 128, 256, 64
STREAM_BM, STREAM_BN = 8, 32
# fwd on buffers of at most this many rows takes the "stream" route: where
# the two routes cross at olmoe's and deepseek-v3's widths on an H100
STREAM_MAX_M = 192
FWD, DX, DW = 0, 1, 2
ROUTES = ("wgmma", "stream", "tile")
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_SM90_ROUTES = {"wgmma": 0, "stream": 1}

_LIB: Optional[ctypes.CDLL] = None
_SM90_LIB: Optional[ctypes.CDLL] = None

# kernel launches since the last reset, by route (CPU calls excluded);
# also ``ragged_dot.launches_by_route``
launches_by_route = dict.fromkeys(ROUTES, 0)


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


def route(mode: int, dtype: torch.dtype, m: int, k: int, n: int,
          aligned: bool) -> str:
    """The kernel for one product of ``x`` (M, K) and ``w`` (G, K, N):
    ``"tile"`` unless the operands are bf16 with K and N multiples of 8
    and ``aligned`` (every pointer 16-byte aligned); then ``"stream"`` for
    ``fwd`` at M <= :data:`STREAM_MAX_M`, else ``"wgmma"``."""
    if dtype != torch.bfloat16 or not aligned or k % 8 or n % 8:
        return "tile"
    if mode == FWD and m <= STREAM_MAX_M:
        return "stream"
    return "wgmma"


_plan = route


def operands_aligned(*ts: torch.Tensor) -> bool:
    """Every tensor's data 16-byte aligned (the TMA's base address)."""
    return all(t.data_ptr() % 16 == 0 for t in ts)


class Tile(NamedTuple):
    """One work item of the new kernel.  ``fwd``, ``dx``: output rows
    ``[r0, min(r0 + bm, r_end))`` of ``group`` (``-1``: rows past the
    groups' sum, ``r_end`` = M, written as zeros), columns from ``c0``.
    ``dw``: rows ``[r0, r0 + bm)`` of ``dw[group]`` (over K, ``r_end`` =
    K), columns from ``c0``, the reduction over the buffer's rows
    ``[lo, hi)``."""

    group: int
    r0: int
    r_end: int
    c0: int
    lo: int = 0
    hi: int = 0


def tile_schedule(group_sizes: torch.Tensor, m: int, n: int, bm: int,
                  bn: int, mode: int = FWD, k: int = 0) -> List[Tile]:
    """The kernel's work items in the order the blocks walk them (item i
    goes to block i mod the grid): ``fwd``, ``dx`` (``n`` the output's
    columns: N, or K for ``dx``): group by group, each column tile of
    ``bn`` with the group's row tiles of ``bm`` rows from its first row
    (the row tiles of a column tile run side by side and share its
    weights), then the tiles of the rows past the groups' sum; ``dw``
    (``k`` = K): every group's (K tile, N tile), an empty group's with no
    reduction.  A read of the sizes on the host (sizes below 0 count as
    0, the sum cut at ``m``)."""
    bounds = _bounds(group_sizes, m)
    cols = range(0, n, bn)
    if mode == DW:
        return [Tile(g, r0, k, c0, lo, hi) for g, (lo, hi) in
                enumerate(bounds) for r0 in range(0, k, bm) for c0 in cols]
    out = [Tile(g, r0, hi, c0) for g, (lo, hi) in enumerate(bounds)
           for c0 in cols for r0 in range(lo, hi, bm)]
    end = bounds[-1][1] if bounds else 0
    return out + [Tile(-1, r0, m, c0) for r0 in range(end, m, bm)
                  for c0 in cols]


def ragged_dot_tiles_ref(mode: int, a: torch.Tensor, b: torch.Tensor,
                         group_sizes: torch.Tensor, bm: int, bn: int,
                         bk: int = WG_BK) -> torch.Tensor:
    """The product computed the new kernel's way, tile by tile of
    :func:`tile_schedule`, in fp32 and rounded once to ``a``'s dtype.
    ``fwd`` (a = x, b = w) and ``dx`` (a = dy, b = w): a tile multiplies
    the full box of ``bm`` rows from its first row (rows past M zeros) and
    stores only the rows below its ``r_end``, so a box that runs into the
    next group computes products that are never stored.  ``dw`` (a = x,
    b = dy): a group's reduction in steps of ``bk`` rows from its first
    row, the rows of a step past the group zeroed in both operands (a
    non-finite value in a neighbouring group stays out of the sum); an
    empty group's tiles are zeros.  Tiles past the groups' sum are
    zeros."""
    m = a.shape[0]
    af = torch.cat([a.float(), a.new_zeros((max(bm, bk), a.shape[1]),
                                           dtype=torch.float32)])
    if mode == DW:
        dy = torch.cat([b.float(), b.new_zeros((bk, b.shape[1]),
                                               dtype=torch.float32)])
        k, n = a.shape[1], b.shape[1]
        groups = group_sizes.shape[0]
        out = torch.empty((groups, k, n), dtype=a.dtype, device=a.device)
        cur = None                  # the group whose sum is in acc
        for t in tile_schedule(group_sizes, m, n, bm, bn, DW, k):
            if t.group != cur:
                cur = t.group
                acc = torch.zeros((k, n), dtype=torch.float32,
                                  device=a.device)
                for r in range(t.lo, t.hi, bk):
                    xs, ds = af[r:r + bk].clone(), dy[r:r + bk].clone()
                    xs[t.hi - r:] = 0
                    ds[t.hi - r:] = 0
                    acc += xs.transpose(0, 1) @ ds
            out[t.group, t.r0:t.r0 + bm, t.c0:t.c0 + bn] = \
                acc[t.r0:t.r0 + bm, t.c0:t.c0 + bn]
        return out
    w = (b if mode == FWD else b.transpose(1, 2)).float()
    n = w.shape[2]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    cur, boxes = None, {}   # the group at hand, its full boxes by first row
    for t in tile_schedule(group_sizes, m, n, bm, bn):
        rows = min(t.r0 + bm, t.r_end) - t.r0
        tile = out[t.r0:t.r0 + rows, t.c0:t.c0 + bn]
        if t.group < 0:
            tile.zero_()
            continue
        if t.group != cur:
            cur, boxes = t.group, {}
        if t.r0 not in boxes:
            boxes[t.r0] = af[t.r0:t.r0 + bm] @ w[t.group]
        tile.copy_(boxes[t.r0][:rows, t.c0:t.c0 + bn])
    return out


def build_library():
    """Compile ``csrc/grouped_gemm.cu`` (if not built yet); return the
    shared library's path."""
    return nvcc.build_library(SOURCE)


def build_sm90_library():
    """Compile ``csrc/grouped_gemm_sm90.cu`` (if not built yet); return
    the shared library's path."""
    return nvcc.build_library(SM90_SOURCE)


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


def _sm90_library() -> ctypes.CDLL:
    global _SM90_LIB
    if _SM90_LIB is None:
        lib = ctypes.CDLL(str(build_sm90_library()))
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        lib.grouped_gemm_sm90_launch.argtypes = (
            [c_int, c_int] + [c_ptr] * 4 + [c_int] * 4 + [c_ptr])
        lib.grouped_gemm_sm90_launch.restype = c_int
        lib.grouped_gemm_sm90_error_string.argtypes = [c_int]
        lib.grouped_gemm_sm90_error_string.restype = ctypes.c_char_p
        _SM90_LIB = lib
    return _SM90_LIB


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
                    group_sizes: torch.Tensor,
                    route: Optional[str] = None) -> torch.Tensor:
    """One kernel launch: ``mode`` ``FWD`` (a = x (M, K), b = w (G, K, N)
    -> (M, N)), ``DX`` (a = dy (M, N), b = w -> (M, K)) or ``DW`` (a = x,
    b = dy -> (G, K, N)).  bf16 (tensor cores, fp32 accumulation) or fp32
    (FFMA) operands, the output in their dtype.  ``route``: the kernel
    (:data:`ROUTES`), by default :func:`route`'s; a route the operands do
    not fit raises."""
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
    aligned = operands_aligned(a, b, out)
    planned = _plan(mode, a.dtype, m, k, n, aligned)
    r = planned if route is None else route
    if r not in ROUTES or (r != "tile" and (planned == "tile" or (
            r == "stream" and mode != FWD))):
        raise ValueError(f"route {r!r} does not take mode {mode} on "
                         f"{a.dtype} (M {m}, K {k}, N {n}, aligned "
                         f"{aligned})")
    index = a.get_device()
    stream = torch._C._cuda_getCurrentRawStream(index)
    if r == "tile":
        elem = a.element_size()
        vec = int(k * elem % 16 == 0 and n * elem % 16 == 0 and aligned)
        lib = _LIB or _library()
        fn, err_string = lib.grouped_gemm_launch, lib.grouped_gemm_error_string
        args = (mode, kind, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                gs.data_ptr(), g, m, k, n, vec, stream)
    else:
        lib = _SM90_LIB or _sm90_library()
        fn = lib.grouped_gemm_sm90_launch
        err_string = lib.grouped_gemm_sm90_error_string
        args = (mode, _SM90_ROUTES[r], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), gs.data_ptr(), g, m, k, n, stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError(f"grouped GEMM ({r}) launch failed: "
                           f"{err_string(err).decode()}")
    ragged_dot.launches += 1
    launches_by_route[r] += 1
    return out


def _fwd(x, w, gs):
    if x.device.type in ("cpu", "meta"):  # meta: the dry run
        return ragged_dot_ref(x, w, gs)
    return ragged_dot_cuda(FWD, x, w, gs)


def _dx(dy, w, gs):
    if dy.device.type in ("cpu", "meta"):  # meta: the dry run
        return ragged_dot_dx_ref(dy, w, gs)
    return ragged_dot_cuda(DX, dy, w, gs)


def _dw(x, dy, gs):
    if x.device.type in ("cpu", "meta"):  # meta: the dry run
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
# CPU calls excluded), in all and by route
ragged_dot.launches = 0
ragged_dot.launches_by_route = launches_by_route


def reset_launches() -> None:
    """Set :attr:`ragged_dot.launches` and every route's count to 0."""
    ragged_dot.launches = 0
    for r in ROUTES:
        launches_by_route[r] = 0
