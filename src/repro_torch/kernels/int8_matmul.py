"""The direct INT8 GEMM on CUDA: its planner, its launcher, its launch
counters and the plain version of its split algorithm.

Counterpart of the XLA dot behind :func:`repro.kernels.ops.int8_matmul`.
:func:`plan` routes each shape, in pure Python, to one of two hand
kernels:

* ``"stream"``: ``csrc/int8_matmul.cu`` (CUDA C++ for ``sm_90a``, built
  by ``nvcc`` at first use through :mod:`.nvcc`, loaded with
  ``ctypes``), made for the decode shapes: M up to :data:`MAX_M` rows of
  x against a (K, N) weight streamed once by TMA, with N a multiple of 16
  and 16-byte aligned operands.  Its grid is (N strips, K slices),
  planned to one wave where x's slice fits; the K slices of a strip are one thread-block
  cluster and combine inside the launch (no memset, no workspace).
* ``"tile"``: the bit-serial source's one-pass tiles
  (:func:`repro_torch.kernels.bitserial_mvm.int8_matmul_cuda`) for every
  other shape (large M, ragged or unaligned N).

The split is a dispatch by shape, counted per route in
:data:`launches_by_route`, not a fallback: a build or launch failure
raises.  :func:`int8_matmul_splits_ref` is the kernels' split algorithm
(per-slice int32 partials, then their wrapped sum) as plain tensor code;
nothing on the CUDA path calls it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import torch

from . import bitserial_mvm as bsm
from . import nvcc
from .ref import mvm_ref

__all__ = ["Plan", "plan", "stream_plan", "operands_aligned",
           "int8_matmul_cuda", "int8_matmul_splits_ref",
           "launches_by_route", "build_library", "SOURCE", "MAX_M",
           "MAX_SLICES"]

SOURCE = nvcc.CSRC / "int8_matmul.cu"
# the stream route takes M up to this many rows
MAX_M = 16
# must match the .cu: w columns a strip (one TMA box wide), K rows a
# stage, stages in the ring, bytes of x a block stages, K slices of a strip
# (one cluster; above 8 a non-portable cluster size)
BOX = 128
ROWS = 128
STAGES = 4
X_MAX = 65536
MAX_SLICES = 16
# the most K slices the planner aims at
SLICES = 8
_LIB: Optional[ctypes.CDLL] = None

# kernel launches since the last reset, by route (CPU calls excluded)
launches_by_route = {"stream": 0, "tile": 0}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Plan:
    """One call's route and split: ``slices`` K slices of ``k_per_slice``
    rows (the last may be shorter) over ``strips`` column strips (of
    :data:`BOX` columns on ``"stream"``).  For ``"tile"``: the tile's
    ``(block_m, block_n)`` in ``tile``."""

    route: str
    k_per_slice: int
    slices: int
    strips: int
    tile: tuple = ()

    @property
    def blocks(self) -> int:
        return self.strips * self.slices


def stream_plan(m: int, n: int, k: int,
                sms: int = bsm.H100_SMS) -> Optional[Plan]:
    """The stream kernel's grid for ``(m, k) @ (k, n)``: strips of
    :data:`BOX` columns, K cut into slices of whole :data:`ROWS`-row
    stages.  ``None`` when no split of at most :data:`MAX_SLICES` slices
    keeps a slice's x within :data:`X_MAX` bytes (which also keeps a
    block's shared memory within the H100's).

    The slices are the largest power of two, at most :data:`SLICES`, that
    keeps the grid within one block an SM, so that it runs in one wave:
    each block then streams a long K run, and a cluster stays within one
    GPC.  At phi4-mini's decode projections that is 64-128 blocks, which
    probes on an H100 found faster than filling every SM (the cluster's
    reduce-scatter costs more with more slices; PERF.md).  Only where x's
    slice would not fit (M * K over 8 * X_MAX) does it take more slices,
    and then the grid may take more than one wave."""
    strips = _cdiv(n, BOX)
    steps = _cdiv(k, ROWS)
    slices = 1 << (max(1, sms // strips).bit_length() - 1)
    slices = min(slices, SLICES, steps)
    while slices <= min(steps, MAX_SLICES):
        per = _cdiv(steps, slices)
        if m * per * ROWS <= X_MAX:
            return Plan("stream", per * ROWS, _cdiv(steps, per), strips)
        slices += 1
    return None


@lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, sms: int = bsm.H100_SMS,
         aligned: bool = True) -> Plan:
    """The route and split of an ``(m, k) @ (k, n)`` call on a card of
    ``sms`` SMs; ``aligned``: x and w contiguous at 16-byte aligned
    addresses.  ``"stream"`` for ``1 <= m <= MAX_M`` with ``n`` a
    multiple of 16 (w's row stride, for the tensor map), aligned operands
    and a split that fits (:func:`stream_plan`); ``"tile"`` (the
    bit-serial source's tiles, with the tile and K split of
    :func:`bitserial_mvm.choose_blocks`) otherwise."""
    if aligned and 1 <= m <= MAX_M and k >= 1 and n >= 16 and n % 16 == 0:
        p = stream_plan(m, n, k, sms)
        if p is not None:
            return p
    bm, bn, bk = bsm.choose_blocks(m, n, k, sms)
    return Plan("tile", bk, max(1, _cdiv(k, bk)), _cdiv(n, bn), (bm, bn))


def int8_matmul_splits_ref(x: torch.Tensor, w: torch.Tensor,
                           p: Plan) -> torch.Tensor:
    """The kernels' algorithm as plain tensor code: K cut into
    ``p.slices`` slices of ``p.k_per_slice`` rows, each slice's
    ``(M, N)`` partial wrapped to int32 (as its block's accumulator
    wraps), the partials added with int32 wrap-around."""
    k = x.shape[1]
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.int64,
                        device=x.device)
    for lo in range(0, k, p.k_per_slice):
        total += mvm_ref(x[:, lo:lo + p.k_per_slice],
                         w[lo:lo + p.k_per_slice]).to(torch.int64)
    return ((total + 2**31) % 2**32 - 2**31).to(torch.int32)


def build_library():
    """Compile ``csrc/int8_matmul.cu`` (if not built yet); return the
    shared library's path.  Raises on any compiler failure."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.int8_matmul_stream_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.int8_matmul_stream_launch.restype = ctypes.c_int
        lib.int8_matmul_stream_error_string.argtypes = [ctypes.c_int]
        lib.int8_matmul_stream_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_stream(x: torch.Tensor, w: torch.Tensor, p: Plan) -> torch.Tensor:
    """Launch the stream kernel on checked, contiguous, aligned CUDA
    operands with the split of ``p`` (a ``"stream"`` plan for this
    shape); the ``(M, N)`` int32 output."""
    m, k = x.shape
    n = w.shape[1]
    index = x.get_device()
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    lib = _LIB or _library()
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
            p.k_per_slice, stream)
    if index == torch.cuda.current_device():
        err = lib.int8_matmul_stream_launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.int8_matmul_stream_launch(*args)
    if err:
        raise RuntimeError(
            "int8_matmul_stream_launch failed: "
            f"{lib.int8_matmul_stream_error_string(err).decode()} ({err})")
    return out


def operands_aligned(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Both operands contiguous at 16-byte aligned addresses (what the
    stream kernel's copies need)."""
    return (x.is_contiguous() and w.is_contiguous()
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


def int8_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32`` on CUDA operands of
    any shape, modulo 2^32, on the route :func:`plan` picks."""
    bsm._check(x, w, 8)
    if not x.is_cuda:
        raise ValueError(f"no CUDA kernel for device {x.device}")
    m, k = x.shape
    n = w.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=torch.int32, device=x.device)
    p = plan(m, n, k, _sms(x.get_device()), operands_aligned(x, w))
    if p.route == "tile":
        out = bsm.int8_matmul_cuda(x.contiguous(), w.contiguous())
    else:
        out = _launch_stream(x, w, p)
    launches_by_route[p.route] += 1
    return out
