"""The gated norm's ``sm90`` route: its planner, router and binding.

``csrc/gated_norm_sm90.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc``
at first use and loaded with ``ctypes``) streams each row's operands by
bulk TMA copies into a ring of shared-memory stages, a persistent grid
of blocks walking the rows; a row too wide for one block's ring is split
head-aligned over a thread-block cluster of 2 or 4 blocks.  This module
holds what surrounds the kernel in plain Python: :func:`route` (which
calls the route takes), :func:`plan` (the launch: cluster size, ring
stages, shared memory, grid), :func:`blocks` (the rows and columns each
block walks), and the library's loading, its device queries and its
launch.  :mod:`repro_torch.kernels.gated_norm` dispatches to it, and
holds the autograd and the plain versions.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from . import nvcc

__all__ = ["SOURCE", "WARPS", "VEC", "VPT", "CLUSTERS", "MIN_STAGES",
           "MAX_STAGES",
           "RING", "RING_MAX", "SLOT", "HEADER", "SMEM_MAX",
           "BLOCKS_PER_SM", "threads", "plan", "blocks", "route",
           "build_library", "load", "plan_on", "launch"]

SOURCE = nvcc.CSRC / "gated_norm_sm90.cu"
# consumer warps a block (the .cu's kWarps), the columns of a vector (16
# bytes, its kVec), vectors a consumer thread (its instantiations), cluster
# sizes
WARPS = 8
VEC = 8
VPT = (1, 2, 3, 4)
CLUSTERS = (1, 2, 4)
# the ring: stages a block (at least three: the consumers hold two rows,
# this one and the next, while the next rows arrive; the .cu's
# kMaxStages), the ring a block aims at (64 KB measured faster than 80 or
# 100 on an H100 at mamba2-780m's widths, PERF.md) and the most it may
# take (two blocks an SM of the card's 228 KB), an operand's slot in a
# stage rounded up to 128 bytes, the shared-memory header before the ring
# (the .cu's kRingOff) and the most a block may opt in to (227 KB)
MIN_STAGES = 3
MAX_STAGES = 8
RING = 64 * 1024
RING_MAX = 100 * 1024
SLOT = 128
HEADER = 5632
SMEM_MAX = 232448
BLOCKS_PER_SM = 2
# the H100's SMs (the planner's default; plan_on asks the device)
_SMS = 132

_LIB: Optional[ctypes.CDLL] = None
_SM_COUNT: Dict[int, int] = {}
_MAX_CLUSTERS: Dict[tuple, int] = {}


def threads(nvec: int) -> Optional[int]:
    """The vectors (:data:`VEC` columns) a consumer thread holds for a
    block's share of ``nvec`` vectors a row: the fewest that cover it over
    :data:`WARPS` warps; ``None`` past 4."""
    vpt = -(-nvec // (WARPS * 32))
    return vpt if vpt in VPT else None


def plan(rows: int, d: int, heads: int, skip: bool, bwd: bool,
         sms: int = _SMS, max_clusters: Optional[int] = None
         ) -> Optional[Dict[str, int]]:
    """The launch for ``rows`` rows of ``d`` bf16 columns (``heads``
    heads): the smallest cluster (1, 2 or 4 blocks, each a head-aligned
    share of every row) whose ring holds at least :data:`MIN_STAGES`
    stages of the call's operands (y, z, x with the skip, dout in the
    backward) within :data:`RING_MAX`, and as many more as :data:`RING`
    holds; as many clusters as rows, at most :data:`BLOCKS_PER_SM` blocks
    an SM and ``max_clusters`` (the clusters the device holds at once: a
    persistent grid never runs a second wave).  ``None`` where no cluster
    size takes the row."""
    if heads < 1 or d % heads or (d // heads) % 8:
        return None
    nops = 2 + bool(skip) + bool(bwd)
    for cs in CLUSTERS:
        if heads % cs:
            continue
        share = d // cs
        vpt = threads(share // VEC)
        if vpt is None:
            continue
        slot = -(-share * 2 // SLOT) * SLOT
        stage = nops * slot
        if MIN_STAGES * stage > RING_MAX:
            continue
        stages = min(MAX_STAGES, max(MIN_STAGES, RING // stage))
        clusters = max(1, min(rows, BLOCKS_PER_SM * sms // cs,
                              max_clusters or rows))
        return {"cluster": cs, "share": share, "nvec": share // VEC,
                "warps": WARPS, "vpt": vpt, "nops": nops,
                "slot_bytes": slot, "stage_bytes": stage, "stages": stages,
                "smem": HEADER + stages * stage, "clusters": clusters,
                "blocks": clusters * cs}
    return None


def blocks(pl: Dict[str, int], rows: int
           ) -> Iterator[Tuple[int, int, range, range]]:
    """``(cluster, rank, rows, columns)`` of each block of the plan
    ``pl``: cluster c walks rows c, c + clusters, ...; its block of rank
    r the columns ``[r share, (r + 1) share)`` of each, its consumer
    thread t the :data:`VEC` columns of each of its vectors ``t + i *
    warps * 32`` (i < vpt) inside them."""
    for c in range(pl["clusters"]):
        for r in range(pl["cluster"]):
            yield (c, r, range(c, rows, pl["clusters"]),
                   range(r * pl["share"], (r + 1) * pl["share"]))


def aligned16(strides: Sequence[int], ptrs: Sequence[int]) -> bool:
    """Every base in ``ptrs`` and every bf16 row stride in ``strides``
    (elements) on a 16-byte boundary."""
    return not any(int(pp) % 16 for pp in ptrs) \
        and not any((int(st) * 2) % 16 for st in strides)


def route(dtype: torch.dtype, d: int, heads: int, strides: Sequence[int],
          ptrs: Sequence[int], aux: Sequence[torch.dtype] = ()) -> str:
    """The planned kernel of a call: ``"sm90"`` for bf16 operands whose
    bases ``ptrs`` and row ``strides`` (elements) are 16-byte aligned,
    head widths a multiple of 8 and a row :func:`plan` takes, with
    ``aux`` (w's and D's dtypes) bf16 or fp32; ``"triton"``
    (``csrc/gated_norm.py``) for every other call (fp32, an unaligned
    view)."""
    if dtype != torch.bfloat16 \
            or any(t not in (torch.bfloat16, torch.float32) for t in aux) \
            or not aligned16(strides, ptrs) \
            or plan(1, d, heads, True, True) is None:
        return "triton"
    return "sm90"


def build_library(source=SOURCE):
    """Compile ``source`` (if not built yet); return the shared library's
    path."""
    return nvcc.build_library(source)


def load(path) -> ctypes.CDLL:
    """The shared library at ``path``, its entry points typed."""
    lib = ctypes.CDLL(str(path))
    c_int, c_ptr, c_f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    strides = ctypes.POINTER(ctypes.c_longlong)
    lib.gate_sm90_fwd.argtypes = ([c_ptr] * 6 + [strides] + [c_int] * 4
                                  + [c_f] + [c_int] * 7 + [c_ptr])
    lib.gate_sm90_fwd.restype = c_int
    lib.gate_sm90_bwd.argtypes = ([c_ptr] * 10 + [strides] + [c_int] * 4
                                  + [c_f] + [c_int] * 7 + [c_ptr])
    lib.gate_sm90_bwd.restype = c_int
    lib.gate_sm90_max_clusters.argtypes = [c_int] * 4
    lib.gate_sm90_max_clusters.restype = c_int
    lib.gate_sm90_error_string.argtypes = [c_int]
    lib.gate_sm90_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The library built from :data:`SOURCE`, loaded at first use."""
    global _LIB
    if _LIB is None:
        _LIB = load(build_library())
    return _LIB


def _sms(index: int) -> int:
    if index not in _SM_COUNT:
        _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SM_COUNT[index]


def plan_on(index: int, rows: int, d: int, heads: int, skip: bool,
            bwd: bool) -> Dict[str, int]:
    """:func:`plan` on CUDA device ``index``: its SMs, and its cap on the
    clusters resident at once (asked of the device once a launch
    shape)."""
    pl = plan(rows, d, heads, skip, bwd, _sms(index))
    key = (index, bwd, pl["vpt"], pl["cluster"], pl["smem"])
    if key not in _MAX_CLUSTERS:
        lib = library()
        with torch.cuda.device(index):
            n = lib.gate_sm90_max_clusters(int(bwd), pl["vpt"],
                                           pl["cluster"], pl["smem"])
        if n <= 0:
            why = lib.gate_sm90_error_string(n).decode() if n else "none"
            raise RuntimeError(f"gated norm (sm90 route): no cluster of "
                               f"{pl['cluster']} fits the device: {why}")
        _MAX_CLUSTERS[key] = n
    if pl["clusters"] > _MAX_CLUSTERS[key]:
        pl = plan(rows, d, heads, skip, bwd, _sms(index),
                  _MAX_CLUSTERS[key])
    return pl


def launch(what: str, index: int, args) -> None:
    """Calls the library's ``gate_sm90_<what>`` on device ``index``;
    raises with its message on a nonzero return (a launch it refused, or
    one that failed: ``cudaGetLastError`` after it)."""
    lib = library()
    fn = getattr(lib, f"gate_sm90_{what}")
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError(f"gated_norm_{what} (sm90 route) failed: "
                           f"{lib.gate_sm90_error_string(err).decode()}")
