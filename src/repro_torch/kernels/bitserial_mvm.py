"""Bit-serial digital-CIM MVM and the direct INT8 GEMM: the wrappers of
the hand-written CUDA kernel.

Counterpart of :mod:`repro.kernels.bitserial_mvm` (the Pallas TPU
kernel).  The kernel, ``csrc/bitserial_mvm.cu``, is CUDA C++ for
``sm_90a``; it is compiled with ``nvcc`` into a shared library with a
plain C interface at first use (:mod:`.nvcc`) and loaded with
``ctypes``.

:func:`bitserial_mvm` keeps the JAX signature and dispatches on the
tensors' device: CUDA tensors launch the kernel (a build or launch
failure raises); CPU tensors run the plain version
:func:`repro_torch.kernels.ref.bitserial_mvm_ref`.
:func:`bitserial_mvm_cuda` launches on CUDA operands of any shape, with
the tile and K split from :func:`choose_blocks` (pure Python) unless
given.  :func:`int8_matmul_cuda` launches the same kernel's one-pass
instantiation (``int8_matmul_launch``, the counterpart of the XLA dot
behind :func:`repro.kernels.ops.int8_matmul`) on the same tiles.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import torch

from . import nvcc
from .ref import bitserial_mvm_ref

__all__ = ["bitserial_mvm", "bitserial_mvm_cuda", "int8_matmul_cuda",
           "choose_blocks",
           "resolve_blocks", "check_tile", "build_library", "SOURCE",
           "TILES", "BK"]

SOURCE = nvcc.CSRC / "bitserial_mvm.cu"
# (block_m, block_n) output tiles the kernel is instantiated for, and the
# depth of one pipeline step: must match the .cu
TILES = ((128, 128), (128, 64), (64, 64), (16, 64))
BK = 64
H100_SMS = 132

_LIB: Optional[ctypes.CDLL] = None


def build_library() -> Path:
    """Compile ``csrc/bitserial_mvm.cu`` (if not built yet); return the
    shared library's path.  Raises on any compiler failure."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.bitserial_mvm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.bitserial_mvm_launch.restype = ctypes.c_int
        lib.int8_matmul_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.int8_matmul_launch.restype = ctypes.c_int
        lib.bitserial_mvm_error_string.argtypes = [ctypes.c_int]
        lib.bitserial_mvm_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=4096)
def choose_blocks(m: int, n: int, k: int, sms: int = H100_SMS
                  ) -> Tuple[int, int, int]:
    """``(block_m, block_n, block_k)`` for an ``(m,k) @ (k,n)`` launch.

    ``(block_m, block_n)`` is the output tile of one thread block, one of
    :data:`TILES`; ``block_k`` (a multiple of :data:`BK`) the K depth each
    block walks, so ``ceil(k / block_k)`` blocks split K for one tile.
    M <= 16 takes the 16-row tile; larger M the largest 64- or 128-row
    tile whose grid covers the ``sms`` multiprocessors; if none does,
    the 16-row tile for M <= 128 and the 64x64 tile above.  A grid of fewer tiles than ``sms`` splits K into
    about ``3 * sms`` blocks (at most one 64-deep step a block): one
    block's K loop is a chain of latency-bound steps, and blocks
    resident side by side hide each other's latency (the rule fits the
    fastest tile and split that ``chip_smoke.py`` finds per main-path
    shape).  Every K slice is non-empty: slice ``s`` starts at
    ``s * block_k < k``.
    """
    if m <= 16:
        bm, bn = 16, 64
    else:
        for bm, bn in TILES[:3]:
            if (n > 64 or bn == 64) and _cdiv(m, bm) * _cdiv(n, bn) >= sms:
                break
        else:
            bm, bn = (16, 64) if m <= 128 else (64, 64)
    steps = max(1, _cdiv(k, BK))
    tiles = _cdiv(m, bm) * _cdiv(n, bn)
    split = 1 if tiles >= sms else min(steps, round(3 * sms / tiles))
    return bm, bn, _cdiv(steps, split) * BK


def resolve_blocks(m: int, n: int, k: int,
                   blocks: Tuple[Optional[int], ...],
                   sms: int = H100_SMS) -> Tuple[int, int, int]:
    """``blocks`` = (block_m, block_n, block_k), each ``None`` filled in
    from :func:`choose_blocks`."""
    auto = choose_blocks(m, n, k, sms)
    bm, bn, bk = (a if b is None else b for a, b in zip(auto, blocks))
    return bm, bn, bk


def check_tile(block_m: int, block_n: int, block_k: int) -> None:
    """Raise ``ValueError`` unless the blocks meet the kernel's
    tensor-core tile rules."""
    if (block_m, block_n) not in TILES:
        raise ValueError(f"no tensor-core tile ({block_m},{block_n}); "
                         f"the kernel has {list(TILES)}")
    if block_k <= 0 or block_k % BK:
        raise ValueError(f"block_k {block_k} is not a positive multiple "
                         f"of the kernel's K step {BK}")


@lru_cache(maxsize=4096)
def _launch_blocks(m: int, n: int, k: int, blocks: Tuple[Optional[int], ...],
                   index: int) -> Tuple[int, int, int]:
    """The checked ``(block_m, block_n, block_k)`` of one launch on CUDA
    device ``index`` (cached: the wrapper runs once per MVM)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    bm, bn, bk = resolve_blocks(m, n, k, blocks, sms)
    check_tile(bm, bn, bk)
    grid = (_cdiv(m, bm), _cdiv(n, bn), _cdiv(k, bk))
    if grid[0] >= 1 << 31 or grid[1] > 65535 or grid[2] > 65535:
        raise ValueError(f"grid {grid} too large")
    return bm, bn, bk


def _check(x: torch.Tensor, w: torch.Tensor, act_bits: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"need int8 operands, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not 1 <= act_bits <= 8:
        raise ValueError(f"act_bits must be in 1..8, got {act_bits}")


def _launch(name: str, x: torch.Tensor, w: torch.Tensor,
            blocks: Tuple[Optional[int], ...], extra: Tuple[int, ...]
            ) -> torch.Tensor:
    """Launch the library's ``name`` on checked CUDA operands: the
    ``(M, N)`` int32 output, the blocks from :func:`choose_blocks` where
    ``None``, ``extra`` before the stream."""
    if not x.is_cuda:
        raise ValueError(f"no CUDA kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    index = x.get_device()
    bm, bn, bk = _launch_blocks(m, n, k, blocks, index)
    if m == 0 or n == 0 or k == 0:
        return x.new_zeros((m, n), dtype=torch.int32)
    # the launcher zeroes the output first when K is split
    out = x.new_empty((m, n), dtype=torch.int32)
    lib = _LIB or _library()
    fn = getattr(lib, name)
    # the raw handle of PyTorch's current stream (what
    # torch.cuda.current_stream(index).cuda_stream reads, without
    # building a Stream object on every launch)
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
            *extra, stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        raise RuntimeError(f"{name} failed: "
                           f"{lib.bitserial_mvm_error_string(err).decode()}")
    return out


def bitserial_mvm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       act_bits: int = 8, signed: bool = True,
                       block_m: Optional[int] = None,
                       block_n: Optional[int] = None,
                       block_k: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA operands of any shape (no padding: the
    kernel masks ragged edges).  Blocks left ``None`` come from
    :func:`choose_blocks`; given ones must pass :func:`check_tile`."""
    _check(x, w, act_bits)
    out = _launch("bitserial_mvm_launch", x, w, (block_m, block_n, block_k),
                  (act_bits, int(signed)))
    bitserial_mvm.launches += 1
    return out


def int8_matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32`` in one pass of the
    int8 tensor cores (modulo 2^32, bit-identical to
    :func:`bitserial_mvm_cuda`), on CUDA operands of any shape, with the
    blocks of :func:`choose_blocks`."""
    _check(x, w, 8)
    out = _launch("int8_matmul_launch", x, w, (None, None, None), ())
    int8_matmul_cuda.launches += 1
    return out


# kernel launches since the last reset (CPU calls excluded)
int8_matmul_cuda.launches = 0


def bitserial_mvm(x: torch.Tensor, w: torch.Tensor, *, act_bits: int = 8,
                  block_m: int = 128, block_n: int = 128,
                  block_k: int = 128, signed: bool = True) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32`` via bit-serial planes.

    Shapes must be multiples of the block sizes — use
    :func:`repro_torch.kernels.ops.cim_mvm` for ragged shapes.  CPU
    operands run the plain version; CUDA operands launch the kernel with
    these blocks, which must meet its tile rules (:func:`check_tile`).
    """
    _check(x, w, act_bits)
    m, k = x.shape
    n = w.shape[1]
    if min(block_m, block_n, block_k) <= 0 \
            or m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shape ({m},{k})x({k},{n}) not divisible by blocks "
            f"({block_m},{block_n},{block_k}); cim_mvm takes ragged shapes")
    if x.device.type == "cpu":
        return bitserial_mvm_ref(x, w, act_bits=act_bits, signed=signed)
    return bitserial_mvm_cuda(x, w, act_bits=act_bits, signed=signed,
                              block_m=block_m, block_n=block_n,
                              block_k=block_k)


# kernel launches since the last reset, one per MVM whatever its K split
# (CPU plain-version calls excluded)
bitserial_mvm.launches = 0
