"""Bit-serial digital-CIM MVM: the hand-written CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.bitserial_mvm` (the Pallas TPU
kernel).  The kernel, ``csrc/bitserial_mvm.cu``, is CUDA C++ for
``sm_90a``; it is compiled with ``nvcc`` into a shared library with a
plain C interface at first use, from this package's sources only, into
``build/repro_torch/`` at the repository root, and loaded with
``ctypes``.  A library is named by a digest
of its source and flags, so an edited source is rebuilt.

:func:`bitserial_mvm` keeps the JAX signature and dispatches on the
tensors' device: CUDA tensors launch the kernel (a build or launch
failure raises); CPU tensors run the plain version
:func:`repro_torch.kernels.ref.bitserial_mvm_ref`.
:func:`bitserial_mvm_cuda` launches on CUDA operands of any shape, with
the tile and K split from :func:`choose_blocks` (pure Python) unless
given.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Optional, Tuple

import torch

from .ref import bitserial_mvm_ref

__all__ = ["bitserial_mvm", "bitserial_mvm_cuda", "choose_blocks",
           "resolve_blocks", "check_tile", "build_library", "SOURCE",
           "NVCC_FLAGS", "TILES", "BK"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitserial_mvm.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# (block_m, block_n) output tiles the kernel is instantiated for, and the
# depth of one pipeline step: must match the .cu
TILES = ((128, 128), (128, 64), (64, 64), (16, 64))
BK = 64
H100_SMS = 132

_LIB: Optional[ctypes.CDLL] = None
# nvcc's output of the last build in this process (register/smem report)
BUILD_LOG = ""


BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the bit-serial CUDA kernel cannot be built")


def build_library() -> Path:
    """Compile ``csrc/bitserial_mvm.cu`` (if not built yet); return the
    shared library's path.  Raises on any compiler failure."""
    global BUILD_LOG
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out_dir = BUILD_DIR
    lib = out_dir / f"libbitserial_mvm-{tag[:16]}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builders never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        lib.bitserial_mvm_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        lib.bitserial_mvm_launch.restype = ctypes.c_int
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


def bitserial_mvm_cuda(x: torch.Tensor, w: torch.Tensor, *,
                       act_bits: int = 8, signed: bool = True,
                       block_m: Optional[int] = None,
                       block_n: Optional[int] = None,
                       block_k: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel on CUDA operands of any shape (no padding: the
    kernel masks ragged edges).  Blocks left ``None`` come from
    :func:`choose_blocks`; given ones must pass :func:`check_tile`."""
    _check(x, w, act_bits)
    if not x.is_cuda:
        raise ValueError(f"no bit-serial kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    index = x.get_device()
    bm, bn, bk = _launch_blocks(m, n, k, (block_m, block_n, block_k), index)
    if m == 0 or n == 0 or k == 0:
        return x.new_zeros((m, n), dtype=torch.int32)
    # the launcher zeroes the output first when K is split
    out = x.new_empty((m, n), dtype=torch.int32)
    lib = _LIB or _library()
    # the raw handle of PyTorch's current stream (what
    # torch.cuda.current_stream(index).cuda_stream reads, without
    # building a Stream object on every launch)
    stream = torch._C._cuda_getCurrentRawStream(index)
    args = (x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, bm, bn, bk,
            act_bits, int(signed), stream)
    if index == torch.cuda.current_device():
        err = lib.bitserial_mvm_launch(*args)
    else:
        with torch.cuda.device(index):
            err = lib.bitserial_mvm_launch(*args)
    if err:
        raise RuntimeError(f"bitserial_mvm launch failed: "
                           f"{lib.bitserial_mvm_error_string(err).decode()}")
    bitserial_mvm.launches += 1
    return out


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
