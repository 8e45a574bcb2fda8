"""Bit-serial digital-CIM MVM: the hand-written CUDA kernel's wrapper.

Counterpart of :mod:`repro.kernels.bitserial_mvm` (the Pallas TPU
kernel).  The kernel, ``csrc/bitserial_mvm.cu``, is CUDA C++ for
``sm_90a``; it is compiled with ``nvcc`` into a shared library with a
plain C interface at first use, from this package's sources only, into
``build/repro_torch/`` at the repository root, and loaded with
``ctypes``.  A library is named by a digest
of its source and flags, so an edited source is rebuilt.

:func:`bitserial_mvm` dispatches on the tensors' device: CUDA tensors
launch the kernel (a build or launch failure raises); CPU tensors run
the plain version :func:`repro_torch.kernels.ref.bitserial_mvm_ref`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from .ref import bitserial_mvm_ref

__all__ = ["bitserial_mvm", "build_library", "SOURCE", "NVCC_FLAGS"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "bitserial_mvm.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_TILE = 8                 # outputs per thread along M and N (see the .cu)
_MAX_THREADS = 256
_MAX_SMEM = 232448        # bytes of shared memory a block can use

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


def _check(x: torch.Tensor, w: torch.Tensor, act_bits: int, block_m: int,
           block_n: int, block_k: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"need (M,K) @ (K,N), got {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"need int8 operands, got {x.dtype}, {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if not 1 <= act_bits <= 8:
        raise ValueError(f"act_bits must be in 1..8, got {act_bits}")
    m, k = x.shape
    n = w.shape[1]
    if m % block_m or n % block_n or k % block_k:
        raise ValueError(
            f"shape ({m},{k})x({k},{n}) not divisible by blocks "
            f"({block_m},{block_n},{block_k}); cim_mvm pads")
    if block_m % _TILE or block_n % _TILE or block_k % 4 \
            or min(block_m, block_n, block_k) <= 0:
        raise ValueError(f"blocks ({block_m},{block_n},{block_k}): M/N "
                         f"blocks must be multiples of {_TILE}, the K "
                         f"block a multiple of 4")
    if (block_m // _TILE) * (block_n // _TILE) > _MAX_THREADS:
        raise ValueError(f"block {block_m}x{block_n} needs more than "
                         f"{_MAX_THREADS} threads")
    if 4 * (block_k // 4) * (block_m + 1 + block_n) > _MAX_SMEM:
        raise ValueError(f"blocks ({block_m},{block_n},{block_k}) exceed "
                         f"a block's shared memory")


def bitserial_mvm(x: torch.Tensor, w: torch.Tensor, *, act_bits: int = 8,
                  block_m: int = 128, block_n: int = 128,
                  block_k: int = 128, signed: bool = True) -> torch.Tensor:
    """``(M, K) int8 @ (K, N) int8 -> (M, N) int32`` via bit-serial planes.

    Shapes must be multiples of the block sizes — use
    :func:`repro_torch.kernels.ops.cim_mvm` for automatic padding.
    """
    _check(x, w, act_bits, block_m, block_n, block_k)
    if x.device.type == "cpu":
        return bitserial_mvm_ref(x, w, act_bits=act_bits, signed=signed)
    if x.device.type != "cuda":
        raise ValueError(f"no bit-serial kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("operands must be contiguous")
    if x.data_ptr() % 4 or w.data_ptr() % 4:
        raise ValueError("operands must be 4-byte aligned")
    m, k = x.shape
    n = w.shape[1]
    if m // block_m >= 1 << 31 or n // block_n > 65535:
        raise ValueError(f"grid ({m // block_m}, {n // block_n}) too large")
    out = torch.empty((m, n), dtype=torch.int32, device=x.device)
    if m == 0 or n == 0:
        return out
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bitserial_mvm_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, block_m,
            block_n, block_k, act_bits, int(signed), stream)
    if err:
        raise RuntimeError(f"bitserial_mvm launch failed: "
                           f"{lib.bitserial_mvm_error_string(err).decode()}")
    bitserial_mvm.launches += 1
    return out


# kernel launches since the last reset (CPU plain-version calls excluded)
bitserial_mvm.launches = 0
