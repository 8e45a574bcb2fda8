"""Building the hand-written CUDA kernels at first use.

Each source under ``csrc/`` (``*.cu`` with a plain C interface) is
compiled by ``nvcc`` for ``sm_90a`` into a shared library, from this
package's sources only, into ``build/repro_torch/`` at the repository
root, and loaded with ``ctypes`` by its wrapper.  A library is named by
a digest of its source and flags, so an edited source is rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict

__all__ = ["build_library", "nvcc_path", "CSRC", "BUILD_DIR", "NVCC_FLAGS",
           "BUILD_LOGS"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# nvcc's output of the last build of each source in this process (the
# ptxas register / shared-memory report), by the source's stem
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")
             if os.environ.get("CUDA_HOME") else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                       "PATH): the CUDA kernels cannot be built")


def build_library(source: Path) -> Path:
    """Compile ``source`` (if not built yet); return the shared
    library's path.  Raises on any compiler failure."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"lib{source.stem}-{tag[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: concurrent builds never
    # load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOGS[source.stem] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOGS[source.stem]}")
    os.replace(tmp, lib)
    return lib
