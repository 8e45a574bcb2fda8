"""Loading the Triton kernels' sources at first use.

The Triton kernels (the SSD decode step, Mamba-2's causal conv front
and gated norm, the cross-entropy, the AdamW step) live as plain
modules under
``csrc/`` (beside the CUDA sources), outside the package: they import
``triton`` at their top, and this package is imported where there is no
``triton``.  A wrapper
loads its source here when it first launches on a CUDA tensor; Triton
then compiles each kernel at its first launch, into its own cache under
``build/repro_torch/triton/`` at the repository root unless
``TRITON_CACHE_DIR`` names another.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path
from types import ModuleType
from typing import Dict

__all__ = ["load", "CSRC"]

CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
_LOADED: Dict[str, ModuleType] = {}


def load(name: str) -> ModuleType:
    """The module ``csrc/<name>.py`` (imports ``triton``; raises where
    it is missing)."""
    mod = _LOADED.get(name)
    if mod is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD / "triton"))
        path = CSRC / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"repro_torch_triton_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[name] = mod
    return mod
