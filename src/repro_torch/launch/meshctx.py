"""Ambient mesh context.

The model layer is mesh-agnostic; the launcher activates a mesh context
so layers that have a distributed implementation (MoE expert parallelism)
can pick it up without threading mesh objects through every call.

Counterpart of :mod:`repro.launch.meshctx`.  The context holds a
``torch.distributed`` ``DeviceMesh`` (or any object standing for one);
on one card it is ``None``, and the layers take their single-device
paths.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Tuple

__all__ = ["MeshCtx", "set_mesh", "current", "use_mesh"]


class MeshCtx:
    def __init__(self, mesh: Any, data_axes: Tuple[str, ...],
                 model_axis: str = "model") -> None:
        self.mesh = mesh
        self.data_axes = data_axes
        self.model_axis = model_axis


_CURRENT: Optional[MeshCtx] = None


def set_mesh(mesh: Optional[Any],
             data_axes: Tuple[str, ...] = ("data",),
             model_axis: str = "model") -> None:
    global _CURRENT
    _CURRENT = None if mesh is None else MeshCtx(mesh, data_axes,
                                                 model_axis)


def current() -> Optional[MeshCtx]:
    return _CURRENT


@contextlib.contextmanager
def use_mesh(mesh: Optional[Any], data_axes: Tuple[str, ...] = ("data",),
             model_axis: str = "model"):
    global _CURRENT
    prev = _CURRENT
    set_mesh(mesh, data_axes, model_axis)
    try:
        yield
    finally:
        _CURRENT = prev
