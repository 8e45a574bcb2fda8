"""Mesh construction.

Counterpart of :mod:`repro.launch.mesh`.  A mesh is a ``torch.distributed``
``DeviceMesh`` when a process group is up (each process one member, its
axes named as the reference's); on one process with every axis of size
1 and no process group, as the launchers run, it is a :class:`LocalMesh`
with the same interface and no groups.  A function, not a module
constant: importing this module touches no device or process-group
state.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

__all__ = ["make_production_mesh", "make_mesh", "data_axes_of",
           "MODEL_AXIS", "LocalMesh", "is_mesh", "axis_size", "axis_group"]

MODEL_AXIS = "model"


class LocalMesh:
    """A one-process mesh: every axis of size 1, no process group.  It
    answers what the port reads of a ``DeviceMesh``: ``mesh_dim_names``,
    ``shape``, ``size()`` and ``get_group`` (``None``)."""

    def __init__(self, shape: Tuple[int, ...],
                 axes: Tuple[str, ...]) -> None:
        self.shape = tuple(shape)
        self.mesh_dim_names = tuple(axes)

    def size(self, mesh_dim: Optional[int] = None) -> int:
        return 1

    def get_group(self, mesh_dim: Any = None) -> None:
        return None


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the process group's ranks
    (CUDA under NCCL, else the CPU), or the :class:`LocalMesh` when no
    group is up and every axis is 1."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device, shape, mesh_dim_names=axes)
    if all(s == 1 for s in shape):
        return LocalMesh(shape, axes)
    raise RuntimeError(f"a {shape} mesh needs a torch.distributed process "
                       f"group (init_process_group) of that many ranks")


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 (or 2x16x16) pod mesh: not ported yet."""
    raise NotImplementedError(
        "the production mesh needs launch/sharding and H100 constants "
        "for the planner, which are not ported yet (ROADMAP §1)")


def is_mesh(mesh: Any) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, (LocalMesh, DeviceMesh))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def axis_group(mesh, axis: str):
    """The process group along ``axis``, ``None`` where the axis has one
    member (nothing to reduce over)."""
    if axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


def data_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != MODEL_AXIS)
