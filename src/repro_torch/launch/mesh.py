"""Mesh construction.

Counterpart of :mod:`repro.launch.mesh`.  A mesh is a ``torch.distributed``
``DeviceMesh`` when a process group is up (each process one member, its
axes named as the reference's); on one process with every axis of size
1 and no process group, as the launchers run, it is a :class:`LocalMesh`
with the same interface and no groups.  :func:`make_production_mesh`
builds the reference's pod meshes over a process group of 256 or 512
ranks.  Functions, not module constants: importing this module touches
no device or process-group state.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

__all__ = ["make_production_mesh", "make_mesh", "data_axes_of",
           "MODEL_AXIS", "LocalMesh", "is_mesh", "axis_size", "axis_group",
           "is_distributed"]

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
        # the fake backend (the dry run) and gloo hold CPU tensors
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return init_device_mesh(device, shape, mesh_dim_names=axes)
    if all(s == 1 for s in shape):
        return LocalMesh(shape, axes)
    raise RuntimeError(f"a {shape} mesh needs a torch.distributed process "
                       f"group (init_process_group) of that many ranks")


_PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                      True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single-pod (256 members) or 2x16x16 two-pod (512): a
    ``DeviceMesh`` over the process group, which must have exactly that
    many ranks: NCCL across the GPUs, or the single-process ``"fake"``
    backend (``torch.testing._internal.distributed.fake_pg.FakeStore``)
    that the dry run uses.  Anything else raises, naming the ranks the
    mesh needs: there is no fallback to a smaller mesh.

    Batch shards over ("pod", "data"); weights/experts/vocab over
    "model".  The dry run (:mod:`.dryrun`) costs every (architecture x
    input shape) on both."""
    shape, axes = _PRODUCTION_SHAPES[bool(multi_pod)]
    need = 1
    for s in shape:
        need *= s
    import torch.distributed as dist
    have = (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else None)
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} {axes} needs a torch.distributed "
            f"process group of exactly {need} ranks (NCCL across {need} "
            f"GPUs, or the 'fake' backend for the dry run); this process "
            f"has " + ("none" if have is None else f"one of {have}"))
    return make_mesh(shape, axes)


def is_mesh(mesh: Any) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, (LocalMesh, DeviceMesh))


def is_distributed(mesh: Any) -> bool:
    """True for a ``DeviceMesh`` of more than one member: the steps
    distribute their trees over it (DTensor).  ``None``, the
    :class:`LocalMesh` and a one-member ``DeviceMesh`` leave every
    tensor as it is."""
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(mesh, DeviceMesh) and mesh.size() > 1


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
