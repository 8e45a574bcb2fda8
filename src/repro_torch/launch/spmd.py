"""Local regions over a distributed mesh: what ``shard_map`` does, on
DTensors.

The steps (:mod:`.steps`) place parameters, moments, batches and decode
states as DTensors over a mesh of more than one member
(:func:`.sharding.distribute`); the matrix products, norms and residual
adds between sublayers then run as DTensor operations.  A sublayer whose
body DTensor cannot follow (RoPE tables, the SSD split, the capacity
packing of MoE) or that calls a hand kernel runs as a *local region*:
its DTensor inputs are redistributed to stated placements and taken to
their local shards, the body runs on plain tensors of this rank (the
kernels included: on CUDA they launch, on the CPU their plain versions
run), and its outputs come back as DTensors with stated placements.
Gradients cross the boundary with stated placements too
(``to_local(grad_placements=...)``), as ``shard_map``'s transpose.

Where no input is a DTensor (one device, the launchers' ``LocalMesh``)
a region calls its body on its arguments as they are: the single-device
paths are unchanged.

:func:`with_axes` builds a region's placements: one ``Placement`` per
mesh dim, from an activation's own placements (its batch sharding over
the data axes) with the model axis set.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence

from .mesh import MODEL_AXIS

__all__ = ["is_dtensor", "any_dtensor", "local_region", "with_axes",
           "grad_over_data", "gather_over_data"]


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def any_dtensor(tree: Any) -> bool:
    if is_dtensor(tree):
        return True
    if isinstance(tree, Mapping) or (hasattr(tree, "keys")
                                     and not hasattr(tree, "shape")):
        return any(any_dtensor(tree[k]) for k in tree.keys())
    if isinstance(tree, (list, tuple)):
        return any(any_dtensor(v) for v in tree)
    return False


def with_axes(mesh, base: Sequence, model=None, data=None) -> tuple:
    """Placements for ``mesh``: ``base``'s (a DTensor's placements) on
    every dim but the model axis, which gets ``model`` (a ``Placement``;
    ``None``: ``Replicate()``).  ``data`` (a ``Placement``) replaces
    every other dim's placement instead, when given."""
    from torch.distributed.tensor import Replicate
    out = []
    for i, name in enumerate(mesh.mesh_dim_names):
        if name == MODEL_AXIS:
            out.append(Replicate() if model is None else model)
        elif data is not None:
            out.append(data)
        else:
            out.append(base[i])
    return tuple(out)


def grad_over_data(mesh, weight_pl: Sequence, act_pl: Sequence) -> tuple:
    """A weight's gradient placements out of a region: ``Partial`` on the
    data dims over which the activation (``act_pl``) is sharded (each
    rank's batch rows give a partial sum), ``weight_pl`` on the others
    and on the model axis."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if name != MODEL_AXIS and a.is_shard() else w
                 for name, w, a in zip(mesh.mesh_dim_names, weight_pl,
                                       act_pl))


def _walk(fn, tree, pl, gpl):
    """``fn(tensor, placements, grad placements)`` over a tensor or a
    mapping of them (placements matching, or one for all)."""
    if hasattr(tree, "shape"):
        return fn(tree, pl, gpl)
    if isinstance(tree, Mapping) or hasattr(tree, "keys"):
        return {k: _walk(fn, tree[k],
                         pl[k] if isinstance(pl, Mapping) else pl,
                         gpl[k] if isinstance(gpl, Mapping) else gpl)
                for k in tree.keys()}
    return tree


def local_region(fn: Callable, mesh, args: Sequence, in_placements: Sequence,
                 out_placements: Any,
                 in_grad_placements: Optional[Sequence] = None) -> Any:
    """``fn(*local args)`` with DTensor arguments taken to their local
    shards under ``in_placements`` (one entry per argument: a placements
    tuple, or a mapping of them for a mapping of tensors, or ``None`` for
    a non-tensor), and the outputs (a tensor, or a tuple of tensors and
    non-tensors) made DTensors with ``out_placements`` (matching; ``None``
    leaves an output as it is).  ``in_grad_placements`` (matching
    ``in_placements``, default: the same) are the placements of the
    gradients that leave the region for each input.  With no DTensor
    among ``args`` it returns ``fn(*args)``."""
    if not any(any_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor
    if in_grad_placements is None:
        in_grad_placements = in_placements

    def to_local(t, pl, gpl):
        if not isinstance(t, DTensor):
            return t
        if pl is None:
            raise ValueError("a DTensor entered a region with no placements")
        if tuple(t.placements) != tuple(pl):
            t = t.redistribute(mesh, pl)
        return t.to_local(grad_placements=gpl)

    local = [_walk(to_local, a, pl, gpl) for a, pl, gpl in
             zip(args, in_placements, in_grad_placements)]
    out = fn(*local)

    def wrap(o, pl):
        if pl is None or not hasattr(o, "shape"):
            return o
        return DTensor.from_local(o, mesh, pl, run_check=False)

    if isinstance(out, tuple):
        return tuple(_walk(lambda t, pl, _: wrap(t, pl), o, p, None)
                     for o, p in zip(out, out_placements))
    return wrap(out, out_placements)


def gather_over_data(tree: Any) -> Any:
    """``tree`` (a parameter tree or one tensor) with every DTensor leaf
    sharded over a data axis (``fsdp_params``) gathered over it: the
    per-use all-gather of ZeRO-3, whose backward reduce-scatters the
    gradient.  The model axis keeps its placement; other leaves are
    returned as they are, and so is a tree with none to gather."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(t):
        if not isinstance(t, DTensor):
            return t
        names = t.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if names[i] != MODEL_AXIS and p.is_shard()
                   else p for i, p in enumerate(t.placements))
        return t if pl == tuple(t.placements) else t.redistribute(
            t.device_mesh, pl)

    if hasattr(tree, "shape"):
        return one(tree)
    if hasattr(tree, "map"):
        return tree.map(one)
    return tree
