"""Nested containers of tensors, walked as ``jax.tree_util`` walks a
pytree: mappings by sorted key, lists and tuples by index, a
:class:`~repro_torch.models.transformer.ParamTree` as its mapping, any
other value a leaf.  The optimizer and the checkpoints flatten trees
this way, so the two agree on leaf order and on each leaf's path."""

from __future__ import annotations

from typing import Any, Callable, List, Mapping, Tuple

from torch import nn

__all__ = ["flatten_with_paths", "leaves", "map_tree", "unflatten"]


def _node(tree) -> Tuple[str, list, list]:
    """``(kind, keys, children)``; kind ``"leaf"`` for a leaf."""
    from .models.transformer import ParamTree
    if isinstance(tree, ParamTree):
        keys = sorted(tree.keys())
        return "param_tree", keys, [tree[k] for k in keys]
    if isinstance(tree, Mapping):
        keys = sorted(tree)
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, (list, tuple, nn.ModuleList)):
        return "tuple" if isinstance(tree, tuple) else "list", \
            list(range(len(tree))), list(tree)
    return "leaf", [], []


def _build(kind: str, keys: list, children: list):
    from .models.transformer import ParamTree
    if kind == "param_tree":
        return ParamTree(dict(zip(keys, children)))
    if kind == "dict":
        return dict(zip(keys, children))
    return tuple(children) if kind == "tuple" else list(children)


def flatten_with_paths(tree) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` in order, a path the keys joined by ``/``."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        kind, keys, children = _node(node)
        if kind == "leaf":
            out.append(("/".join(prefix), node))
            return
        for k, c in zip(keys, children):
            walk(c, prefix + [str(k)])

    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with ``new_leaves`` in leaf order."""
    it = iter(new_leaves)
    end = object()

    def walk(node):
        kind, keys, children = _node(node)
        if kind == "leaf":
            return next(it)
        return _build(kind, keys, [walk(c) for c in children])

    out = walk(template)
    if next(it, end) is not end:
        raise ValueError("more leaves than the template holds")
    return out


def map_tree(fn: Callable, tree) -> Any:
    """``tree``'s structure with ``fn(leaf)`` at every leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])
