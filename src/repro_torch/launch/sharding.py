"""Per-architecture sharding rules: spec trees as data, DTensor placements.

Counterpart of :mod:`repro.launch.sharding`.  The spec trees
(:func:`param_specs`, :func:`batch_specs`, :func:`decode_state_specs`,
:func:`opt_state_specs`, :func:`fsdp_specs`) are the reference's,
element for element: the same nesting, the stacked blocks' leading
``None`` included, with a port-owned :class:`P` (a tuple normalized as
``jax.sharding.PartitionSpec`` normalizes its entries) at every leaf.
Axis sizes are read through :func:`~repro_torch.launch.mesh.axis_size`,
so the rules run on a ``DeviceMesh``, the
:class:`~repro_torch.launch.mesh.LocalMesh` and any object with
``mesh_dim_names`` and a ``shape`` tuple.

:func:`placements` is the counterpart of ``NamedSharding``: one
``Shard(dim)`` / ``Replicate()`` per mesh dim.  A tensor dim sharded
over two mesh dims (``fsdp_specs``' ``("pod", "data")``) is ``Shard``
on both, in mesh-dim order: the first is the major one, as in JAX's
layout.  :func:`distribute` places a whole tree (parameters, moments, a
batch, a decode state) with ``distribute_tensor``; the port's trees
keep one tree per block, so a stacked spec's leading ``None`` is dropped
for each block's leaves.  On the ``LocalMesh`` (or ``None``) trees are
returned as they are.

What follows is the reference's account.

Weight sharding is Megatron-style tensor parallelism over the ``model``
axis (column-parallel up-projections, row-parallel down-projections,
expert-sharded MoE, vocab-sharded embeddings) with a **divisibility
fallback**: any dimension the 16-way axis does not divide falls back to
the next candidate (e.g. attention shards heads when ``H % tp == 0``,
else head_dim, else replicates) — so every assigned architecture
compiles on the fixed production mesh without padding its published
hyper-parameters.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

from ..configs.base import ArchConfig
from .mesh import MODEL_AXIS, axis_size, data_axes_of, is_distributed

__all__ = ["P", "param_specs", "batch_specs", "decode_state_specs",
           "opt_state_specs", "fsdp_specs", "head_sharding_choice",
           "usable_data_axes", "placements", "distribute", "spec_map",
           "stacked_shapes"]


def _norm_entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        if len(e) == 1:
            return e[0]
    return e


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names.  As ``jax.sharding.PartitionSpec``,
    an empty tuple entry is ``None`` and a one-name tuple is the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_norm_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def spec_map(fn: Callable, *trees) -> Any:
    """``fn`` over the leaves of spec trees (and trees shaped like them):
    mappings by key, a :class:`P` a leaf."""
    first = trees[0]
    if isinstance(first, P) or not isinstance(first, Mapping):
        return fn(*trees)
    if any(set(t) != set(first) for t in trees[1:]):
        raise ValueError(f"trees differ in keys: {[sorted(t) for t in trees]}")
    return {k: spec_map(fn, *(t[k] for t in trees)) for k in first}


def _tp(mesh) -> int:
    return axis_size(mesh, MODEL_AXIS)


def head_sharding_choice(cfg: ArchConfig, mesh) -> str:
    """heads | head_dim | replicated — the attention fallback chain."""
    tp = _tp(mesh)
    n_heads = cfg.n_heads
    kvh = cfg.n_kv_heads
    if cfg.mla is not None:
        return "heads" if n_heads % tp == 0 else (
            "head_dim" if cfg.mla.v_head_dim % tp == 0 else "replicated")
    if n_heads % tp == 0 and kvh % tp == 0:
        return "heads"
    if cfg.hd % tp == 0:
        return "head_dim"
    return "replicated"


def _col(tp: int, dim: int) -> P:
    """Column-parallel (shard the output dim) when divisible."""
    return P(None, MODEL_AXIS) if dim % tp == 0 else P(None, None)


def _row(tp: int, dim: int) -> P:
    return P(MODEL_AXIS, None) if dim % tp == 0 else P(None, None)


def _stack(tree):
    return spec_map(lambda s: P(*((None,) + tuple(s))), tree)


def param_specs(cfg: ArchConfig, mesh) -> Any:
    """Spec tree matching the reference's ``transformer.init_params``
    (blocks stacked: a leading ``None``)."""
    tp = _tp(mesh)
    d, hd = cfg.d_model, cfg.hd

    def _norm():
        return ({"w": P(None), "b": P(None)} if cfg.norm == "layernorm"
                else {"w": P(None)})

    def _mlp_spec(f):
        sp = {"wi": _col(tp, f), "wo": _row(tp, f)}
        if cfg.act == "swiglu":
            sp["wg"] = _col(tp, f)
        return sp

    def _ffn_keys(i):
        if cfg.family == "ssm":
            return set()
        if cfg.moe is not None and i % max(cfg.moe.moe_stride, 1) == 0:
            return {f"moe{i}"}
        return {f"mlp{i}"}

    def block_specs() -> Dict[str, Any]:
        bs: Dict[str, Any] = {}
        for i, ch in enumerate(cfg.block_pattern):
            bs[f"norm{i}"] = _norm()
            if ch == "A":
                if cfg.mla is not None:
                    m = cfg.mla
                    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
                    bs[f"attn{i}"] = {
                        "wq_a": P(None, None),
                        "wq_b": _col(tp, cfg.n_heads * qk),
                        "wkv_a": P(None, None),
                        "wkv_b": _col(tp, cfg.n_heads
                                      * (m.qk_nope_head_dim
                                         + m.v_head_dim)),
                        "wo": _row(tp, cfg.n_heads * m.v_head_dim),
                        "q_norm": P(None),
                        "kv_norm": P(None),
                    }
                else:
                    bs[f"attn{i}"] = {
                        "wq": _col(tp, cfg.n_heads * hd),
                        "wk": _col(tp, cfg.n_kv_heads * hd),
                        "wv": _col(tp, cfg.n_kv_heads * hd),
                        "wo": _row(tp, cfg.n_heads * hd),
                    }
                if cfg.encoder_layers:
                    bs[f"xnorm{i}"] = _norm()
                    bs[f"xattn{i}"] = dict(bs[f"attn{i}"])
            else:
                s = cfg.ssm
                d_in = s.expand * d
                nh = d_in // s.head_dim
                proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                bs[f"ssm{i}"] = {
                    "in_proj": _col(tp, proj_out),
                    "conv_w": P(None, MODEL_AXIS)
                    if conv_dim % tp == 0 else P(None, None),
                    "conv_b": P(None),
                    "A_log": P(None), "D": P(None), "dt_bias": P(None),
                    "norm_w": P(None),
                    "out_proj": _row(tp, d_in),
                }
            keys = _ffn_keys(i)
            if keys:
                bs[f"fnorm{i}"] = _norm()
                if keys == {f"moe{i}"}:
                    m = cfg.moe
                    espec = P(MODEL_AXIS, None, None) \
                        if m.n_experts % tp == 0 else P(None, None, None)
                    moe_spec: Dict[str, Any] = {
                        "router": P(None, None),
                        "wi": espec, "wg": espec, "wo": espec,
                    }
                    if m.n_shared_experts:
                        moe_spec["shared"] = _mlp_spec(
                            (m.shared_d_ff or m.d_ff) * m.n_shared_experts)
                    bs[f"moe{i}"] = moe_spec
                else:
                    bs[f"mlp{i}"] = _mlp_spec(cfg.d_ff)
        return bs

    # embeddings: vocab-sharded when divisible, else d_model, else full
    if cfg.vocab % tp == 0:
        embed = P(MODEL_AXIS, None)
    elif d % tp == 0:
        embed = P(None, MODEL_AXIS)
    else:
        embed = P(None, None)

    specs: Dict[str, Any] = {
        "embed": embed,
        "final_norm": _norm(),
        # stacked block params get a leading None for the scan dim
        "blocks": _stack(block_specs()),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = _col(tp, cfg.vocab)
    if cfg.encoder_layers:
        enc = {
            "norm0": _norm(),
            "attn0": {"wq": _col(tp, cfg.n_heads * hd),
                      "wk": _col(tp, cfg.n_kv_heads * hd),
                      "wv": _col(tp, cfg.n_kv_heads * hd),
                      "wo": _row(tp, cfg.n_heads * hd)},
            "fnorm0": _norm(),
            "mlp0": _mlp_spec(cfg.d_ff),
        }
        specs["enc_blocks"] = _stack(enc)
        specs["enc_norm"] = _norm()
    if cfg.vision_tokens:
        specs["vis_proj"] = P(None, None)
    if cfg.mtp:
        specs["mtp"] = {"norm": _norm(), "proj": P(None, None)}
    return specs


def _prod(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def usable_data_axes(mesh, batch: Optional[int]) -> Tuple[str, ...]:
    """Data axes whose product divides the batch (else drop axes from the
    left: long_500k's single request replicates over the batch axes)."""
    dp = data_axes_of(mesh)
    if batch is None:
        return dp
    while dp and batch % _prod(mesh, dp):
        dp = dp[1:]
    return dp


def batch_specs(cfg: ArchConfig, mesh,
                batch: Optional[int] = None) -> Dict[str, P]:
    dp = usable_data_axes(mesh, batch)
    out = {"tokens": P(dp, None)}
    if cfg.encoder_layers:
        out["frames"] = P(dp, None, None)
    if cfg.vision_tokens:
        out["patches"] = P(dp, None, None)
    return out


def decode_state_specs(cfg: ArchConfig, mesh,
                       batch: Optional[int] = None) -> Dict[str, Any]:
    """Specs for the reference's ``init_decode_state`` pytrees (caches
    stacked over blocks: a leading ``None``)."""
    dp = usable_data_axes(mesh, batch)
    tp = _tp(mesh)
    choice = head_sharding_choice(cfg, mesh)
    if cfg.mla is not None:
        attn_spec = {"c_kv": P(None, dp, None, None),
                     "k_rope": P(None, dp, None, None, None)}
    elif choice == "heads":
        attn_spec = {"k": P(None, dp, None, MODEL_AXIS, None),
                     "v": P(None, dp, None, MODEL_AXIS, None)}
    elif choice == "head_dim":
        attn_spec = {"k": P(None, dp, None, None, MODEL_AXIS),
                     "v": P(None, dp, None, None, MODEL_AXIS)}
    else:
        attn_spec = {"k": P(None, dp, None, None, None),
                     "v": P(None, dp, None, None, None)}
    caches: Dict[str, Any] = {}
    for i, ch in enumerate(cfg.block_pattern):
        if ch == "A":
            caches[f"attn{i}"] = attn_spec
        else:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            nh = d_in // s.head_dim
            caches[f"ssm{i}"] = {
                "h": P(None, dp, MODEL_AXIS if nh % tp == 0 else None,
                       None, None),
                "conv": P(None, dp, None, None),
            }
    out = {"caches": caches, "pos": P()}
    if cfg.encoder_layers:
        out["enc"] = P(dp, None, None)
    return out


def opt_state_specs(pspecs: Any) -> Dict[str, Any]:
    """AdamW state mirrors the parameter sharding."""
    return {"m": pspecs, "v": pspecs, "step": P()}


def stacked_shapes(params: Any) -> Any:
    """The reference's tree of leaf shapes for a port parameter tree
    (mappings, the port's ``ParamTree``; each tensor's ``shape``): the
    per-block trees of ``blocks`` / ``enc_blocks`` stacked, a leading
    block count on every leaf.  A tree already stacked (a mapping under
    ``blocks``) is read as it is."""
    from torch import nn

    def walk(node):
        if hasattr(node, "keys") and not hasattr(node, "shape"):
            return {k: walk(node[k]) for k in node.keys()}
        return tuple(node.shape)

    out = {}
    for k in params.keys():
        v = params[k]
        if isinstance(v, (list, tuple, nn.ModuleList)):
            per = [walk(b) for b in v]
            out[k] = spec_map(lambda *shapes: (len(shapes),) + shapes[0],
                              *per) if per else {}
        else:
            out[k] = walk(v)
    return out


def fsdp_specs(specs: Any, abstract_params: Any, mesh) -> Any:
    """§Perf knob (ZeRO-3-style): additionally shard each parameter's
    largest still-replicated dimension over the data axis.
    ``abstract_params`` is a port parameter tree (meta tensors from
    :func:`~repro_torch.launch.steps.abstract_params`, or real ones); its
    shapes are read stacked, as the reference's are."""
    daxes = data_axes_of(mesh)
    if not daxes:
        return specs
    dsize = _prod(mesh, daxes)
    shapes = stacked_shapes(abstract_params)

    def up(spec, dims):
        if len(dims) < 2:
            return spec
        full = tuple(spec) + (None,) * (len(dims) - len(spec))
        best = None
        for i, ax in enumerate(full):
            if ax is None and dims[i] % dsize == 0:
                if best is None or dims[i] > dims[best]:
                    best = i
        if best is None:
            return spec
        new = list(full)
        new[best] = daxes if len(daxes) > 1 else daxes[0]
        return P(*new)

    return spec_map(up, specs, shapes)


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def placements(mesh, spec) -> tuple:
    """``spec`` (a :class:`P`, or any sequence of entries) as one
    ``Shard(dim)`` / ``Replicate()`` per dim of ``mesh``: a mesh dim named
    at tensor dim ``d`` is ``Shard(d)``, a mesh dim not named anywhere is
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(P(*spec)):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax not in names:
                raise ValueError(f"spec {spec} names {ax!r}, not an axis "
                                 f"of the mesh {names}")
            if ax in seen:
                raise ValueError(f"spec {spec} names {ax!r} twice")
            seen.add(ax)
            out[names.index(ax)] = Shard(d)
    return tuple(out)


def _distribute_leaf(mesh, t, spec):
    from torch.distributed.tensor import DTensor, distribute_tensor
    if t is None or not hasattr(t, "shape"):
        return t
    if isinstance(t, DTensor):
        return t
    # every rank holds the same full tensor (from one seed): each keeps
    # its own slice, nothing is sent
    return distribute_tensor(t.detach() if t.requires_grad else t, mesh,
                             placements(mesh, spec), src_data_rank=None)


def distribute(mesh, tree: Any, specs: Any) -> Any:
    """``tree`` (a port parameter tree, optimizer state, batch or decode
    state) with each tensor leaf a DTensor placed by ``specs`` (the
    matching spec tree) over ``mesh``.  Per-block lists (``blocks``,
    ``enc_blocks``, the decode state's ``caches``) take the stacked
    spec's entries after its leading block dim (which ``fsdp_specs`` may
    shard over the data axes: each block's leaf then stays replicated
    over them); host values (the decode position) stay as they are.  On
    the ``LocalMesh`` or ``None`` the tree comes back as it is."""
    if not is_distributed(mesh):
        return tree
    from torch import nn
    from ..models.transformer import ParamTree

    def unstack(spec):
        # a block dim sharded over the data axes (fsdp_specs on a leaf
        # whose only divisible free dim is the layer count, e.g. mamba2's
        # conv_w) leaves each block's leaf replicated over them
        return P(*tuple(spec)[1:])

    def walk(node, spec):
        if isinstance(node, ParamTree):
            out = ParamTree({k: walk(node[k], spec[k]) for k in node.keys()})
            out.compute_dtype = node.compute_dtype
            return out
        if isinstance(node, (list, tuple, nn.ModuleList)):
            per = spec_map(unstack, spec)
            return [walk(b, per) for b in node]
        if isinstance(node, Mapping):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return _distribute_leaf(mesh, node, spec)

    return walk(tree, specs)
