"""Expert-parallel MoE on tensors: capacity packing, a sort by expert and
the grouped expert GEMM.

Counterpart of :mod:`repro.models.moe_ep` (``shard_map`` +
``lax.ragged_dot``).  The dense one-hot dispatch in :mod:`.layers`
applies every expert to every token and materializes ``(B, S, E, f)``;
this is the path every MoE model takes under a mesh context, as the
launchers run:

* Activations enter **replicated over the model group** (standard TP).
  Every model rank computes the identical router decision, then handles
  only the (token, choice) pairs routed to *its* expert shard; the one
  collective is an all-reduce of the output over the model group.
* Per rank: local choices are packed into a fixed ``capacity`` buffer
  (scatter with drop semantics: capacity-factor token dropping),
  **sorted by local expert id** (a stable sort), and run through
  :func:`~repro_torch.kernels.grouped_gemm.ragged_dot` (the grouped
  GEMM kernel on CUDA, three launches a forward); results scatter back
  through the inverse permutation and combine with the router gates.
* No host sync: capacity comes from shapes, and the group sizes, slots
  and permutations stay on the device (a decode step can be captured).

Autograd matches ``shard_map``'s transpose.  The expert dispatch is a
model-parallel region: its replicated inputs (the tokens and the gates)
enter through an identity whose backward all-reduces their gradient over
the model group (Megatron's "f"), and its output leaves through an
all-reduce whose backward is the identity ("g").  So every replicated
gradient (x, the router, the shared expert) comes out whole and equal on
every model rank, and each rank's expert slice gets its own experts'.
(``torch.distributed.nn.functional.all_reduce`` in the forward would
all-reduce the output's gradient too: tp times the expert gradients.)
The aux loss is averaged over the data groups with an identity backward,
as ``lax.psum`` of an unvarying value transposes there.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.grouped_gemm import ragged_dot
from ..launch import mesh as M
from . import layers as L
from .analysis_flags import FLAGS as _AFLAGS

__all__ = ["moe_ep_apply_local", "moe_ep_apply", "EP_AXIS"]

Params = Dict[str, Any]

EP_AXIS = "model"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class _EnterModelRegion(torch.autograd.Function):
    """Identity; the backward all-reduces the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduceIdentityGrad(torch.autograd.Function):
    """All-reduce (sum) over ``group``; the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def moe_ep_apply_local(cfg: ArchConfig, p: Params, x: torch.Tensor,
                       group=None, data_groups: Sequence[Any] = ()
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-rank body.

    ``x`` (B_loc, S, d) is replicated over the model ``group`` (``None``:
    one rank); ``p['wi'|'wg'|'wo']`` are this rank's expert shards
    (E_loc, ...), the router and the shared expert are replicated.
    ``data_groups``: the process groups of the data axes the aux loss is
    averaged over.  Returns (output already all-reduced over the model
    group, aux loss).
    """
    m = cfg.moe
    tp = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    e_loc = p["wi"].shape[0]
    b, s, d = x.shape
    t = b * s
    k = m.experts_per_tok
    dev = x.device
    xf = x.reshape(t, d)

    logits = (xf @ p["router"]).to(torch.float32)          # (T, E)
    if m.router_score == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    vals, idx = torch.topk(scores, k, dim=-1)               # (T, k)
    gates = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)

    # ---- pack this rank's (token, choice) hits into a capacity buffer ----
    flat_e = idx.reshape(-1)                                # (T*k,)
    flat_g = gates.reshape(-1).to(x.dtype)
    xr = xf
    if tp > 1:
        xr = _EnterModelRegion.apply(xf, group)
        flat_g = _EnterModelRegion.apply(flat_g, group)
    mine = torch.div(flat_e, e_loc, rounding_mode="floor") == rank
    eloc = flat_e % e_loc
    cap = _round_up(max(int(m.capacity_factor * t * k / tp), 8), 8)
    pos = torch.cumsum(mine.to(torch.int32), 0) - 1         # slot per hit
    slot = torch.where(mine & (pos < cap), pos,
                       torch.full_like(pos, cap)).long()    # cap == drop
    # xf[tok] with tok = hit // k: each token's row k times (its backward
    # sums over the k copies, no scatter)
    x_hits = xr[:, None, :].expand(t, k, d).reshape(t * k, d)
    # the drop-mode scatters: into cap + 1 rows, the last (the dropped
    # hits') then cut
    buf = torch.zeros((cap + 1, d), dtype=x.dtype, device=dev).index_copy(
        0, slot, x_hits)[:cap]
    buf_e = torch.full((cap + 1,), e_loc, dtype=torch.long,
                       device=dev).index_copy(0, slot, eloc)[:cap]

    # ---- sort by local expert, ragged segment matmuls --------------------
    order = torch.argsort(buf_e, stable=True)
    xs = buf.index_select(0, order)
    if _AFLAGS["balanced_moe"]:
        # cost-probe path: a balanced equal-capacity batched matmul (the
        # reference's roofline probe; models/analysis_flags.py)
        cpe = max(cap // e_loc, 1)
        rows = cpe * e_loc
        xs_p = (F.pad(xs, (0, 0, 0, rows - cap)) if rows > cap
                else xs[:rows])
        xb = xs_p.reshape(e_loc, cpe, d)
        h = F.silu(torch.einsum("ecd,edf->ecf", xb, p["wg"])) \
            * torch.einsum("ecd,edf->ecf", xb, p["wi"])
        y = torch.einsum("ecf,efd->ecd", h, p["wo"]).reshape(-1, d)
        y = (y[:cap] if rows > cap
             else F.pad(y, (0, 0, 0, cap - y.shape[0])))
    else:
        # bincount on the device (torch.bincount reads its maximum back)
        gs = torch.zeros(e_loc + 1, dtype=torch.long, device=dev) \
            .index_add_(0, buf_e, torch.ones_like(buf_e))[:e_loc] \
            .to(torch.int32)
        h = F.silu(ragged_dot(xs, p["wg"], gs)) * ragged_dot(xs, p["wi"], gs)
        y = ragged_dot(h, p["wo"], gs)                      # (cap, d)
    # the inverse permutation
    y_unsorted = torch.zeros_like(y).index_copy(0, order, y)

    # ---- combine: gate-weighted sum back to tokens -----------------------
    contrib = torch.where((slot < cap)[:, None],
                          y_unsorted.index_select(
                              0, torch.clamp(slot, max=cap - 1)),
                          torch.zeros((), dtype=y.dtype, device=dev))
    # the reference's scatter-add over tok = hit // k, in x's dtype: the k
    # choices of a token are adjacent rows
    out = (contrib * flat_g[:, None]).reshape(t, k, d).sum(1)
    if tp > 1:
        out = _AllReduceIdentityGrad.apply(out, group)

    # shared expert(s): replicated compute, outside the all-reduce
    if "shared" in p:
        out = out + L.mlp_apply(cfg, p["shared"], xf)

    # aux load-balance loss: identical on model ranks, averaged over the
    # data groups where it varies
    me = torch.mean(F.one_hot(idx[..., 0], m.n_experts).to(torch.float32),
                    dim=0)
    pe = torch.mean(torch.softmax(logits, -1), dim=0)
    aux = m.n_experts * torch.sum(me * pe)
    n_data = 1
    for g in data_groups:
        aux = _AllReduceIdentityGrad.apply(aux, g)
        n_data *= dist.get_world_size(g)
    if n_data > 1:
        aux = aux / n_data
    return out.reshape(b, s, d), aux


def moe_ep_apply(cfg: ArchConfig, p: Params, x: torch.Tensor,
                 ctx) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` under a mesh context ``ctx`` (:mod:`..launch.meshctx`):
    this rank's expert slice ``[rank * E_loc, (rank + 1) * E_loc)`` of the
    global weights, taken as views (gradients land in the global
    tensors), through :func:`moe_ep_apply_local` over the mesh's model
    group, the aux loss averaged over its data axes."""
    mesh = ctx.mesh
    if not M.is_mesh(mesh):
        raise TypeError(f"the mesh context holds {type(mesh).__name__}, not "
                        f"a mesh (launch.mesh.make_mesh)")
    group = M.axis_group(mesh, ctx.model_axis)
    data_groups = [M.axis_group(mesh, a) for a in ctx.data_axes
                   if M.axis_size(mesh, a) > 1]
    if group is not None:
        tp = dist.get_world_size(group)
        rank = dist.get_rank(group)
        e = p["wi"].shape[0]
        if e % tp:
            raise ValueError(f"{e} experts do not split over {tp} model "
                             f"ranks")
        lo, hi = rank * (e // tp), (rank + 1) * (e // tp)
        local: Params = {"router": p["router"], "wi": p["wi"][lo:hi],
                         "wg": p["wg"][lo:hi], "wo": p["wo"][lo:hi]}
        if "shared" in p:
            local["shared"] = p["shared"]
        p = local
    return moe_ep_apply_local(cfg, p, x, group=group,
                              data_groups=data_groups)
