"""Train / prefill / decode steps, on one device or over a mesh.

Counterpart of :mod:`repro.launch.steps`.  The reference returns jitted
steps with in/out shardings; here each step is a plain callable (no
``torch.compile``).  With ``mesh=None``, the launchers'
:class:`~repro_torch.launch.mesh.LocalMesh` or a one-member mesh, the
tensors are used as they are, on one device.  Over a ``DeviceMesh`` of
more than one member each step places its inputs as DTensors by the
spec trees of :mod:`.sharding` (the parameters by ``param_specs``, under
the ``fsdp_params`` knob by ``fsdp_specs``; the moments by
``opt_state_specs``; the batch by ``batch_specs``; the decode state by
``decode_state_specs``): inputs already placed pass through, so a loop
feeds each step's outputs to the next.  Sublayers and hand kernels then
run as local regions (:mod:`.spmd`), and the optimizer step takes one
global gradient norm over every rank's shards.  Each step carries its
spec trees as ``step.specs``.

The abstract trees (:func:`abstract_params`, :func:`abstract_opt_state`,
:func:`abstract_state`) are the port's trees of ``meta`` tensors, one
tree per block; stacked, their shapes and dtypes are the reference's
``jax.eval_shape`` (the decode position is a host int here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple, Union

import torch

from .. import tree as tree_util
from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from ..models import model_zoo, transformer as T
from ..optim import AdamWConfig, adamw_init, adamw_update, cosine_warmup
from . import sharding, tuning
from .mesh import is_distributed
from .sharding import usable_data_axes

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "abstract_params", "abstract_opt_state", "abstract_state"]


def _meta(tree: Any) -> Any:
    """``tree`` with every tensor a ``meta`` tensor of its shape and
    dtype (mappings, lists and parameter trees kept)."""
    from torch import nn

    def walk(node):
        if isinstance(node, T.ParamTree):
            out = T.ParamTree({k: walk(node[k]) for k in node.keys()})
            out.compute_dtype = node.compute_dtype
            return out
        if isinstance(node, (list, tuple, nn.ModuleList)):
            return [walk(v) for v in node]
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor):
            return torch.empty(node.shape, dtype=node.dtype, device="meta")
        return node

    return walk(tree)


def _fake_cpu(build: Callable) -> Any:
    """``build()`` run under ``FakeTensorMode`` (nothing allocated), its
    tensors returned as ``meta`` tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        tree = build()
    return _meta(tree)


def abstract_params(cfg: ArchConfig) -> T.ParamTree:
    """The parameter tree on the ``meta`` device (no allocation).

    Under the ``int8_weights`` tuning knob, float leaves of two dims or
    more *as the reference stacks them* become INT8 storage (so a
    block's 1-D norm scales, 2-D stacked there, do too; dequantized at
    use by ``transformer.cast_params``)."""
    tree = _fake_cpu(lambda: T.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    if tuning.FLAGS["int8_weights"]:
        def q(t, stacked):
            if t.dim() + stacked >= 2 and t.is_floating_point():
                return torch.empty(t.shape, dtype=torch.int8, device="meta")
            return t
        out = {}
        for k in tree.keys():
            v = tree[k]
            if isinstance(v, torch.nn.ModuleList):
                out[k] = [b.map(lambda t: q(t, True)) for b in v]
            elif isinstance(v, T.ParamTree):
                out[k] = v.map(lambda t: q(t, False))
            else:
                out[k] = q(v, False)
        tree = T.ParamTree(out)
    return tree


def abstract_opt_state(cfg: ArchConfig, adamw: AdamWConfig):
    """AdamW's state for :func:`abstract_params`, on ``meta``."""
    return adamw_init(abstract_params(cfg), adamw)


def abstract_state(cfg: ArchConfig, batch: int, seq: int):
    """The decode state (caches, SSM states, encoder output) on
    ``meta``; its position is the host int 0."""
    def build():
        _, cdtype = T._dt(cfg)
        enc = (torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                           dtype=cdtype)
               if cfg.encoder_layers else None)
        return T.init_decode_state(cfg, None, batch, seq, enc=enc,
                                   device="cpu")
    return _fake_cpu(build)


def _param_specs(cfg: ArchConfig, mesh) -> Any:
    pspecs = sharding.param_specs(cfg, mesh)
    if tuning.FLAGS["fsdp_params"]:
        pspecs = sharding.fsdp_specs(pspecs, abstract_params(cfg), mesh)
    return pspecs


def _out_logits(logits, mesh, dp):
    """The logits in the reference's out_sharding ``P(dp, None)``: rows
    as the batch is sharded, the vocab whole on every model rank."""
    if not is_distributed(mesh):
        return logits
    return logits.redistribute(mesh, sharding.placements(
        mesh, sharding.P(dp, None)))


# ---------------------------------------------------------------------------
# Train
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig,
                    device: Union[str, torch.device, None],
                    shape: ShapeConfig,
                    adamw: AdamWConfig = AdamWConfig(),
                    lr_peak: float = 3e-4, warmup: int = 200,
                    total_steps: int = 10_000, mesh=None
                    ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(step, spec)``: ``step(params, opt, batch, step_i)`` runs the
    loss (:func:`~repro_torch.models.transformer.loss_fn`, remat per
    block), its gradients with respect to the parameters' floating
    leaves, the ``cosine_warmup`` learning rate at ``step_i`` and
    ``adamw_update``, and returns ``(params, opt, metrics)`` with
    ``loss``, ``lr`` and ``grad_norm`` as device tensors: nothing waits
    on the device.  The parameters and moments are updated in place (the
    reference donates them).  ``spec`` gives each batch input's and the
    step's ``(shape, dtype)``.  Over a distributed ``mesh`` the inputs
    are placed by the spec trees (``step.specs``), the loss is reduced
    over the mesh before the backward, and ``metrics`` are plain tensors
    equal on every rank."""
    dev = resolve_device(device)
    dist_mesh = mesh if is_distributed(mesh) else None
    specs = {}
    if dist_mesh is not None:
        pspecs = _param_specs(cfg, mesh)
        specs = {"params": pspecs,
                 "opt": sharding.opt_state_specs(pspecs),
                 "batch": sharding.batch_specs(cfg, mesh,
                                               shape.global_batch)}

    def train_step(params: T.ParamTree, opt, batch, step_i):
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        if dist_mesh is not None:
            params = sharding.distribute(dist_mesh, params, specs["params"])
            opt = sharding.distribute(dist_mesh, opt, specs["opt"])
            batch = sharding.distribute(dist_mesh, batch, specs["batch"])
        params.requires_grad_(True)
        leaves = tree_util.leaves(params)
        loss = T.loss_fn(cfg, params, batch)
        if dist_mesh is not None:
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves)
        if not isinstance(step_i, torch.Tensor):
            step_i = torch.full((), step_i, dtype=torch.int32, device=dev)
        lr = cosine_warmup(step_i, peak=lr_peak, warmup=warmup,
                           total=total_steps)
        params, opt, metrics = adamw_update(
            tree_util.unflatten(params, grads), opt, params, lr, adamw)
        metrics = dict(metrics, loss=loss.detach(), lr=lr)
        return params, opt, metrics

    train_step.specs = specs
    spec = dict(model_zoo.batch_spec(cfg, shape.global_batch,
                                     shape.seq_len),
                step=((), torch.int32))
    return train_step, spec


# ---------------------------------------------------------------------------
# Serve: prefill + decode
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ArchConfig,
                      device: Union[str, torch.device, None],
                      shape: ShapeConfig, mesh=None
                      ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(prefill, spec)``: ``prefill(params, batch)`` is the full-
    sequence prefill lowered to last-token logits, the reference's
    ``make_prefill_step``: one cast of the parameters, the embedding,
    every block under remat (as the reference's ``jax.checkpoint``; with
    no gradient tracked it recomputes nothing), the final norm, and the
    vocabulary projection of the final position only, so the (B, S, V)
    logits never exist.  Returns fp32 (B, vocab); ``spec`` gives each
    batch input's ``(shape, dtype)``.  Over a distributed ``mesh`` the
    inputs are placed by ``step.specs`` and the logits come back
    ``P(dp, None)``."""
    dev = resolve_device(device)
    dist_mesh = mesh if is_distributed(mesh) else None
    specs = {}
    dp = ()
    if dist_mesh is not None:
        specs = {"params": _param_specs(cfg, mesh),
                 "batch": sharding.batch_specs(cfg, mesh,
                                               shape.global_batch)}
        dp = usable_data_axes(mesh, shape.global_batch)

    @torch.no_grad()
    def prefill_step(params: T.ParamTree, batch):
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        if dist_mesh is not None:
            params = sharding.distribute(dist_mesh, params, specs["params"])
            batch = sharding.distribute(dist_mesh, batch, specs["batch"])
        params = T.cast_params(cfg, params)
        x, enc = T._embed_inputs(cfg, params, batch)
        for bp in params["blocks"]:
            x, _ = T._block_apply(cfg, bp, x, enc=enc)
        x = T.L.apply_norm(cfg, params["final_norm"], x)
        head = T._head(cfg, params, x.dtype)
        logits = (x[:, -1:] @ head)[:, 0].to(torch.float32)
        return _out_logits(logits, dist_mesh, dp)

    prefill_step.specs = specs
    spec = model_zoo.batch_spec(cfg, shape.global_batch, shape.seq_len)
    return prefill_step, spec


def make_decode_step(cfg: ArchConfig,
                     device: Union[str, torch.device, None],
                     shape: ShapeConfig, mesh=None
                     ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(decode, spec)``: ``decode(params, state, token)`` runs one new
    token (B, 1) against the pre-allocated ``shape.seq_len`` caches and
    returns ``(logits (B, vocab) fp32, state)``; ``spec`` gives the
    token's ``(shape, dtype)``.  The parameters are cast to the compute
    dtype once per parameter tree, not at every step; decoding tracks no
    gradients.  Over a distributed ``mesh`` the parameters, state and
    token are placed by ``step.specs`` and the logits come back
    ``P(dp, None)``."""
    dev = resolve_device(device)
    dist_mesh = mesh if is_distributed(mesh) else None
    specs = {}
    dp = ()
    if dist_mesh is not None:
        dp = usable_data_axes(mesh, shape.global_batch)
        specs = {"params": _param_specs(cfg, mesh),
                 "state": sharding.decode_state_specs(cfg, mesh,
                                                      shape.global_batch),
                 "token": sharding.P(dp, None)}
    last: Dict[str, T.ParamTree] = {}

    @torch.no_grad()
    def decode(params: T.ParamTree, state, token: torch.Tensor):
        token = token.to(dev)
        if last.get("src") is not params:
            last["src"] = params
            if dist_mesh is not None:
                params = sharding.distribute(dist_mesh, params,
                                             specs["params"])
            last["cast"] = T.cast_params(cfg, params)
        if dist_mesh is not None:
            state = sharding.distribute(dist_mesh, state, specs["state"])
            token = sharding.distribute(dist_mesh, {"t": token},
                                        {"t": specs["token"]})["t"]
        logits, state = T.decode_step(cfg, last["cast"], state, token)
        return _out_logits(logits, dist_mesh, dp), state

    decode.specs = specs
    spec = {"token": ((shape.global_batch, 1), torch.int32)}
    return decode, spec
