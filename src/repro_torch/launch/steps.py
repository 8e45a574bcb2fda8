"""Train and decode steps, on one device.

Counterpart of :func:`repro.launch.steps.make_train_step` and
:func:`repro.launch.steps.make_decode_step`.  The reference returns
jitted, sharded steps; here each step is a plain callable on one device
(no ``torch.compile``).  The prefill step and the sharded forms come
with later slices (ROADMAP §1).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from .. import tree as tree_util
from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from ..models import model_zoo, transformer as T
from ..optim import AdamWConfig, adamw_update, cosine_warmup

__all__ = ["make_train_step", "make_decode_step"]


def make_train_step(cfg: ArchConfig,
                    device: Union[str, torch.device, None],
                    shape: ShapeConfig,
                    adamw: AdamWConfig = AdamWConfig(),
                    lr_peak: float = 3e-4, warmup: int = 200,
                    total_steps: int = 10_000
                    ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(step, spec)``: ``step(params, opt, batch, step_i)`` runs the
    loss (:func:`~repro_torch.models.transformer.loss_fn`, remat per
    block), its gradients with respect to the parameters' floating
    leaves, the ``cosine_warmup`` learning rate at ``step_i`` and
    ``adamw_update``, and returns ``(params, opt, metrics)`` with
    ``loss``, ``lr`` and ``grad_norm`` as device tensors: nothing waits
    on the device.  The parameters and moments are updated in place (the
    reference donates them).  ``spec`` gives each batch input's and the
    step's ``(shape, dtype)``."""
    dev = resolve_device(device)

    def train_step(params: T.ParamTree, opt, batch, step_i):
        params.requires_grad_(True)
        leaves = tree_util.leaves(params)
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        loss = T.loss_fn(cfg, params, batch)
        grads = torch.autograd.grad(loss, leaves)
        if not isinstance(step_i, torch.Tensor):
            step_i = torch.full((), step_i, dtype=torch.int32, device=dev)
        lr = cosine_warmup(step_i, peak=lr_peak, warmup=warmup,
                           total=total_steps)
        params, opt, metrics = adamw_update(
            tree_util.unflatten(params, grads), opt, params, lr, adamw)
        metrics = dict(metrics, loss=loss.detach(), lr=lr)
        return params, opt, metrics

    spec = dict(model_zoo.batch_spec(cfg, shape.global_batch,
                                     shape.seq_len),
                step=((), torch.int32))
    return train_step, spec


def make_decode_step(cfg: ArchConfig,
                     device: Union[str, torch.device, None],
                     shape: ShapeConfig
                     ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(decode, spec)``: ``decode(params, state, token)`` runs one new
    token (B, 1) against the pre-allocated ``shape.seq_len`` caches and
    returns ``(logits (B, vocab) fp32, state)``; ``spec`` gives the
    token's ``(shape, dtype)``.  The parameters are cast to the compute
    dtype once per parameter tree, not at every step; decoding tracks no
    gradients."""
    dev = resolve_device(device)
    last: Dict[str, T.ParamTree] = {}

    @torch.no_grad()
    def decode(params: T.ParamTree, state, token: torch.Tensor):
        if last.get("src") is not params:
            last["src"] = params
            last["cast"] = T.cast_params(cfg, params)
        return T.decode_step(cfg, last["cast"], state, token.to(dev))

    spec = {"token": ((shape.global_batch, 1), torch.int32)}
    return decode, spec
