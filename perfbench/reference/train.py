"""Plain training steps: the next-token loss's gradients in blocks of
rows, global-norm clipping, the linear-warmup cosine schedule and AdamW
with decoupled weight decay, in float32.

Returns what the benchmark compares: each step's mean loss, each leaf's
norm of the first clipped gradient, and each leaf's norm of the change
of its parameters over the steps.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict, List

import torch

from .common import Arith, nest


def lr_at(step: int, peak: float, warmup: int, total: int,
          floor: float = 0.1) -> float:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine to
    ``floor · peak`` at ``total``."""
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return floor * peak + (1 - floor) * peak * 0.5 * (1 + math.cos(math.pi * t))


def steps(ref: ModuleType, m: Dict, W: Dict[str, torch.Tensor],
          batches: List[torch.Tensor], opt: Dict, ar: Arith,
          rows: int = 1, first_step: int = 0) -> Dict:
    """``len(batches)`` steps from the weights ``W`` (``{name: tensor}``
    by :func:`common.param_names`' dotted names) on the batches (rows,
    S), each step's loss the mean over every predicted token, its
    gradients summed ``rows`` rows of a batch at a time."""
    names = list(W)
    p = {k: W[k].detach().to(torch.float32).clone() for k in names}
    p0 = {k: v.clone() for k, v in p.items()}
    mo = {k: torch.zeros_like(v) for k, v in p.items()}
    vo = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2 = opt["b1"], opt["b2"]
    losses, grad1 = [], {}
    for t, tokens in enumerate(batches):
        n = tokens.shape[0] * (tokens.shape[1] - 1)
        g = {k: torch.zeros_like(v) for k, v in p.items()}
        total = 0.0
        for r0 in range(0, tokens.shape[0], rows):
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            tree = nest({tuple(_path(k)): v for k, v in leaves.items()})
            loss = ref.loss_sum(m, tree, tokens[r0:r0 + rows], ar) / n
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
            for k, gk in zip(names, grads):
                g[k] += gk
            total += float(loss.detach())
            for v in p.values():
                v.requires_grad_(False)
        losses.append(total)
        gnorm = math.sqrt(sum(float(torch.sum(v * v)) for v in g.values()))
        scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
        if t == 0:
            grad1 = {k: float(torch.linalg.vector_norm(v)) * scale
                     for k, v in g.items()}
        step = t + 1
        lr = lr_at(first_step + t, opt["lr_peak"], opt["warmup"],
                   opt["total_steps"])
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        with torch.no_grad():
            for k in names:
                gk = g[k] * scale
                mo[k].mul_(b1).add_((1 - b1) * gk)
                vo[k].mul_(b2).add_((1 - b2) * gk * gk)
                upd = (mo[k] / c1) / (torch.sqrt(vo[k] / c2) + opt["eps"]) \
                    + opt["weight_decay"] * p[k]
                p[k].sub_(lr * upd)
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in names}
    return {"loss": losses, "grad1": grad1, "change": change}


def _path(name: str) -> list:
    return [int(s) if s.isdigit() else s for s in name.split(".")]
