"""AdamW with global-norm clipping and configurable moment dtype.

Counterpart of :mod:`repro.optim.adamw` on tensors.  The reference is
pure (new trees out); here the step updates the parameters and moments
in place (their memory is the largest a training run holds) and returns
the same objects, with a new ``step`` tensor.  The global norm and the
per-leaf update run in :mod:`repro_torch.kernels.adamw`: the Triton
kernels on CUDA (no host sync), their plain versions on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch

from .. import tree as tree_util
from ..kernels import adamw as K

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # bf16 for memory-bound configs


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    """Zero moments shaped as ``params`` (in ``moment_dtype``, on each
    leaf's device) and a zero int32 ``step`` on the first leaf's."""
    dt = _DTYPES[cfg.moment_dtype]
    leaves = tree_util.leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {
        "m": tree_util.map_tree(zeros, params),
        "v": tree_util.map_tree(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def global_norm(tree) -> torch.Tensor:
    """The fp32 global norm of the tree's leaves (the norm kernel on
    CUDA)."""
    return K.grad_norm(tree_util.leaves(tree))


def adamw_update(grads, state: Dict[str, Any], params,
                 lr: Union[float, torch.Tensor],
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns ``(params, state, {"grad_norm"})`` as the reference does;
    ``params`` and the moments are updated in place."""
    gnorm, step = K.adamw_step(
        tree_util.leaves(params), tree_util.leaves(grads),
        tree_util.leaves(state["m"]), tree_util.leaves(state["v"]), lr,
        state["step"], b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
        weight_decay=cfg.weight_decay, clip_norm=cfg.clip_norm)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gnorm}
