"""Decode step for serving, on one device.

Counterpart of :func:`repro.launch.steps.make_decode_step`.  The
reference returns a jitted, sharded step; here the step is a plain
callable on one device (no ``torch.compile``).  The train and prefill
steps, and the sharded forms, come with later slices (ROADMAP §1).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..device import resolve_device
from ..models import transformer as T

__all__ = ["make_decode_step"]


def make_decode_step(cfg: ArchConfig,
                     device: Union[str, torch.device, None],
                     shape: ShapeConfig
                     ) -> Tuple[Callable, Dict[str, Tuple]]:
    """``(decode, spec)``: ``decode(params, state, token)`` runs one new
    token (B, 1) against the pre-allocated ``shape.seq_len`` caches and
    returns ``(logits (B, vocab) fp32, state)``; ``spec`` gives the
    token's ``(shape, dtype)``.  The parameters are cast to the compute
    dtype once per parameter tree, not at every step."""
    dev = resolve_device(device)
    last: Dict[str, T.ParamTree] = {}

    def decode(params: T.ParamTree, state, token: torch.Tensor):
        if last.get("src") is not params:
            last["src"] = params
            last["cast"] = T.cast_params(cfg, params)
        return T.decode_step(cfg, last["cast"], state, token.to(dev))

    spec = {"token": ((shape.global_batch, 1), torch.int32)}
    return decode, spec
