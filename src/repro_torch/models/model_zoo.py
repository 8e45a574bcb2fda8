"""Convenience layer over the unified model: init + dummy batches.

Counterpart of :mod:`repro.models.model_zoo`; :func:`batch_spec` gives
``(shape, dtype)`` pairs where the reference gives
``jax.ShapeDtypeStruct``s.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..device import resolve_device
from . import transformer as T

__all__ = ["init", "dummy_batch", "batch_spec"]


def init(cfg: ArchConfig, seed: int = 0,
         device: Union[str, torch.device, None] = None) -> T.ParamTree:
    dev = resolve_device(device)
    return T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)


def dummy_batch(cfg: ArchConfig, batch: int, seq: int, seed: int = 1,
                device: Union[str, torch.device, None] = None
                ) -> Dict[str, torch.Tensor]:
    """Concrete random batch (smoke tests / examples)."""
    dev = resolve_device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    out: Dict[str, torch.Tensor] = {
        "tokens": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                dtype=torch.int32, device=dev),
    }
    if cfg.encoder_layers:
        out["frames"] = torch.randn((batch, cfg.encoder_seq, cfg.d_model),
                                    generator=gen, device=dev) * 0.02
    if cfg.vision_tokens:
        out["patches"] = torch.randn((batch, cfg.vision_tokens,
                                      cfg.d_model), generator=gen,
                                     device=dev) * 0.02
    return out


def batch_spec(cfg: ArchConfig, batch: int, seq: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` of each input (no allocation)."""
    out = {"tokens": ((batch, seq), torch.int32)}
    if cfg.encoder_layers:
        out["frames"] = ((batch, cfg.encoder_seq, cfg.d_model),
                         torch.float32)
    if cfg.vision_tokens:
        out["patches"] = ((batch, cfg.vision_tokens, cfg.d_model),
                          torch.float32)
    return out
