"""Learning-rate schedules (pure functions of the step), on tensors.

Counterpart of :mod:`repro.optim.schedule`.
"""

from __future__ import annotations

import math
from typing import Union

import torch

__all__ = ["cosine_warmup"]


def cosine_warmup(step: Union[int, float, torch.Tensor], *, peak: float,
                  warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to ``peak`` then cosine decay to ``floor * peak``,
    an fp32 0-d tensor on ``step``'s device (the CPU for a number); the
    reference's operations in fp32, with its Python-float constants."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.full((), step, dtype=torch.float32)
    # divisors as tensors on step's device: CUDA turns a division by a
    # host number into a product with its reciprocal
    warm = peak * step / step.new_full((), max(warmup, 1))
    t = torch.clamp((step - warmup) / step.new_full((), max(total - warmup,
                                                            1)), 0, 1)
    cos = floor * peak + (1 - floor) * peak * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)
