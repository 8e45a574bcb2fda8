"""Elastic re-meshing after node loss / join.

Given the surviving chip count and the model's parallelism needs, pick a
new ``(pod, data, model)`` mesh and the training adjustments (gradient-
accumulation factor to preserve global batch).  The model axis is kept at
its configured size whenever the survivor count allows — re-sharding the
model axis means re-partitioning weights, which is far more expensive
than shrinking the data axis.

This mirrors the CIMFlow planner's capacity logic (a chip's HBM must hold
its parameter + optimizer-state shard); the planner (``core/planner.py``,
not ported yet) supplies the per-arch byte estimates.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

__all__ = ["ElasticPlan", "plan_remesh"]


@dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: Tuple[int, ...]          # (data, model) or (pod, data, model)
    axis_names: Tuple[str, ...]
    chips_used: int
    chips_idle: int
    grad_accum: int                      # to preserve the global batch
    reason: str


def _divisors_desc(n: int) -> List[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_remesh(surviving_chips: int, *, model_parallel: int,
                target_data_parallel: int,
                min_model_parallel: Optional[int] = None) -> ElasticPlan:
    """Largest usable (data x model) grid from the survivors.

    Keeps ``model_parallel`` if possible; otherwise falls back to the
    largest power-of-two model axis >= ``min_model_parallel`` that still
    fits.  Idle chips (remainder) become hot spares.
    """
    min_mp = min_model_parallel or model_parallel
    best: Optional[ElasticPlan] = None
    mp = model_parallel
    while mp >= 1:
        if mp >= min_mp and surviving_chips >= mp:
            dp = surviving_chips // mp
            used = dp * mp
            accum = max(1, math.ceil(target_data_parallel / dp))
            plan = ElasticPlan(
                mesh_shape=(dp, mp), axis_names=("data", "model"),
                chips_used=used, chips_idle=surviving_chips - used,
                grad_accum=accum,
                reason=(f"kept model axis {mp}" if mp == model_parallel
                        else f"shrunk model axis {model_parallel}->{mp}"))
            if best is None or plan.chips_used > best.chips_used:
                best = plan
            if mp == model_parallel:
                break                      # prefer the configured axis
        mp //= 2
    if best is None:
        raise ValueError(
            f"{surviving_chips} chips cannot host model_parallel>="
            f"{min_mp}")
    return best
