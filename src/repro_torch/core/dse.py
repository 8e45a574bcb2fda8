"""Deprecated shim over :mod:`repro_torch.explore` (the DSE subsystem).

The serial fixed-grid sweep that used to live here was replaced by the
``repro_torch.explore`` package — declarative design spaces, a pool-parallel
cached evaluation engine, search strategies and Pareto analysis.  This
module keeps the original public surface (``DsePoint``, ``evaluate``,
``sweep_mg_flit``, ``SWEEP_MG``, ``SWEEP_FLIT``) alive for existing
callers; new code should import from :mod:`repro_torch.explore`.
Copied from :mod:`repro.core.dse` (the JAX package), with a ``device``
for its simulator runs.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Union

import torch

from ..device import resolve_device
from ..explore.engine import evaluate_chip
from ..explore.space import SWEEP_FLIT, SWEEP_MG
from .arch import ChipConfig, default_chip
from .graph import CondensedGraph
from .mapping import CostParams

__all__ = ["DsePoint", "evaluate", "sweep_mg_flit", "SWEEP_MG",
           "SWEEP_FLIT"]

warnings.warn(
    "repro_torch.core.dse is deprecated; use the repro_torch.explore subsystem "
    "(ExplorationEngine, DesignSpace, search, pareto) instead",
    DeprecationWarning, stacklevel=2)


@dataclass
class DsePoint:
    model: str
    strategy: str
    macros_per_group: int
    flit_bytes: int
    cycles: float
    throughput_sps: float       # samples/s at 1 GHz
    energy: Dict[str, float]    # nJ breakdown
    simulated: bool

    def row(self) -> Dict:
        return {
            "model": self.model, "strategy": self.strategy,
            "mg": self.macros_per_group, "flit": self.flit_bytes,
            "cycles": self.cycles, "throughput_sps": self.throughput_sps,
            "energy_total_mJ": self.energy["total"] / 1e6,
            **{f"energy_{k}_frac":
               (self.energy[k] / self.energy["total"]
                if self.energy["total"] else 0.0)
               for k in ("compute", "weight_load", "noc", "gmem",
                         "lmem", "static")},
            "simulated": self.simulated,
        }


def evaluate(cg: CondensedGraph, chip: ChipConfig, strategy: str,
             params: Optional[CostParams] = None,
             simulate: bool = False,
             device: Union[str, torch.device, None] = None) -> DsePoint:
    """Score one chip; a simulator run decodes on ``device`` (CUDA
    unless named; raises without a card, whether or not it simulates)."""
    out = evaluate_chip(cg, chip, strategy, params,
                        fidelity="simulate" if simulate else "analytic",
                        device=resolve_device(device))
    return DsePoint(model=cg.name, strategy=strategy,
                    macros_per_group=chip.core.cim.macros_per_group,
                    flit_bytes=chip.noc.flit_bytes, cycles=out["cycles"],
                    throughput_sps=out["throughput_sps"],
                    energy=out["energy"], simulated=simulate)


def sweep_mg_flit(cg: CondensedGraph, strategy: str = "generic",
                  mgs: Iterable[int] = SWEEP_MG,
                  flits: Iterable[int] = SWEEP_FLIT,
                  simulate: bool = False,
                  params: Optional[CostParams] = None,
                  device: Union[str, torch.device, None] = None
                  ) -> List[DsePoint]:
    dev = resolve_device(device)
    out = []
    for mg in mgs:
        for flit in flits:
            chip = default_chip(macros_per_group=mg, flit_bytes=flit)
            out.append(evaluate(cg, chip, strategy, params, simulate,
                                dev))
    return out
