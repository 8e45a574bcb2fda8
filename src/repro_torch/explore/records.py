"""Evaluation records and the JSONL result store.

Copied from :mod:`repro.explore.records` (the JAX package): records
and stores round-trip between the two packages.

Every evaluated design point becomes an :class:`EvalRecord` — the point,
the workload it was scored on, the fidelity used ("analytic" cost model
vs "simulate" cycle-accurate), and the measured cycles / throughput /
energy breakdown.  Records round-trip through plain dicts (the cache and
the JSONL store share one format) and flatten to the legacy
``core.dse.DsePoint.row()`` schema so existing benchmark reports keep
working unchanged.
"""

from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from .space import DesignPoint

__all__ = ["FIDELITIES", "EvalRecord", "RecordStore"]

# the fidelity ladder, cheap to expensive ("func" is a validation mode,
# not an exploration fidelity)
FIDELITIES = ("analytic", "trace", "simulate")

_ENERGY_KEYS = ("compute", "weight_load", "noc", "gmem", "lmem", "static")


@dataclass
class EvalRecord:
    """One (model x design point x fidelity) evaluation result."""

    point: DesignPoint
    model: str
    fidelity: str               # "analytic" | "simulate"
    cycles: float
    throughput_sps: float       # samples/s at the chip clock
    energy: Dict[str, float]    # nJ breakdown, incl. "total"
    batch: int = 4
    cache_hit: bool = False
    wall_s: float = 0.0
    error: Optional[str] = None   # evaluation failed (infeasible point)
    # perf-simulator execution path for simulate-fidelity rows
    # ("auto" | "scalar" | "vector" | "torch"); cheap fidelities run no
    # simulator and always record "auto"
    engine: str = "auto"

    @property
    def ok(self) -> bool:
        return self.error is None

    # -- derived objectives -------------------------------------------------

    @property
    def energy_total(self) -> float:
        return self.energy.get("total", 0.0)

    @property
    def edp(self) -> float:
        """Energy-delay product (nJ * cycles) — the example's objective."""
        return self.cycles * self.energy_total

    @property
    def simulated(self) -> bool:
        return self.fidelity == "simulate"

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return {
            "point": self.point.to_dict(), "model": self.model,
            "fidelity": self.fidelity, "cycles": self.cycles,
            "throughput_sps": self.throughput_sps, "energy": self.energy,
            "batch": self.batch, "cache_hit": self.cache_hit,
            "wall_s": self.wall_s, "error": self.error,
            "engine": self.engine,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EvalRecord":
        return cls(point=DesignPoint.from_dict(d["point"]),
                   model=d["model"], fidelity=d["fidelity"],
                   cycles=d["cycles"],
                   throughput_sps=d["throughput_sps"],
                   energy=dict(d["energy"]), batch=d.get("batch", 4),
                   cache_hit=d.get("cache_hit", False),
                   wall_s=d.get("wall_s", 0.0),
                   error=d.get("error"),
                   engine=d.get("engine", "auto"))

    def row(self) -> Dict[str, Any]:
        """Flat dict in the legacy ``DsePoint.row()`` schema (+ extras)."""
        tot = self.energy_total
        return {
            "model": self.model, "strategy": self.point.strategy,
            "mg": self.point.macros_per_group,
            "flit": self.point.flit_bytes,
            "cycles": self.cycles, "throughput_sps": self.throughput_sps,
            "energy_total_mJ": tot / 1e6,
            **{f"energy_{k}_frac":
               (self.energy.get(k, 0.0) / tot if tot else 0.0)
               for k in _ENERGY_KEYS},
            "simulated": self.simulated,
            # extras beyond the legacy schema
            "fidelity": self.fidelity,
            "n_mg": self.point.n_macro_groups,
            "cores": self.point.n_cores,
            "lmem_kb": self.point.local_mem_kb,
            "total_macros": self.point.total_macros,
            "cache_hit": self.cache_hit,
            "error": self.error,
            "engine": self.engine,
        }


class RecordStore:
    """Append-only JSONL store of :class:`EvalRecord` dicts."""

    def __init__(self, path: str) -> None:
        self.path = path

    def append(self, rec: EvalRecord) -> None:
        self.extend([rec])

    def extend(self, recs: List[EvalRecord]) -> None:
        if not recs:
            return
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(self.path, "a") as f:
            for r in recs:
                f.write(json.dumps(r.to_dict(), sort_keys=True) + "\n")

    def __iter__(self) -> Iterator[EvalRecord]:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    yield EvalRecord.from_dict(json.loads(line))
                except (json.JSONDecodeError, KeyError, TypeError) as e:
                    # a crash mid-append leaves a truncated last line;
                    # skip it (the sweep will simply redo that point)
                    # instead of making the whole store unreadable
                    warnings.warn(
                        f"record store {self.path}:{lineno}: skipping "
                        f"unreadable record ({type(e).__name__}: {e})",
                        RuntimeWarning, stacklevel=2)

    def load(self) -> List[EvalRecord]:
        out: List[EvalRecord] = []
        for rec in self.__iter__():
            out.append(rec)
        return out

    def __len__(self) -> int:
        return len(self.load())
