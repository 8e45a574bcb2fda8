"""Compile options for the :mod:`repro_torch.flow` pipeline.

Counterpart of :mod:`repro.flow.options`.  :class:`CompileOptions` is
the single declarative knob bundle of the pass-based compiler: strategy,
batch, quantization, local-memory strictness, target fidelity and the
analytic cost-model parameters.  It is frozen and renders any *subset*
of itself into a canonical JSON fragment — the pass-output cache keys
each pipeline pass by exactly the option fields it declares in
``Pass.depends``, so a re-compile that only changes ``fidelity`` reuses
the already-computed partition.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Union

from ..core.machine import Calibration
from ..core.mapping import CostParams
from ..core.ref import QuantParams

__all__ = ["CompileOptions", "FIDELITIES"]

# The fidelity ladder: "analytic" = closed-form cost model (no
# codegen); "trace" = StagePlan replay at unit/transfer granularity;
# "simulate" = perf-mode cycle-accurate run; "func" = functional ISS
# (bit-exact data semantics).  The port evaluates "analytic" so far.
FIDELITIES = ("analytic", "trace", "simulate", "func")


@dataclass(frozen=True)
class CompileOptions:
    """Everything that determines a compile's outcome, in one record.

    ``batch=None`` falls back to ``params.batch``.  ``quant`` maps group
    index to :class:`~repro_torch.core.ref.QuantParams`; it is
    normalized to a sorted tuple so options hash/compare structurally.
    """

    strategy: str = "dp"
    batch: Optional[int] = None
    quant: Optional[Mapping[int, QuantParams]] = None
    strict_lmem: bool = False
    fidelity: str = "analytic"
    params: CostParams = field(default_factory=CostParams)
    workload_kw: Optional[Mapping[str, Any]] = None   # for str workloads
    dump_dir: Optional[str] = None    # per-pass JSON IR dumps (debugging)
    # per-unit correction factors applied by the analytic backend at
    # evaluation time; the partition search itself stays uncalibrated
    # and cache-shared.  Named presets (a string) need the calibration
    # slice.
    calibration: Union[Calibration, str, None] = None
    # multi-chip scale-out (a SystemConfig) needs the system slice
    system: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.fidelity not in FIDELITIES:
            raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                             f"got {self.fidelity!r}")
        if isinstance(self.calibration, str):
            raise NotImplementedError(
                "named calibration presets need flow/calibrate.py, which "
                "the port has not reached yet (calibration slice); pass "
                "a Calibration object")
        if self.batch is not None and self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")
        if self.quant is not None and not isinstance(self.quant, tuple):
            object.__setattr__(
                self, "quant",
                tuple(sorted((int(k), v) for k, v in
                             dict(self.quant).items())))
        if self.workload_kw is not None \
                and not isinstance(self.workload_kw, tuple):
            object.__setattr__(
                self, "workload_kw",
                tuple(sorted(dict(self.workload_kw).items())))

    # -- derived -------------------------------------------------------------

    def resolved_batch(self) -> int:
        return self.batch if self.batch is not None else self.params.batch

    def quant_dict(self) -> Dict[int, QuantParams]:
        return dict(self.quant) if self.quant else {}

    def workload_kw_dict(self) -> Dict[str, Any]:
        return dict(self.workload_kw) if self.workload_kw else {}

    def replace(self, **kw: Any) -> "CompileOptions":
        return dataclasses.replace(self, **kw)

    # -- cache keying ---------------------------------------------------------

    def subset_key(self, fields: Sequence[str]) -> str:
        """Canonical JSON of the named option fields only (the
        "options-prefix" a pass contributes to its cache key)."""
        desc: Dict[str, Any] = {}
        for f in sorted(fields):
            v = getattr(self, f)
            if f == "params":
                v = dataclasses.asdict(v)
            elif f == "calibration":
                v = v.to_dict() if v is not None else None
            elif f == "quant":
                v = [[gid, qp.scale, qp.shift]
                     for gid, qp in (v or ())]
            elif f == "workload_kw":
                v = [list(kv) for kv in (v or ())]
            elif f == "system":
                v = v.to_dict() if v is not None else None
            desc[f] = v
        return json.dumps(desc, sort_keys=True, separators=(",", ":"))

    def describe(self) -> str:
        return (f"CompileOptions(strategy={self.strategy!r}, "
                f"batch={self.resolved_batch()}, "
                f"fidelity={self.fidelity!r}, "
                f"strict_lmem={self.strict_lmem}, "
                f"quant={'yes' if self.quant else 'default'})")
