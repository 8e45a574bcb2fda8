"""``flow.calibrate``: fit per-unit correction factors from a handful
of simulator runs.

Host code copied from :mod:`repro.flow.calibrate` (the JAX package);
the simulator runs use the port's default perf engine (``torch``, the
stage decode on ``device``: CUDA unless named).  Named presets are the
same committed JSON files the JAX package reads.

The analytic cost model and the trace replay share the simulator's
:class:`~repro_torch.core.machine.MachineModel`, but they still idealize
effects only per-instruction stepping sees (in-order issue stalls, link
back-pressure, padding-edge gather work).  This harness closes the
residual *systematically* instead of hand-tuning constants:

1. compile each calibration workload and run the perf-mode simulator
   (ground truth) plus the target cheap fidelity;
2. fit per-unit factors as the ratio of simulator unit-busy cycles to
   the cheap model's per-unit cycle estimates (CIM / vector / NoC);
3. fit a residual ``makespan`` factor as the geometric-mean ratio of
   simulator cycles to the unit-calibrated cheap-model cycles.

The result is a :class:`~repro_torch.core.machine.Calibration` that rides on
``CompileOptions.calibration`` (and therefore on the machine model via
``machine_for(chip, calib)``): the analytic and trace backends apply it
at evaluation time, the partition search and pass cache stay
calibration-free, and :mod:`repro_torch.explore`'s successive halving screens
with simulator-faithful rankings.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.arch import ChipConfig
from ..core.machine import Calibration
from ..core.mapping import CostParams
from ..core.partition import PartitionResult
from .options import CompileOptions

__all__ = ["CalibrationRow", "CalibrationReport", "calibrate",
           "analytic_unit_cycles", "calibration_dir", "save_calibration",
           "load_calibration", "list_calibrations"]

# Named calibration presets: ``flow.calibrate(..., save="name")`` writes
# ``results/calibrations/<name>.json`` and
# ``CompileOptions(calibration="name")`` loads it back — so a fit paid
# once (a handful of simulator runs) rides along to later runs,
# benchmark scripts and explore sweeps by name.
ENV_CALIB_DIR = "REPRO_CALIB_DIR"
# anchored to the repo root (like the committed bench goldens), not the
# CWD — presets must resolve no matter where the process was launched
DEFAULT_CALIB_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "results", "calibrations")


def calibration_dir(directory: Optional[str] = None) -> str:
    return (directory or os.environ.get(ENV_CALIB_DIR)
            or DEFAULT_CALIB_DIR)


def _preset_path(name: str, directory: Optional[str] = None) -> str:
    if name.endswith(".json") or os.sep in name:
        return name                     # explicit path passes through
    return os.path.join(calibration_dir(directory), f"{name}.json")


def save_calibration(calib: Calibration, name: str,
                     directory: Optional[str] = None,
                     meta: Optional[Dict[str, Any]] = None) -> str:
    """Persist a fitted :class:`Calibration` as a named preset."""
    path = _preset_path(name, directory)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = {"name": os.path.splitext(os.path.basename(path))[0],
           "calibration": calib.to_dict()}
    if meta:
        doc.update(meta)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_calibration(name: str,
                     directory: Optional[str] = None) -> Calibration:
    """Load a named preset (or an explicit ``*.json`` path)."""
    path = _preset_path(name, directory)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        have = list_calibrations(directory)
        hint = (", ".join(have) if have
                else "none — fit one with flow.calibrate(..., save=name)")
        raise FileNotFoundError(
            f"no calibration preset {name!r} at {path} "
            f"(available: {hint})") from None
    return Calibration.from_dict(doc["calibration"])


def list_calibrations(directory: Optional[str] = None) -> List[str]:
    d = calibration_dir(directory)
    try:
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d)
                      if f.endswith(".json"))
    except FileNotFoundError:
        return []


def analytic_unit_cycles(res: PartitionResult,
                         batch: int) -> Dict[str, float]:
    """Per-unit busy-cycle totals implied by the analytic components.

    ``compute``/``vector`` are per-sample per-replica-core figures, so
    total unit busy multiplies by batch and the replica's core count;
    ``comm`` is a per-replica port figure (gmem streams occupy the NoC
    unit in the simulator, so both comm shares map to ``noc``).
    """
    tot = {"cim": 0.0, "vector": 0.0, "noc": 0.0}
    for sp in res.stages:
        for a in sp.allocs:
            tot["cim"] += a.compute * batch * a.cores * a.dup
            tot["vector"] += a.vector * batch * a.cores * a.dup
            tot["noc"] += a.comm * batch * a.dup
    return tot


@dataclass
class CalibrationRow:
    """One calibration workload's before/after agreement.

    Carries the full simulator payload so callers (e.g.
    ``ExplorationEngine.calibrate``) can reuse the ground-truth run —
    it cost seconds — instead of re-simulating the same point later.
    """

    workload: str
    sim_cycles: float
    base_cycles: float             # cheap fidelity, uncalibrated
    calibrated_cycles: float = 0.0
    sim_energy: Optional[Dict[str, float]] = None
    sim_throughput_sps: float = 0.0
    sim_wall_s: float = 0.0

    @property
    def base_ratio(self) -> float:
        return self.sim_cycles / max(self.base_cycles, 1e-12)

    @property
    def calibrated_ratio(self) -> float:
        return self.sim_cycles / max(self.calibrated_cycles, 1e-12)


@dataclass
class CalibrationReport:
    """Fit result + per-workload agreement before/after."""

    calibration: Calibration
    fidelity: str
    rows: List[CalibrationRow] = field(default_factory=list)

    def max_ratio(self, calibrated: bool = True) -> float:
        """Worst-case |log-ratio| band, as a multiplicative factor."""
        ratios = [(r.calibrated_ratio if calibrated else r.base_ratio)
                  for r in self.rows]
        if not ratios:
            return 1.0
        return max(max(r, 1.0 / r) for r in ratios)

    def describe(self) -> str:
        lines = [f"{self.fidelity} {self.calibration.describe()}"]
        for r in self.rows:
            lines.append(
                f"  {r.workload:24s} sim={r.sim_cycles:12.0f} "
                f"{self.fidelity}={r.base_cycles:12.0f} "
                f"(x{r.base_ratio:6.2f}) calibrated="
                f"{r.calibrated_cycles:12.0f} (x{r.calibrated_ratio:5.2f})")
        lines.append(f"  band: x{self.max_ratio(False):.2f} -> "
                     f"x{self.max_ratio(True):.2f}")
        return "\n".join(lines)


Workload = Union[str, Tuple[str, Dict[str, Any]], Any]


def _norm_workload(w: Workload) -> Tuple[Any, Dict[str, Any], str]:
    if isinstance(w, str):
        return w, {}, w
    if isinstance(w, tuple):
        name, kw = w
        label = name + "".join(f"@{k}={v}" for k, v in sorted(kw.items()))
        return name, dict(kw), label
    return w, {}, getattr(w, "name", type(w).__name__)


def _geomean(xs: Sequence[float]) -> float:
    xs = [x for x in xs if x > 0 and math.isfinite(x)]
    if not xs:
        return 1.0
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def calibrate(workloads: Sequence[Workload], chip: ChipConfig,
              strategy: str = "dp",
              params: Optional[CostParams] = None,
              batch: Optional[int] = None,
              fidelity: str = "analytic",
              pipeline: Any = None,
              save: Optional[str] = None,
              device: Union[str, torch.device, None] = None
              ) -> CalibrationReport:
    """Fit a :class:`Calibration` for ``fidelity`` on ``chip``.

    ``workloads`` is a handful of calibration models — names,
    ``(name, workload_kw)`` pairs, or graph objects.  Each one costs a
    perf-mode simulator run (seconds); everything else is cheap.  Use
    small geometries (``res=64``/``112``) — per-unit ratios transfer to
    the full-size models because the *mechanism* (im2col gather cost,
    handoff serialization) is geometry-independent.

    ``save`` persists the fit as a named preset
    (``results/calibrations/<save>.json``; see :func:`save_calibration`)
    that ``CompileOptions(calibration="<save>")`` and
    ``ExplorationEngine(calibration="<save>")`` load by name.

    The simulator runs decode on ``device`` (CUDA unless named; raises
    without a card).
    """
    if fidelity not in ("analytic", "trace"):
        raise ValueError(f"calibrate fits 'analytic' or 'trace', "
                         f"got {fidelity!r}")
    from . import compile as flow_compile       # late: avoid cycle
    params = params or CostParams(batch=4)

    arts = []
    rows: List[CalibrationRow] = []
    sim_busy = {"cim": 0.0, "vector": 0.0, "noc": 0.0}
    model_busy = {"cim": 0.0, "vector": 0.0, "noc": 0.0}
    for w in workloads:
        workload, kw, label = _norm_workload(w)
        opts = CompileOptions(strategy=strategy, params=params,
                              batch=batch, workload_kw=kw or None)
        art = flow_compile(workload, chip, opts, pipeline=pipeline)
        sim = art.evaluate("simulate", device=device)
        base = art.evaluate(fidelity)
        if fidelity == "analytic":
            unit = analytic_unit_cycles(art.partition,
                                        opts.resolved_batch())
            for u in sim_busy:
                sim_busy[u] += sim.sim.unit_busy.get(u, 0.0)
                model_busy[u] += unit.get(u, 0.0)
        arts.append((art, label))
        rows.append(CalibrationRow(workload=label,
                                   sim_cycles=sim.cycles,
                                   base_cycles=base.cycles,
                                   sim_energy=dict(sim.energy),
                                   sim_throughput_sps=sim.throughput_sps,
                                   sim_wall_s=sim.wall_s))

    if fidelity == "analytic":
        factors = {u: (sim_busy[u] / model_busy[u]) if model_busy[u] > 0
                   else 1.0 for u in sim_busy}
        unit_calib = Calibration(cim=factors["cim"],
                                 vector=factors["vector"],
                                 noc=factors["noc"], gmem=factors["noc"])
    else:
        # trace already charges machine-model unit costs per replayed
        # event; its residual is serialization-shaped, so a makespan-only
        # fit is more robust than re-scaling units it got right
        unit_calib = Calibration()

    # residual serialization: re-evaluate with unit factors only, then
    # absorb what per-unit scaling cannot explain into ``makespan``
    resid = []
    partial = []
    for (art, label), row in zip(arts, rows):
        rep = art.replace_options(calibration=unit_calib) \
            .evaluate(fidelity)
        partial.append(rep.cycles)
        resid.append(row.sim_cycles / max(rep.cycles, 1e-12))
    calib = unit_calib.scaled(makespan=_geomean(resid))
    for row, cyc in zip(rows, partial):
        row.calibrated_cycles = cyc * calib.makespan
    report = CalibrationReport(calibration=calib, fidelity=fidelity,
                               rows=rows)
    if save:
        save_calibration(
            calib, save,
            meta={"fidelity": fidelity, "chip": chip.name,
                  "strategy": strategy,
                  "workloads": [r.workload for r in rows],
                  "band": round(report.max_ratio(True), 4)})
    return report
