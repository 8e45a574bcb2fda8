"""Multi-chip plan evaluation: stitch per-chip reports over the links.

One :class:`SystemReport` (an :class:`~repro_torch.flow.backends.EvalReport`
subclass, so every existing consumer — serve, explore, benchmarks —
reads it unchanged) per evaluation:

* **pipeline mode** — ``cycles`` is the *fill* makespan of one batch
  through all chips (per-chip latencies + every cut transfer, priced
  gmem-port-contended on the configured link tier), while
  ``throughput_sps`` reflects pipelined steady state: the bottleneck
  chip's latency plus its incident transfers.  At trace fidelity the
  per-chip :class:`~repro_torch.core.trace.TraceReport` replays are stitched
  (:meth:`TraceReport.stitch`) into one system-level trace.
* **tensor mode** — chips run the same stage sequence on shards, so
  ``cycles`` is the slowest chip plus the per-group collectives
  (ring all-gather / all-reduce, see
  :meth:`MachineModel.interchip_collective_cycles`).

Energy is the per-chip breakdown summed key-wise plus an ``interchip``
category priced from the plan's total link traffic at the tier's
pJ/byte — single-chip reports keep their exact historical shape (no
new zero-valued keys).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.machine import machine_for
from ..core.trace import TraceReport
from ..flow.backends import EvalReport, _throughput
from .partition import SystemPlan

__all__ = ["SystemReport", "evaluate_plan"]


@dataclass
class SystemReport(EvalReport):
    """One multi-chip evaluation (EvalReport shape + system extras)."""

    mode: str = "pipeline"
    n_chips: int = 1
    comm_cycles: float = 0.0           # inter-chip transfer/collective
    bottleneck_cycles: float = 0.0     # steady-state pipeline interval
    per_chip: List[EvalReport] = field(default_factory=list)
    # degraded-mode accounting: chips/links the plan routed around.
    # ``throughput_sps`` above IS the degraded throughput when these
    # are nonzero — chip-loss degradation curves read it directly.
    n_failed_chips: int = 0
    n_failed_links: int = 0

    @property
    def degraded(self) -> bool:
        return self.n_failed_chips > 0 or self.n_failed_links > 0

    def summary(self) -> str:
        s = (f"[{self.backend}/{self.mode}x{self.n_chips}] "
             f"{self.cycles:.0f} cycles "
             f"({self.comm_cycles:.0f} inter-chip), "
             f"{self.energy_total / 1e6:.3f} mJ, "
             f"{self.throughput_sps:.1f} samples/s "
             f"(batch={self.batch})")
        if self.degraded:
            s += (f" [degraded: -{self.n_failed_chips} chips, "
                  f"-{self.n_failed_links} links]")
        return s


def _merge_energy(reports: List[EvalReport],
                  interchip_nj: float) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for r in reports:
        for k, v in r.energy.items():
            if k == "total":
                continue
            out[k] = out.get(k, 0.0) + v
    if interchip_nj > 0:
        out["interchip"] = out.get("interchip", 0.0) + interchip_nj
    out["total"] = sum(out.values())
    return out


def evaluate_plan(plan: SystemPlan, chip: Any, reports: List[EvalReport],
                  batch: int, calibration: Any = None,
                  backend_name: str = "analytic") -> SystemReport:
    """Stitch per-chip backend reports into one system report."""
    t0 = time.perf_counter()
    sys = plan.system
    m = machine_for(chip, calibration)
    link, ports = sys.link, sys.boundary_ports
    n = plan.n_chips

    if plan.mode == "pipeline":
        incident = [0.0] * n
        comm = 0.0
        for t in plan.transfers:
            cyc = m.interchip_transfer_cycles(
                t.nbytes * batch, link, hops=t.hops, ports=ports)
            comm += cyc
            incident[t.src_chip] += cyc
            incident[t.dst_chip] += cyc
        cycles = sum(r.cycles for r in reports) + comm
        bottleneck = max(r.cycles + incident[i]
                         for i, r in enumerate(reports))
    else:                                      # tensor
        # collectives ring over the *participating* chips (== the mesh
        # size on a healthy system, fewer under failover)
        comm = sum(m.interchip_collective_cycles(
            c.nbytes * batch, link, n, kind=c.kind,
            ports=ports) for c in plan.collectives)
        cycles = max(r.cycles for r in reports) + comm
        bottleneck = cycles

    interchip_nj = m.interchip_energy_nj(plan.transfer_bytes(batch),
                                         link)
    stitched: Optional[TraceReport] = None
    if plan.mode == "pipeline" and all(r.trace is not None
                                       for r in reports):
        stitched = TraceReport.stitch([r.trace for r in reports],
                                      link_cycles=comm)
    return SystemReport(
        backend=backend_name, cycles=float(cycles),
        energy=_merge_energy(reports, interchip_nj),
        throughput_sps=_throughput(chip, bottleneck, batch),
        batch=batch, wall_s=time.perf_counter() - t0, trace=stitched,
        mode=plan.mode, n_chips=n, comm_cycles=float(comm),
        bottleneck_cycles=float(bottleneck), per_chip=list(reports),
        n_failed_chips=len(sys.failed_chips),
        n_failed_links=len(sys.failed_links))
