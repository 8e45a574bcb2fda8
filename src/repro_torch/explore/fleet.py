"""Fleet evaluation: one compiled program, a batch of chips.

Host code copied from :mod:`repro.explore.fleet` (the JAX package),
with the batched decode on :class:`repro_torch.core.torchsim.
FleetStageDecoder`; the port imports nothing of ``repro``.

A timing sweep — "how do cycles move as scalar/vector/CIM/NoC latencies
change?" — evaluates the *same* compiled program under different
:class:`~repro_torch.core.machine.MachineModel` constants.  The pool-parallel
engine pays a full per-point pipeline for each such point; this module
pays it once:

1. **Canonicalize** — :func:`canonical_chip` resets every timing-only
   field (unit latencies, weight-load rate, NoC rates, clock) to its
   default, leaving the structural fields (cores, macro groups, memory,
   flit width) that actually shape partitioning and codegen.  Points
   sharing a canonical chip share one ``flow.compile``.
2. **Batch-decode** — each stage preps once
   (:meth:`~repro_torch.core.vectorsim.StageDecoder._prep`) and one
   tensor pass over the stacked
   :class:`~repro_torch.core.torchsim.MachineTables` produces every
   machine's per-instruction latencies on the device; the
   machine-independent dataflow half is computed once for the whole
   fleet (:class:`~repro_torch.core.torchsim.FleetStageDecoder`).
3. **Replay per chip** — the shared
   :func:`~repro_torch.core.vectorsim.replay_stage` runs against a
   lightweight shim carrying each point's own ``MachineModel``, so NoC
   arbitration / gmem ports / barriers replay with that machine's
   replay-side constants.

Semantics ("pinned program"): every chip in a group executes the
binary compiled for the group's canonical chip.  For chips that differ
only in the canonicalized timing fields this matches per-point
compilation whenever those fields don't steer the partitioner; the
equivalence contract the tests pin is the sharper one that always
holds — a fleet evaluation equals a loop of
``Simulator(chip_i, engine="torch").run_model`` calls over the same
compiled model.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import flow
from ..core import workloads
from ..core.arch import (ChipConfig, NocConfig, ScalarUnitConfig,
                         VectorUnitConfig)
from ..core.graph import CondensedGraph
from ..core.machine import MachineModel, energy_breakdown, machine_for
from ..core.mapping import CostParams
from ..core.simulator import Simulator
from ..core.torchsim import FleetStageDecoder, StageTiming
from ..core.vectorsim import DecodeUnsupported, replay_stage
from ..device import resolve_device
from ..flow import CompileOptions

__all__ = ["canonical_chip", "FleetEvaluator"]

# default-valued donors for the timing-only fields
_SCALAR_DEFAULT = ScalarUnitConfig()
_VECTOR_DEFAULT = VectorUnitConfig()
_NOC_DEFAULT = NocConfig()
_CIM_WL_DEFAULT = 1            # CimUnitConfig.weight_load_rows_per_cycle


def canonical_chip(chip: ChipConfig) -> ChipConfig:
    """``chip`` with every timing-only field reset to its default.

    Two chips with equal canonical forms describe the same *structure*
    (partitioning / codegen inputs) and may share one compiled program;
    they differ only in the :class:`MachineModel` constants the decode
    and replay passes consume.
    """
    core = chip.core
    vec = core.vector
    return dataclasses.replace(
        chip,
        core=dataclasses.replace(
            core,
            scalar=_SCALAR_DEFAULT,
            vector=dataclasses.replace(
                vec,
                alu_latency=_VECTOR_DEFAULT.alu_latency,
                mul_latency=_VECTOR_DEFAULT.mul_latency,
                special_latency=_VECTOR_DEFAULT.special_latency),
            cim=dataclasses.replace(
                core.cim, weight_load_rows_per_cycle=_CIM_WL_DEFAULT)),
        noc=dataclasses.replace(
            chip.noc,
            flits_per_cycle=_NOC_DEFAULT.flits_per_cycle,
            router_latency=_NOC_DEFAULT.router_latency,
            inject_latency=_NOC_DEFAULT.inject_latency),
        clock_ghz=1.0,
        # labels are cosmetic (the flow cache already ignores them) but
        # enter ChipConfig equality — normalize so same-structure chips
        # group into one compile
        name="canonical")


class _ShimSim:
    """The two attributes :func:`replay_stage` reads from a Simulator."""

    __slots__ = ("m", "max_cycles")

    def __init__(self, m: MachineModel, max_cycles: float) -> None:
        self.m = m
        self.max_cycles = max_cycles


def _err_payload(e: Exception) -> Dict[str, Any]:
    return {"cycles": float("inf"), "energy": {"total": float("inf")},
            "throughput_sps": 0.0, "wall_s": 0.0,
            "error": f"{type(e).__name__}: {e}"}


class FleetEvaluator:
    """Batched perf-simulator evaluation of many chips on one workload.

    ``model`` may be a workload name or an already-condensed graph.
    The stage decode runs on ``device`` (CUDA unless named; raises
    without a card); a :class:`~repro_torch.core.torchsim.StageTiming`
    given as ``timing`` adds up the split of every decode.
    """

    def __init__(self, model: Union[str, CondensedGraph],
                 params: Optional[CostParams] = None,
                 max_cycles: float = 5e9,
                 device: Union[str, torch.device, None] = None,
                 timing: Optional[StageTiming] = None,
                 **workload_kw: Any) -> None:
        self.params = params or CostParams(batch=4)
        self.max_cycles = max_cycles
        self.device = resolve_device(device)
        self.timing = timing
        if isinstance(model, str):
            self._cg: Optional[CondensedGraph] = None
            self.model = model
            self.workload_kw = dict(workload_kw)
        else:
            self._cg = model
            self.model = getattr(model, "name", "<graph>")
            self.workload_kw = dict(workload_kw)

    @property
    def cg(self) -> CondensedGraph:
        if self._cg is None:
            self._cg = workloads.build(self.model,
                                       **self.workload_kw).condense()
        return self._cg

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, jobs: Sequence[Tuple[ChipConfig, str]]
                 ) -> List[Dict[str, Any]]:
        """Evaluate ``(chip, strategy)`` jobs at simulate/perf fidelity.

        Returns payload dicts in input order (``cycles`` / ``energy`` /
        ``throughput_sps`` / ``wall_s``, or an ``error`` entry for
        point-local failures) — the same shape the exploration engine
        caches and wraps into :class:`EvalRecord`.
        """
        results: List[Optional[Dict[str, Any]]] = [None] * len(jobs)
        groups: Dict[Tuple[ChipConfig, str], List[int]] = {}
        for i, (chip, strategy) in enumerate(jobs):
            try:
                key = (canonical_chip(chip), strategy)
            except Exception as e:       # noqa: BLE001 — bad chip
                results[i] = _err_payload(e)
                continue
            groups.setdefault(key, []).append(i)
        for (canon, strategy), idxs in groups.items():
            chips = [jobs[i][0] for i in idxs]
            for i, payload in zip(idxs,
                                  self._eval_group(canon, strategy,
                                                   chips)):
                results[i] = payload
        return results           # type: ignore[return-value]

    def _eval_group(self, canon: ChipConfig, strategy: str,
                    chips: List[ChipConfig]) -> List[Dict[str, Any]]:
        t0 = time.perf_counter()
        try:
            art = flow.compile(self.cg, canon,
                               CompileOptions(strategy=strategy,
                                              params=self.params,
                                              fidelity="simulate"))
            cm = art.ensure_model()
        except Exception as e:           # noqa: BLE001 — group-level
            return [_err_payload(e) for _ in chips]
        return self._eval_model(cm, chips, t0)

    def _eval_model(self, cm: Any, chips: Sequence[ChipConfig],
                    t0: float) -> List[Dict[str, Any]]:
        """Payloads of one compiled model ``cm`` on each of ``chips``
        (which share the structure ``cm`` was compiled for), in order:
        each stage decodes once for all of them.  ``wall_s`` is the
        time since ``t0`` over the chips."""
        chips = list(chips)
        n = len(chips)
        machines = [machine_for(c) for c in chips]
        dec = FleetStageDecoder(cm.isa, machines, self.device)
        dec.timing = self.timing
        shims = [_ShimSim(m, self.max_cycles) for m in machines]
        scalar_sims: List[Optional[Simulator]] = [None] * n

        stage_cycles: List[List[float]] = [[] for _ in range(n)]
        events: List[Dict[str, float]] = [{} for _ in range(n)]
        busy: List[Dict[str, float]] = [{} for _ in range(n)]
        instrs = [0] * n
        err: List[Optional[str]] = [None] * n

        for sp in cm.stages:
            try:
                outs = dec.decode_stage(sp.programs)
            except DecodeUnsupported:
                outs = None              # scalar fallback, per chip
            for i in range(n):
                if err[i] is not None:
                    continue
                try:
                    if outs is None:
                        sim = scalar_sims[i]
                        if sim is None:
                            sim = scalar_sims[i] = Simulator(
                                chips[i], cm.isa, engine="scalar",
                                max_cycles=self.max_cycles)
                        out = sim._run_stage(sp, None)
                    else:
                        out = replay_stage(shims[i], sp, outs[i])
                except Exception as e:   # noqa: BLE001 — point-local
                    err[i] = f"{type(e).__name__}: {e}"
                    continue
                c, ev, bz, ni = out
                stage_cycles[i].append(c)
                instrs[i] += ni
                for k, v in ev.items():
                    events[i][k] = events[i].get(k, 0.0) + v
                for k, v in bz.items():
                    busy[i][k] = busy[i].get(k, 0.0) + v

        wall = (time.perf_counter() - t0) / n
        payloads: List[Dict[str, Any]] = []
        for i, chip in enumerate(chips):
            if err[i] is not None:
                payloads.append({"cycles": float("inf"),
                                 "energy": {"total": float("inf")},
                                 "throughput_sps": 0.0, "wall_s": wall,
                                 "error": err[i]})
                continue
            # identical aggregation to Simulator.run_model /
            # SimulatorBackend.evaluate — same events, same pricing
            total = float(sum(stage_cycles[i]))
            events[i]["static_core_cycles"] = total * chip.n_cores
            energy = dict(energy_breakdown(events[i],
                                           machines[i].energy_table))
            sps = (0.0 if total <= 0
                   else cm.batch / (total / (chip.clock_ghz * 1e9)))
            payloads.append({"cycles": total, "energy": energy,
                             "throughput_sps": sps, "wall_s": wall})
        return payloads

    def report(self, chip: ChipConfig, strategy: str) -> Dict[str, Any]:
        """Single-chip convenience wrapper around :meth:`evaluate`."""
        return self.evaluate([(chip, strategy)])[0]
