"""The ``trace`` fidelity: StagePlan replay at unit/transfer granularity.

Host code: a copy of :mod:`repro.core.trace` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

Sits between the closed-form analytic cost model (§III-C) and the
cycle-accurate simulator (§III-D).  Instead of stepping per-core
instruction streams, it replays each stage as a timeline of
``(group, replica, sample)`` events whose unit costs are derived from
the *same* op-level schedules codegen lowers (``core.oplevel``) and the
*same* :class:`~repro_torch.core.machine.MachineModel` the simulator charges
— so it sees the three effects the analytic model idealizes away:

* **im2col gather work** — the vector-unit cost of staging conv patches
  (dominant on spatial layers; the analytic ``vector_elems`` estimate
  misses it entirely);
* **whole-sample handoffs** — codegen emits an unrolled sample loop
  with blocking SEND/RECV per (producer, consumer, sample), so stages
  pipeline at sample granularity, not the row-chunk granularity the
  analytic fill model assumes;
* **per-sample weight re-streaming / dynamic staging** — weight costs
  derive from the schedules' weight-source metadata: ``streamed``
  groups (columns exceed their cores' free MG slots) re-fetch from
  gmem every round of every sample; ``dynamic`` groups (attention)
  wait on their weight producer's activations, then pay the gather
  V_MOVs and CIM array writes every sample.

Cost: one ``plan_stage`` call per stage plus ``O(groups x replicas x
batch)`` timeline events — typically two to three orders of magnitude
faster than perf-mode simulation, and within its cycle count by design
(the fidelity-agreement suite pins the band).

Replay consults a handful of private geometry helpers from
:mod:`repro_torch.core.codegen` (`_needed_in_rows`, `_out_geometry`, ...) on
purpose: the trace fidelity must mirror what codegen actually emits,
and sharing the helpers keeps the two from drifting.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .arch import ChipConfig
from .codegen import (_conv_rows_to_compute, _core_columns, _in_row_bytes,
                      _main_and_skip_preds, _needed_in_rows, _out_geometry,
                      _owned_out_rows, _pooled_rows, _side_pre_reduce,
                      _side_rows)
from .energy import DEFAULT_TABLE, EnergyTable, energy_breakdown
from .graph import CondensedGraph
from .machine import Calibration, MachineModel, machine_for
from .mapping import StagePlan
from .oplevel import (OpSchedule, ReplicaPlan, incremental_ops,
                      plan_stage)
from .partition import PartitionResult

__all__ = ["TraceReport", "TraceEngine", "trace_model"]


@dataclass
class TraceReport:
    """Trace-fidelity evaluation result (shape mirrors ``SimReport``)."""

    cycles: float
    stage_cycles: List[float]
    events: Dict[str, float]
    unit_busy: Dict[str, float]
    n_events: int                     # replayed timeline events
    table: EnergyTable = DEFAULT_TABLE

    def energy(self, table: Optional[EnergyTable] = None
               ) -> Dict[str, float]:
        return energy_breakdown(self.events, table or self.table)

    def summary(self) -> str:
        e = self.energy()
        return (f"{self.cycles:.0f} cycles (trace, {self.n_events} "
                f"events), {e['total'] / 1e6:.3f} mJ")

    @classmethod
    def stitch(cls, reports: "List[TraceReport]",
               link_cycles: float = 0.0) -> "TraceReport":
        """Concatenate per-chip trace replays into one system-level
        report: chips of a pipeline-parallel plan run their stage lists
        back to back, joined by inter-chip link transfers whose total
        occupancy is ``link_cycles`` (priced by the caller against
        :class:`~repro_torch.core.machine.InterChipLink` — link energy is
        accounted there too, not in this event ledger)."""
        if not reports:
            raise ValueError("stitch needs at least one TraceReport")
        events: Dict[str, float] = {}
        busy: Dict[str, float] = {}
        stage_cycles: List[float] = []
        for r in reports:
            stage_cycles.extend(r.stage_cycles)
            for k, v in r.events.items():
                events[k] = events.get(k, 0.0) + v
            for k, v in r.unit_busy.items():
                busy[k] = busy.get(k, 0.0) + v
        if link_cycles > 0:
            busy["interchip"] = busy.get("interchip", 0.0) + link_cycles
        return cls(cycles=sum(r.cycles for r in reports) + link_cycles,
                   stage_cycles=stage_cycles, events=events,
                   unit_busy=busy,
                   n_events=sum(r.n_events for r in reports),
                   table=reports[0].table)


# ---------------------------------------------------------------------------
# Per-(group, replica) replay profile
# ---------------------------------------------------------------------------


@dataclass
class _Profile:
    """Sample-invariant unit costs of one replica (raw, uncalibrated)."""

    cores: Tuple[int, ...]
    asm_core: int
    main: Optional[int]               # main-input producer gid (None=gmem)
    main_in_member: bool
    in_nb: int                        # needed input bytes per core
    side_inputs: List[Tuple[int, int, bool]] = field(default_factory=list)
    # (sgid, nbytes, producer_in_stage)
    cim: float = 0.0                  # per-sample CIM-unit busy
    vec: float = 0.0                  # per-sample vector busy (asm core)
    noc: float = 0.0                  # per-sample intra-replica NoC busy
    send_issue: float = 0.0           # delivery serialization on asm core
    gst_bytes: int = 0                # boundary-out bytes per sample
    # weight-stream costs, derived from the schedule's weight-source
    # metadata (static: prologue only; streamed: prologue + per-sample
    # gmem re-stream; dynamic: per-sample gather + CIM write, no gmem)
    prologue_gld_bytes: int = 0       # round-0 weight stream (static)
    prologue_cim: float = 0.0         # round-0 CIM_LOAD cycles (per core)
    reload_gld_bytes_tail: int = 0    # rounds >= 1 re-stream (sample 0)
    reload_gld_bytes_full: int = 0    # all rounds re-stream (samples > 0)
    reload_cim_tail: float = 0.0
    reload_cim_full: float = 0.0
    # dynamic weights: producer handoff + per-sample staging costs
    dyn_w: Optional[Tuple[int, int, bool]] = None   # (gid|-1, nb, in_stage)
    dyn_gather_vec: float = 0.0       # gather V_MOVs (per core, max)
    dyn_load_cim: float = 0.0         # CIM_LOAD cycles, all rounds
    # append-only (kv_append) staging: samples > 0 fetch one producer
    # row and re-stage only the tiles it touches (incremental_ops)
    dyn_w_incr: bool = False
    dyn_w_row_nb: int = 0             # appended-row bytes
    dyn_gather_vec_incr: float = 0.0  # per-core max, incremental gather
    dyn_load_cim_incr: float = 0.0    # per-core max, incremental load


def _chunk_shapes(sched: OpSchedule, rep: ReplicaPlan,
                  cg: CondensedGraph) -> Tuple[int, List[int]]:
    """(row_repeats, chunk widths): conv rows share one chunk template."""
    spec = sched.im2col
    if spec is not None:
        y0, y1 = _conv_rows_to_compute(cg, sched, rep)
        widths = [min(spec.wo - x0, sched.m_chunk)
                  for x0 in range(0, spec.wo, sched.m_chunk)]
        return max(0, y1 - y0), widths
    span = max(0, rep.m_hi - rep.m_lo)
    widths = [min(span - c0, sched.m_chunk)
              for c0 in range(0, span, sched.m_chunk)]
    return (1, widths) if widths else (0, [])


def _profile(cg: CondensedGraph, sched: OpSchedule, rep: ReplicaPlan,
             by_gid: Dict[int, OpSchedule], member: set,
             op_owner: Dict[int, int], m: MachineModel) -> _Profile:
    g = cg[sched.gid]
    spec = sched.im2col
    K, N = sched.k_total, sched.n_total
    multi = len(rep.cores) > 1
    vo = sched.vector_ops
    first = next((v for v in vo if v != "bias"), None)
    relu_here = first == "relu"

    main, side = _main_and_skip_preds(cg, g, op_owner)
    in_rows_total = spec.h if spec is not None else 0
    r0, r1 = _needed_in_rows(cg, sched, rep, in_rows_total)
    in_nb = max(0, r1 - r0) * _in_row_bytes(sched)

    p = _Profile(cores=rep.cores, asm_core=rep.cores[0], main=main,
                 main_in_member=(main is not None and main in member),
                 in_nb=in_nb)

    # -- weight load / re-stream / dynamic staging -------------------------
    # all three costs derive from the same MgAssign weight-source
    # metadata codegen lowers (one definition, no drift)
    dyn = sched.weight_source == "dynamic"
    per_core_rows: Dict[Tuple[int, int], float] = {}
    per_core_gather: Dict[int, float] = {}
    for a in rep.assigns:
        nb = a.k_len * a.n_len
        if not dyn:
            if a.round == 0:
                p.prologue_gld_bytes += nb
            else:
                p.reload_gld_bytes_tail += nb
            p.reload_gld_bytes_full += nb
        else:
            per_core_gather[a.core] = per_core_gather.get(a.core, 0.0) \
                + m.vector_cycles("mov", nb)
        key = (a.core, a.round)
        per_core_rows[key] = per_core_rows.get(key, 0.0) \
            + m.weight_load_cycles(a.k_len)
    by_round: Dict[int, float] = {}
    for (c, rnd), cyc in per_core_rows.items():
        by_round[rnd] = max(by_round.get(rnd, 0.0), cyc)
    if dyn:
        # every round's arrays are (re)written every sample, from the
        # RECV'd/GLD'd producer activations resident in local memory;
        # the multi-round path re-loads per m-chunk (codegen's
        # chunk-outer/round-inner emission), single-round loads once
        chunk_f = sched.n_chunks if sched.n_rounds > 1 else 1
        p.dyn_load_cim = sum(by_round.values()) * chunk_f
        p.dyn_gather_vec = max(per_core_gather.values(),
                               default=0.0) * chunk_f
        p.dyn_w = (sched.weight_pred if sched.weight_pred is not None
                   else -1,
                   sched.w_rows * sched.w_row_bytes,
                   sched.weight_pred is not None
                   and sched.weight_pred in member)
        if sched.w_incremental and sched.n_rounds == 1:
            # append-only staging (codegen's incremental emission):
            # per-core cost of re-staging just the appended row's tiles
            gv: Dict[int, float] = {}
            lc: Dict[int, float] = {}
            for a in rep.assigns:
                ops = incremental_ops(g, sched, a)
                if ops is None:
                    continue
                movs, loads = ops
                gv[a.core] = gv.get(a.core, 0.0) + sum(
                    m.vector_cycles("mov", e) for e in movs)
                lc[a.core] = lc.get(a.core, 0.0) + sum(
                    m.weight_load_cycles(r) for r in loads)
            p.dyn_w_incr = True
            p.dyn_w_row_nb = sched.w_row_bytes
            p.dyn_gather_vec_incr = max(gv.values(), default=0.0)
            p.dyn_load_cim_incr = max(lc.values(), default=0.0)
    else:
        p.prologue_cim = by_round.get(0, 0.0)
        p.reload_cim_tail = sum(v for r, v in by_round.items() if r > 0)
        p.reload_cim_full = sum(by_round.values())
        if sched.n_rounds <= 1:
            p.reload_gld_bytes_tail = p.reload_gld_bytes_full = 0
            p.reload_cim_tail = p.reload_cim_full = 0.0

    # -- side (residual / SE-scale) operands -------------------------------
    k0, k1, krow_nb = _side_rows(cg, sched, rep)
    for sgid in side:
        if k1 <= k0:
            break
        nbytes = (k1 - k0) * krow_nb
        prod_sched = by_gid.get(sgid)
        if prod_sched is not None:
            prod_rows, prod_row_nb, _ = _out_geometry(cg, prod_sched)
            if prod_rows == 1 and ((k1 - k0) * krow_nb > krow_nb
                                   or krow_nb != prod_row_nb):
                nbytes = prod_row_nb          # broadcast operand
        p.side_inputs.append((sgid, nbytes, sgid in member))

    # -- compute: chunk template x rows ------------------------------------
    nrows, widths = _chunk_shapes(sched, rep, cg)
    cols_by_core = {c: _core_columns(rep, c) for c in rep.cores}
    for npos in widths:
        # CIM: one MVM burst per round per core (cores fire in parallel)
        p.cim += m.mvm_cycles(npos) * sched.n_rounds * nrows
        # vector gather (per round — re-staged for every round)
        gather = 0.0
        if spec is not None:
            if spec.pad > 0:
                gather += m.vector_cycles("zero", K * npos)
            if spec.depthwise:
                gather += spec.kh * spec.kw \
                    * m.vector_cycles("mov", spec.cin * npos)
            else:
                gather += spec.kh \
                    * m.vector_cycles("mov", spec.kw * spec.cin * npos)
        p.vec += gather * sched.n_rounds * nrows
        # post-ops (last round only); the asm core is the serialization
        # point — its own columns plus assembly of the siblings'
        asm_cols = cols_by_core[p.asm_core]
        post = 0.0
        if "bias" in vo:
            post += sum(m.vector_cycles("add", a.n_len * npos)
                        for a in asm_cols)
        if not multi:
            if relu_here:
                post += m.vector_cycles("relu", npos * N)
            post += m.vector_cycles("quant", npos * N)
        else:
            for a in asm_cols:
                if relu_here:
                    post += m.vector_cycles("relu", a.n_len * npos)
                post += m.vector_cycles("quant", a.n_len * npos)
                post += m.vector_cycles("mov", a.n_len * npos)
            for c in rep.cores[1:]:
                for a in cols_by_core[c]:
                    # sibling SEND + asm RECV + interleave mov
                    p.noc += 2 * m.send_issue_cycles(a.n_len * npos) \
                        * nrows
                    post += m.vector_cycles("mov", a.n_len * npos)
        p.vec += post * nrows

    # -- fused tail (once per sample, on the asm core) ---------------------
    has_side_op = "add" in vo or "mul" in vo
    side_pre = _side_pre_reduce(sched)
    o0, o1 = _owned_out_rows(cg, sched, rep)
    _, out_row_nb, _ = _out_geometry(cg, sched)
    if has_side_op:
        lo, hi, row_nb = (k0, k1, krow_nb) if side_pre \
            else (o0, o1, out_row_nb)
        if hi > lo:
            fn = "mul" if "mul" in vo else "add"
            p.vec += m.vector_cycles(fn, (hi - lo) * row_nb)
            if "relu" in vo and not relu_here:
                p.vec += m.vector_cycles("relu", (hi - lo) * row_nb)
    for vop in vo:
        # fused special tails (softmax/layernorm/gelu) on the asm core
        if vop in ("softmax", "layernorm", "gelu") and o1 > o0:
            p.vec += m.vector_cycles(vop, (o1 - o0) * out_row_nb)
    if sched.pool is not None:
        pl = sched.pool
        if sched.gap:
            plo, phi = _pooled_rows(cg, sched, rep)
        else:
            plo, phi = o0, o1
        per_row = (m.vector_cycles("zero", pl.wo * N)
                   + pl.k * pl.k * m.vector_cycles("max", pl.wo * N))
        p.vec += max(0, phi - plo) * per_row
    if sched.gap:
        if sched.pool is not None:
            plo, phi = _pooled_rows(cg, sched, rep)
            src_pos = max(0, phi - plo) * sched.pool.wo
        elif spec is not None:
            y0, y1 = _conv_rows_to_compute(cg, sched, rep)
            src_pos = max(0, y1 - y0) * spec.wo
        else:
            src_pos = max(0, rep.m_hi - rep.m_lo)
        p.vec += m.vector_cycles("zero", N)
        if src_pos:
            p.vec += m.vector_cycles("sum8", N * src_pos)
        if rep.replica == 0:
            others = len(sched.replicas) - 1
            p.noc += others * m.send_issue_cycles(N * 4)
            p.vec += others * m.vector_cycles("add", N)
            p.vec += m.vector_cycles("quant", N)
        else:
            p.send_issue += m.send_issue_cycles(N * 4)

    # -- delivery ----------------------------------------------------------
    consumers = [h for h in cg if g.idx in h.preds]
    boundary_out = (not consumers) or any(h.idx not in member
                                          for h in consumers)
    my_rows, my_row_nb, _ = _out_geometry(cg, sched)
    if not (sched.gap and rep.replica != 0):
        for h in consumers:
            if h.idx not in member:
                continue
            cons = by_gid[h.idx]
            hmain, _ = _main_and_skip_preds(cg, h, op_owner)
            for crep in cons.replicas:
                if hmain == g.idx:
                    c0, c1 = _needed_in_rows(
                        cg, cons, crep,
                        cons.im2col.h if cons.im2col is not None else 0)
                    crnb = _in_row_bytes(cons)
                    lo_b = max(o0 * my_row_nb, c0 * crnb)
                    hi_b = min(o1 * my_row_nb, c1 * crnb)
                    if hi_b <= lo_b:
                        continue
                    p.send_issue += len(crep.cores) \
                        * m.send_issue_cycles(hi_b - lo_b)
                    continue
                c0, c1, crow_nb = _side_rows(cg, cons, crep)
                if my_rows == 1 and (c1 - c0 != 1 or crow_nb != my_row_nb):
                    if c1 > c0 and o0 == 0 and o1 >= 1:
                        p.send_issue += m.send_issue_cycles(my_row_nb)
                    continue
                lo, hi = max(o0, c0), min(o1, c1)
                if hi > lo:
                    p.send_issue += m.send_issue_cycles(
                        (hi - lo) * out_row_nb)
        if boundary_out and o1 > o0:
            p.gst_bytes = (o1 - o0) * out_row_nb
    return p


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


class TraceEngine:
    """Replays a :class:`PartitionResult` on the shared machine model."""

    def __init__(self, chip: ChipConfig,
                 calibration: Optional[Calibration] = None) -> None:
        self.chip = chip
        self.m = machine_for(chip, calibration)

    # -- gmem port booking -------------------------------------------------

    def _gmem(self, ports: List[float], nbytes: float, t0: float,
              streams: int = 1) -> float:
        """Book ``nbytes`` split over ``streams`` port streams."""
        if nbytes <= 0:
            return t0
        k = max(1, min(streams, len(ports)))
        per = self.m.gmem_stream_cycles(nbytes / k, ports=1) \
            * self.m.calib.gmem
        done = t0
        for j in sorted(range(len(ports)), key=ports.__getitem__)[:k]:
            start = max(t0, ports[j])
            ports[j] = start + per
            done = max(done, ports[j])
        return done

    # -- stage replay ------------------------------------------------------

    def _run_stage(self, cg: CondensedGraph, sp: StagePlan, batch: int,
                   op_owner: Dict[int, int], busy: Dict[str, float]
                   ) -> Tuple[float, int]:
        m, cal = self.m, self.m.calib
        schedules = plan_stage(cg, sp, self.chip)
        by_gid = {s.gid: s for s in schedules}
        member = set(sp.gids)
        profiles: Dict[Tuple[int, int], _Profile] = {}
        for sched in schedules:
            for ri, rep in enumerate(sched.replicas):
                profiles[(sched.gid, ri)] = _profile(
                    cg, sched, rep, by_gid, member, op_owner, m)

        ports = [0.0] * m.gmem_ports
        core_free: Dict[int, float] = {}

        # 1. weight prologue (round 0), replicas stream concurrently
        for sched in schedules:
            for ri, rep in enumerate(sched.replicas):
                p = profiles[(sched.gid, ri)]
                t0 = max((core_free.get(c, 0.0) for c in rep.cores),
                         default=0.0)
                t = self._gmem(ports, p.prologue_gld_bytes, t0,
                               streams=len(rep.cores))
                t += p.prologue_cim * cal.load
                for c in rep.cores:
                    core_free[c] = t

        # 2. unrolled sample loop, groups in stage (= topological) order
        fin: Dict[Tuple[int, int, int], float] = {}
        n_events = 0
        for s in range(batch):
            for sched in schedules:
                for ri, rep in enumerate(sched.replicas):
                    p = profiles[(sched.gid, ri)]
                    n_events += 1
                    t = max(core_free.get(c, 0.0) for c in rep.cores)
                    # input acquisition
                    if p.main_in_member:
                        prod = by_gid[p.main]
                        for pr in range(len(prod.replicas)):
                            src = profiles[(p.main, pr)].asm_core
                            hop = m.hops(src, p.asm_core)
                            arr = fin[(p.main, pr, s)] + cal.noc * (
                                hop * m.router_hop_cycles
                                + m.link_occupancy_cycles(p.in_nb))
                            t = max(t, arr)
                    elif p.in_nb:
                        t = self._gmem(ports, p.in_nb * len(rep.cores), t,
                                       streams=len(rep.cores))
                    for sgid, nbytes, in_stage in p.side_inputs:
                        if in_stage:
                            for pr in range(len(by_gid[sgid].replicas)):
                                arr = fin[(sgid, pr, s)] + cal.noc * (
                                    m.avg_hops * m.router_hop_cycles
                                    + m.link_occupancy_cycles(nbytes))
                                t = max(t, arr)
                        else:
                            t = self._gmem(ports, nbytes, t, streams=1)
                    # dynamic weights: producer handoff + per-sample
                    # gather/CIM-write staging (local memory, no gmem)
                    if p.dyn_w is not None:
                        wgid, w_nb, in_stage = p.dyn_w
                        # append-only cache: steady-state samples fetch
                        # one row and re-stage only the touched tiles
                        # (in-stage producers re-send the full buffer
                        # every sample, so incremental needs gmem src)
                        incr = p.dyn_w_incr and s > 0 and not in_stage
                        if in_stage:
                            for pr in range(len(by_gid[wgid].replicas)):
                                arr = fin[(wgid, pr, s)] + cal.noc * (
                                    m.avg_hops * m.router_hop_cycles
                                    + m.link_occupancy_cycles(w_nb))
                                t = max(t, arr)
                        elif w_nb:
                            nb = p.dyn_w_row_nb if incr else w_nb
                            t = self._gmem(ports, nb * len(rep.cores),
                                           t, streams=len(rep.cores))
                        gv = p.dyn_gather_vec_incr if incr \
                            else p.dyn_gather_vec
                        lc = p.dyn_load_cim_incr if incr \
                            else p.dyn_load_cim
                        t += gv * cal.vector + lc * cal.load
                        nc = len(rep.cores)
                        busy["vector"] = busy.get("vector", 0.0) \
                            + gv * nc
                        busy["cim"] = busy.get("cim", 0.0) \
                            + lc * nc
                    # per-sample weight re-streaming (streamed source)
                    rl_bytes = p.reload_gld_bytes_full if s \
                        else p.reload_gld_bytes_tail
                    rl_cim = p.reload_cim_full if s else p.reload_cim_tail
                    if rl_bytes:
                        t = self._gmem(ports, rl_bytes, t,
                                       streams=len(rep.cores))
                        t += rl_cim * cal.load
                    # decoupled unit pipelines: service = slowest unit
                    dt = max(p.cim * cal.cim, p.vec * cal.vector,
                             p.noc * cal.noc)
                    t_end = t + dt + p.send_issue * cal.noc
                    if p.gst_bytes:
                        t_end = self._gmem(ports, p.gst_bytes, t_end,
                                           streams=1)
                    fin[(sched.gid, ri, s)] = t_end
                    for c in rep.cores:
                        core_free[c] = t_end
                    nc = len(rep.cores)
                    busy["cim"] = busy.get("cim", 0.0) + p.cim * nc
                    busy["vector"] = busy.get("vector", 0.0) + p.vec * nc
                    busy["noc"] = busy.get("noc", 0.0) \
                        + p.noc + p.send_issue
        makespan = max(core_free.values(), default=0.0) * cal.makespan
        return makespan, n_events

    # -- public API --------------------------------------------------------

    def run(self, result: PartitionResult,
            batch: Optional[int] = None) -> TraceReport:
        batch = batch if batch is not None else result.params.batch
        cg = result.cg
        op_owner: Dict[int, int] = {}
        for g in cg:
            for i in g.op_ids:
                op_owner[i] = g.idx
        busy: Dict[str, float] = {}
        stage_cycles: List[float] = []
        n_events = 0
        for sp in result.stages:
            c, n = self._run_stage(cg, sp, batch, op_owner, busy)
            stage_cycles.append(c)
            n_events += n
        total = float(sum(stage_cycles))
        # event ledger: the analytic model's traffic/compute counts are
        # exact for the replayed schedule; only the static term follows
        # the traced makespan
        events = result.energy_events(batch)
        events["static_core_cycles"] = total * self.chip.n_cores
        return TraceReport(cycles=total, stage_cycles=stage_cycles,
                           events=events, unit_busy=busy,
                           n_events=n_events, table=self.m.energy_table)


def trace_model(result: PartitionResult, batch: Optional[int] = None,
                calibration: Optional[Calibration] = None) -> TraceReport:
    """One-shot trace evaluation of a partitioned model."""
    return TraceEngine(result.chip, calibration).run(result, batch)
