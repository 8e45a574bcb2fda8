"""Core mapping + analytic cost model (paper §III-C, ``OptimalMapping``).

Host code: a copy of :mod:`repro.core.mapping` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

Given a candidate partition *stage* (a set of condensed-CG groups) and the
hardware resources, this module decides

* how many MG-tiles each group needs (weight → macro allocation, organized
  along output channels; block-diagonal packing for grouped/depth-wise conv);
* how many cores each group occupies and its **duplication factor** — the
  paper's key lever: replicating an operator's weights across clusters of
  cores buys parallel throughput at the price of extra weight-load and
  input-multicast traffic;
* the resulting stage cost: weight-(re)load cycles + pipeline fill +
  steady-state interval per sample, plus an energy-event ledger.

Execution model (documented assumptions; the cycle-accurate simulator is the
ground truth, this model guides the DP search):

* Stages run **sequentially**: load stage weights, stream the whole batch
  through the stage's inter-operator pipeline, spill boundary activations to
  global memory, move on.  This is the capacity-wall execution the paper
  targets.
* Within a stage each group occupies its own cluster of cores (several small
  groups may share a core — their intervals then serialize).
* A replica processes one im2col input vector per ``act_bits`` beats
  (bit-serial), all its MG-tiles firing in parallel; ``dup`` replicas split
  ``gemm_m``.
* Input multicast: each extra replica re-receives ``alpha x in_bytes``
  (``alpha = 1`` — conservative full broadcast, matching the MG input
  broadcast organization).
* Oversized groups (weights exceed whole-chip MG capacity) execute in
  ``rounds`` with weight streaming.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .arch import ChipConfig
from .graph import CondensedGraph, Group
from .machine import Calibration, MachineModel, machine_for

__all__ = [
    "CostParams", "GroupAlloc", "StagePlan", "mg_tiles", "min_cores",
    "optimal_mapping", "generic_mapping", "opportunistic_mapping",
    "gmem_footprint_bytes",
]


def gmem_footprint_bytes(groups: "Iterable") -> int:
    """Resident global-memory footprint of a set of groups, per chip.

    Static and streamed weights live in gmem for the whole run (streamed
    groups re-fetch from there every round) — they are the *resident*
    term and the capacity wall.  Dynamic weights are activations and
    never materialize; boundary activations stream through gmem
    transiently (stage-sequential execution frees a blob once the
    consumer stage drains it) and are excluded.  The system-level
    partitioner uses this as the per-chip capacity rule — one chip's
    16 MB gmem is the wall that forces multi-chip plans.  The legacy
    single-chip path stays unguarded for backwards compatibility.
    """
    return sum(g.weight_bytes for g in groups
               if g.weight_source != "dynamic")


@dataclass(frozen=True)
class CostParams:
    """Knobs of the analytic cost model."""

    batch: int = 32                # samples streamed per stage
    # Duplication splits a group's work along its spatial/batch dimension:
    # each replica receives only its input slice, plus a halo overlap for
    # convolutions.  ``dup_halo`` is the per-extra-replica traffic overhead.
    dup_halo: float = 0.15
    max_dup: int = 64              # duplication search bound
    # Inter-operator pipelines stream at *row-chunk* granularity: a consumer
    # starts once its producer has emitted the few rows its kernel needs, so
    # the fill contribution of a spatial (gemm_m > 1) group is only a
    # fraction of its per-sample latency.  FC-like groups (gemm_m == 1)
    # contribute their full latency.
    pipeline_fill_frac: float = 0.1
    # static (leakage + clock-tree) power per core, as a fraction of one
    # core's peak dynamic power — makes latency savings show up as energy
    # savings, the dominant effect behind the paper's energy wins.
    static_frac: float = 0.35


# ---------------------------------------------------------------------------
# Geometry: group -> MG tiles
# ---------------------------------------------------------------------------


def mg_tiles(g: Group, chip: ChipConfig) -> int:
    """MG-tiles needed to hold one replica of the group's weights."""
    if not g.is_mvm or g.weight_bytes == 0 and g.macs == 0:
        return 0
    cim = chip.core.cim
    rows, n_out = cim.macro.rows, cim.group_n_out
    if g.groups == 1:
        tk = math.ceil(g.gemm_k / rows)
        tn = math.ceil(g.gemm_n / n_out)
        return tk * tn
    # grouped / depth-wise: block-diagonal packing.  Each MG pass computes
    # ``ch`` conv-groups: their input patches concatenated along rows,
    # each group's outputs on its own columns.
    ch = max(1, min(rows // max(g.gemm_k, 1), n_out // max(g.gemm_n, 1)))
    if g.gemm_k <= rows and g.gemm_n <= n_out:
        return math.ceil(g.groups / ch) * math.ceil(g.gemm_n / n_out)
    # giant grouped op (per-group K or N exceeds one MG): per-group tiling
    tk = math.ceil(g.gemm_k / rows)
    tn = math.ceil(g.gemm_n / n_out)
    return g.groups * tk * tn


def column_geometry(g: Group, chip: ChipConfig) -> Tuple[int, int]:
    """(n_columns, slots_per_column).

    A *column* is the set of k-tiles of one n-tile; its INT32 partial sums
    accumulate locally, so all its tiles must land on one core (mirrors
    :func:`repro.core.oplevel._n_tile_columns`).
    """
    cim = chip.core.cim
    rows, n_out = cim.macro.rows, cim.group_n_out
    if g.groups == 1:
        return (math.ceil(max(g.gemm_n, 1) / n_out),
                max(1, math.ceil(g.gemm_k / rows)))
    ch = max(1, min(rows // max(g.gemm_k, 1), n_out // max(g.gemm_n, 1)))
    if g.gemm_k > rows or g.gemm_n > n_out:
        return (g.groups * math.ceil(max(g.gemm_n, 1) / n_out),
                math.ceil(g.gemm_k / rows))
    return math.ceil(g.groups / ch), 1


def column_rows(g: Group, chip: ChipConfig) -> int:
    """Weight rows of one n-column (the CIM_LOAD row count a core pays
    per column when (re)writing its arrays — streamed/dynamic costing)."""
    cim = chip.core.cim
    rows, n_out = cim.macro.rows, cim.group_n_out
    if g.groups == 1 or g.gemm_k > rows or g.gemm_n > n_out:
        return max(g.gemm_k, 1)
    ch = max(1, min(rows // max(g.gemm_k, 1), n_out // max(g.gemm_n, 1)))
    return min(ch, g.groups) * g.gemm_k


def min_cores(g: Group, chip: ChipConfig) -> int:
    """Minimum cores to hold one replica (0 for anchor-less groups).

    Column-granular: all k-tiles of an n-column co-locate on one core, so
    a core hosts ``floor(slots / col_size)`` columns.  Groups whose column
    exceeds a core's slots (huge-K FC layers) stream in rounds instead.
    """
    t = mg_tiles(g, chip)
    if t == 0:
        return 1                   # still needs a core to run vector work
    slots = chip.core.cim.n_macro_groups
    ncol, colsz = column_geometry(g, chip)
    per_core = max(1, slots // colsz)
    return min(math.ceil(ncol / per_core), chip.n_cores)


# ---------------------------------------------------------------------------
# Allocation records
# ---------------------------------------------------------------------------


@dataclass
class GroupAlloc:
    """One group's placement within a stage."""

    gid: int
    tiles: int                 # MG tiles per replica
    cores: int                 # cores per replica
    dup: int                   # replicas
    rounds: int                # weight-streaming rounds (oversized groups)
    percore_slots: int         # MG slots needed on each allocated core
    boundary_in: bool          # inputs come from global memory
    # weight source of this allocation: "static" (gmem prologue),
    # "streamed" (gmem re-stream, ``rounds`` per sample) or "dynamic"
    # (a predecessor's activations, CIM-written every sample)
    weight_source: str = "static"
    col_slots: int = 1         # MG slots one n-column needs (placement)
    # per-sample cycle components (after duplication)
    compute: float = 0.0
    vector: float = 0.0
    comm: float = 0.0
    comm_gmem: float = 0.0     # gmem share of ``comm`` (boundary streams)
    fill_frac: float = 1.0     # chunked-pipelining fill fraction
    load_bytes: int = 0        # weight bytes fetched at stage start (x dup)

    @property
    def total_cores(self) -> int:
        return self.cores * self.dup

    def components(self, calib: Optional[Calibration] = None
                   ) -> Tuple[float, float, float]:
        """(compute, vector, comm) per-sample cycles, optionally scaled
        by per-unit calibration factors (``comm`` splits into its gmem
        and NoC shares so each takes its own factor)."""
        if calib is None or calib.is_identity:
            return self.compute, self.vector, self.comm
        noc_part = self.comm - self.comm_gmem
        return (self.compute * calib.cim,
                self.vector * calib.vector,
                self.comm_gmem * calib.gmem + noc_part * calib.noc)

    def interval_c(self, calib: Optional[Calibration] = None) -> float:
        return max(self.components(calib))

    def latency_c(self, calib: Optional[Calibration] = None) -> float:
        return sum(self.components(calib))

    def fill_c(self, calib: Optional[Calibration] = None) -> float:
        return self.latency_c(calib) * self.fill_frac

    @property
    def interval(self) -> float:
        return self.interval_c()

    @property
    def latency(self) -> float:
        return self.latency_c()

    @property
    def fill(self) -> float:
        """Pipeline-fill contribution (row-chunk streaming)."""
        return self.fill_c()


@dataclass
class StagePlan:
    """A mapped stage with its cost and energy-event ledger."""

    gids: Tuple[int, ...]
    allocs: List[GroupAlloc]
    chip: ChipConfig
    params: CostParams
    shared_cores: bool = False          # groups time-share cores
    bases: Optional[List[int]] = None   # base core per alloc (place_stage)

    # -- derived costs -------------------------------------------------------

    @property
    def machine(self) -> MachineModel:
        """The shared timing/energy model (uncalibrated; calibration is
        applied per evaluation via the ``calib`` arguments)."""
        return machine_for(self.chip)

    @property
    def cores_used(self) -> int:
        return min(self.chip.n_cores,
                   sum(a.total_cores for a in self.allocs))

    def interval_c(self, calib: Optional[Calibration] = None) -> float:
        """Steady-state cycles per sample."""
        if self.shared_cores:
            # groups serialize on shared cores: intervals add, scaled by
            # how over-subscribed the chip is.
            return sum(a.interval_c(calib) for a in self.allocs)
        return max((a.interval_c(calib) for a in self.allocs),
                   default=0.0)

    def fill_cycles(self, calib: Optional[Calibration] = None) -> float:
        """Latency of the first sample through the stage pipeline.

        Groups stream row-chunks to their successors, so spatial groups
        contribute only a fraction of their per-sample latency; the last
        group completes a full sample.
        """
        if not self.allocs:
            return 0.0
        return (sum(a.fill_c(calib) for a in self.allocs[:-1])
                + self.allocs[-1].latency_c(calib))

    def load_cycles_c(self, calib: Optional[Calibration] = None) -> float:
        """Weight (re)load at stage start (gmem stream + array write)."""
        m = self.machine
        total_bytes = sum(a.load_bytes for a in self.allocs)
        gmem = m.gmem_stream_cycles(total_bytes)
        # array row writes happen in parallel across cores; dynamic
        # groups have no prologue (their weights are written per sample
        # from a predecessor's activations — priced in the interval)
        per_core_tiles = max(
            (math.ceil(a.tiles / max(a.cores, 1)) * a.rounds
             for a in self.allocs if a.weight_source != "dynamic"),
            default=0)
        write = per_core_tiles * m.group_load_cycles()
        cycles = max(gmem, write)
        return cycles * calib.load if calib is not None else cycles

    @property
    def interval(self) -> float:
        return self.interval_c()

    @property
    def fill(self) -> float:
        return self.fill_cycles()

    @property
    def load_cycles(self) -> float:
        return self.load_cycles_c()

    def latency_cycles(self, batch: Optional[int] = None,
                       calib: Optional[Calibration] = None) -> float:
        b = batch if batch is not None else self.params.batch
        cycles = (self.load_cycles_c(calib) + self.fill_cycles(calib)
                  + max(0, b - 1) * self.interval_c(calib))
        if calib is not None:
            cycles *= calib.makespan
        return cycles

    # -- energy event ledger (consumed by core.energy) ------------------------

    def energy_events(self, batch: Optional[int] = None,
                      calib: Optional[Calibration] = None
                      ) -> Dict[str, float]:
        b = batch if batch is not None else self.params.batch
        chip = self.chip
        m = self.machine
        ev: Dict[str, float] = {
            "cim_macro_passes": 0.0, "cim_weight_load_bytes": 0.0,
            "vector_elems": 0.0, "noc_byte_hops": 0.0,
            "gmem_bytes": 0.0, "lmem_bytes": 0.0,
        }
        avg_hops = m.avg_hops
        for a in self.allocs:
            g = self._group(a.gid)
            # one pass activates `tiles` MGs = tiles*macros_per_group macros
            passes = g.gemm_m * b * a.tiles * m.macros_per_group
            ev["cim_macro_passes"] += passes
            if a.weight_source == "dynamic":
                if g.weight_incremental and a.rounds == 1:
                    # append-only cache: full staging once, then only
                    # the appended row's tiles re-write per sample
                    no = chip.core.cim.group_n_out
                    if g.transpose_weights:
                        incr_b = g.groups * g.gemm_k * min(g.gemm_n, no)
                    else:
                        incr_b = g.groups * g.gemm_n
                    ev["cim_weight_load_bytes"] += (
                        g.weight_bytes + incr_b * max(b - 1, 0)) * a.dup
                else:
                    # macro arrays rewritten from activations every
                    # sample
                    ev["cim_weight_load_bytes"] += g.weight_bytes \
                        * a.dup * b
            elif a.weight_source == "streamed":
                ev["cim_weight_load_bytes"] += a.load_bytes * b
            else:
                ev["cim_weight_load_bytes"] += a.load_bytes
            ev["vector_elems"] += g.vector_elems * b
            halo = self.params.dup_halo if (g.gemm_m > 1 and a.dup > 1) \
                else 0.0
            in_bytes = g.in_bytes
            if a.weight_source == "dynamic" and g.weight_incremental \
                    and a.rounds == 1:
                # the cache operand is part of in_bytes, but append-only
                # growth only moves the new row per steady-state sample
                row_b = (g.gemm_k if g.transpose_weights
                         else g.gemm_n) * g.groups
                in_bytes = max(in_bytes - g.weight_bytes, 0) + row_b
            in_traffic = in_bytes * (1 + halo * (a.dup - 1) / a.dup) * b
            if a.boundary_in:
                ev["gmem_bytes"] += in_traffic
            else:
                ev["noc_byte_hops"] += in_traffic * avg_hops
            ev["lmem_bytes"] += (g.in_bytes + g.out_bytes) * b
        # boundary outputs spill to gmem (approx: last groups of the stage)
        member = set(self.gids)
        for a in self.allocs:
            g = self._group(a.gid)
            if not any(s in member for s in self._consumers(g)):
                ev["gmem_bytes"] += g.out_bytes * b
        ev["static_core_cycles"] = (self.latency_cycles(b, calib)
                                    * chip.n_cores)
        return ev

    # -- plumbing -------------------------------------------------------------

    _groups_ref: Optional[CondensedGraph] = None

    def bind(self, cg: CondensedGraph) -> "StagePlan":
        self._groups_ref = cg
        return self

    def _group(self, gid: int) -> Group:
        assert self._groups_ref is not None, "StagePlan not bound to a CG"
        return self._groups_ref[gid]

    def _consumers(self, g: Group) -> List[int]:
        assert self._groups_ref is not None
        return [h.idx for h in self._groups_ref if g.idx in h.preds]

    def describe(self) -> str:
        rows = [f"stage{{{','.join(map(str, self.gids))}}} "
                f"cores={self.cores_used} interval={self.interval:.0f} "
                f"load={self.load_cycles:.0f}"]
        for a in self.allocs:
            rows.append(
                f"  g{a.gid}: tiles={a.tiles} cores={a.cores}x{a.dup}"
                f" cyc(c/v/m)={a.compute:.0f}/{a.vector:.0f}/{a.comm:.0f}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# Per-group cycle components
# ---------------------------------------------------------------------------


def _alloc_group(g: Group, chip: ChipConfig, params: CostParams,
                 dup: int, boundary_in: bool) -> GroupAlloc:
    cim = chip.core.cim
    m = machine_for(chip)
    tiles = mg_tiles(g, chip)
    chip_tiles = chip.n_cores * cim.n_macro_groups
    eff_tiles = min(tiles, chip_tiles)
    cores = min_cores(g, chip)
    # weight-streaming rounds: per-core slot pressure at column
    # granularity.  Sized for the FULL slot range — when place_stage
    # later time-shares the core, the op-level plan cycles more rounds
    # through the smaller free range, so this is a (documented) lower
    # bound for co-resident streamers; trace/perf price the real count.
    if tiles:
        ncol, colsz = column_geometry(g, chip)
        slots_needed = math.ceil(ncol / cores) * colsz
        rounds = max(1, math.ceil(slots_needed / cim.n_macro_groups))
    else:
        ncol, colsz = 0, 1
        slots_needed = 0
        rounds = 1
    source = g.weight_source if (g.is_mvm and tiles) else "static"
    if source == "static" and rounds > 1:
        source = "streamed"

    m_per_rep = math.ceil(g.gemm_m / dup) if g.gemm_m else 0
    compute = (m_per_rep * m.mvm_interval_beats * rounds
               + m.mvm_fill_beats) if g.is_mvm else 0.0

    vector = g.vector_elems / (m.vector_lanes * max(cores, 1)) / dup if \
        g.vector_elems else 0.0

    # per-round CIM array (re)writes: streamed and dynamic weights are
    # written into macro groups *every sample*; a static group pays this
    # once in the stage prologue (load_cycles) instead.  (Lower bound:
    # the dynamic multi-round path additionally re-loads per m-chunk,
    # which only op-level planning can see — trace prices it exactly.)
    if source != "static":
        if source == "dynamic" and g.weight_incremental and rounds == 1:
            # append-only (KV-cache) steady state: only the tiles
            # covering the appended producer row re-stage — per head,
            # one column (row-granular tile rewrite of the head dim)
            # for Q·Kᵀ, one weight row for P·V.  O(1) in the cache
            # length; sample 0's full staging amortizes away (trace
            # prices it exactly).
            heads_pc = math.ceil(max(g.groups, 1) / max(cores, 1))
            if g.transpose_weights:
                compute += m.weight_load_cycles(heads_pc * g.gemm_k)
                vector += m.vector_cycles("mov", heads_pc * g.gemm_k)
            else:
                compute += m.weight_load_cycles(heads_pc)
                vector += m.vector_cycles("mov", heads_pc * g.gemm_n)
        else:
            rows_pc = math.ceil(ncol / cores) * column_rows(g, chip)
            compute += m.weight_load_cycles(rows_pc)
            if source == "dynamic":
                # gather-transpose staging of the producer's activations
                # into the CIM write layout (vector unit, per core)
                w_elems = g.gemm_k * g.gemm_n * g.groups
                vector += m.vector_cycles(
                    "mov", math.ceil(w_elems / max(cores, 1)))

    # Input delivery.  Replicas own disjoint spatial/batch slices: each
    # receives in_bytes/dup (+ conv halo) over its own mesh port, so the
    # per-sample comm interval scales down with duplication — this is the
    # communication side of the paper's duplicate-vs-communicate trade-off.
    halo = params.dup_halo if (g.gemm_m > 1 and dup > 1) else 0.0
    in_bytes = g.in_bytes
    if source == "dynamic" and g.weight_incremental and rounds == 1:
        # cache operand rides in in_bytes; append-only growth streams
        # one new row per steady-state sample, not the whole buffer
        row_b = (g.gemm_k if g.transpose_weights else g.gemm_n) * g.groups
        in_bytes = max(in_bytes - g.weight_bytes, 0) + row_b
    in_traffic = in_bytes * (1 + halo * (dup - 1) / dup)
    comm_gmem = 0.0
    if boundary_in:
        # gmem streams are a shared resource
        comm_gmem = m.gmem_stream_cycles(in_traffic)
        comm = comm_gmem
    else:
        comm = in_traffic / (m.link_bytes_per_cycle * dup)
        comm += m.router_hop_cycles * m.avg_hops
    # output delivery to the next group / gmem, likewise port-parallel
    comm += g.out_bytes / (m.link_bytes_per_cycle * dup)
    if source == "streamed":
        # multi-round groups re-fetch their weights from gmem per sample
        restream = m.gmem_stream_cycles(g.weight_bytes * dup)
        comm_gmem += restream
        comm += restream

    fill_frac = params.pipeline_fill_frac if g.gemm_m > 4 else 1.0
    return GroupAlloc(
        gid=g.idx, tiles=eff_tiles, cores=cores, dup=dup, rounds=rounds,
        percore_slots=min(slots_needed, cim.n_macro_groups),
        boundary_in=boundary_in, weight_source=source,
        col_slots=min(colsz, cim.n_macro_groups),
        compute=float(compute), vector=float(vector),
        comm=float(comm), comm_gmem=float(comm_gmem), fill_frac=fill_frac,
        # every replica fetches the full static weights once per stage
        # execution; dynamic weights never touch gmem (they arrive as a
        # predecessor's activations and are priced per sample above)
        load_bytes=0 if source == "dynamic" else g.weight_bytes * dup)


def place_stage(allocs: Sequence["GroupAlloc"],
                chip: ChipConfig) -> Optional[List[int]]:
    """First-fit placement of a stage's groups onto the core grid.

    Returns one base core per alloc (replicas occupy consecutive
    ``cores``-wide windows from there), such that no core's MG-slot
    occupancy exceeds the CIM unit — or ``None`` if no placement exists.
    Weight-streaming groups (rounds > 1) take every remaining slot of
    their window: they *prefer* an exclusive window (their round count
    was sized for the full slot range) but may time-share a core as
    long as one n-column's worth of slots is free — the op-level
    planner then cycles the rounds through the group's own slot range
    above its co-residents.  This is the single source of truth for
    stage feasibility: the cost model and the code generator both use
    it.
    """
    slots = chip.core.cim.n_macro_groups
    occ = [0] * chip.n_cores
    # place big groups first for tighter packing, but report in input order
    order = sorted(range(len(allocs)),
                   key=lambda i: -(allocs[i].total_cores * 1000
                                   + allocs[i].percore_slots))
    result = [0] * len(allocs)
    for i in order:
        a = allocs[i]
        need = min(a.total_cores, chip.n_cores)
        placed = False
        if a.rounds > 1:
            passes = ("exclusive", "shared")
        else:
            passes = ("additive",)
        for mode in passes:
            for base in range(0, chip.n_cores - need + 1):
                window = occ[base:base + need]
                # exact additive accounting: final per-core occupancy is
                # order-independent, so codegen (stage order) can never
                # overflow a placement validated here (size order)
                if mode == "exclusive":
                    ok = all(o == 0 for o in window)
                elif mode == "shared":
                    ok = all(o + a.col_slots <= slots for o in window)
                else:
                    ok = all(o + a.percore_slots <= slots for o in window)
                if ok:
                    for c in range(base, base + need):
                        occ[c] = slots if a.rounds > 1 \
                            else occ[c] + a.percore_slots
                    result[i] = base
                    placed = True
                    break
            if placed:
                break
        if not placed:
            return None
    return result


def needs_streaming(g: Group, chip: ChipConfig) -> bool:
    """Group's columns exceed its minimal allocation's slots -> it must
    re-stream weights every sample and monopolizes its stage."""
    if mg_tiles(g, chip) == 0:
        return False
    ncol, colsz = column_geometry(g, chip)
    cores = min_cores(g, chip)
    return math.ceil(ncol / cores) * colsz > chip.core.cim.n_macro_groups


def _stage_feasible(groups: Sequence[Group], chip: ChipConfig) -> bool:
    """A stage is feasible if its groups jointly fit the chip's MG
    capacity (time-sharing of cores allowed).  A weight-streaming group
    contributes the slots of the cores it monopolizes, not its (larger)
    nominal tile count — it may share a stage; :func:`place_stage` is
    the final arbiter."""
    slots = chip.core.cim.n_macro_groups
    chip_tiles = chip.n_cores * slots
    total = sum(min(mg_tiles(g, chip), min_cores(g, chip) * slots)
                for g in groups)
    return total <= chip_tiles or len(groups) == 1


# ---------------------------------------------------------------------------
# Mapping strategies
# ---------------------------------------------------------------------------


def _boundary_flags(groups: Sequence[Group], stage_set: set) -> Dict[int, bool]:
    flags = {}
    for g in groups:
        flags[g.idx] = (not g.preds) or any(p not in stage_set
                                            for p in g.preds)
    return flags


def generic_mapping(cg: CondensedGraph, gids: Sequence[int],
                    chip: ChipConfig, params: CostParams) -> Optional[StagePlan]:
    """Baseline 1 (§IV-B): inter-layer pipeline, **no duplication**."""
    groups = [cg[i] for i in gids]
    if not _stage_feasible(groups, chip):
        return None
    stage_set = set(gids)
    flags = _boundary_flags(groups, stage_set)
    allocs = [_alloc_group(g, chip, params, dup=1,
                           boundary_in=flags[g.idx]) for g in groups]
    bases = place_stage(allocs, chip)
    if bases is None:
        return None
    shared = sum(a.total_cores for a in allocs) > chip.n_cores
    return StagePlan(tuple(gids), allocs, chip, params,
                     shared_cores=shared, bases=bases).bind(cg)


def _improve_duplication(cg: CondensedGraph, allocs: List[GroupAlloc],
                         chip: ChipConfig, params: CostParams,
                         flags: Dict[int, bool]) -> List[GroupAlloc]:
    """Greedy duplication hillclimb: repeatedly replicate the bottleneck
    group while cores remain and the stage interval improves."""
    def used() -> int:
        return sum(a.total_cores for a in allocs)

    while True:
        free = chip.n_cores - used()
        if free <= 0:
            break
        # current bottleneck
        order = sorted(range(len(allocs)), key=lambda i: -allocs[i].interval)
        improved = False
        for i in order:
            a = allocs[i]
            g = cg[a.gid]
            # duplication splits gemm_m positions and/or batch samples
            dup_cap = min(params.max_dup, max(g.gemm_m, 1) * params.batch)
            if not g.is_mvm or a.dup >= dup_cap or a.rounds > 1:
                continue
            if a.cores > free:
                continue
            cand = _alloc_group(g, chip, params, dup=a.dup + 1,
                                boundary_in=flags[a.gid])
            if cand.interval < a.interval - 1e-9:
                trial = list(allocs)
                trial[i] = cand
                if place_stage(trial, chip) is None:
                    continue
                allocs[i] = cand
                improved = True
                break
        if not improved:
            break
    return allocs


def optimal_mapping(cg: CondensedGraph, gids: Sequence[int],
                    chip: ChipConfig, params: CostParams) -> Optional[StagePlan]:
    """The paper's ``OptimalMapping(stage, R)``: joint core allocation +
    weight duplication minimizing the stage's steady-state interval."""
    base = generic_mapping(cg, gids, chip, params)
    if base is None:
        return None
    if base.shared_cores:
        return base            # no spare cores to duplicate into
    stage_set = set(gids)
    flags = _boundary_flags([cg[i] for i in gids], stage_set)
    allocs = _improve_duplication(cg, list(base.allocs), chip, params, flags)
    bases = place_stage(allocs, chip)
    if bases is None:           # should not happen (hillclimb checked)
        return base
    return StagePlan(tuple(gids), allocs, chip, params,
                     bases=bases).bind(cg)


def opportunistic_mapping(cg: CondensedGraph, gids: Sequence[int],
                          chip: ChipConfig,
                          params: CostParams) -> Optional[StagePlan]:
    """Baseline 2 (§IV-B, CIM-MLC style): capacity-first partition given,
    then *opportunistic* duplication into whatever cores remain vacant.

    Identical duplication mechanics to :func:`optimal_mapping` — the
    difference is upstream: the partition was chosen greedily by capacity,
    not by the DP, so packed stages rarely have vacant cores.
    """
    return optimal_mapping(cg, gids, chip, params)
