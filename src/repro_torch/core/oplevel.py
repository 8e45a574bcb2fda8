"""OP-level optimization (paper §III-C): virtual → physical mapping.

Host code: a copy of :mod:`repro.core.oplevel` (the JAX package), kept
identical so the port's results equal the reference's; the
port imports nothing of ``repro``.

For every group of a mapped stage this module derives an :class:`OpSchedule`:

* **Virtual mapping** — the operator's loop nest is flattened to an ideal
  2-D weight layout ``(K = reduction, N = output channels)`` in a
  constraint-free space; convolutions go through the im2col transformation
  (HWC feature layout, ``(ky, kx, c)`` patch ordering — one contiguous
  ``kw*C`` segment per kernel row, which the code generator exploits to
  gather a whole patch row with a single strided ``V_MOV``).
* **Physical mapping** — the ideal layout is tiled to macro-group geometry:
  ``k``-tiles bounded by macro rows, ``n``-tiles by the MG's output width;
  grouped/depth-wise convolutions use block-diagonal packing (several conv
  groups share one MG pass, each on its own rows x columns block).  Tiles
  are assigned round-robin to the replica's cores, and the ``m`` dimension
  is chunked (one conv output row, or <= 511 positions — the CIM_MVM ``rep``
  field) against the local-memory segment budget.

The resulting schedule fixes every address-generation constant the code
generator needs; codegen then only emits instructions.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .arch import ChipConfig
from .graph import (WEIGHT_DYNAMIC, WEIGHT_STATIC, WEIGHT_STREAMED,
                    CondensedGraph, Group, Op)
from .mapping import GroupAlloc, StagePlan

__all__ = ["Im2colSpec", "MgAssign", "ReplicaPlan", "OpSchedule",
           "plan_group", "plan_stage", "incremental_ops", "MAX_REP"]

MAX_REP = 511          # CIM_MVM imm10 repetition bound


@dataclass(frozen=True)
class Im2colSpec:
    """Conv geometry for the im2col gather (HWC layout)."""

    h: int
    w: int
    cin: int
    kh: int
    kw: int
    stride: int
    pad: int
    ho: int
    wo: int
    depthwise: bool = False

    @property
    def patch_len(self) -> int:
        """im2col row length: (ky, kx, c) ordering."""
        return self.kh * self.kw * self.cin


@dataclass(frozen=True)
class PoolSpec:
    """Fused pooling geometry (applies to the anchor's HWC output)."""

    kind: str          # maxpool | avgpool
    k: int
    stride: int
    pad: int
    ho: int            # pooled output rows
    wo: int            # pooled output cols


@dataclass(frozen=True)
class MgAssign:
    """One macro-group's share of the operator.

    All k-tiles of a given n-tile are co-located on one core (consecutive
    slots) so INT32 partial sums accumulate locally; when they exceed the
    core's *free* MG slots the surplus executes in later ``round`` s,
    cycling the group's own slot range (above any co-resident groups on
    a time-shared core) with weight re-streaming.

    ``source`` is the tile's weight source: ``static`` tiles load a
    gmem blob in the stage prologue, ``streamed`` tiles re-load per
    sample per round, ``dynamic`` tiles are gathered from a predecessor
    group's activations in local memory and CIM-written every sample.
    """

    core: int          # physical core id
    slot: int          # MG index within the core's CIM unit
    round: int         # weight-streaming round this tile executes in
    k_off: int         # input-vector offset (elements)
    k_len: int         # rows used
    n_off: int         # output-channel offset
    n_len: int         # output channels produced
    ch_off: int = 0    # block-diagonal packing: first conv group
    ch_cnt: int = 1    # conv groups packed into this MG
    source: str = WEIGHT_STATIC


@dataclass
class ReplicaPlan:
    """One weight replica: its cores, MG assignments and m-range."""

    replica: int
    cores: Tuple[int, ...]
    assigns: List[MgAssign]
    m_lo: int
    m_hi: int          # owns output positions [m_lo, m_hi)


@dataclass
class OpSchedule:
    """Everything codegen needs for one group."""

    gid: int
    name: str
    alloc: GroupAlloc
    replicas: List[ReplicaPlan]
    k_total: int               # im2col'd reduction length (elements)
    n_total: int               # output channels
    m_total: int               # output positions per sample
    m_chunk: int               # positions per CIM_MVM burst
    im2col: Optional[Im2colSpec]
    vector_ops: Tuple[str, ...]    # fused post-ops in execution order
    pool: Optional[PoolSpec] = None
    gap: bool = False          # fused global average pool
    weight_bits: int = 8
    n_rounds: int = 1          # weight-streaming rounds
    # weight-source metadata (see repro_torch.core.graph.WEIGHT_SOURCES):
    weight_source: str = WEIGHT_STATIC
    weight_pred: Optional[int] = None   # producer group (None = graph in)
    w_rows: int = 0                     # producer output rows
    w_row_bytes: int = 0                # producer output row bytes
    w_transpose: bool = False           # W = producer outputᵀ (Q·Kᵀ)
    # append-only weight growth (KV-cached decode): samples s > 0 may
    # re-stage only the appended producer row (see incremental_ops)
    w_incremental: bool = False
    # graph-input op id of the weight operand when weight_pred is None
    # (multi-input graphs: codegen offsets the per-sample gmem region)
    w_input: Optional[int] = None

    @property
    def n_chunks(self) -> int:
        return math.ceil(self.m_total / self.m_chunk) if self.m_total else 0

    @property
    def psum_bytes_per_chunk(self) -> int:
        return self.m_chunk * self.n_total * 4

    @property
    def stage_in_bytes_per_chunk(self) -> int:
        return self.m_chunk * self.k_total


class OpLevelError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def _conv_spec(cg: CondensedGraph, g: Group) -> Optional[Im2colSpec]:
    """Recover conv geometry from the source graph, if available."""
    if cg.source is None or g.anchor is None:
        return None
    op = cg.source.ops[g.anchor]
    if op.kind not in ("conv", "dwconv"):
        return None
    src = cg.source.ops[op.inputs[0]]
    h, w, cin = src.out_shape
    ho, wo, _ = op.out_shape
    return Im2colSpec(h=h, w=w, cin=cin, kh=op.attrs["k"], kw=op.attrs["k"],
                      stride=op.attrs["stride"], pad=op.attrs["padding"],
                      ho=ho, wo=wo, depthwise=(op.kind == "dwconv"))


def _fused_vector_ops(cg: CondensedGraph, g: Group) \
        -> Tuple[Tuple[str, ...], Optional[PoolSpec], bool]:
    """(post-anchor fused ops, pooling spec, gap?) — bn folds into requant."""
    if cg.source is None:
        return (), None, False
    out = []
    pool: Optional[PoolSpec] = None
    gap = False
    for i in g.op_ids:
        op = cg.source.ops[i]
        if op.is_mvm or op.kind in ("bn", "flatten", "identity"):
            continue
        if op.kind in ("maxpool", "avgpool"):
            ho, wo, _ = op.out_shape
            pool = PoolSpec(kind=op.kind, k=op.attrs["k"],
                            stride=op.attrs["stride"],
                            pad=op.attrs.get("padding", 0), ho=ho, wo=wo)
        if op.kind == "globalpool":
            gap = True
        out.append(op.kind)
    return tuple(out), pool, gap


def _split(total: int, tile: int) -> List[Tuple[int, int]]:
    """[(offset, length)] covering ``total`` in ``tile``-sized pieces."""
    out = []
    off = 0
    while off < total:
        out.append((off, min(tile, total - off)))
        off += tile
    return out or [(0, 0)]


# ---------------------------------------------------------------------------
# Physical mapping
# ---------------------------------------------------------------------------


def _n_tile_columns(g: Group, chip: ChipConfig) \
        -> List[List[Tuple[int, int, int, int, int, int]]]:
    """Tiles grouped into *columns*: each column is the list of k-tiles of
    one n-tile, [(k_off, k_len, n_off, n_len, ch_off, ch_cnt)].  A column's
    partial sums accumulate locally, so all its tiles land on one core.
    """
    cim = chip.core.cim
    rows, n_out = cim.macro.rows, cim.group_n_out
    if g.groups == 1:
        return [[(k_off, k_len, n_off, n_len, 0, 1)
                 for k_off, k_len in _split(g.gemm_k, rows)]
                for n_off, n_len in _split(g.gemm_n, n_out)]
    ch = max(1, min(rows // max(g.gemm_k, 1), n_out // max(g.gemm_n, 1)))
    if g.gemm_k > rows or g.gemm_n > n_out:
        # giant grouped op (per-group K or N exceeds one MG): tile each
        # conv group independently
        return [[(ci * g.gemm_k + k_off, k_len,
                  ci * g.gemm_n + n_off, n_len, ci, 1)
                 for k_off, k_len in _split(g.gemm_k, rows)]
                for ci in range(g.groups)
                for n_off, n_len in _split(g.gemm_n, n_out)]
    # block-diagonal packing: one tile per packed channel bundle
    return [[(ch_off * g.gemm_k, min(ch, g.groups - ch_off) * g.gemm_k,
              ch_off * g.gemm_n, min(ch, g.groups - ch_off) * g.gemm_n,
              ch_off, min(ch, g.groups - ch_off))]
            for ch_off in range(0, g.groups, ch)]


def plan_group(cg: CondensedGraph, g: Group, alloc: GroupAlloc,
               chip: ChipConfig, core_base: int,
               slot_base: Optional[dict] = None,
               op_owner: Optional[dict] = None) -> OpSchedule:
    """Physical mapping of one group onto its allocated cores.

    ``core_base`` is the first physical core of this group's allocation;
    replicas occupy consecutive ``alloc.cores``-sized windows.
    ``slot_base`` maps physical core -> first free MG slot (time-shared
    stages pack several groups' weights onto one core's macro groups).
    When a core's tiles exceed its *free* slots, the surplus executes in
    weight-streaming rounds that cycle the group's own slot range above
    its co-residents (INT32 partial sums accumulate across rounds, so a
    column's k-tiles may split between rounds).
    """
    cim = chip.core.cim
    spec = _conv_spec(cg, g)
    vops, pool, gap = _fused_vector_ops(cg, g)
    k_total = g.gemm_k * g.groups if g.groups > 1 else g.gemm_k
    n_total = g.gemm_n * g.groups if g.groups > 1 else g.gemm_n
    m_total = g.gemm_m
    slot_base = slot_base if slot_base is not None else {}
    dynamic = g.dynamic_weights

    columns = _n_tile_columns(g, chip)
    slots = cim.n_macro_groups

    # Bucket columns' tiles per logical core (round-robin), then assign
    # slots per PHYSICAL core above whatever co-resident groups already
    # occupy there (additive accounting — matches mapping.place_stage).
    per_core_tiles: List[List[Tuple[int, int, int, int, int, int]]] = \
        [[] for _ in range(alloc.cores)]
    for ci, col in enumerate(columns):
        per_core_tiles[ci % alloc.cores].extend(col)
    n_rounds = 1
    streamed_cores: set = set()
    placed_by_rep: List[List[MgAssign]] = []
    for r in range(alloc.dup):
        assigns: List[MgAssign] = []
        for c, tiles_c in enumerate(per_core_tiles):
            pc = core_base + r * alloc.cores + c
            start = slot_base.get(pc, 0)
            avail = slots - start
            if len(tiles_c) > avail:
                if avail <= 0:
                    raise OpLevelError(
                        f"{g.name}: no free MG slots on core {pc} "
                        f"(co-residents occupy all {slots})")
                # weight-streaming rounds cycle this group's own slot
                # range [start, slots) above any co-resident groups
                streamed_cores.add(pc)
                src = WEIGHT_DYNAMIC if dynamic else WEIGHT_STREAMED
                for s, t in enumerate(tiles_c):
                    rnd, slot = divmod(s, avail)
                    n_rounds = max(n_rounds, rnd + 1)
                    assigns.append(MgAssign(
                        core=pc, slot=start + slot, round=rnd, k_off=t[0],
                        k_len=t[1], n_off=t[2], n_len=t[3], ch_off=t[4],
                        ch_cnt=t[5], source=src))
            else:
                src = WEIGHT_DYNAMIC if dynamic else WEIGHT_STATIC
                for s, t in enumerate(tiles_c):
                    assigns.append(MgAssign(
                        core=pc, slot=start + s, round=0, k_off=t[0],
                        k_len=t[1], n_off=t[2], n_len=t[3], ch_off=t[4],
                        ch_cnt=t[5], source=src))
        placed_by_rep.append(assigns)
    # record additive occupancy: streamed cores are consumed to the top
    # (their rounds cycle everything above the co-residents)
    for r in range(alloc.dup):
        for c, tiles_c in enumerate(per_core_tiles):
            pc = core_base + r * alloc.cores + c
            slot_base[pc] = slots if pc in streamed_cores \
                else slot_base.get(pc, 0) + len(tiles_c)

    # Replica ownership is row-aligned for convs (and pool-stride aligned
    # when pooling is fused) so spatial slices map to whole rows.
    align = 1
    if spec is not None:
        align = spec.wo * (pool.stride if pool is not None else 1)
    m_per = math.ceil(max(m_total, 1) / alloc.dup)
    m_per = math.ceil(m_per / align) * align

    replicas: List[ReplicaPlan] = []
    for r in range(alloc.dup):
        cores = tuple(core_base + r * alloc.cores + c
                      for c in range(alloc.cores))
        replicas.append(ReplicaPlan(
            replica=r, cores=cores, assigns=placed_by_rep[r],
            m_lo=min(r * m_per, m_total), m_hi=min((r + 1) * m_per, m_total)))

    # m-chunking: one conv output row, bounded by rep field and lmem segment
    seg = chip.core.local_mem.segment_bytes
    if spec is not None:
        m_chunk = spec.wo
    else:
        m_chunk = min(max(m_total, 1), MAX_REP)
    m_chunk = min(m_chunk, MAX_REP)
    # staging (int8 K) + psum (int32 N) per chunk must fit one segment each
    while m_chunk > 1 and (m_chunk * k_total > seg
                           or m_chunk * n_total * 4 > seg):
        m_chunk = max(1, m_chunk // 2)

    # weight-source metadata: a dynamic group's weights are its anchor's
    # second input — a predecessor group's (or the graph input's)
    # activations, gathered from local memory every sample
    w_pred: Optional[int] = None
    w_rows = w_row_bytes = 0
    if dynamic:
        if cg.source is None or g.anchor is None:
            raise OpLevelError(f"{g.name}: dynamic weights need the "
                               f"source graph")
        anchor = cg.source.ops[g.anchor]
        if len(anchor.inputs) < 2:
            raise OpLevelError(f"{g.name}: dynamic-weight anchor has no "
                               f"weight operand")
        wop = cg.source.ops[anchor.inputs[1]]
        if op_owner is None:
            op_owner = {i: grp.idx for grp in cg for i in grp.op_ids}
        w_pred = op_owner.get(wop.idx)          # None => graph input
        w_input = wop.idx if w_pred is None else None
        w_row_bytes = int(wop.out_shape[-1]) * wop.act_bits // 8
        w_rows = max(1, wop.out_elems // max(int(wop.out_shape[-1]), 1))
    else:
        w_input = None
    source = (WEIGHT_DYNAMIC if dynamic
              else WEIGHT_STREAMED if n_rounds > 1 else WEIGHT_STATIC)

    return OpSchedule(
        gid=g.idx, name=g.name, alloc=alloc, replicas=replicas,
        k_total=k_total, n_total=n_total, m_total=m_total, m_chunk=m_chunk,
        im2col=spec, vector_ops=vops, pool=pool, gap=gap,
        weight_bits=g.weight_bits, n_rounds=n_rounds,
        weight_source=source, weight_pred=w_pred, w_rows=w_rows,
        w_row_bytes=w_row_bytes, w_transpose=g.transpose_weights,
        w_incremental=bool(dynamic and g.weight_incremental),
        w_input=w_input)


def incremental_ops(g: Group, sched: OpSchedule, a: MgAssign
                    ) -> Optional[Tuple[List[int], List[int]]]:
    """Append-row re-stage shape for one MG assign, or ``None``.

    For a ``kv_append`` dynamic group, samples ``s > 0`` differ from
    sample ``s-1`` in exactly one producer row — the appended cache
    entry ``w_rows - 1``.  This helper is the single definition of
    *which* tiles that row touches and *what* it costs, shared by
    codegen (instruction emission) and trace (unit pricing) so the two
    cannot drift:

    * non-transpose (``P·V``): the appended V row is one new *weight
      row*; gather one ``n_len``-wide row per packed head and CIM-write
      it with a single-row ``CIM_LOAD`` (array writes are
      row-granular, so an appended row costs exactly one row write).
    * transpose (``Q·Kᵀ``): the appended K row is one new *weight
      column*; gather one ``k_len``-deep column per packed head, but
      the row-granular array write must re-write the whole touched
      tile (``k_len`` rows) — still O(1) in the cache length, since
      ``k_len`` is the head dimension.

    Returns ``(gather_elems, load_rows)``: per-V_MOV element counts and
    per-CIM_LOAD row counts, or ``None`` when the assign's tile does
    not cover the appended row.  Only meaningful for single-round
    schedules (multi-round slot cycling leaves nothing resident).
    """
    if not (sched.w_incremental and sched.weight_source == WEIGHT_DYNAMIC):
        return None
    row = sched.w_rows - 1
    gk, gn = g.gemm_k, g.gemm_n
    if a.ch_cnt > 1:
        # block-diagonal packed tile: every packed head's block spans
        # the full per-head K and N, so the appended row always lands
        if sched.w_transpose:
            return [gk] * a.ch_cnt, [a.k_len]
        return [gn] * a.ch_cnt, [1] * a.ch_cnt
    ch = a.ch_off
    if sched.w_transpose:
        n0 = a.n_off - ch * gn          # tile-local cache-row window
        if not n0 <= row < n0 + a.n_len:
            return None
        return [a.k_len], [a.k_len]
    k0 = a.k_off - ch * gk
    if not k0 <= row < k0 + a.k_len:
        return None
    return [a.n_len], [1]


def plan_stage(cg: CondensedGraph, stage: StagePlan,
               chip: ChipConfig) -> List[OpSchedule]:
    """Assign physical cores to every group of the stage and plan each.

    Groups are placed left-to-right on the core grid in topological order —
    producers end up adjacent to consumers, which is what the NoC cost model
    assumes.  When the stage time-shares cores (``shared_cores``), groups
    overlap on the same windows (their programs serialize).
    """
    schedules: List[OpSchedule] = []
    slot_base: dict = {}
    op_owner = {i: grp.idx for grp in cg for i in grp.op_ids}
    if stage.bases is not None:
        # plan single-round (additive) groups first so a streaming
        # group's rounds cycle above ALL its co-residents' slots —
        # place_stage validated occupancy in size order, and additive
        # accounting is order-independent, so only the streamers (which
        # consume "the rest" of a core) must come last.  Results are
        # reported in stage order regardless.
        order = sorted(range(len(stage.allocs)),
                       key=lambda i: (stage.allocs[i].rounds > 1, i))
        out: List[Optional[OpSchedule]] = [None] * len(stage.allocs)
        for i in order:
            alloc, base = stage.allocs[i], stage.bases[i]
            out[i] = plan_group(cg, cg[alloc.gid], alloc, chip,
                                core_base=base, slot_base=slot_base,
                                op_owner=op_owner)
        return [s for s in out if s is not None]
    # fallback: sequential left-to-right walk (hand-built StagePlans)
    base = 0
    for alloc in stage.allocs:
        g = cg[alloc.gid]
        need = alloc.total_cores
        if base + need > chip.n_cores:
            base = 0                      # wrap: time-share from the left
        schedules.append(plan_group(cg, g, alloc, chip, core_base=base,
                                    slot_base=slot_base,
                                    op_owner=op_owner))
        base += need
        if base >= chip.n_cores:
            base = 0
    return schedules
