"""System-level partitioners: split one condensed graph across chips.

Two strategies, registered as ``system:pipeline`` / ``system:tensor``
passes on the :mod:`repro_torch.flow` registry:

* **pipeline** — the condensed graph's groups are cut into contiguous
  ranges, one per chip, balanced by a compute proxy (MACs + vector
  element-ops) under the per-chip gmem capacity rule
  (:func:`repro_torch.core.mapping.gmem_footprint_bytes`).  Each range is
  *re-materialized* as a real sub-:class:`~repro_torch.core.graph.Graph`
  (cut-crossing tensors become graph inputs), so a chip's slice runs
  the whole single-chip fidelity ladder unchanged — including bit-exact
  func mode.  Cut-crossing activations are priced as inter-chip
  SEND/RECV transfers (gmem-port-contended, see
  :meth:`MachineModel.interchip_transfer_cycles`).

* **tensor** — every MVM group is sharded across *all* chips along the
  best available axis (attention heads -> ``groups``; else ``gemm_n``
  column split -> concat/all-gather; else ``gemm_m`` row split ->
  all-gather; else ``gemm_k`` reduction split -> all-reduce of int32
  partials), with exact integer splits so total MACs are conserved to
  the bit.  Per-chip shards are group-level scaled condensed graphs
  over the shared source, evaluated at the analytic and trace
  fidelities; vector-only groups are replicated (their compute is
  counted per chip, their *unique* work once — see
  :meth:`SystemPlan.total_macs`).

The splitters are pure functions of ``(cg, chip, system)`` and their
outputs are picklable, so the flow pass cache memoizes plans across
processes like any other pass output.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from ..core.arch import ChipConfig
from ..core.graph import CondensedGraph, Graph, Group, Op
from ..core.mapping import gmem_footprint_bytes
from ..core.partition import InfeasibleModel
from .config import SystemConfig

__all__ = ["SystemPlan", "ChipSlice", "Transfer", "Collective",
           "SystemPlanError", "split_pipeline", "shard_tensor"]


class SystemPlanError(RuntimeError):
    """The graph cannot be split the requested way (structural, not
    capacity — capacity failures raise
    :class:`~repro_torch.core.partition.InfeasibleModel`)."""


@dataclass(frozen=True)
class Transfer:
    """One cut-crossing activation tensor (pipeline mode), per sample."""

    gid: int            # global producer group id
    src_chip: int
    dst_chip: int
    nbytes: int         # per-sample payload
    hops: int           # mesh Manhattan distance


@dataclass(frozen=True)
class Collective:
    """One per-group shard-boundary collective (tensor mode)."""

    gid: int            # global group id
    kind: str           # "allgather" | "allreduce"
    nbytes: int         # full per-sample payload moved by the collective


@dataclass
class ChipSlice:
    """One chip's share of the plan.

    ``workload`` is what that chip compiles: a sub-``Graph`` (pipeline
    mode), a scaled ``CondensedGraph`` (tensor mode), or ``None``
    meaning "the original workload, unchanged" (the 1-chip degenerate
    case — this is what makes a 1x1 mesh bit-identical to the
    single-chip path).  ``input_srcs`` maps the sub-graph's input ops,
    in op order, back to their origin: ``("input", op_idx)`` for an
    original graph input, ``("group", gid)`` for a cut-crossing
    producer group — the func-mode stitcher feeds each chip from this.

    ``chip_id`` is the *logical* slice index (0..n-1, what transfers
    and per-chip reports index); ``slot`` is the *physical* mesh slot
    the slice landed on.  They coincide on a healthy mesh and diverge
    under failover, when slices skip failed slots (``-1`` = legacy
    plan, read it as ``chip_id``).
    """

    chip_id: int
    gids: Tuple[int, ...]               # global group ids on this chip
    workload: Any = None                # Graph | CondensedGraph | None
    input_srcs: Tuple[Tuple[str, int], ...] = ()
    macs: int = 0                       # unique MACs charged to this slice
    out_bytes: int = 0                  # unique boundary bytes charged
    weight_bytes: int = 0               # resident (non-dynamic) weights
    slot: int = -1                      # physical mesh slot (-1 = chip_id)

    @property
    def mesh_slot(self) -> int:
        return self.chip_id if self.slot < 0 else self.slot


@dataclass
class SystemPlan:
    """A multi-chip execution plan over one condensed graph."""

    mode: str                           # "pipeline" | "tensor"
    system: SystemConfig
    cg: CondensedGraph                  # the full, unsplit graph
    slices: List[ChipSlice]
    transfers: Tuple[Transfer, ...] = ()
    collectives: Tuple[Collective, ...] = ()

    @property
    def n_chips(self) -> int:
        return len(self.slices)

    def total_macs(self) -> int:
        """Unique MACs across the plan — must equal ``cg.total_macs``
        (the conservation invariant; replicated groups count once)."""
        return sum(s.macs for s in self.slices)

    def total_out_bytes(self) -> int:
        """Unique boundary-activation bytes across the plan."""
        return sum(s.out_bytes for s in self.slices)

    def transfer_bytes(self, batch: int = 1) -> int:
        """Total inter-chip payload per batch (pipeline transfers +
        collective ring traffic)."""
        b = max(1, int(batch))
        total = sum(t.nbytes for t in self.transfers) * b
        c = max(1, len(self.slices))     # participating (surviving) chips
        for col in self.collectives:
            steps = (c - 1) * (2 if col.kind == "allreduce" else 1)
            total += steps * (col.nbytes // max(c, 1)) * b
        return total

    def describe(self) -> str:
        lines = [f"system plan [{self.mode}] '{self.cg.name}' on "
                 f"{self.system.chips_x}x{self.system.chips_y} chips "
                 f"('{self.system.link.name}' links)"]
        for s in self.slices:
            lines.append(
                f"  chip {s.chip_id}: {len(s.gids)} groups, "
                f"{s.macs / 1e6:.1f} MMACs, "
                f"{s.weight_bytes / 1e6:.2f} MB weights")
        if self.transfers:
            nb = sum(t.nbytes for t in self.transfers)
            lines.append(f"  {len(self.transfers)} cut transfers, "
                         f"{nb / 1e3:.1f} KB/sample")
        if self.collectives:
            lines.append(f"  {len(self.collectives)} collectives")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------


def _group_cost(g: Group) -> float:
    """Load-balance proxy: MAC work + vector element-ops."""
    return float(g.macs + g.vector_elems)


def _prop_slice(total: int, parts: Sequence[int]) -> List[int]:
    """Split ``total`` proportionally to ``parts`` with exact integer
    conservation (cumulative flooring telescopes to ``total``)."""
    whole = sum(parts)
    if whole <= 0:
        return [0] * len(parts)
    out, cum, prev = [], 0, 0
    for p in parts:
        cum += p
        now = total * cum // whole
        out.append(now - prev)
        prev = now
    return out


def _even_parts(n: int, c: int) -> List[int]:
    """``n`` split into ``c`` near-equal integer parts (first parts get
    the remainder), exactly conserving the sum."""
    q, r = divmod(n, c)
    return [q + (1 if i < r else 0) for i in range(c)]


# ---------------------------------------------------------------------------
# Pipeline-parallel splitter
# ---------------------------------------------------------------------------


def split_pipeline(cg: CondensedGraph, chip: ChipConfig,
                   system: SystemConfig) -> SystemPlan:
    """Cut ``cg`` into contiguous per-chip stage ranges.

    Cuts are chosen by DP minimizing the max per-chip compute proxy,
    subject to (a) the per-chip gmem capacity rule and (b) structural
    validity: a tensor crossing a cut must be its producer group's
    final output op (that is the blob codegen spills to gmem and the
    stitcher can forward).  Raises
    :class:`~repro_torch.core.partition.InfeasibleModel` when no split at
    this chip count satisfies capacity.
    """
    G = len(cg.groups)
    if G == 0:
        raise SystemPlanError(f"'{cg.name}': empty condensed graph")
    # failover: plan over the surviving mesh slots only; logical slice
    # c lands on physical slot avail[c] (identity on a healthy mesh)
    avail = system.alive_slots
    n = min(len(avail), G)
    cap = chip.global_mem_bytes

    # -- structural cut validity ------------------------------------------
    # An op-level edge (op s in group p) -> (consumer in group q > p)
    # invalidates every cut j in [p, q-1] unless s is p's output op.
    valid_cut = [True] * G          # valid_cut[j]: may cut after group j
    if cg.source is not None:
        owner: Dict[int, int] = {i: g.idx for g in cg for i in g.op_ids}
        last_op = {g.idx: g.op_ids[-1] for g in cg}
        for g in cg:
            for i in g.op_ids:
                for s in cg.source.ops[i].inputs:
                    p = owner.get(s)
                    if p is None or p == g.idx or s == last_op[p]:
                        continue
                    for j in range(p, g.idx):
                        valid_cut[j] = False
    elif n > 1:
        raise SystemPlanError(
            f"'{cg.name}': pipeline split needs a source graph "
            f"(got a group-only condensed graph)")

    cost = [_group_cost(g) for g in cg]
    pref = [0.0]
    for c in cost:
        pref.append(pref[-1] + c)

    def range_cost(lo: int, hi: int) -> float:
        return pref[hi] - pref[lo]

    def feasible(lo: int, hi: int) -> bool:
        return gmem_footprint_bytes(cg.groups[lo:hi]) <= cap

    # -- DP: minimize the max range cost over exactly n valid ranges ------
    INF = float("inf")
    best = [[INF] * (G + 1) for _ in range(n + 1)]
    back = [[-1] * (G + 1) for _ in range(n + 1)]
    best[0][0] = 0.0
    for k in range(1, n + 1):
        for hi in range(k, G + 1):
            if hi < G and not valid_cut[hi - 1]:
                continue
            for lo in range(k - 1, hi):
                if best[k - 1][lo] == INF or not feasible(lo, hi):
                    continue
                v = max(best[k - 1][lo], range_cost(lo, hi))
                if v < best[k][hi]:
                    best[k][hi] = v
                    back[k][hi] = lo
    # fewer ranges than chips is allowed (graphs with sparse valid
    # cuts — e.g. residual blocks — may not support n non-empty
    # ranges): take the best feasible chip count <= n
    n_used = min((k for k in range(1, n + 1) if best[k][G] < INF),
                 key=lambda k: (best[k][G], k), default=0)
    if n_used == 0:
        need = _min_chips(cg, chip)
        raise InfeasibleModel(
            f"'{cg.name}' does not fit {n} chip(s) of "
            f"{cap / 1e6:.0f} MB gmem each "
            f"({gmem_footprint_bytes(cg.groups) / 1e6:.1f} "
            f"MB resident weights; needs >= {need} chips)")
    n = n_used

    bounds: List[int] = [G]
    k, hi = n, G
    while k > 0:
        lo = back[k][hi]
        bounds.append(lo)
        k, hi = k - 1, lo
    bounds.reverse()                # [0, c1, c2, ..., G]

    # -- materialize slices -----------------------------------------------
    slices: List[ChipSlice] = []
    chip_of: Dict[int, int] = {}
    for c in range(n):
        lo, hi = bounds[c], bounds[c + 1]
        gids = tuple(range(lo, hi))
        for gid in gids:
            chip_of[gid] = c
        sub, srcs = ((None, ()) if n == 1
                     else _slice_graph(cg, lo, hi))
        grp = cg.groups[lo:hi]
        slices.append(ChipSlice(
            chip_id=c, gids=gids, workload=sub, input_srcs=srcs,
            macs=sum(g.macs for g in grp),
            out_bytes=sum(g.out_bytes for g in grp),
            weight_bytes=sum(g.weight_bytes for g in grp
                             if g.weight_source != "dynamic"),
            slot=avail[c]))

    # -- cut-crossing transfers (deduped per producer, destination) ------
    transfers: List[Transfer] = []
    if n > 1 and cg.source is not None:
        seen: Set[Tuple[int, int]] = set()
        for g in cg:
            for i in g.op_ids:
                for s in cg.source.ops[i].inputs:
                    p = owner.get(s)
                    if p is None or chip_of[p] == chip_of[g.idx]:
                        continue
                    key = (p, chip_of[g.idx])
                    if key in seen:
                        continue
                    seen.add(key)
                    op = cg.source.ops[last_op[p]]
                    transfers.append(Transfer(
                        gid=p, src_chip=chip_of[p],
                        dst_chip=chip_of[g.idx],
                        nbytes=op.out_elems * op.act_bits // 8,
                        hops=system.hops(avail[chip_of[p]],
                                         avail[chip_of[g.idx]])))
    transfers.sort(key=lambda t: (t.src_chip, t.dst_chip, t.gid))
    return SystemPlan(mode="pipeline", system=system, cg=cg,
                      slices=slices, transfers=tuple(transfers))


def _min_chips(cg: CondensedGraph, chip: ChipConfig) -> int:
    """Lower-bound chip count: greedy first-fit over group ranges."""
    cap = chip.global_mem_bytes
    chips, lo = 1, 0
    for hi in range(1, len(cg.groups) + 1):
        if gmem_footprint_bytes(cg.groups[lo:hi]) > cap:
            if hi - 1 == lo:        # one group alone exceeds a chip
                return len(cg.groups) + 1
            chips += 1
            lo = hi - 1
    return chips


def _slice_graph(cg: CondensedGraph, lo: int,
                 hi: int) -> Tuple[Graph, Tuple[Tuple[str, int], ...]]:
    """Rebuild groups ``[lo, hi)`` as a standalone Graph.

    External tensors (original graph inputs and cut-crossing producer
    outputs) become input ops, created at first use so op order stays
    topological; the per-op geometry is copied verbatim, so the slice
    re-condenses to groups identical to the originals (asserted by the
    caller's conservation tests).
    """
    src = cg.source
    assert src is not None
    owner = {i: g.idx for g in cg for i in g.op_ids}
    last_op = {g.idx: g.op_ids[-1] for g in cg}
    member = [i for g in cg.groups[lo:hi] for i in g.op_ids]
    member.sort()
    inside = set(member)
    sub = Graph(f"{src.name}.pp{lo}_{hi}")
    remap: Dict[int, int] = {}
    srcs: List[Tuple[str, int]] = []
    for i in member:
        op = src.ops[i]
        for s in op.inputs:
            if s in inside or s in remap:
                continue
            sop = src.ops[s]
            if sop.kind != "input":
                p = owner[s]
                if s != last_op[p]:
                    raise SystemPlanError(
                        f"cut crosses a non-terminal tensor of group "
                        f"{p} ('{cg[p].name}' op {sop.name}); invalid "
                        f"cut placement")
                srcs.append(("group", p))
            else:
                srcs.append(("input", s))
            remap[s] = sub.input(f"in.{sop.name}",
                                 tuple(sop.out_shape))
        remap[i] = sub.add(Op(
            name=op.name, kind=op.kind,
            inputs=tuple(remap[s] for s in op.inputs),
            out_shape=tuple(op.out_shape), attrs=dict(op.attrs),
            gemm_m=op.gemm_m, gemm_k=op.gemm_k, gemm_n=op.gemm_n,
            groups=op.groups, weight_bits=op.weight_bits,
            act_bits=op.act_bits))
    return sub, tuple(srcs)


# ---------------------------------------------------------------------------
# Tensor-parallel sharder
# ---------------------------------------------------------------------------


def shard_tensor(cg: CondensedGraph, chip: ChipConfig,
                 system: SystemConfig) -> SystemPlan:
    """Shard every MVM group across all chips of the mesh.

    Axis choice per group (first match wins): attention heads
    (``groups`` divisible by the chip count), output columns
    (``gemm_n``), output rows (``gemm_m``), reduction (``gemm_k``,
    int32-partial all-reduce).  Unshardable groups are replicated.
    Splits are exact-integer, so ``plan.total_macs() == cg.total_macs``
    always holds.

    Under failover the shard count is the number of *surviving* chips
    — the same workload simply re-shards wider per chip.
    """
    avail = system.alive_slots
    C = len(avail)
    per_chip: List[List[Group]] = [[] for _ in range(C)]
    slice_macs = [0] * C
    slice_out = [0] * C
    slice_w = [0] * C
    collectives: List[Collective] = []

    for g in cg:
        shards, col = _shard_group(g, C)
        for c in range(C):
            sg = shards[c]
            per_chip[c].append(sg)
            if sg.weight_source != "dynamic":
                slice_w[c] += sg.weight_bytes
        if col is not None:
            collectives.append(col)
            for c in range(C):
                slice_macs[c] += shards[c].macs
            if col.kind == "allreduce":    # output replicated post-reduce
                slice_out[0] += g.out_bytes
            else:
                for c in range(C):
                    slice_out[c] += shards[c].out_bytes
        else:                              # replicated: unique work once
            slice_macs[0] += g.macs
            slice_out[0] += g.out_bytes

    cap = chip.global_mem_bytes
    for c in range(C):
        fp = gmem_footprint_bytes(per_chip[c])
        if fp > cap:
            raise InfeasibleModel(
                f"'{cg.name}' tensor shard {c}/{C} needs "
                f"{fp / 1e6:.1f} MB gmem (> {cap / 1e6:.0f} MB); "
                f"use more chips")

    slices = [ChipSlice(
        chip_id=c, gids=tuple(g.idx for g in cg),
        workload=CondensedGraph(f"{cg.name}.tp{c}of{C}", per_chip[c],
                                source=cg.source),
        macs=slice_macs[c], out_bytes=slice_out[c],
        weight_bytes=slice_w[c], slot=avail[c]) for c in range(C)]
    return SystemPlan(mode="tensor", system=system, cg=cg,
                      slices=slices, collectives=tuple(collectives))


def _shard_group(g: Group,
                 C: int) -> Tuple[List[Group], Optional[Collective]]:
    """One group's per-chip shard records + its boundary collective."""
    if C == 1:
        return [g], None
    if g.anchor is None or g.macs == 0:
        return [dataclasses.replace(g) for _ in range(C)], None

    if g.groups >= C and g.groups % C == 0:          # attention heads
        parts = _even_parts(g.groups, C)
        shards = _scaled(g, parts, groups=True)
        return shards, Collective(g.idx, "allgather", g.out_bytes)
    if g.gemm_n >= C:                                # output columns
        parts = _even_parts(g.gemm_n, C)
        shards = _scaled(g, parts, n=True)
        return shards, Collective(g.idx, "allgather", g.out_bytes)
    if g.gemm_m >= C:                                # output rows
        parts = _even_parts(g.gemm_m, C)
        shards = _scaled(g, parts, m=True)
        return shards, Collective(g.idx, "allgather", g.out_bytes)
    if g.gemm_k >= C:                                # reduction split
        parts = _even_parts(g.gemm_k, C)
        shards = _scaled(g, parts, k=True)
        # int32 partial sums ride the ring: 4x the int8 payload
        return shards, Collective(g.idx, "allreduce", 4 * g.out_bytes)
    return [dataclasses.replace(g) for _ in range(C)], None


def _scaled(g: Group, parts: Sequence[int], groups: bool = False,
            n: bool = False, m: bool = False,
            k: bool = False) -> List[Group]:
    """Per-chip scaled copies of ``g`` along one shard axis, with
    exact-integer conservation of MACs / weight / boundary bytes."""
    macs = _prop_slice(g.macs, parts)
    out: List[Group] = []
    w = (_prop_slice(g.weight_bytes, parts) if not m
         else [g.weight_bytes] * len(parts))       # M-shard: full weights
    ob = (_prop_slice(g.out_bytes, parts) if not k
          else [g.out_bytes] * len(parts))         # K-shard: full partials
    ib = (_prop_slice(g.in_bytes, parts) if (m or k)
          else [g.in_bytes] * len(parts))          # N/head: full input
    vw = {cls: _prop_slice(e, parts)
          for cls, e in g.vector_work.items()}
    for c, p in enumerate(parts):
        out.append(dataclasses.replace(
            g,
            groups=p if groups else g.groups,
            gemm_n=p if n else g.gemm_n,
            gemm_m=p if m else g.gemm_m,
            gemm_k=p if k else g.gemm_k,
            macs=macs[c], weight_bytes=w[c], out_bytes=ob[c],
            in_bytes=ib[c],
            vector_work={cls: v[c] for cls, v in vw.items()}))
    return out
