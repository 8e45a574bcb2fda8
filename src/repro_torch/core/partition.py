"""CG-level partitioning (paper §III-C, Alg. 1) and the §IV-B baselines.

Host code: a copy of :mod:`repro.core.partition` (the JAX package), kept
identical so the port's compile results equal the reference's; the
port imports nothing of ``repro``.

The model is divided into **execution stages** to respect the digital-CIM
weight-capacity wall.  Stages execute sequentially (weights are reloaded per
stage); inside a stage, groups form an inter-operator pipeline across cores.

* :func:`dependency_closures` — Alg. 1 line 1: every *dependency closure*
  (predecessor-closed subset of the condensed CG) encoded as a bitmask.
* :func:`dp_partition` — Alg. 1's dynamic program over the closure lattice:
  ``dp[i] = min_{j ⊑ i} dp[j] + OptimalMapping(D_i \\ D_j, R)``.
* :func:`greedy_partition` — capacity-first partitioning in topological
  order; with ``generic`` mapping it is baseline (1) *generic inter-layer
  pipeline, no duplication*; with ``opportunistic`` mapping it is baseline
  (2), the CIM-MLC-style partition-then-duplicate scheme.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .arch import ChipConfig
from .graph import CondensedGraph
from .mapping import (CostParams, StagePlan, generic_mapping, mg_tiles,
                      min_cores, needs_streaming, opportunistic_mapping,
                      optimal_mapping)

__all__ = [
    "PartitionResult", "dependency_closures", "dp_partition",
    "greedy_partition", "partition", "STRATEGIES", "ClosureExplosion",
]

Mapper = Callable[[CondensedGraph, Sequence[int], ChipConfig, CostParams],
                  Optional[StagePlan]]


class ClosureExplosion(RuntimeError):
    """Raised when the closure lattice exceeds the enumeration cap."""


class InfeasibleModel(RuntimeError):
    """No valid partition exists (some group cannot fit the chip at all)."""


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------


@dataclass
class PartitionResult:
    strategy: str
    stages: List[StagePlan]
    cg: CondensedGraph
    chip: ChipConfig
    params: CostParams

    def latency_cycles(self, batch: Optional[int] = None,
                       calib=None) -> float:
        return sum(s.latency_cycles(batch, calib) for s in self.stages)

    def latency_s(self, batch: Optional[int] = None) -> float:
        return self.latency_cycles(batch) / (self.chip.clock_ghz * 1e9)

    def throughput_sps(self, batch: Optional[int] = None) -> float:
        b = batch if batch is not None else self.params.batch
        return b / self.latency_s(b)

    def energy_events(self, batch: Optional[int] = None,
                      calib=None) -> Dict[str, float]:
        tot: Dict[str, float] = {}
        for s in self.stages:
            for k, v in s.energy_events(batch, calib).items():
                tot[k] = tot.get(k, 0.0) + v
        return tot

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def describe(self) -> str:
        head = (f"[{self.strategy}] {self.cg.name}: {self.n_stages} stages, "
                f"{self.latency_cycles():.0f} cycles "
                f"(batch={self.params.batch})")
        return "\n".join([head] + [s.describe() for s in self.stages])


# ---------------------------------------------------------------------------
# Dependency closures (Alg. 1, line 1)
# ---------------------------------------------------------------------------


def dependency_closures(cg: CondensedGraph, cap: int = 1 << 16) -> List[int]:
    """All predecessor-closed subsets of ``cg`` as bitmasks.

    BFS over the closure lattice: a closure ``m`` extends to ``m | 1<<v``
    for any node ``v ∉ m`` whose predecessors are all in ``m``.  Sorted by
    population count (then value) so the DP can scan subsets forward.
    Raises :class:`ClosureExplosion` beyond ``cap`` — callers fall back to
    topological-prefix closures.
    """
    n = len(cg)
    pred_mask = [0] * n
    for g in cg:
        for p in g.preds:
            pred_mask[g.idx] |= 1 << p
    seen = {0}
    frontier = [0]
    while frontier:
        m = frontier.pop()
        for v in range(n):
            bit = 1 << v
            if m & bit:
                continue
            if (pred_mask[v] & m) == pred_mask[v]:
                nm = m | bit
                if nm not in seen:
                    if len(seen) >= cap:
                        raise ClosureExplosion(
                            f"closure lattice of '{cg.name}' exceeds {cap}")
                    seen.add(nm)
                    frontier.append(nm)
    return sorted(seen, key=lambda m: (bin(m).count("1"), m))


def prefix_closures(cg: CondensedGraph) -> List[int]:
    """Fallback: topological prefixes only (always valid closures)."""
    masks = [0]
    m = 0
    for g in cg:
        m |= 1 << g.idx
        masks.append(m)
    return masks


def _bits(mask: int) -> List[int]:
    out = []
    i = 0
    while mask:
        if mask & 1:
            out.append(i)
        mask >>= 1
        i += 1
    return out


# ---------------------------------------------------------------------------
# Alg. 1: DP-based partitioning and mapping
# ---------------------------------------------------------------------------


def dp_partition(cg: CondensedGraph, chip: ChipConfig,
                 params: Optional[CostParams] = None,
                 mapper: Mapper = optimal_mapping,
                 closure_cap: int = 1 << 16) -> PartitionResult:
    """The paper's Alg. 1, including the state-compression bitmask encoding."""
    params = params or CostParams()
    try:
        D = dependency_closures(cg, cap=closure_cap)
    except ClosureExplosion:
        D = prefix_closures(cg)
    index = {m: i for i, m in enumerate(D)}
    full = (1 << len(cg)) - 1
    if full not in index:          # defensive; full set is always a closure
        D.append(full)
        index[full] = len(D) - 1

    INF = float("inf")
    dp = [INF] * len(D)
    prev = [-1] * len(D)
    plan: List[Optional[StagePlan]] = [None] * len(D)
    cache: Dict[int, Optional[StagePlan]] = {}

    def map_stage(stage_mask: int) -> Optional[StagePlan]:
        if stage_mask not in cache:
            cache[stage_mask] = mapper(cg, _bits(stage_mask), chip, params)
        return cache[stage_mask]

    for i, Di in enumerate(D):
        if Di == 0:
            dp[i] = 0.0
            continue
        for j, Dj in enumerate(D):
            if Dj == Di or (Di & Dj) != Dj:
                continue
            if dp[j] == INF:
                continue
            sp = map_stage(Di ^ Dj)            # D[i] - D[j] set difference
            if sp is None:
                continue
            cost = dp[j] + sp.latency_cycles()
            if cost < dp[i]:
                dp[i], prev[i], plan[i] = cost, j, sp

    fi = index[full]
    if dp[fi] == INF:
        raise InfeasibleModel(
            f"'{cg.name}' has no feasible partition on chip "
            f"'{chip.name}'")
    # ReconstructSolution
    stages: List[StagePlan] = []
    i = fi
    while prev[i] != -1:
        stages.append(plan[i])          # type: ignore[arg-type]
        i = prev[i]
    stages.reverse()
    return PartitionResult("dp", stages, cg, chip, params)


# ---------------------------------------------------------------------------
# Greedy capacity-first partitioning (baselines)
# ---------------------------------------------------------------------------


def greedy_partition(cg: CondensedGraph, chip: ChipConfig,
                     params: Optional[CostParams] = None,
                     mapper: Mapper = generic_mapping,
                     strategy: str = "generic") -> PartitionResult:
    """Pack groups into stages in topological order until capacity is hit."""
    params = params or CostParams()
    slots = chip.core.cim.n_macro_groups
    chip_tiles = chip.n_cores * slots
    stages: List[List[int]] = []
    cur: List[int] = []
    cur_tiles = 0
    cur_cores = 0
    for g in cg:
        t = mg_tiles(g, chip)
        c = min_cores(g, chip)
        # a weight-streaming group occupies the slots of the cores it
        # monopolizes, not its (larger) nominal tile count — it may
        # share a stage as long as the mapper can place the result
        eff = min(t, c * slots)
        if needs_streaming(g, chip) or t > chip_tiles:
            if cur and mapper(cg, cur + [g.idx], chip, params) is not None:
                cur.append(g.idx)
                cur_tiles += eff
                cur_cores += c
                continue
            if cur:
                stages.append(cur)
            stages.append([g.idx])
            cur, cur_tiles, cur_cores = [], 0, 0
            continue
        if cur and (cur_tiles + eff > chip_tiles
                    or cur_cores + c > chip.n_cores):
            stages.append(cur)
            cur, cur_tiles, cur_cores = [], 0, 0
        cur.append(g.idx)
        cur_tiles += eff
        cur_cores += c
    if cur:
        stages.append(cur)

    plans: List[StagePlan] = []
    for gids in stages:
        sp = mapper(cg, gids, chip, params)
        if sp is None:
            raise InfeasibleModel(
                f"greedy stage {gids} of '{cg.name}' unmappable")
        plans.append(sp)
    return PartitionResult(strategy, plans, cg, chip, params)


# ---------------------------------------------------------------------------
# Strategy registry (used by benchmarks / DSE)
# ---------------------------------------------------------------------------


def _partition(cg: CondensedGraph, chip: ChipConfig,
               strategy: str = "dp",
               params: Optional[CostParams] = None) -> PartitionResult:
    """Internal strategy dispatcher (the :mod:`repro.flow` pass bodies)."""
    if strategy == "dp":
        return dp_partition(cg, chip, params)
    if strategy == "generic":
        return greedy_partition(cg, chip, params, generic_mapping, "generic")
    if strategy == "cim-mlc":
        return greedy_partition(cg, chip, params, opportunistic_mapping,
                                "cim-mlc")
    raise KeyError(f"unknown strategy {strategy!r}")


def partition(cg: CondensedGraph, chip: ChipConfig,
              strategy: str = "dp",
              params: Optional[CostParams] = None) -> PartitionResult:
    """Deprecated free-function entry point.

    Use ``repro.flow.compile(cg, chip, CompileOptions(strategy=...))``
    — the pass-based pipeline adds per-pass instrumentation and caches
    partition outputs across fidelities.  This shim stays for existing
    callers and the golden equivalence tests.
    """
    warnings.warn(
        "repro_torch.core.partition.partition() is deprecated; use "
        "repro_torch.flow.compile(workload, chip, "
        "CompileOptions(strategy=...))",
        DeprecationWarning, stacklevel=2)
    return _partition(cg, chip, strategy, params)


STRATEGIES = ("generic", "cim-mlc", "dp")
