"""Declarative design space over ``ChipConfig`` x compile strategy.

Host code copied from :mod:`repro.explore.space` (the JAX package).
Multi-chip points (``chips > 1``) build their mesh with
:class:`repro_torch.system.SystemConfig`.

The exploration subsystem (paper §IV-C) treats a candidate design as a
:class:`DesignPoint` — a small, hashable record of the architectural
knobs the paper sweeps (macro-group size, MG count, core grid, NoC flit
width, local-memory size) plus the compilation strategy.  A
:class:`DesignSpace` is an ordered set of :class:`Dimension` values with
validity constraints; it can enumerate the full grid, sample uniformly,
and mutate a point along one axis (the neighborhood structure used by
hill-climbing / evolutionary search).

Points are *descriptions*, not hardware: :meth:`DesignPoint.chip`
materializes the ``ChipConfig`` (raising nothing for valid points —
validity is checked at space level via :meth:`DesignSpace.is_valid`).
"""

from __future__ import annotations

import dataclasses
import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from ..core.arch import (ArchError, ChipConfig, ProtectionConfig,
                         default_chip)
from ..core.partition import STRATEGIES

__all__ = [
    "DesignPoint", "Dimension", "DesignSpace", "default_space",
    "mg_flit_space", "mesh_space", "timing_space", "protection_space",
    "SWEEP_MG", "SWEEP_FLIT",
]

# The paper's Fig. 6 / Fig. 7 grid — the single source of truth shared
# by mg_flit_space() defaults, the fig6/fig7 benchmarks and the
# core.dse shim, so overlapping sweeps keep hitting the same cache keys.
SWEEP_MG = (4, 8, 16)          # macros per MG (Fig. 6 x-axis)
SWEEP_FLIT = (8, 16)           # NoC flit bytes (light/dark shading)


def _mesh_cols(n_cores: int) -> int:
    """Squarest 2-D mesh factorization: largest divisor <= sqrt(n)."""
    best = 1
    d = 1
    while d * d <= n_cores:
        if n_cores % d == 0:
            best = d
        d += 1
    return best


@dataclass(frozen=True, order=True)
class DesignPoint:
    """One candidate design: architecture knobs + compile strategy."""

    macros_per_group: int = 8
    n_macro_groups: int = 16
    n_cores: int = 64
    flit_bytes: int = 8
    local_mem_kb: int = 512
    strategy: str = "generic"
    # multi-chip scale-out axes (repro_torch.system); chips=1 keeps the
    # classic single-chip path (and its historical cache keys)
    chips: int = 1
    link: str = "pcb"
    parallel: str = "pipeline"
    # timing-only axes: none of these steer partitioning or codegen, so
    # points differing only here share one canonical chip — the fleet
    # evaluator (explore.fleet) compiles once and decodes the batch
    scalar_alu_latency: int = 1
    vector_alu_latency: int = 1
    weight_load_rows_per_cycle: int = 1
    router_latency: int = 2
    # fault-mitigation axes (repro_torch.faults): cycle/energy/area overhead
    # vs residual fault rate.  All-off keeps the historical chip.
    ecc: bool = False
    spare_rows: int = 0
    tmr: bool = False

    def chip(self) -> ChipConfig:
        prot = ProtectionConfig(ecc=self.ecc,
                                spare_rows=self.spare_rows,
                                tmr=self.tmr)
        suffix = ""
        if prot.enabled:
            suffix = ("-p" + ("e" if self.ecc else "")
                      + (f"s{self.spare_rows}" if self.spare_rows else "")
                      + ("t" if self.tmr else ""))
        chip = default_chip(
            macros_per_group=self.macros_per_group,
            n_macro_groups=self.n_macro_groups,
            flit_bytes=self.flit_bytes,
            local_mem_kb=self.local_mem_kb,
            n_cores=self.n_cores,
            mesh_cols=_mesh_cols(self.n_cores),
            protection=prot,
            name=(f"c{self.n_cores}-mg{self.macros_per_group}"
                  f"x{self.n_macro_groups}-f{self.flit_bytes}"
                  f"-l{self.local_mem_kb}{suffix}"),
        )
        if (self.scalar_alu_latency, self.vector_alu_latency,
                self.weight_load_rows_per_cycle,
                self.router_latency) == (1, 1, 1, 2):
            return chip              # defaults: historical chip object
        core = chip.core
        return dataclasses.replace(
            chip,
            core=dataclasses.replace(
                core,
                scalar=dataclasses.replace(
                    core.scalar, alu_latency=self.scalar_alu_latency),
                vector=dataclasses.replace(
                    core.vector, alu_latency=self.vector_alu_latency),
                cim=dataclasses.replace(
                    core.cim, weight_load_rows_per_cycle=(
                        self.weight_load_rows_per_cycle))),
            noc=dataclasses.replace(chip.noc,
                                    router_latency=self.router_latency))

    def system(self) -> Optional[Any]:
        """``SystemConfig`` mesh for multi-chip points, else ``None``."""
        if self.chips <= 1:
            return None
        from ..system import SystemConfig
        return SystemConfig.mesh(self.chips, link=self.link,
                                 parallel=self.parallel)

    @property
    def total_macros(self) -> int:
        """Silicon-cost axis for Pareto — macro count across all chips."""
        return (self.n_cores * self.n_macro_groups * self.macros_per_group
                * max(1, self.chips))

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DesignPoint":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    def replace(self, **kw: Any) -> "DesignPoint":
        return dataclasses.replace(self, **kw)


_POINT_FIELDS = tuple(f.name for f in dataclasses.fields(DesignPoint))

Constraint = Callable[[DesignPoint], bool]


@dataclass(frozen=True)
class Dimension:
    """One axis of the design space (name must be a DesignPoint field)."""

    name: str
    values: Tuple[Any, ...]

    def __post_init__(self) -> None:
        if self.name not in _POINT_FIELDS:
            raise ValueError(f"unknown dimension {self.name!r}; "
                             f"DesignPoint has {_POINT_FIELDS}")
        if not self.values:
            raise ValueError(f"dimension {self.name!r} has no values")
        object.__setattr__(self, "values", tuple(self.values))


class DesignSpace:
    """Cartesian product of :class:`Dimension` values with constraints.

    Unlisted ``DesignPoint`` fields stay at their defaults.  Built-in
    validity = the point's ``ChipConfig`` constructs without
    :class:`ArchError`; extra predicates narrow it further.
    """

    def __init__(self, dims: Sequence[Dimension],
                 constraints: Sequence[Constraint] = ()) -> None:
        seen = set()
        for d in dims:
            if d.name in seen:
                raise ValueError(f"duplicate dimension {d.name!r}")
            seen.add(d.name)
        self.dims: Tuple[Dimension, ...] = tuple(dims)
        self.constraints: Tuple[Constraint, ...] = tuple(constraints)

    # -- validity -----------------------------------------------------------

    def is_valid(self, pt: DesignPoint) -> bool:
        try:
            pt.chip()
            pt.system()
        except (ArchError, ValueError):
            return False
        return all(c(pt) for c in self.constraints)

    # -- enumeration / sampling --------------------------------------------

    @property
    def grid_size(self) -> int:
        """Size of the raw grid (before constraint filtering)."""
        n = 1
        for d in self.dims:
            n *= len(d.values)
        return n

    def __iter__(self) -> Iterator[DesignPoint]:
        """All *valid* points, grid order (last dimension fastest)."""
        names = [d.name for d in self.dims]
        for combo in itertools.product(*(d.values for d in self.dims)):
            pt = DesignPoint(**dict(zip(names, combo)))
            if self.is_valid(pt):
                yield pt

    def points(self) -> List[DesignPoint]:
        out: List[DesignPoint] = []
        for pt in self.__iter__():
            out.append(pt)
        return out

    def __len__(self) -> int:
        return len(self.points())

    def __contains__(self, pt: DesignPoint) -> bool:
        for d in self.dims:
            if getattr(pt, d.name) not in d.values:
                return False
        return self.is_valid(pt)

    def random_point(self, rng: random.Random) -> DesignPoint:
        """One uniformly-sampled valid point (rejection sampling)."""
        for _ in range(10_000):
            pt = DesignPoint(**{d.name: rng.choice(d.values)
                                for d in self.dims})
            if self.is_valid(pt):
                return pt
        raise ArchError("design space appears empty (10k rejections)")

    def sample(self, n: int, seed: int = 0) -> List[DesignPoint]:
        """``n`` distinct valid points (or the whole space if smaller)."""
        rng = random.Random(seed)
        pts = self.points()
        if n >= len(pts):
            return pts
        return rng.sample(pts, n)

    # -- neighborhood (mutation) -------------------------------------------

    def mutate(self, pt: DesignPoint, rng: random.Random) -> DesignPoint:
        """Step one randomly-chosen dimension to an adjacent/other value."""
        dims = [d for d in self.dims if len(d.values) > 1]
        if not dims:
            return pt
        for _ in range(100):
            d = rng.choice(dims)
            cur = getattr(pt, d.name)
            if cur in d.values:
                i = d.values.index(cur)
                # prefer adjacent values (smooth walk) over teleports
                cand = [j for j in (i - 1, i + 1) if 0 <= j < len(d.values)]
                j = rng.choice(cand)
            else:
                j = rng.randrange(len(d.values))
            new = pt.replace(**{d.name: d.values[j]})
            if new != pt and self.is_valid(new):
                return new
        return pt

    def neighbors(self, pt: DesignPoint) -> List[DesignPoint]:
        """All valid single-dimension steps from ``pt``."""
        out: List[DesignPoint] = []
        for d in self.dims:
            cur = getattr(pt, d.name)
            idx = d.values.index(cur) if cur in d.values else None
            cand = (d.values if idx is None
                    else [d.values[j] for j in (idx - 1, idx + 1)
                          if 0 <= j < len(d.values)])
            for v in cand:
                new = pt.replace(**{d.name: v})
                if new != pt and self.is_valid(new):
                    out.append(new)
        return out

    def describe(self) -> str:
        dims = ", ".join(f"{d.name}={list(d.values)}" for d in self.dims)
        return f"DesignSpace({dims}; grid {self.grid_size})"


# ---------------------------------------------------------------------------
# Stock spaces
# ---------------------------------------------------------------------------


def mg_flit_space(mgs: Sequence[int] = SWEEP_MG,
                  flits: Sequence[int] = SWEEP_FLIT,
                  strategies: Sequence[str] = ("generic",)) -> DesignSpace:
    """The seed's Fig. 6 / Fig. 7 grid: MG size x flit width (x strategy)."""
    return DesignSpace([
        Dimension("macros_per_group", tuple(mgs)),
        Dimension("flit_bytes", tuple(flits)),
        Dimension("strategy", tuple(strategies)),
    ])


def mesh_space(chips: Sequence[int] = (1, 2, 4),
               links: Sequence[str] = ("interposer", "pcb"),
               parallel: Sequence[str] = ("pipeline",)) -> DesignSpace:
    """Scale-out grid: chip count x inter-chip link tier (x parallelism).

    Single-chip points ignore the ``link``/``parallel`` axes; the grid
    still enumerates every combination, so pair this with a constraint
    (or dedup on ``pt.system()``) when exact point counts matter.
    """
    return DesignSpace([
        Dimension("chips", tuple(chips)),
        Dimension("link", tuple(links)),
        Dimension("parallel", tuple(parallel)),
    ])


def timing_space(scalar_alu: Sequence[int] = (1, 2),
                 vector_alu: Sequence[int] = (1, 2, 3, 4),
                 wl_rate: Sequence[int] = (1, 2, 4, 8),
                 router: Sequence[int] = (1, 2),
                 strategies: Sequence[str] = ("dp",)) -> DesignSpace:
    """Timing-only sweep on a fixed structure (64 points by default).

    Every point shares one canonical chip, so the fleet evaluator
    (``ExplorationEngine(engine="torch")``) compiles the workload once
    and evaluates the whole grid in one batched decode per stage on the
    card.
    """
    return DesignSpace([
        Dimension("scalar_alu_latency", tuple(scalar_alu)),
        Dimension("vector_alu_latency", tuple(vector_alu)),
        Dimension("weight_load_rows_per_cycle", tuple(wl_rate)),
        Dimension("router_latency", tuple(router)),
        Dimension("strategy", tuple(strategies)),
    ])


def protection_space(spares: Sequence[int] = (0, 2, 4),
                     strategies: Sequence[str] = ("dp",)) -> DesignSpace:
    """Fault-mitigation sweep on the default structure (12 points).

    ECC x TMR x spare-row grid over one chip: pairs with
    :func:`repro_torch.faults.residual_rate` to trade protection overhead
    (cycles/energy via :class:`~repro_torch.core.machine.MachineModel`
    accessors, area via ``protection_area_factor``) against residual
    fault rate at a given raw-defect rate.
    """
    return DesignSpace([
        Dimension("ecc", (False, True)),
        Dimension("tmr", (False, True)),
        Dimension("spare_rows", tuple(spares)),
        Dimension("strategy", tuple(strategies)),
    ])


def default_space(strategies: Sequence[str] = STRATEGIES) -> DesignSpace:
    """The full 5-dimension architecture space from the paper §IV-C."""
    return DesignSpace([
        Dimension("macros_per_group", (2, 4, 8, 16)),
        Dimension("n_macro_groups", (8, 16, 32)),
        Dimension("n_cores", (16, 36, 64)),
        Dimension("flit_bytes", (8, 16, 32)),
        Dimension("local_mem_kb", (256, 512, 1024)),
        Dimension("strategy", tuple(strategies)),
    ])
