"""Pareto-frontier extraction over evaluation records.

Copied from :mod:`repro.explore.pareto` (the JAX package).

Objectives are *minimized*.  Axes can be named strings ("cycles",
"energy", "edp", "macros", "latency_s") or arbitrary
``EvalRecord -> float`` callables; the default pair is the paper's
cycles-vs-energy trade-off, and adding "macros" gives the
3-objective performance/energy/silicon frontier.

:func:`annotate` attaches per-point dominance metadata
(:class:`ParetoPoint`: on-frontier flag, how many points dominate it,
frontier rank by non-dominated sorting); :func:`pareto_frontier`
returns just the non-dominated records.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple, Union

from .records import EvalRecord

__all__ = ["AXES", "ParetoPoint", "dominates", "annotate",
           "pareto_frontier", "frontier_report"]

Axis = Union[str, Callable[[EvalRecord], float]]

AXES: Dict[str, Callable[[EvalRecord], float]] = {
    "cycles": lambda r: r.cycles,
    "energy": lambda r: r.energy_total,
    "edp": lambda r: r.edp,
    "macros": lambda r: float(r.point.total_macros),
    "latency_s": lambda r: r.cycles,   # monotone alias of cycles
}


def _resolve(axes: Sequence[Axis]) -> List[Callable[[EvalRecord], float]]:
    out = []
    for a in axes:
        if callable(a):
            out.append(a)
        elif a in AXES:
            out.append(AXES[a])
        else:
            raise KeyError(f"unknown Pareto axis {a!r}; "
                           f"have {sorted(AXES)} or pass a callable")
    return out


def _values(rec: EvalRecord,
            fns: Sequence[Callable[[EvalRecord], float]]
            ) -> Tuple[float, ...]:
    return tuple(f(rec) for f in fns)


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff ``a`` is no worse than ``b`` everywhere, better somewhere."""
    return all(x <= y for x, y in zip(a, b)) \
        and any(x < y for x, y in zip(a, b))


@dataclass
class ParetoPoint:
    """A record plus its dominance metadata within one analyzed set."""

    record: EvalRecord
    values: Tuple[float, ...]      # objective vector (minimized)
    on_frontier: bool
    dominated_by: int              # how many points dominate this one
    rank: int                      # non-dominated sorting front (0 = frontier)


def annotate(records: Sequence[EvalRecord],
             axes: Sequence[Axis] = ("cycles", "energy")
             ) -> List[ParetoPoint]:
    """Full dominance analysis: O(n^2) pairwise + front peeling."""
    fns = _resolve(axes)
    vals = [_values(r, fns) for r in records]
    n = len(records)
    dom_count = [0] * n
    for i in range(n):
        for j in range(n):
            if i != j and dominates(vals[j], vals[i]):
                dom_count[i] += 1

    # non-dominated sorting (front peeling) for ranks
    rank = [-1] * n
    remaining = set(range(n))
    level = 0
    while remaining:
        front = {i for i in remaining
                 if not any(dominates(vals[j], vals[i])
                            for j in remaining if j != i)}
        if not front:          # identical duplicate vectors: break ties
            front = set(remaining)
        for i in front:
            rank[i] = level
        remaining -= front
        level += 1

    return [ParetoPoint(record=records[i], values=vals[i],
                        on_frontier=dom_count[i] == 0,
                        dominated_by=dom_count[i], rank=rank[i])
            for i in range(n)]


def pareto_frontier(records: Sequence[EvalRecord],
                    axes: Sequence[Axis] = ("cycles", "energy")
                    ) -> List[EvalRecord]:
    """The non-dominated subset, sorted by the first axis.

    Failed evaluations (``record.ok == False``) are excluded up front —
    their infinite objective vectors would survive dominance checks in
    the all-errors corner case.
    """
    records = [r for r in records if r.ok]
    fns = _resolve(axes)
    pts = [p for p in annotate(records, axes) if p.on_frontier]
    pts.sort(key=lambda p: p.values)
    # collapse exact duplicates (same objective vector + same point)
    out: List[EvalRecord] = []
    seen = set()
    for p in pts:
        key = (p.values, p.record.point)
        if key not in seen:
            seen.add(key)
            out.append(p.record)
    return out


def frontier_report(records: Sequence[EvalRecord],
                    axes: Sequence[Axis] = ("cycles", "energy")
                    ) -> str:
    """Human-readable frontier table for benchmark reports."""
    front = pareto_frontier(records, axes)
    names = [a if isinstance(a, str) else getattr(a, "__name__", "obj")
             for a in axes]
    head = ("point (strategy mg n_mg cores flit lmem)  "
            + "  ".join(f"{n:>12s}" for n in names))
    lines = [head]
    fns = _resolve(axes)
    for r in front:
        p = r.point
        lines.append(
            f"{p.strategy:8s} {p.macros_per_group:3d} "
            f"{p.n_macro_groups:4d} {p.n_cores:5d} {p.flit_bytes:4d} "
            f"{p.local_mem_kb:5d}  "
            + "  ".join(f"{f(r):12.4g}" for f in fns))
    return "\n".join(lines)
