"""Search strategies over a :class:`DesignSpace`.

Copied from :mod:`repro.explore.search` (the JAX package).

All strategies consume an :class:`ExplorationEngine` (so caching and
pool parallelism apply transparently) and minimize an *objective* — any
``EvalRecord -> float``.  Stock objectives: :func:`by_cycles`,
:func:`by_energy`, :func:`by_edp`.

* :func:`grid_search` — exhaustive enumeration of the valid grid.
* :func:`random_search` — uniform sampling without replacement.
* :func:`hill_climb` — restarted stochastic hill-climbing: batches of
  mutated neighbors per step (batch evaluation keeps the pool busy),
  move to the best improving neighbor, restart from a fresh random
  point at local optima.
* :func:`successive_halving` — the two-fidelity mode: screen every
  candidate with the analytic cost model, then promote only the top-K
  survivors to the cycle-accurate simulator.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .engine import ExplorationEngine
from .records import EvalRecord
from .space import DesignPoint, DesignSpace

__all__ = [
    "by_cycles", "by_energy", "by_edp", "SearchResult",
    "grid_search", "random_search", "hill_climb", "successive_halving",
]

Objective = Callable[[EvalRecord], float]


def by_cycles(r: EvalRecord) -> float:
    return r.cycles


def by_energy(r: EvalRecord) -> float:
    return r.energy_total


def by_edp(r: EvalRecord) -> float:
    return r.edp


@dataclass
class SearchResult:
    """Best record found plus the full evaluation trace."""

    best: EvalRecord
    history: List[EvalRecord] = field(default_factory=list)
    n_evals: int = 0

    @property
    def best_point(self) -> DesignPoint:
        return self.best.point


def _pick_best(records: Sequence[EvalRecord],
               objective: Objective) -> EvalRecord:
    if not records:
        raise ValueError("no records to pick from")
    return min(records, key=objective)


def grid_search(engine: ExplorationEngine, space: DesignSpace,
                objective: Objective = by_edp,
                fidelity: Optional[str] = None) -> SearchResult:
    recs = engine.sweep(space, fidelity)
    return SearchResult(best=_pick_best(recs, objective), history=recs,
                        n_evals=len(recs))


def random_search(engine: ExplorationEngine, space: DesignSpace,
                  n: int, objective: Objective = by_edp, seed: int = 0,
                  fidelity: Optional[str] = None) -> SearchResult:
    pts = space.sample(n, seed=seed)
    recs = engine.evaluate(pts, fidelity)
    return SearchResult(best=_pick_best(recs, objective), history=recs,
                        n_evals=len(recs))


def hill_climb(engine: ExplorationEngine, space: DesignSpace,
               objective: Objective = by_edp, seed: int = 0,
               iters: int = 24, neighbors: int = 4, restarts: int = 2,
               fidelity: Optional[str] = None) -> SearchResult:
    """Restarted stochastic hill-climbing with batched neighbor evals.

    ``iters`` is the *total* step budget across all restarts; each step
    evaluates up to ``neighbors`` distinct mutations of the incumbent
    (one pool batch).  Previously-seen points are skipped — with the
    engine's cache they would be free anyway, but skipping keeps the
    step budget meaningful on small spaces.
    """
    rng = random.Random(seed)
    history: List[EvalRecord] = []
    seen: Dict[DesignPoint, EvalRecord] = {}

    def eval_points(pts: Sequence[DesignPoint]) -> List[EvalRecord]:
        fresh = [p for p in pts if p not in seen]
        for rec in engine.evaluate(fresh, fidelity):
            seen[rec.point] = rec
            history.append(rec)
        return [seen[p] for p in pts]

    best: Optional[EvalRecord] = None
    steps = 0
    for _ in range(max(1, restarts)):
        cur = eval_points([space.random_point(rng)])[0]
        if best is None or objective(cur) < objective(best):
            best = cur
        while steps < iters:
            steps += 1
            cand: List[DesignPoint] = []
            for _ in range(neighbors * 4):
                m = space.mutate(cur.point, rng)
                if m != cur.point and m not in cand:
                    cand.append(m)
                if len(cand) >= neighbors:
                    break
            if not cand:
                break
            recs = eval_points(cand)
            step_best = _pick_best(recs, objective)
            if objective(step_best) < objective(cur):
                cur = step_best
                if objective(cur) < objective(best):
                    best = cur
            else:
                break               # local optimum -> restart
        if steps >= iters:
            break
    assert best is not None
    return SearchResult(best=best, history=history,
                        n_evals=len(history))


def successive_halving(engine: ExplorationEngine,
                       points_or_space, top_k: int = 4,
                       objective: Objective = by_edp,
                       screen_fidelity: str = "analytic",
                       calibrate: int = 0,
                       ) -> Tuple[SearchResult, List[EvalRecord]]:
    """Two-fidelity screening: cheap everywhere, simulate the top-K.

    ``screen_fidelity`` picks the cheap rung (``"analytic"`` or
    ``"trace"``).  With ``calibrate=N > 0`` the screen runs twice: a
    raw pass picks N representative points, the engine fits per-unit
    correction factors from their simulator runs
    (:meth:`ExplorationEngine.calibrate`), and the *calibrated* screen
    decides the promotions — the fix for cheap-model mis-rankings on
    communication-heavy workloads (the resnet18@112 ~10x gap).

    Returns ``(result, screened)`` where ``result`` ranks only the
    simulator-validated survivors and ``screened`` holds the final
    cheap-fidelity pass (for Pareto plots of the whole space).
    """
    if isinstance(points_or_space, DesignSpace):
        points = points_or_space.points()
    else:
        points = list(points_or_space)
    screened = engine.evaluate(points, fidelity=screen_fidelity)
    n_evals = len(screened)
    if calibrate > 0:
        ranked = sorted(screened, key=objective)
        anchors = [r.point for r in ranked[:calibrate] if r.ok]
        if anchors:
            engine.calibrate(anchors, fidelity=screen_fidelity,
                             max_points=calibrate)
            n_evals += len(anchors)     # one simulator run per anchor
            screened = engine.evaluate(points,
                                       fidelity=screen_fidelity)
            n_evals += len(screened)
    ranked = sorted(screened, key=objective)
    survivors = [r.point for r in ranked[:max(1, top_k)]]
    promoted = engine.evaluate(survivors, fidelity="simulate")
    res = SearchResult(best=_pick_best(promoted, objective),
                       history=promoted,
                       n_evals=n_evals + len(promoted))
    return res, screened
