"""``repro_torch.explore`` — design-space exploration on the port.

Counterpart of :mod:`repro.explore` (the JAX package), with the same
public surface:

* :mod:`~repro_torch.explore.space` — declarative ``ChipConfig`` x
  strategy design spaces with constraints, sampling and mutation;
* :mod:`~repro_torch.explore.engine` — pool-parallel evaluation behind
  a content-addressed on-disk result cache, the simulate fidelity on
  the card (``engine="torch"`` batches timing sweeps through the
  fleet);
* :mod:`~repro_torch.explore.fleet` — :class:`FleetEvaluator`, one
  compiled program under many chips' timing, each stage decoded once
  for the whole fleet;
* :mod:`~repro_torch.explore.search` — grid / random / hill-climbing /
  two-fidelity successive-halving strategies;
* :mod:`~repro_torch.explore.pareto` + :mod:`~repro_torch.explore.
  records` — JSONL result store and Pareto-frontier dominance analysis;
* :mod:`~repro_torch.explore.cli` — ``python -m repro_torch.explore``.

Quickstart::

    from repro_torch.explore import (ExplorationEngine, default_space,
                                     pareto_frontier, successive_halving)
    eng = ExplorationEngine("resnet18", res=112, pool=8)
    result, screened = successive_halving(eng, default_space(), top_k=4)
    front = pareto_frontier(screened, axes=("cycles", "energy"))

Multi-chip points (``mesh_space``) compile through
:mod:`repro_torch.system`; at simulate fidelity they run per point, in
this process, each chip slice decoded on the card.
"""

from ..core.machine import Calibration
from . import cache, cli, engine, fleet, pareto, records, search, space
from .cache import ResultCache, cache_key, default_cache_dir
from .engine import ExplorationEngine, evaluate_chip
from .fleet import FleetEvaluator, canonical_chip
from .pareto import (AXES, ParetoPoint, annotate, frontier_report,
                     pareto_frontier)
from .records import FIDELITIES, EvalRecord, RecordStore
from .search import (SearchResult, by_cycles, by_edp, by_energy,
                     grid_search, hill_climb, random_search,
                     successive_halving)
from .space import (SWEEP_FLIT, SWEEP_MG, DesignPoint, DesignSpace,
                    Dimension, default_space, mesh_space, mg_flit_space,
                    protection_space, timing_space)

__all__ = [
    "cache", "cli", "engine", "fleet", "pareto", "records", "search",
    "space",
    "ResultCache", "cache_key", "default_cache_dir",
    "ExplorationEngine", "evaluate_chip", "Calibration",
    "FleetEvaluator", "canonical_chip",
    "AXES", "ParetoPoint", "annotate", "frontier_report",
    "pareto_frontier",
    "FIDELITIES", "EvalRecord", "RecordStore",
    "SearchResult", "by_cycles", "by_edp", "by_energy", "grid_search",
    "hill_climb", "random_search", "successive_halving",
    "DesignPoint", "DesignSpace", "Dimension", "default_space",
    "mesh_space", "mg_flit_space", "protection_space", "timing_space",
    "SWEEP_MG", "SWEEP_FLIT",
]
