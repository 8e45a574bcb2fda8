"""Parallel evaluation engine for design-space exploration.

Host code copied from :mod:`repro.explore.engine` (the JAX package),
with a ``device`` for the simulate fidelity and the port's engines.

Evaluates :class:`~repro_torch.explore.space.DesignPoint` batches against one
workload, at any rung of the fidelity ladder:

* ``"analytic"`` — partition + the analytic cost model (fast; the
  screening fidelity for large sweeps and successive halving);
* ``"trace"`` — StagePlan replay at unit/transfer granularity
  (~100x faster than the simulator, within its documented band);
* ``"simulate"`` — compile to ISA streams and run the cycle-accurate
  simulator (ground truth), each stage decoded on ``device``.

Simulate-fidelity engines (``engine=``): ``"auto"`` runs each point on
its own with the simulator's default engine (``torch``, the stage
decode on the card); ``"vector"`` and ``"scalar"`` are the numpy host
engines, bit-identical to it; ``"torch"`` batches single-chip misses
through :class:`~repro_torch.explore.fleet.FleetEvaluator` (one compile
and one batched decode per stage for every group of points sharing a
canonical chip).

The engine checks the content-addressed :class:`ResultCache` first, fans
the misses out over a ``multiprocessing`` pool, writes results back to
the cache, and optionally appends every record to a JSONL
:class:`RecordStore`.  The pool forks, which is safe for the numpy
paths (the cheap fidelities, the host engines).  A forked child can use
neither CUDA nor torch's CPU thread pool once its parent has, so
simulate points on the ``torch`` engine (``"auto"`` or ``"torch"``, on
any device) are evaluated in this process instead.  Results always come
back in input order, and a given key always produces an identical
record — cached or not.

Cheap-fidelity misses (analytic / trace) are evaluated in *batches*:
one ``flow.compile_many`` invocation partitions N candidate chips
against the engine's single condensed graph, so an arch sweep pays the
condense pass once per process instead of once per point.  A
:class:`~repro_torch.core.machine.Calibration` (see
:meth:`ExplorationEngine.calibrate`) rides into every cheap evaluation
— and into the cache key — so calibrated screening ranks match
simulator ranks.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time
import warnings
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .. import flow
from ..core import workloads
from ..core.arch import ArchError, ChipConfig
from ..core.graph import CondensedGraph
from ..core.machine import Calibration
from ..core.mapping import CostParams
from ..device import resolve_device
from ..flow import CompileOptions
from ..flow.diskcache import ENV_VAR as _FLOW_CACHE_ENV
from .cache import ResultCache, cache_key
from .records import FIDELITIES, EvalRecord, RecordStore
from .space import DesignPoint, DesignSpace

__all__ = ["evaluate_chip", "ExplorationEngine"]

# fidelities the batched compile_many path handles (no codegen needed)
_CHEAP = ("analytic", "trace")


def evaluate_chip(cg: CondensedGraph, chip: ChipConfig, strategy: str,
                  params: Optional[CostParams] = None,
                  fidelity: str = "analytic",
                  calibration: Optional[Calibration] = None,
                  system: Optional[Any] = None,
                  engine: str = "auto",
                  device: Union[str, torch.device, None] = None
                  ) -> Dict[str, Any]:
    """Score one (graph, chip, strategy) at the given fidelity.

    Runs on the :mod:`repro_torch.flow` pass pipeline, so a point promoted
    from the analytic screen to the simulator in the same process
    reuses its cached partition instead of re-partitioning.  With a
    ``system`` (:class:`repro_torch.system.SystemConfig`), the chip is
    replicated over the mesh and the score covers the whole multi-chip
    plan.  The simulate fidelity runs ``engine`` with its stage decode
    on ``device`` (CUDA unless named; raises without a card).  Returns
    ``{"cycles", "energy", "throughput_sps"}`` — the payload the cache
    stores and :class:`EvalRecord` wraps.
    """
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                         f"got {fidelity!r}")
    params = params or CostParams(batch=4)
    art = flow.compile(cg, chip,
                       CompileOptions(strategy=strategy, params=params,
                                      fidelity=fidelity,
                                      calibration=calibration,
                                      system=system))
    # only the simulator backend takes an engine and a device; cheap
    # fidelities have no per-instruction execution path to select
    kw = ({"engine": engine, "device": device}
          if fidelity == "simulate" else {})
    rep = art.evaluate(**kw)
    return {"cycles": rep.cycles, "energy": dict(rep.energy),
            "throughput_sps": rep.throughput_sps}


# ---------------------------------------------------------------------------
# Pool workers (module-level for spawn-context picklability)
# ---------------------------------------------------------------------------

_WORKER: Dict[str, Any] = {}


def _init_worker(model: str, workload_kw: Dict[str, Any],
                 params: CostParams,
                 calibration: Optional[Calibration] = None,
                 flow_cache: Optional[str] = None,
                 engine: str = "auto",
                 device: Optional[torch.device] = None) -> None:
    if flow_cache:
        os.environ[_FLOW_CACHE_ENV] = flow_cache
    _WORKER["cg"] = workloads.build(model, **workload_kw).condense()
    _WORKER["params"] = params
    _WORKER["calibration"] = calibration
    _WORKER["engine"] = engine
    _WORKER["device"] = device


def _err_payload(e: Exception, wall_s: float = 0.0) -> Dict[str, Any]:
    return {"cycles": float("inf"), "energy": {"total": float("inf")},
            "throughput_sps": 0.0, "wall_s": wall_s,
            "error": f"{type(e).__name__}: {e}"}


def _eval_worker(job: Tuple[DesignPoint, str]) -> Dict[str, Any]:
    """Evaluate one point; infeasible points become error payloads
    (cycles=inf) instead of killing the whole sweep."""
    point, fidelity = job
    t0 = time.perf_counter()
    try:
        out = evaluate_chip(_WORKER["cg"], point.chip(), point.strategy,
                            _WORKER["params"], fidelity,
                            _WORKER.get("calibration"),
                            system=point.system(),
                            engine=_WORKER.get("engine", "auto"),
                            device=_WORKER.get("device"))
    except Exception as e:        # noqa: BLE001 — point-local failure
        out = _err_payload(e)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _eval_batch_worker(jobs: List[Tuple[DesignPoint, str]]
                       ) -> List[Dict[str, Any]]:
    """Batched cheap-fidelity evaluation: one ``flow.compile_many``
    per (strategy, fidelity) group — the condense pass runs once for
    the whole chunk.  Any group-level failure falls back to per-point
    evaluation so one infeasible chip cannot poison its batch."""
    cg = _WORKER["cg"]
    params = _WORKER["params"]
    calibration = _WORKER.get("calibration")
    results: List[Optional[Dict[str, Any]]] = [None] * len(jobs)
    groups: Dict[Tuple[str, str, Any], List[int]] = defaultdict(list)
    for i, (pt, fid) in enumerate(jobs):
        # SystemConfig is a frozen dataclass, so it groups/hashes fine;
        # single-chip points all land in the system=None group
        try:
            groups[(pt.strategy, fid, pt.system())].append(i)
        except Exception as e:           # noqa: BLE001 — bad mesh/link
            results[i] = _err_payload(e)
    for (strategy, fidelity, system), idxs in groups.items():
        chips: List[ChipConfig] = []
        ok: List[int] = []
        for i in idxs:
            try:
                chips.append(jobs[i][0].chip())
                ok.append(i)
            except Exception as e:       # noqa: BLE001
                results[i] = _err_payload(e)
        if not ok:
            continue
        t0 = time.perf_counter()
        try:
            arts = flow.compile_many(
                cg, chips,
                CompileOptions(strategy=strategy, params=params,
                               fidelity=fidelity,
                               calibration=calibration,
                               system=system))
        except Exception:                # noqa: BLE001
            # e.g. one chip infeasible mid-batch: isolate per point
            for i in ok:
                results[i] = _eval_worker(jobs[i])
            continue
        per_compile = (time.perf_counter() - t0) / len(arts)
        for i, art in zip(ok, arts):
            t1 = time.perf_counter()
            try:
                rep = art.evaluate()
                results[i] = {
                    "cycles": rep.cycles, "energy": dict(rep.energy),
                    "throughput_sps": rep.throughput_sps,
                    "wall_s": (time.perf_counter() - t1) + per_compile}
            except Exception as e:       # noqa: BLE001
                results[i] = _err_payload(
                    e, (time.perf_counter() - t1) + per_compile)
    return results


class ExplorationEngine:
    """Cached, pool-parallel evaluator for one workload.

    Parameters
    ----------
    model:
        Workload name from :data:`repro_torch.core.workloads.WORKLOADS`.
    pool:
        Worker processes; ``0``/``1`` evaluates serially in-process.
    cache:
        ``ResultCache`` instance, a directory path, or ``None`` to
        disable caching entirely.
    store:
        Optional ``RecordStore`` (or path) appended to on every eval.
    calibration:
        Per-unit correction factors applied to cheap fidelities
        (analytic / trace) and mixed into every cache key.  Fit one
        with :meth:`calibrate` or :func:`repro_torch.flow.calibrate`; a
        string names a saved preset (``results/calibrations/*.json``,
        written by ``flow.calibrate(..., save=name)``).
    flow_cache:
        Directory for the :mod:`repro_torch.flow` *pass-output* disk cache
        (distinct from ``cache``, which stores finished evaluation
        payloads).  Pool workers inherit it, so no worker ever
        re-partitions a (workload, chip, strategy) any process has
        already partitioned.
    engine:
        Simulate-fidelity engine: ``"auto"`` (each point on the
        simulator's default ``torch`` engine), ``"vector"``,
        ``"scalar"``, or ``"torch"`` for the batched fleet.
    device:
        Where simulate-fidelity decodes run (CUDA unless named; raises
        without a card, whatever the fidelity).
    """

    def __init__(self, model: str, params: Optional[CostParams] = None,
                 pool: int = 0,
                 cache: Union[ResultCache, str, None] = None,
                 store: Union[RecordStore, str, None] = None,
                 fidelity: str = "analytic",
                 calibration: Union[Calibration, str, None] = None,
                 flow_cache: Optional[str] = None,
                 engine: str = "auto",
                 pool_retries: int = 2,
                 pool_backoff_s: float = 0.5,
                 device: Union[str, torch.device, None] = None,
                 **workload_kw: Any) -> None:
        # validate eagerly: an unknown model raising inside a pool
        # worker's initializer would respawn workers forever
        if model not in workloads.WORKLOADS:
            raise KeyError(f"unknown workload {model!r}; "
                           f"have {sorted(workloads.WORKLOADS)}")
        from ..core.simulator import ENGINES
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, "
                             f"got {engine!r}")
        self.engine = engine
        self.device = resolve_device(device)
        self.model = model
        if pool_retries < 0 or pool_backoff_s < 0:
            raise ValueError("pool_retries and pool_backoff_s must be "
                             "non-negative")
        self.pool_retries = pool_retries
        self.pool_backoff_s = pool_backoff_s
        self.workload_kw = dict(workload_kw)
        self.params = params or CostParams(batch=4)
        self.pool = int(pool)
        self.fidelity = fidelity
        if isinstance(calibration, str):
            calibration = flow.load_calibration(calibration)
        self.calibration = calibration
        self.flow_cache = flow_cache
        if flow_cache:
            # the parent's default pipeline (and fork children) attach
            # the disk tier; spawn children get it via the initializer.
            # Rebind an existing tier too — parent and workers must
            # agree on one directory or workers' partitions are lost.
            # NOTE: the flow pass cache is process-wide by design (all
            # compiles in this process funnel through the default
            # pipeline), so the last engine constructed wins; warn when
            # engines disagree instead of silently redirecting.
            os.environ[_FLOW_CACHE_ENV] = flow_cache
            pipe = flow.default_pipeline()
            if pipe.disk is not None and pipe.disk.root != flow_cache:
                warnings.warn(
                    f"flow pass cache is process-wide: rebinding it "
                    f"from {pipe.disk.root!r} to {flow_cache!r} for "
                    f"every engine/compile in this process",
                    RuntimeWarning, stacklevel=2)
            if pipe.disk is None or pipe.disk.root != flow_cache:
                pipe.disk = flow.PassDiskCache(flow_cache)
        if isinstance(cache, str):
            cache = ResultCache(cache)
        self.cache = cache
        if isinstance(store, str):
            store = RecordStore(store)
        self.store = store
        self._cg: Optional[CondensedGraph] = None

    @property
    def cg(self) -> CondensedGraph:
        if self._cg is None:
            self._cg = workloads.build(self.model,
                                       **self.workload_kw).condense()
        return self._cg

    # -- keys ---------------------------------------------------------------

    def _key(self, point: DesignPoint, fidelity: str) -> str:
        # calibration changes cheap-fidelity outcomes, so it must enter
        # the key; the simulator is calibration-free by construction.
        # Omit the kwarg entirely when uncalibrated so pre-calibration
        # cache entries (including expensive simulator runs) stay valid.
        extra: Dict[str, Any] = {"workload_kw": self.workload_kw}
        if self.calibration is not None and fidelity in _CHEAP:
            extra["calibration"] = self.calibration.to_dict()
        system = point.system()
        if system is not None:
            # only multi-chip points carry the kwarg, so every
            # pre-scale-out cache entry keeps its key
            extra["system"] = system.to_dict()
        if self.engine == "torch" and fidelity == "simulate":
            # fleet results use pinned-program semantics (compiled on
            # the point's canonical chip — see explore.fleet), which
            # can diverge from per-point compilation when a timing
            # field steers the partitioner; key them separately so the
            # two paths never share entries.  scalar/vector/auto are
            # bit-identical per-point runs and keep the historical key.
            extra["engine"] = "torch"
        return cache_key(self.model, point.chip(), point.strategy,
                         fidelity, self.params, **extra)

    # -- calibration --------------------------------------------------------

    def calibrate(self, points: Sequence[DesignPoint],
                  fidelity: Optional[str] = None,
                  max_points: int = 3) -> Calibration:
        """Fit (and adopt) per-unit correction factors for this
        workload from perf-simulator runs on a few design points.

        Each point costs one simulator run; factors are combined by
        geometric mean across points so no single chip's quirks
        dominate.  The fit is stored on the engine — subsequent cheap
        evaluations (and their cache keys) use it automatically.
        """
        fidelity = fidelity or (self.fidelity
                                if self.fidelity in _CHEAP
                                else "analytic")
        fits = []
        for pt in list(points)[:max(1, max_points)]:
            rep = flow.calibrate(
                [(self.model, self.workload_kw)], pt.chip(),
                strategy=pt.strategy, params=self.params,
                fidelity=fidelity, device=self.device)
            fits.append(rep.calibration)
            # the fit's ground-truth run IS this point's simulator
            # evaluation — seed the result cache so a later promotion
            # of the same point is a hit instead of a re-simulation
            row = rep.rows[0]
            if self.cache is not None and row.sim_energy is not None:
                self.cache.put(self._key(pt, "simulate"), {
                    "cycles": row.sim_cycles,
                    "energy": row.sim_energy,
                    "throughput_sps": row.sim_throughput_sps,
                    "wall_s": row.sim_wall_s})
        self.calibration = Calibration.combine(fits)
        return self.calibration

    # -- evaluation ---------------------------------------------------------

    def evaluate(self, points: Sequence[DesignPoint],
                 fidelity: Optional[str] = None) -> List[EvalRecord]:
        """Evaluate points (cache-first, pool for misses), input order."""
        fidelity = fidelity or self.fidelity
        if fidelity not in FIDELITIES:
            # caller bug, not an infeasible point — fail loudly instead
            # of letting the per-point error capture swallow it
            raise ValueError(f"fidelity must be one of {FIDELITIES}, "
                             f"got {fidelity!r}")
        points = list(points)
        results: List[Optional[Dict[str, Any]]] = [None] * len(points)
        hit: List[bool] = [False] * len(points)
        keys: List[Optional[str]] = [None] * len(points)

        # pre-screen chip construction in the parent: a point whose
        # ChipConfig cannot even be built must become an error record on
        # every path (cache keying calls point.chip() before workers
        # would get a chance to capture the failure)
        dispatchable: List[bool] = [True] * len(points)
        for i, pt in enumerate(points):
            try:
                pt.chip()
                pt.system()
            except (ArchError, ValueError) as e:
                results[i] = {"cycles": float("inf"),
                              "energy": {"total": float("inf")},
                              "throughput_sps": 0.0, "wall_s": 0.0,
                              "error": f"{type(e).__name__}: {e}"}
                dispatchable[i] = False

        if self.cache is not None:
            for i, pt in enumerate(points):
                if not dispatchable[i]:
                    continue
                keys[i] = self._key(pt, fidelity)
                got = self.cache.get(keys[i])
                if got is not None:
                    results[i] = got
                    hit[i] = True

        miss_idx = [i for i, r in enumerate(results) if r is None]
        jobs = [(points[i], fidelity) for i in miss_idx]
        if jobs:
            fresh: List[Optional[Dict[str, Any]]] = [None] * len(jobs)
            rest = list(range(len(jobs)))
            if fidelity == "simulate" and self.engine == "torch":
                # fleet path: single-chip misses batch into one decode
                # per stage on the device — one compile + one decode per
                # canonical chip group instead of a pipeline per point.
                # Mesh (system) points keep the per-point path below.
                fleet_k = [k for k in rest
                           if jobs[k][0].system() is None]
                if fleet_k:
                    outs = self._fleet().evaluate(
                        [(jobs[k][0].chip(), jobs[k][0].strategy)
                         for k in fleet_k])
                    for k, out in zip(fleet_k, outs):
                        fresh[k] = out
                    taken = set(fleet_k)
                    rest = [k for k in rest if k not in taken]
            sub = [jobs[k] for k in rest]
            if sub:
                if self.pool > 1 and len(sub) > 1 \
                        and not self._uses_torch(fidelity):
                    got = self._run_pool(sub, fidelity)
                else:
                    self._bind_worker()
                    if fidelity in _CHEAP:
                        got = _eval_batch_worker(sub)
                    else:
                        got = [_eval_worker(j) for j in sub]
                for k, out in zip(rest, got):
                    fresh[k] = out
            for i, out in zip(miss_idx, fresh):
                results[i] = out
                # errors are deterministic for a given key but cheap to
                # recompute; keep the cache clean of failure payloads
                if self.cache is not None and keys[i] is not None \
                        and "error" not in out:
                    self.cache.put(keys[i], out)

        rec_engine = self.engine if fidelity == "simulate" else "auto"
        records = [
            EvalRecord(point=pt, model=self.model, fidelity=fidelity,
                       cycles=out["cycles"],
                       throughput_sps=out["throughput_sps"],
                       energy=out["energy"], batch=self.params.batch,
                       cache_hit=hit[i],
                       wall_s=out.get("wall_s", 0.0),
                       error=out.get("error"),
                       engine=rec_engine)
            for i, (pt, out) in enumerate(zip(points, results))
        ]
        if self.store is not None:
            self.store.extend(records)
        return records

    def evaluate_one(self, point: DesignPoint,
                     fidelity: Optional[str] = None) -> EvalRecord:
        return self.evaluate([point], fidelity)[0]

    def sweep(self, space: DesignSpace,
              fidelity: Optional[str] = None,
              resume: bool = False) -> List[EvalRecord]:
        """Exhaustive grid evaluation of a space.

        With ``resume=True`` (requires a ``store``), points that this
        engine's :class:`RecordStore` already holds a *successful*
        record for — same model, same fidelity — are not re-evaluated:
        the stored record is returned in place.  A sweep killed
        mid-run (OOM, Ctrl-C, node preemption) picks up where the
        JSONL left off instead of starting over; failed records are
        always retried.
        """
        fidelity = fidelity or self.fidelity
        points = space.points()
        if not resume:
            return self.evaluate(points, fidelity)
        if self.store is None:
            raise ValueError("sweep(resume=True) needs a RecordStore "
                             "(construct the engine with store=...)")
        prior: Dict[DesignPoint, EvalRecord] = {}
        for rec in self.store:
            if rec.ok and rec.model == self.model \
                    and rec.fidelity == fidelity:
                prior[rec.point] = rec
        todo = [pt for pt in points if pt not in prior]
        skipped = len(points) - len(todo)
        if skipped:
            warnings.warn(
                f"sweep resume: skipping {skipped}/{len(points)} "
                f"points already recorded in {self.store.path}",
                RuntimeWarning, stacklevel=2)
        fresh: Dict[DesignPoint, EvalRecord] = {}
        if todo:
            # evaluate() appends the fresh records to the store itself
            fresh = {r.point: r for r in self.evaluate(todo, fidelity)}
        return [prior[pt] if pt in prior else fresh[pt]
                for pt in points]

    def _run_pool(self, jobs: List[Tuple[DesignPoint, str]],
                  fidelity: str) -> List[Dict[str, Any]]:
        """Pool evaluation with bounded retry.

        Worker *exceptions* are already captured per point
        (``_err_payload``); what reaches here is pool-infrastructure
        failure — a worker killed by the OOM reaper, a wedged fork,
        an unpicklable result.  Those are frequently transient, so the
        batch is retried with exponential backoff; when the pool keeps
        collapsing, the sweep degrades to serial in-process evaluation
        rather than dying.
        """
        last: Optional[BaseException] = None
        for attempt in range(self.pool_retries + 1):
            try:
                return self._run_pool_once(jobs, fidelity)
            except KeyboardInterrupt:
                raise
            except Exception as e:     # noqa: BLE001 — pool-level only
                last = e
                if attempt < self.pool_retries:
                    delay = self.pool_backoff_s * (2 ** attempt)
                    warnings.warn(
                        f"worker pool failed ({type(e).__name__}: {e});"
                        f" retrying batch in {delay:.1f}s "
                        f"(attempt {attempt + 1}/{self.pool_retries})",
                        RuntimeWarning, stacklevel=2)
                    time.sleep(delay)
        warnings.warn(
            f"worker pool failed {self.pool_retries + 1} times "
            f"({type(last).__name__}: {last}); falling back to serial "
            f"in-process evaluation for this batch",
            RuntimeWarning, stacklevel=2)
        self._bind_worker()
        if fidelity in _CHEAP:
            return _eval_batch_worker(jobs)
        return [_eval_worker(j) for j in jobs]

    def _run_pool_once(self, jobs: List[Tuple[DesignPoint, str]],
                       fidelity: str) -> List[Dict[str, Any]]:
        try:
            # fork children inherit the parent's prepared graph — no
            # per-worker workloads.build() in the initializer
            ctx = mp.get_context("fork")
            self._bind_worker()
            init, initargs = None, ()
        except ValueError:
            ctx = mp.get_context("spawn")
            init = _init_worker
            initargs = (self.model, self.workload_kw, self.params,
                        self.calibration, self.flow_cache, self.engine,
                        self.device)
        n = min(self.pool, len(jobs))
        chunk = max(1, len(jobs) // (n * 4))
        with ctx.Pool(processes=n, initializer=init,
                      initargs=initargs) as pool:
            if fidelity in _CHEAP:
                # batched path: each worker chunk shares one condense
                # (and one compile_many per strategy in the chunk)
                chunks = [jobs[i:i + chunk]
                          for i in range(0, len(jobs), chunk)]
                out: List[Dict[str, Any]] = []
                for batch in pool.map(_eval_batch_worker, chunks):
                    out.extend(batch)
                return out
            return pool.map(_eval_worker, jobs, chunksize=chunk)

    def _uses_torch(self, fidelity: str) -> bool:
        """Whether evaluating at ``fidelity`` runs tensor code (the
        ``torch`` stage decode), which a forked pool worker cannot run
        safely once this process has."""
        return fidelity == "simulate" and self.engine in ("auto", "torch")

    def _bind_worker(self) -> None:
        """This engine's state for the in-process (and forked) worker
        functions; the graph is built once per engine."""
        _WORKER["cg"] = self.cg
        _WORKER["params"] = self.params
        _WORKER["calibration"] = self.calibration
        _WORKER["engine"] = self.engine
        _WORKER["device"] = self.device

    def _fleet(self) -> Any:
        fe = getattr(self, "_fleet_eval", None)
        if fe is None:
            from .fleet import FleetEvaluator
            fe = self._fleet_eval = FleetEvaluator(
                self.cg, params=self.params, device=self.device)
        return fe

    def cache_stats(self) -> Dict[str, int]:
        return dict(self.cache.stats) if self.cache is not None \
            else {"hits": 0, "misses": 0}
