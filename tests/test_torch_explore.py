"""The port's design-space exploration (``repro_torch.explore``), pass
disk cache and calibration against the JAX package.

* cache keys are the reference's digests, with and without calibration;
* the stock spaces enumerate the same points; multi-chip points
  evaluate through the port's ``system`` package as in the reference;
* engine records equal the reference's at ``analytic`` and ``trace``
  (serial and pooled) and, at ``simulate`` on the CPU, the port's
  default engine equals the reference's ``vector`` engine; the fleet
  (``engine="torch"``) equals per-point ``vector`` runs of the pinned
  program;
* successive halving, ``frontier_report``, the CLI and
  ``core.dse.sweep_mg_flit`` give the reference's results and output;
* the flow disk cache is shared between pipelines of the port and
  keeps the reference's entries apart; named calibrations and
  ``flow.calibrate`` equal the reference's.

Mirrors ``tests/test_explore.py``.  Every comparison is exact.
"""

import contextlib
import dataclasses
import io
import math
import os
import random
import warnings

import pytest
import torch

from repro import flow as jflow
from repro.core import workloads as jworkloads
from repro.core.arch import default_chip as j_default_chip
from repro.core.mapping import CostParams as JCostParams
from repro.explore import EvalRecord as JEvalRecord
from repro.explore import ExplorationEngine as JExplorationEngine
from repro.explore import RecordStore as JRecordStore
from repro.explore import cache_key as j_cache_key
from repro.explore import cli as jcli
from repro.explore import frontier_report as j_frontier_report
from repro.explore import space as jspace
from repro.explore import successive_halving as j_successive_halving
from repro_torch import flow
from repro_torch.core import workloads
from repro_torch.core.arch import default_chip
from repro_torch.core.mapping import CostParams
from repro_torch.core.simulator import Simulator
from repro_torch.explore import (DesignPoint, DesignSpace, Dimension,
                                 EvalRecord, ExplorationEngine,
                                 RecordStore, ResultCache, annotate,
                                 by_edp, cache_key, canonical_chip, cli,
                                 frontier_report, grid_search, hill_climb,
                                 mesh_space, mg_flit_space, pareto_frontier,
                                 random_search, space, successive_halving,
                                 timing_space)

pytestmark = pytest.mark.filterwarnings(
    "ignore:perf-mode lmem overflow:RuntimeWarning")

torch.set_num_threads(1)

CPU = "cpu"
MODEL = "tiny_cnn"
KW = dict(res=8)
PARAMS = CostParams(batch=2)
J_PARAMS = JCostParams(batch=2)
PRESET = "default-chip-analytic"


def make_engine(pool=0, cache=None, store=None, **kw):
    return ExplorationEngine(MODEL, params=PARAMS, pool=pool, cache=cache,
                             store=store, device=CPU, **kw, **KW)


def make_ref_engine(pool=0, **kw):
    return JExplorationEngine(MODEL, params=J_PARAMS, pool=pool,
                              cache=None, **kw, **KW)


def toy_space():
    return mg_flit_space((4, 8), (8, 16))     # 4 valid points


def _payload(rec):
    """A record without what differs between two runs of one point."""
    d = rec.to_dict()
    d.pop("wall_s")
    d.pop("cache_hit")
    return d


def _same_records(got, want):
    assert [_payload(r) for r in got] == [_payload(r) for r in want]


def _to_ref_point(pt):
    return jspace.DesignPoint.from_dict(pt.to_dict())


# ---------------------------------------------------------------------------
# design space
# ---------------------------------------------------------------------------


def test_space_enumerates_valid_grid():
    sp = toy_space()
    pts = sp.points()
    assert len(pts) == 4 == len(sp)
    assert len(set(pts)) == 4
    for pt in pts:
        chip = pt.chip()
        assert chip.core.cim.macros_per_group == pt.macros_per_group
        assert chip.noc.flit_bytes == pt.flit_bytes
        assert pt in sp


@pytest.mark.parametrize("name", ["default_space", "mg_flit_space",
                                  "timing_space", "protection_space",
                                  "mesh_space"])
def test_space_enumerations_equal_reference(name):
    got = getattr(space, name)()
    want = getattr(jspace, name)()
    assert got.describe() == want.describe()
    assert [p.to_dict() for p in got] == [p.to_dict() for p in want]
    for p in list(got)[:8]:
        assert p.chip().to_dict() == _to_ref_point(p).chip().to_dict()


def test_space_constraints_filter_points():
    sp = DesignSpace([Dimension("macros_per_group", (4, 8, 16))],
                     constraints=[lambda p: p.macros_per_group <= 8])
    assert [p.macros_per_group for p in sp] == [4, 8]


def test_space_mutation_stays_valid_and_equals_reference():
    sp, jsp = toy_space(), jspace.mg_flit_space((4, 8), (8, 16))
    rng, jrng = random.Random(0), random.Random(0)
    pt, jpt = sp.random_point(rng), jsp.random_point(jrng)
    for _ in range(20):
        new = sp.mutate(pt, rng)
        assert new in sp and new != pt
        jpt = jsp.mutate(jpt, jrng)
        assert new.to_dict() == jpt.to_dict()
        pt = new
    assert [p.to_dict() for p in sp.neighbors(pt)] == \
        [p.to_dict() for p in jsp.neighbors(jpt)]


def test_point_roundtrip_and_macro_count():
    pt = DesignPoint(macros_per_group=4, n_macro_groups=8, n_cores=16)
    assert DesignPoint.from_dict(pt.to_dict()) == pt
    assert pt.total_macros == 16 * 8 * 4


def test_mesh_points_refused_until_the_system_slice(tmp_path):
    """Multi-chip points were refused until the system slice; now they
    evaluate on every path (with and without a result cache; per point
    when the engine is the fleet), and their records equal the
    reference's."""
    pts = mesh_space().points()
    multi = [p for p in pts if p.chips > 1]
    assert multi and DesignPoint().system() is None
    jpts = [_to_ref_point(p) for p in pts]
    for cache in (None, ResultCache(str(tmp_path / "c"))):
        eng = make_engine(cache=cache)
        for fid in ("analytic", "simulate"):
            got = eng.evaluate(pts, fid)
            assert all(r.error is None for r in got)
            _same_records(got, make_ref_engine().evaluate(jpts, fid))
    got = make_engine(engine="torch").evaluate(multi, "simulate")
    want = make_ref_engine(engine="vector").evaluate(
        [_to_ref_point(p) for p in multi], "simulate")
    assert [(r.cycles, r.energy, r.throughput_sps) for r in got] == \
        [(r.cycles, r.energy, r.throughput_sps) for r in want]


# ---------------------------------------------------------------------------
# pareto
# ---------------------------------------------------------------------------


def _rec(cycles, energy, mg=8):
    return EvalRecord(point=DesignPoint(macros_per_group=mg),
                      model=MODEL, fidelity="analytic", cycles=cycles,
                      throughput_sps=1.0,
                      energy={"total": energy})


def test_pareto_frontier_hand_built():
    recs = [
        _rec(10, 100, mg=2),    # frontier (best cycles)
        _rec(20, 50, mg=4),     # frontier
        _rec(40, 20, mg=8),     # frontier (best energy)
        _rec(25, 60, mg=16),    # dominated by (20, 50)
        _rec(50, 120, mg=16),   # dominated by everything
    ]
    front = pareto_frontier(recs, axes=("cycles", "energy"))
    assert [(r.cycles, r.energy_total) for r in front] == \
        [(10, 100), (20, 50), (40, 20)]
    meta = {p.record.cycles: p for p in annotate(recs)}
    assert meta[25].dominated_by == 1 and not meta[25].on_frontier
    assert meta[50].dominated_by == 4 and meta[50].rank > 0
    assert all(meta[c].rank == 0 for c in (10, 20, 40))


def test_pareto_three_objectives_and_errors():
    good = _rec(10, 100)
    bad = _rec(math.inf, math.inf)
    bad.error = "InfeasibleModel: nope"
    assert pareto_frontier([good, bad], axes=("cycles", "energy",
                                              "macros")) == [good]


@pytest.mark.parametrize("axes", [("cycles", "energy"),
                                  ("cycles", "energy", "macros"),
                                  ("edp",)])
def test_frontier_report_equals_reference(axes):
    recs = make_engine().sweep(mg_flit_space((2, 4, 8, 16), (8, 16, 32)))
    jrecs = [JEvalRecord.from_dict(r.to_dict()) for r in recs]
    assert frontier_report(recs, axes=axes) == \
        j_frontier_report(jrecs, axes=axes)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------


def test_cache_key_deterministic_and_discriminating():
    pt = DesignPoint()
    k1 = cache_key(MODEL, pt.chip(), "generic", "analytic", PARAMS)
    assert k1 == cache_key(MODEL, pt.chip(), "generic", "analytic", PARAMS)
    assert k1 != cache_key(MODEL, pt.chip(), "dp", "analytic", PARAMS)
    assert k1 != cache_key(MODEL, pt.chip(), "generic", "simulate",
                           PARAMS)
    other = pt.replace(flit_bytes=16).chip()
    assert k1 != cache_key(MODEL, other, "generic", "analytic", PARAMS)
    renamed = dataclasses.replace(pt.chip(), name="whatever")
    assert k1 == cache_key(MODEL, renamed, "generic", "analytic", PARAMS)


KEY_POINTS = [DesignPoint(), DesignPoint(macros_per_group=4, flit_bytes=16),
              DesignPoint(n_cores=16, local_mem_kb=256, strategy="dp"),
              DesignPoint(vector_alu_latency=3, router_latency=1,
                          weight_load_rows_per_cycle=4, strategy="dp"),
              DesignPoint(ecc=True, spare_rows=2, tmr=True)]


@pytest.mark.parametrize("calibration", [None, PRESET])
@pytest.mark.parametrize("fidelity", ["analytic", "trace", "simulate"])
def test_cache_key_equals_reference(fidelity, calibration):
    """The port's engine keys a point with the reference's digest (the
    fleet under its own ``"torch"`` tag, as the reference's ``"jax"``)."""
    eng = make_engine(calibration=calibration)
    jeng = make_ref_engine(calibration=calibration)
    fleet = make_engine(engine="torch", calibration=calibration)
    for pt in KEY_POINTS:
        jpt = _to_ref_point(pt)
        assert cache_key(MODEL, pt.chip(), pt.strategy, fidelity,
                         PARAMS) == j_cache_key(MODEL, jpt.chip(),
                                                jpt.strategy, fidelity,
                                                J_PARAMS)
        assert eng._key(pt, fidelity) == jeng._key(jpt, fidelity)
        # the fleet keys its simulate results apart
        assert (fleet._key(pt, fidelity) == eng._key(pt, fidelity)) == \
            (fidelity != "simulate")


def test_cache_hit_miss_and_identical_records(tmp_path):
    cache = ResultCache(str(tmp_path / "cache"))
    eng = make_engine(cache=cache)
    sp = toy_space()
    first = eng.sweep(sp)
    assert all(not r.cache_hit for r in first)
    assert cache.misses == len(first) and cache.hits == 0
    assert len(cache) == len(first)
    second = eng.sweep(sp)
    assert all(r.cache_hit for r in second)
    _same_records(second, first)
    third = make_engine(cache=ResultCache(str(tmp_path / "cache"))) \
        .sweep(sp)
    assert all(r.cache_hit for r in third)
    # a reference engine over the same directory hits the port's entries
    jeng = JExplorationEngine(MODEL, params=J_PARAMS,
                              cache=str(tmp_path / "cache"), **KW)
    jrecs = jeng.sweep(jspace.mg_flit_space((4, 8), (8, 16)))
    assert all(r.cache_hit for r in jrecs)
    _same_records(first, jrecs)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", [0, 2])
@pytest.mark.parametrize("fidelity", ["analytic", "trace"])
def test_engine_records_equal_reference(fidelity, pool):
    sp = mg_flit_space((4, 8), (8, 16), strategies=("generic", "dp"))
    got = make_engine(pool=pool).sweep(sp, fidelity)
    want = make_ref_engine(pool=pool).sweep(
        jspace.mg_flit_space((4, 8), (8, 16),
                             strategies=("generic", "dp")), fidelity)
    assert len(got) == 8
    _same_records(got, want)


@pytest.mark.parametrize("pool", [0, 2])
def test_engine_simulate_auto_equals_reference_vector(pool):
    """Per-point simulate runs on the port's default engine (``torch``,
    on the CPU here), pool or not, equal the reference's ``vector``
    runs; the host engines may fork, the torch engine never does."""
    sp = mg_flit_space((4, 8), (8,), strategies=("generic", "dp"))
    want = make_ref_engine(engine="vector").sweep(
        jspace.mg_flit_space((4, 8), (8,), strategies=("generic", "dp")),
        "simulate")
    for engine in ("auto", "vector"):
        eng = make_engine(pool=pool, engine=engine)
        assert eng._uses_torch("simulate") == (engine == "auto")
        got = eng.sweep(sp, "simulate")
        assert [r.engine for r in got] == [engine] * 4
        for g, w in zip(got, want):
            assert (g.point.to_dict(), g.cycles, g.energy,
                    g.throughput_sps) == (w.point.to_dict(), w.cycles,
                                          w.energy, w.throughput_sps)


def test_fleet_equals_vector_runs_of_the_pinned_program(tmp_path):
    """``engine="torch"`` batches a timing sweep through the fleet: one
    compile per canonical chip; each record equals that chip's own
    ``vector`` run of the program compiled for the canonical chip."""
    sp = timing_space(vector_alu=(1, 3), wl_rate=(1, 4))
    cache = ResultCache(str(tmp_path / "c"))
    eng = make_engine(engine="torch", cache=cache)
    recs = eng.sweep(sp, "simulate")
    assert len(recs) == 16 and all(r.ok and r.engine == "torch"
                                   for r in recs)
    canon = {canonical_chip(p.chip()) for p in sp}
    assert len(canon) == 1
    cm = flow.compile(eng.cg, canon.pop(), flow.CompileOptions(
        strategy="dp", params=PARAMS, fidelity="simulate")).ensure_model()
    for r in recs:
        chip = r.point.chip()
        rep = Simulator(chip, cm.isa, engine="vector").run_model(cm)
        sps = cm.batch / (rep.cycles / (chip.clock_ghz * 1e9))
        assert (r.cycles, r.energy, r.throughput_sps) == \
            (rep.cycles, dict(rep.energy()), sps)
    assert len({r.cycles for r in recs}) > 1
    again = eng.sweep(sp, "simulate")
    assert all(r.cache_hit for r in again)
    _same_records(again, recs)


def test_engine_matches_legacy_dse_and_reference_dse():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        from repro.core import dse as jdse
        from repro_torch.core import dse
    cg = workloads.build(MODEL, **KW).condense()
    for rec in make_engine().sweep(toy_space()):
        legacy = dse.evaluate(cg, rec.point.chip(), rec.point.strategy,
                              PARAMS, simulate=False, device=CPU)
        assert (rec.cycles, rec.energy) == (legacy.cycles, legacy.energy)
        assert rec.throughput_sps == pytest.approx(legacy.throughput_sps)
    jcg = jworkloads.build(MODEL, **KW).condense()
    for simulate in (False, True):
        got = dse.sweep_mg_flit(cg, "dp", mgs=(4, 8), flits=(8, 16),
                                simulate=simulate, params=PARAMS,
                                device=CPU)
        want = jdse.sweep_mg_flit(jcg, "dp", mgs=(4, 8), flits=(8, 16),
                                  simulate=simulate, params=J_PARAMS)
        assert [p.row() for p in got] == [p.row() for p in want]


def test_engine_survives_infeasible_points():
    eng = ExplorationEngine("transformer", params=CostParams(batch=1),
                            pool=0, cache=None, device=CPU, n_layers=1,
                            d_model=64, n_heads=2, seq=8)
    recs = eng.evaluate([DesignPoint(macros_per_group=2, n_macro_groups=8,
                                     n_cores=16, local_mem_kb=256)])
    assert len(recs) == 1
    r = recs[0]
    assert r.ok or (math.isinf(r.cycles) and r.error)


def test_engine_invalid_chip_point_errors_on_both_cache_paths(tmp_path):
    bad, good = DesignPoint(flit_bytes=0), DesignPoint()
    for cache in (None, ResultCache(str(tmp_path / "c"))):
        recs = make_engine(cache=cache).evaluate([bad, good])
        assert not recs[0].ok and math.isinf(recs[0].cycles)
        assert "ArchError" in recs[0].error
        assert recs[1].ok and math.isfinite(recs[1].cycles)


def test_record_store_roundtrip(tmp_path):
    path = str(tmp_path / "out" / "trace.jsonl")
    store = RecordStore(path)
    recs = make_engine(store=store).sweep(toy_space())
    loaded = store.load()
    assert [r.to_dict() for r in loaded] == [r.to_dict() for r in recs]
    # a reference store reads the port's records
    assert [r.to_dict() for r in JRecordStore(path).load()] == \
        [r.to_dict() for r in recs]


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def test_random_and_hillclimb_find_known_best():
    eng = make_engine()
    sp = toy_space()
    best_point = grid_search(eng, sp, objective=by_edp).best.point
    assert random_search(eng, sp, n=len(sp), objective=by_edp,
                         seed=3).best.point == best_point
    hc = hill_climb(eng, sp, objective=by_edp, seed=1, iters=12,
                    neighbors=3, restarts=3)
    assert hc.best.point == best_point
    assert hc.n_evals <= len(sp)


@pytest.mark.parametrize("calibrate", [0, 1])
def test_successive_halving_equals_reference(calibrate):
    """The same screen, the same top-k promoted to the simulator (the
    port's default engine against the reference's ``vector``), the
    same records."""
    sp = mg_flit_space((4, 8), (8, 16), strategies=("generic", "dp"))
    eng = make_engine()
    res, screened = successive_halving(eng, sp, top_k=2, objective=by_edp,
                                       calibrate=calibrate)
    jeng = make_ref_engine(engine="vector")
    jres, jscreened = j_successive_halving(
        jeng, jspace.mg_flit_space((4, 8), (8, 16),
                                   strategies=("generic", "dp")),
        top_k=2, calibrate=calibrate)
    _same_records(screened, jscreened)
    assert len(res.history) == 2 and res.n_evals == jres.n_evals
    assert all(r.fidelity == "simulate" for r in res.history)
    for g, w in zip(res.history, jres.history):
        assert (g.point.to_dict(), g.cycles, g.energy) == \
            (w.point.to_dict(), w.cycles, w.energy)
    assert res.best.point.to_dict() == jres.best.point.to_dict()
    if calibrate:
        assert eng.calibration.to_dict() == jeng.calibration.to_dict()
    ranked = sorted(screened, key=by_edp)[:2]
    assert res.best.point in {r.point for r in ranked}


def test_engine_promotion_reuses_partition_pass(monkeypatch):
    from repro_torch.flow import passes as flow_passes
    flow.default_pipeline().clear_cache()
    calls = []
    orig = flow_passes._partition
    monkeypatch.setattr(
        flow_passes, "_partition",
        lambda *a, **kw: (calls.append(a), orig(*a, **kw))[1])
    successive_halving(make_engine(), mg_flit_space((4,), (8,)), top_k=1)
    assert len(calls) == 1


# ---------------------------------------------------------------------------
# cache eviction
# ---------------------------------------------------------------------------


def _seed_cache(tmp_path, n=5, t0=1_000_000.0):
    """Cache with n entries whose mtimes are one day apart."""
    cache = ResultCache(str(tmp_path / "evict"))
    paths = []
    for i in range(n):
        key = cache_key(f"m{i}", DesignPoint().chip(), "dp", "analytic")
        cache.put(key, {"cycles": float(i)})
        path = cache._path(key)
        os.utime(path, (t0 + 86400 * i, t0 + 86400 * i))
        paths.append(path)
    return cache, paths, t0


@pytest.mark.parametrize("how", ["age", "count", "constructor", "none"])
def test_cache_prune(tmp_path, how):
    cache, paths, t0 = _seed_cache(tmp_path)
    now = t0 + 4 * 86400 + 10        # entries 0..3 are > 1 day old
    if how == "age":
        assert cache.prune(max_age_days=1, now=now) == 4
        assert len(cache) == 1
        assert os.path.exists(paths[4]) and not os.path.exists(paths[0])
    elif how == "count":
        assert cache.prune(max_entries=2) == 3
        assert len(cache) == 2
        assert os.path.exists(paths[3]) and os.path.exists(paths[4])
        assert not os.path.exists(paths[1])
    elif how == "constructor":
        cache2 = ResultCache(cache.root, max_age_days=1, max_entries=1)
        assert cache2.prune(now=now) == 4
        assert cache2.prune(now=now) == 0
        cache.put(cache_key("x", DesignPoint().chip(), "dp", "analytic"),
                  {"cycles": 1.0})
        assert cache2.prune(now=now) == 1
        assert len(cache2) == 1
    else:
        assert cache.prune() == 0
        assert len(cache) == 5


# ---------------------------------------------------------------------------
# CLI (python -m repro_torch.explore)
# ---------------------------------------------------------------------------


def _cli(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_sweep_and_pareto_equal_reference(tmp_path):
    store, jstore = str(tmp_path / "s.jsonl"), str(tmp_path / "j.jsonl")
    argv = ["sweep", "tiny_cnn", "--res", "8", "--batch", "2", "--mg",
            "4,8", "--flit", "8", "--strategies", "generic,dp",
            "--no-cache", "--store"]
    rc, out = _cli(cli.main, argv + [store, "--device", CPU])
    assert rc == 0 and "tiny_cnn" in out and "dp" in out
    assert len(RecordStore(store)) == 4
    assert (rc, out.replace(store, jstore)) == _cli(jcli.main,
                                                    argv + [jstore])
    for axes in ("cycles,energy", "cycles,energy,macros"):
        got = _cli(cli.main, ["pareto", store, "--axes", axes])
        assert "frontier" in got[1]
        assert got == _cli(jcli.main, ["pareto", jstore, "--axes", axes])


def test_cli_top_k_with_calibration_equals_reference():
    argv = ["sweep", "tiny_cnn", "--res", "8", "--batch", "2", "--mg",
            "4,8", "--flit", "8", "--top-k", "2", "--calibrate", "1",
            "--no-cache"]
    got = _cli(cli.main, argv + ["--device", CPU])
    assert got[0] == 0 and "promoted to the simulator" in got[1]
    assert got == _cli(jcli.main, argv)


def test_cli_cache_prune_and_stats(tmp_path):
    cache, _, _ = _seed_cache(tmp_path)
    for argv in (["cache", "stats", "--cache-root", cache.root],
                 ["cache", "prune", "--cache-root", cache.root,
                  "--max-entries", "3"]):
        want = _cli(jcli.main, argv)
        _seed_cache(tmp_path)             # undo the reference's prune
        assert _cli(cli.main, argv) == want
        _seed_cache(tmp_path)
    assert "5 entries" in _cli(cli.main, ["cache", "stats", "--cache-root",
                                          cache.root])[1]
    rc, out = _cli(cli.main, ["cache", "prune", "--cache-root", cache.root,
                              "--max-entries", "1"])
    assert rc == 0 and "pruned 4 entries" in out and len(cache) == 1
    with pytest.raises(SystemExit):
        cli.main(["cache", "prune", "--cache-root", cache.root])


# ---------------------------------------------------------------------------
# the flow disk cache and calibration
# ---------------------------------------------------------------------------


def test_flow_disk_cache_shared_between_pipelines(tmp_path):
    root = str(tmp_path / "flow")
    opts = flow.CompileOptions(strategy="dp", batch=2, workload_kw=KW)
    first = flow.Pipeline(disk_cache=root)
    art = first.compile(MODEL, default_chip(), opts)
    assert first.disk.misses == 2 and len(first.disk) == 2
    assert all(f.endswith(flow.diskcache.SUFFIX)
               for _, f in first.disk._entries())
    second = flow.Pipeline(disk_cache=root)
    art2 = second.compile(MODEL, default_chip(), opts)
    assert second.cache_info()["disk_hits"] == 2
    assert all(rec.cached for rec in art2.trace)
    assert art2.partition.latency_cycles(2) == \
        art.partition.latency_cycles(2)


def test_flow_disk_cache_skips_reference_entries(tmp_path, monkeypatch):
    """The JAX package writes its pickles under the same pass keys into
    the same directory: the port never reads them (each is a miss) and
    never counts, prunes or clears them."""
    import pickle
    root = str(tmp_path / "flow")
    jopts = jflow.CompileOptions(strategy="dp", batch=2, workload_kw=KW)
    jpipe = jflow.Pipeline(disk_cache=root)
    jpipe.compile(MODEL, j_default_chip(), jopts)
    assert len(jpipe.disk) == 2
    loads = []
    orig = pickle.load
    monkeypatch.setattr(pickle, "load",
                        lambda f, *a, **k: (loads.append(f.name),
                                            orig(f, *a, **k))[1])
    pipe = flow.Pipeline(disk_cache=root)
    assert len(pipe.disk) == 0
    pipe.compile(MODEL, default_chip(), flow.CompileOptions(
        strategy="dp", batch=2, workload_kw=KW))
    assert pipe.disk.hits == 0 and pipe.disk.misses == 2
    assert loads == []
    assert pipe.disk.prune(max_entries=0) == 2 and pipe.disk.clear() == 0
    assert len(jpipe.disk) == 2        # the reference's entries stay


def test_default_pipeline_reads_its_own_env_var(monkeypatch, tmp_path):
    from repro_torch.flow import diskcache, pipeline
    assert diskcache.ENV_VAR != "REPRO_FLOW_CACHE"
    monkeypatch.setattr(pipeline, "_DEFAULT_PIPELINE", None)
    monkeypatch.setenv("REPRO_FLOW_CACHE", str(tmp_path / "ref"))
    assert flow.default_pipeline().disk is None
    monkeypatch.setattr(pipeline, "_DEFAULT_PIPELINE", None)
    monkeypatch.setenv(diskcache.ENV_VAR, str(tmp_path / "port"))
    assert flow.default_pipeline().disk.root == str(tmp_path / "port")
    monkeypatch.setattr(pipeline, "_DEFAULT_PIPELINE", None)


def test_named_calibrations_equal_reference():
    assert flow.list_calibrations() == jflow.list_calibrations()
    for name in flow.list_calibrations():
        assert flow.load_calibration(name).to_dict() == \
            jflow.load_calibration(name).to_dict()
    opts = flow.CompileOptions(calibration=PRESET)
    assert opts.calibration.to_dict() == \
        jflow.load_calibration(PRESET).to_dict()
    with pytest.raises(FileNotFoundError):
        flow.load_calibration("no-such-preset")


@pytest.mark.parametrize("fidelity", ["analytic", "trace"])
def test_flow_calibrate_equals_reference(fidelity, tmp_path):
    kw = dict(strategy="dp", fidelity=fidelity)
    rep = flow.calibrate([(MODEL, KW)], default_chip(), device=CPU,
                         params=PARAMS, save=str(tmp_path / "c.json"),
                         **kw)
    jrep = jflow.calibrate([(MODEL, KW)], j_default_chip(),
                           params=J_PARAMS, **kw)
    assert rep.calibration.to_dict() == jrep.calibration.to_dict()
    assert rep.describe() == jrep.describe()
    assert flow.load_calibration(str(tmp_path / "c.json")) == \
        rep.calibration
    art = flow.compile(MODEL, default_chip(), flow.CompileOptions(
        workload_kw=KW, params=PARAMS, calibration=rep.calibration))
    jart = jflow.compile(MODEL, j_default_chip(), jflow.CompileOptions(
        workload_kw=KW, params=J_PARAMS, calibration=jrep.calibration))
    assert art.evaluate().cycles == jart.evaluate().cycles
    replaced = art.replace_options(calibration=None)
    assert replaced.partition is art.partition
    with pytest.raises(ValueError):
        art.replace_options(strategy="generic")
