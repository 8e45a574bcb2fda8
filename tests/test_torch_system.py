"""The port's mesh of chips (``repro_torch.system``) against the JAX
package's ``repro.system``.

* pipeline and tensor plans of the full transformer conserve work and
  equal the reference's plans; a ``SystemConfig`` serializes as the
  reference's, so the pass-cache keys are the reference's digests;
* a 1x1 mesh is the single-chip compile, ISA streams included;
* pipeline func runs (``tiny_cnn`` on 2 and 4 chips, a one-layer
  transformer on 2) equal the port's ``run_reference`` on the CPU and
  the reference's ``run_func``;
* reports at analytic, trace and simulate fidelity equal the
  reference's field for field; at simulate the port's ``torch`` engine
  on the CPU equals its ``vector`` engine and the reference's;
* ``deepseek_proxy`` needs a mesh; the mesh DSE sweep, the design-point
  axes, the serve table's disk cache with a mesh and ``--chips``
  parsing behave as in the reference.

Mirrors ``tests/test_system.py`` at small sizes (no full-size compile).
Every comparison is exact (tolerance 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro import flow as jflow
from repro.core import ref as jref
from repro.core import workloads as jworkloads
from repro.core.arch import default_chip as j_default_chip
from repro.core.partition import InfeasibleModel as JInfeasibleModel
from repro.explore import ExplorationEngine as JExplorationEngine
from repro.explore import mesh_space as j_mesh_space
from repro.serve import ServeModelCfg as JServeModelCfg
from repro.serve import StepCostTable as JStepCostTable
from repro.system import SystemConfig as JSystemConfig
from repro.system import shard_tensor as j_shard_tensor
from repro.system import split_pipeline as j_split_pipeline
from repro_torch import flow
from repro_torch.convert import from_reference
from repro_torch.core import ref, workloads
from repro_torch.core.arch import default_chip
from repro_torch.core.mapping import gmem_footprint_bytes
from repro_torch.core.partition import InfeasibleModel
from repro_torch.explore import DesignPoint, ExplorationEngine, mesh_space
from repro_torch.flow import CompileOptions
from repro_torch.system import (SystemArtifact, SystemConfig, SystemReport,
                                shard_tensor, split_pipeline)
from repro_torch.system.passes import SystemPartitionPass

pytestmark = pytest.mark.filterwarnings(
    "ignore:perf-mode lmem overflow:RuntimeWarning")

torch.set_num_threads(1)

CPU = "cpu"
# the func-ladder transformer of tests/test_system.py
SMALL_TF = dict(n_layers=1, d_model=128, n_heads=4, seq=16, vocab=64)


def _plain(x):
    """A report (or plan) as plain values, wall times dropped, so the
    port's and the reference's objects compare field for field."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.name != "wall_s"}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, x.tobytes())
    return x


def _same_report(got, want):
    assert type(got).__name__ == type(want).__name__
    assert _plain(got) == _plain(want)


def _both(workload, n, fidelity, batch=None, workload_kw=None, **sys_kw):
    """The same multi-chip compile in the port and the reference."""
    kw = dict(fidelity=fidelity, batch=batch,
              workload_kw=workload_kw or {})
    art = flow.compile(workload, default_chip(), CompileOptions(
        system=SystemConfig.mesh(n, **sys_kw), **kw))
    jart = jflow.compile(workload, j_default_chip(), jflow.CompileOptions(
        system=JSystemConfig.mesh(n, **sys_kw), **kw))
    return art, jart


# ---------------------------------------------------------------------------
# plans: conservation, equality with the reference, cache keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_conserves_work(n):
    cg = workloads.build("transformer").condense()
    plan = split_pipeline(cg, default_chip(), SystemConfig.mesh(n))
    assert plan.total_macs() == cg.total_macs
    assert sum(s.out_bytes for s in plan.slices) == \
        sum(g.out_bytes for g in cg)
    covered = [g for s in plan.slices for g in s.gids]
    assert covered == list(range(len(cg)))
    jcg = jworkloads.build("transformer").condense()
    jplan = j_split_pipeline(jcg, j_default_chip(), JSystemConfig.mesh(n))
    dump = SystemPartitionPass("pipeline").dump
    assert dump(plan) == dump(jplan)
    assert plan.describe() == jplan.describe()


@pytest.mark.parametrize("n", [2, 4])
def test_tensor_conserves_work(n):
    cg = workloads.build("transformer").condense()
    plan = shard_tensor(cg, default_chip(),
                        SystemConfig.mesh(n, parallel="tensor"))
    assert plan.total_macs() == cg.total_macs
    jcg = jworkloads.build("transformer").condense()
    jplan = j_shard_tensor(jcg, j_default_chip(),
                           JSystemConfig.mesh(n, parallel="tensor"))
    dump = SystemPartitionPass("tensor").dump
    assert dump(plan) == dump(jplan)
    assert plan.total_macs() == jplan.total_macs()


@pytest.mark.parametrize("kw", [
    dict(n=1), dict(n=4), dict(n=8, link="interposer", parallel="tensor"),
    dict(n=4, failed=(2,)), dict(n=4, links=((0, 1),), boundary_ports=1)])
def test_config_serializes_as_reference(kw):
    """Same ``to_dict``, hops, description and cache-key fragment: the
    pass keys of a mesh compile are the reference's digests."""
    kw = dict(kw)
    n = kw.pop("n")
    failed, links = kw.pop("failed", ()), kw.pop("links", ())
    cfg = SystemConfig.mesh(n, **kw).degrade(failed, links)
    jcfg = JSystemConfig.mesh(n, **kw).degrade(failed, links)
    assert cfg.to_dict() == jcfg.to_dict()
    assert SystemConfig.from_dict(cfg.to_dict()) == cfg
    assert cfg.describe() == jcfg.describe()
    assert cfg.alive_slots == jcfg.alive_slots
    alive = cfg.alive_slots
    assert [cfg.hops(a, b) for a in alive for b in alive] == \
        [jcfg.hops(a, b) for a in alive for b in alive]
    opts = CompileOptions(system=cfg)
    jopts = jflow.CompileOptions(system=jcfg)
    assert opts.subset_key(("system",)) == \
        jopts.subset_key(("system",))


def test_system_option_type_checked():
    with pytest.raises(TypeError, match="SystemConfig"):
        CompileOptions(system=object())


# ---------------------------------------------------------------------------
# 1x1 mesh == single chip
# ---------------------------------------------------------------------------


def test_1x1_mesh_is_identity():
    chip = default_chip()
    solo = flow.compile("tiny_cnn", chip, CompileOptions(
        fidelity="simulate"))
    mesh = flow.compile("tiny_cnn", chip, CompileOptions(
        fidelity="simulate", system=SystemConfig(chips_x=1, chips_y=1)))
    assert isinstance(mesh, SystemArtifact) and mesh.n_chips == 1
    rep_solo = solo.evaluate(device=CPU)
    rep_mesh = mesh.evaluate(device=CPU)
    assert rep_mesh.cycles == rep_solo.cycles
    assert rep_mesh.comm_cycles == 0
    inner = mesh.chips[0]
    assert len(inner.model.stages) == len(solo.model.stages)
    for st_a, st_b in zip(inner.model.stages, solo.model.stages):
        assert sorted(st_a.programs) == sorted(st_b.programs)
        for core in st_a.programs:
            assert str(st_a.programs[core]) == str(st_b.programs[core])
    jmesh = jflow.compile("tiny_cnn", j_default_chip(), jflow.CompileOptions(
        fidelity="simulate", system=JSystemConfig(chips_x=1, chips_y=1)))
    _same_report(rep_mesh, jmesh.evaluate())


# ---------------------------------------------------------------------------
# func bit-exactness across pipeline cuts
# ---------------------------------------------------------------------------


def _func_three_ways(workload, n, batch=2, workload_kw=None, seed=7,
                     **sys_kw):
    """Port ``run_func`` == the port's ``run_reference`` on the CPU ==
    the reference's ``run_func``, on the reference's random state."""
    art, jart = _both(workload, n, "func", batch=batch,
                      workload_kw=workload_kw, **sys_kw)
    assert art.n_chips == jart.n_chips
    assert art.plan.transfers
    jcg = jart.cg
    w, b, x = jref.random_init(jcg, batch=batch, seed=seed)
    q = jref.auto_quant(jcg, w, b, x)
    got = art.run_func(w, b, x, quant=q)
    jgot = jart.run_func(w, b, x, quant=q)
    assert sorted(got.outputs) == sorted(jgot.outputs)
    for gid, blob in jgot.outputs.items():
        np.testing.assert_array_equal(got.outputs[gid], blob)
    assert [r.instrs for r in got.reports] == \
        [r.instrs for r in jgot.reports]
    # the oracle on the unsplit graph, as the port's tensors on the CPU;
    # run_func takes the tensors as well
    tw, tb, tx, tq = from_reference(w, b, x, q, CPU)
    oracle = ref.run_reference(art.cg, tw, tb, tq, tx)
    last = len(art.cg) - 1
    final = oracle[last].reshape(batch, -1).numpy()
    np.testing.assert_array_equal(got.final, final)
    np.testing.assert_array_equal(art.run_func(tw, tb, tx, quant=tq).final,
                                  final)
    return art


@pytest.mark.parametrize("n", [2, 4])
def test_pipeline_func_tiny_cnn(n):
    art = _func_three_ways("tiny_cnn", n)
    assert art.n_chips >= 2


def test_pipeline_func_transformer():
    """Residual taps crossing a cut (side operand arrives as a slice
    input) stay bit-exact."""
    art = _func_three_ways("transformer", 2, workload_kw=SMALL_TF)
    assert art.n_chips == 2


def test_func_and_tensor_simulate_refused_as_reference():
    art, jart = _both("tiny_cnn", 2, "analytic")
    for a in (art, jart):
        with pytest.raises(ValueError, match="run_func"):
            a.evaluate("func")
    for fl in (flow, jflow):
        cfg = (SystemConfig if fl is flow else JSystemConfig).mesh(
            2, parallel="tensor")
        chip = (default_chip if fl is flow else j_default_chip)()
        with pytest.raises(ValueError, match="tensor-parallel"):
            fl.compile("tiny_cnn", chip, fl.CompileOptions(
                fidelity="simulate", system=cfg))
        tart = fl.compile("tiny_cnn", chip, fl.CompileOptions(
            fidelity="trace", system=cfg))
        with pytest.raises(ValueError, match="tensor-parallel"):
            tart.evaluate("simulate")
        with pytest.raises(ValueError, match="pipeline"):
            tart.run_func({}, {}, np.zeros((1, 8, 8, 3), np.int8))


# ---------------------------------------------------------------------------
# reports equal the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fidelity", ["analytic", "trace"])
@pytest.mark.parametrize("parallel", ["pipeline", "tensor"])
def test_reports_equal_reference(fidelity, parallel):
    art, jart = _both("transformer", 4, fidelity, workload_kw=SMALL_TF,
                      parallel=parallel)
    rep, jrep = art.evaluate(), jart.evaluate()
    assert isinstance(rep, SystemReport) and rep.mode == parallel
    _same_report(rep, jrep)
    assert art.describe().splitlines()[-1] == \
        jart.describe().splitlines()[-1]


def test_pipeline_energy_has_interchip_key():
    art, jart = _both("transformer", 2, "analytic", workload_kw=SMALL_TF)
    rep = art.evaluate()
    assert rep.n_chips == 2
    assert rep.comm_cycles > 0
    assert rep.energy.get("interchip", 0) > 0
    assert rep.energy["total"] >= rep.energy["interchip"]
    _same_report(rep, jart.evaluate())


def test_simulate_torch_equals_vector_and_reference():
    """Every chip slice decoded by the ``torch`` engine (here on the
    CPU) equals the ``vector`` engine and the reference's."""
    art, jart = _both("tiny_cnn", 2, "simulate", batch=2)
    assert art.n_chips == 2
    got = art.evaluate(device=CPU)
    vec = art.evaluate(engine="vector")
    want = jart.evaluate(engine="vector")
    for rep in (got, vec):
        _same_report(rep, want)
    assert [r.sim.instrs for r in got.per_chip] == \
        [r.sim.instrs for r in want.per_chip]
    # batch rescaled on the same plan, as the serve table does
    _same_report(art.replace_options(batch=4).evaluate(device=CPU),
                 jart.replace_options(batch=4).evaluate(engine="vector"))
    with pytest.raises(ValueError, match="recompile"):
        art.replace_options(strategy="dp")


# ---------------------------------------------------------------------------
# the capacity wall
# ---------------------------------------------------------------------------


def test_deepseek_proxy_needs_a_mesh():
    chip = default_chip()
    cg = workloads.build("deepseek_proxy").condense()
    assert gmem_footprint_bytes(cg.groups) > chip.global_mem_bytes
    for n in (1, 2):
        with pytest.raises(InfeasibleModel) as got:
            flow.compile("deepseek_proxy", chip, CompileOptions(
                fidelity="analytic", system=SystemConfig.mesh(n)))
        with pytest.raises(JInfeasibleModel) as want:
            jflow.compile("deepseek_proxy", j_default_chip(),
                          jflow.CompileOptions(
                              fidelity="analytic",
                              system=JSystemConfig.mesh(n)))
        assert str(got.value) == str(want.value)
    # at 4 chips both splitters clear the wall with the reference's plan
    jcg = jworkloads.build("deepseek_proxy").condense()
    for mode, split, jsplit in (("pipeline", split_pipeline,
                                 j_split_pipeline),
                                ("tensor", shard_tensor, j_shard_tensor)):
        plan = split(cg, chip, SystemConfig.mesh(4, parallel=mode))
        jplan = jsplit(jcg, j_default_chip(),
                       JSystemConfig.mesh(4, parallel=mode))
        assert plan.n_chips == 4
        assert SystemPartitionPass(mode).dump(plan) == \
            SystemPartitionPass(mode).dump(jplan)


# ---------------------------------------------------------------------------
# multi-chip DSE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fidelity", ["analytic", "trace"])
def test_mesh_dse_sweep(fidelity, tmp_path):
    space = mesh_space(chips=(1, 2, 4), links=("interposer", "pcb"))
    pts = space.points()
    assert len(pts) == 6
    eng = ExplorationEngine("transformer", cache=str(tmp_path),
                            device=CPU, **SMALL_TF)
    recs = eng.evaluate(pts, fidelity=fidelity)
    assert all(r.error is None for r in recs)
    by = {(r.point.chips, r.point.link): r for r in recs}
    assert by[(2, "interposer")].throughput_sps > \
        by[(1, "interposer")].throughput_sps
    assert by[(2, "interposer")].cycles <= by[(2, "pcb")].cycles
    again = eng.evaluate(pts, fidelity=fidelity)
    assert all(r.cache_hit for r in again)
    assert [r.cycles for r in again] == [r.cycles for r in recs]
    jrecs = JExplorationEngine("transformer", cache=None, **SMALL_TF
                               ).evaluate(j_mesh_space(
                                   chips=(1, 2, 4),
                                   links=("interposer", "pcb")).points(),
                                   fidelity=fidelity)
    assert [(r.cycles, r.energy, r.throughput_sps) for r in recs] == \
        [(r.cycles, r.energy, r.throughput_sps) for r in jrecs]
    # cache keys are the reference's digests
    jeng = JExplorationEngine("transformer", cache=str(tmp_path / "j"),
                              **SMALL_TF)
    assert [eng._key(p, fidelity) for p in pts] == \
        [jeng._key(jp, fidelity) for jp in j_mesh_space(
            chips=(1, 2, 4), links=("interposer", "pcb")).points()]


def test_design_point_system_axes_default_off():
    from repro.explore import DesignPoint as JDesignPoint
    pt = DesignPoint()
    assert pt.system() is None
    legacy = {"macros_per_group": 8, "n_macro_groups": 16,
              "n_cores": 64, "flit_bytes": 8, "local_mem_kb": 512,
              "strategy": "generic"}
    assert DesignPoint.from_dict(legacy) == pt
    assert DesignPoint.from_dict(pt.to_dict()) == pt
    pt4 = pt.replace(chips=4, link="interposer")
    assert pt4.system().n_chips == 4
    assert pt4.system().link.name == "interposer"
    assert pt4.system().to_dict() == \
        JDesignPoint.from_dict(pt4.to_dict()).system().to_dict()


def test_mesh_point_simulate_runs_in_process(monkeypatch):
    """Mesh points at simulate fidelity on the ``torch`` engine run per
    point in this process (never in the fork pool, nor on the fleet)
    and equal the reference's records."""
    def refused(*a, **kw):
        raise AssertionError("mesh points left this process")
    monkeypatch.setattr(ExplorationEngine, "_run_pool", refused)
    monkeypatch.setattr(ExplorationEngine, "_fleet", refused)
    pts = mesh_space(chips=(2, 4), links=("pcb",)).points()
    jrecs = JExplorationEngine("tiny_cnn", cache=None, res=8).evaluate(
        j_mesh_space(chips=(2, 4), links=("pcb",)).points(),
        fidelity="simulate")
    for engine in ("auto", "torch"):
        eng = ExplorationEngine("tiny_cnn", cache=None, pool=2,
                                engine=engine, device=CPU, res=8)
        recs = eng.evaluate(pts, fidelity="simulate")
        assert all(r.error is None for r in recs)
        assert [(r.cycles, r.energy, r.throughput_sps) for r in recs] == \
            [(r.cycles, r.energy, r.throughput_sps) for r in jrecs]


# ---------------------------------------------------------------------------
# serving: multi-chip tables + whole-table disk cache
# ---------------------------------------------------------------------------


def test_serve_table_disk_cache(tmp_path, monkeypatch):
    from repro_torch.flow import diskcache
    from repro_torch.serve import ServeModelCfg, StepCostTable
    monkeypatch.delenv(diskcache.ENV_VAR, raising=False)
    cfg = ServeModelCfg(n_layers=1, d_model=64, n_heads=2, vocab=64,
                        max_prompt=16, max_new=16)
    jcfg = JServeModelCfg(**cfg.to_dict())
    root = str(tmp_path / "flow")
    kw = dict(fidelity="analytic", flow_cache=root)
    t1 = StepCostTable(cfg, **kw)
    assert not t1.cache_hit
    t2 = StepCostTable(cfg, **kw)
    assert t2.cache_hit
    assert t2.to_dict() == t1.to_dict()
    t3 = StepCostTable(cfg, system=SystemConfig.mesh(2), **kw)
    assert not t3.cache_hit
    assert t3.to_dict()["system"] is not None
    # the reference's tables and keys, built without a disk tier
    monkeypatch.delenv("REPRO_FLOW_CACHE", raising=False)
    j1 = JStepCostTable(jcfg, fidelity="analytic")
    j3 = JStepCostTable(jcfg, fidelity="analytic",
                        system=JSystemConfig.mesh(2))
    assert t1.to_dict() == j1.to_dict()
    assert t3.to_dict() == j3.to_dict()
    assert t3._table_key() == j3._table_key()
    # the port's disk tier holds its own entries only
    files = [p.name for p in (tmp_path / "flow").rglob("*.pkl")]
    assert files and all(f.endswith(diskcache.SUFFIX) for f in files)


def test_serve_cli_chips_parsing():
    from repro_torch.serve.__main__ import _system, build_parser
    p = build_parser()
    assert _system(p.parse_args(["--chips", "1"])) is None
    sysc = _system(p.parse_args(["--chips", "2x2",
                                 "--link", "interposer"]))
    assert (sysc.chips_x, sysc.chips_y) == (2, 2)
    assert sysc.link.name == "interposer"
    assert _system(p.parse_args(["--chips", "4"])).n_chips == 4
    with pytest.raises(SystemExit):
        _system(p.parse_args(["--chips", "zero"]))
    assert p.parse_args(["--device", "cpu"]).device == "cpu"
    assert p.parse_args([]).device is None
