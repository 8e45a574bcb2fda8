"""The port's launch layer (``repro_torch.launch.sharding``,
``launch.analysis``, ``launch.mesh``, ``launch.steps``' abstract trees,
``core.planner``) against the JAX package's.

Spec trees are compared element for element, each ``PartitionSpec`` and
each port ``P`` taken as a tuple, on meshes of the production shapes
(objects that answer what the rules read: the reference's ``shape``
mapping and ``axis_names``, the port's ``shape`` tuple and
``mesh_dim_names``).  The abstract trees are compared stacked (the
port keeps one tree per block), shape and dtype.  The analysis and the
planner are host code copied as it is: their outputs must be equal.
The production mesh and DTensor placements run in subprocesses on the
single-process ``"fake"`` backend (it is process-global).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ARCHS, STANDARD_SHAPES
from repro.core import planner as jplanner
from repro.launch import analysis as janalysis
from repro.launch import sharding as jsharding, steps as jsteps
from repro.launch import tuning as jtuning
from repro.optim import AdamWConfig as JAdamWConfig

from repro_torch.configs import ARCHS as TARCHS, STANDARD_SHAPES as TSHAPES
from repro_torch.core import planner
from repro_torch.launch import analysis, sharding, steps, tuning
from repro_torch.launch.mesh import LocalMesh
from repro_torch.optim import AdamWConfig

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((1, 1), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "1x1"]
BATCHES = [None, 1, 16, 32, 128, 256]


class _JMesh:
    """What the reference's rules read of a ``Mesh``."""

    def __init__(self, shape, axes):
        self.shape = dict(zip(axes, shape))
        self.axis_names = tuple(axes)


def _meshes(i):
    shape, axes = MESHES[i]
    return _JMesh(shape, axes), LocalMesh(shape, axes)


def _jtuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, JP))


def _ttuples(tree):
    return sharding.spec_map(tuple, tree)


def _stacked(tree):
    """The port's abstract tree as the reference's: ``(shape, dtype)``
    leaves, per-block trees stacked."""
    from torch import nn
    shapes = sharding.stacked_shapes(tree)

    def dtypes(node):
        if hasattr(node, "keys") and not hasattr(node, "shape"):
            return {k: dtypes(node[k]) for k in node.keys()}
        return str(node.dtype).replace("torch.", "")

    out = {}
    for k in tree.keys():
        v = tree[k]
        if isinstance(v, (list, nn.ModuleList)):
            out[k] = dtypes(v[0])
        else:
            out[k] = dtypes(v)
    return sharding.spec_map(lambda s, d: (tuple(s), d), shapes, out)


def _jstacked(tree):
    return jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)), tree)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------


def test_p_normalizes_as_partition_spec():
    for entries in [((), None), (("data",), None), (("pod", "data"), None),
                    (None, "model"), (), (None, (), "model")]:
        assert tuple(sharding.P(*entries)) == tuple(JP(*entries))


@pytest.mark.parametrize("mi", range(3), ids=MESH_IDS)
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_spec_trees_match_reference(name, mi):
    jm, tm = _meshes(mi)
    cfg, tcfg = ARCHS[name], TARCHS[name]
    pj = jsharding.param_specs(cfg, jm)
    pt = sharding.param_specs(tcfg, tm)
    assert _ttuples(pt) == _jtuples(pj)
    assert _ttuples(sharding.opt_state_specs(pt)) == _jtuples(
        jsharding.opt_state_specs(pj))
    for b in BATCHES:
        assert _ttuples(sharding.batch_specs(tcfg, tm, b)) == _jtuples(
            jsharding.batch_specs(cfg, jm, b))
        assert _ttuples(sharding.decode_state_specs(tcfg, tm, b)) == \
            _jtuples(jsharding.decode_state_specs(cfg, jm, b))
        assert sharding.usable_data_axes(tm, b) == \
            jsharding.usable_data_axes(jm, b)
    assert sharding.head_sharding_choice(tcfg, tm) == \
        jsharding.head_sharding_choice(cfg, jm)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_fsdp_specs_match_reference(name):
    """``fsdp_specs`` on every mesh, from the port's abstract tree (read
    stacked) and the reference's; the spec tree matches the abstract
    tree's structure and every sharded dim divides by its axes' size."""
    cfg, tcfg = ARCHS[name], TARCHS[name]
    jabs = jsteps.abstract_params(cfg)
    tabs = steps.abstract_params(tcfg)
    shapes = sharding.stacked_shapes(tabs)
    for mi in range(3):
        jm, tm = _meshes(mi)
        pj = jsharding.param_specs(cfg, jm)
        pt = sharding.param_specs(tcfg, tm)
        fj = jsharding.fsdp_specs(pj, jabs, jm)
        ft = sharding.fsdp_specs(pt, tabs, tm)
        assert _ttuples(ft) == _jtuples(fj)

        def check(spec, shape, tm=tm):
            for d, entry in enumerate(spec):
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                n = int(np.prod([tm.shape[tm.mesh_dim_names.index(a)]
                                 for a in axes])) if axes else 1
                assert shape[d] % n == 0, (name, spec, shape)
            return None

        sharding.spec_map(check, pt, shapes)
        sharding.spec_map(check, ft, shapes)


def test_head_sharding_pinned_cases():
    """The reference's pinned cases (tests/test_launch.py)."""
    _, prod = _meshes(0)
    hs = lambda n: sharding.head_sharding_choice(TARCHS[n], prod)  # noqa
    assert hs("phi3-medium-14b") == "head_dim"
    assert hs("deepseek-coder-33b") == "head_dim"
    assert hs("deepseek-v3-671b") == "heads"
    assert hs("olmoe-1b-7b") == "heads"
    assert hs("whisper-small") == "head_dim"
    assert sharding.usable_data_axes(prod, 256) == ("data",)
    assert sharding.usable_data_axes(prod, 1) == ()
    three = LocalMesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.usable_data_axes(three, 256) == ("pod", "data")
    assert sharding.usable_data_axes(three, 16) == ("data",)
    assert sharding.usable_data_axes(three, 1) == ()


# ---------------------------------------------------------------------------
# Abstract trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8_weights"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_trees_match_reference(name, int8):
    cfg, tcfg = ARCHS[name], TARCHS[name]
    with jtuning.tuned(int8_weights=int8), tuning.tuned(int8_weights=int8):
        jp, tp = jsteps.abstract_params(cfg), steps.abstract_params(tcfg)
        jo = jsteps.abstract_opt_state(cfg, JAdamWConfig())
        to = steps.abstract_opt_state(tcfg, AdamWConfig())
    assert all(t.device.type == "meta" for t in tp.parameters())
    assert _stacked(tp) == _jstacked(jp)
    assert _stacked(to["m"]) == _jstacked(jo["m"])
    assert _stacked(to["v"]) == _jstacked(jo["v"])
    assert tuple(to["step"].shape) == () and to["step"].dtype == torch.int32
    if not int8:
        shape = STANDARD_SHAPES["decode_32k"]
        js = jsteps.abstract_state(cfg, shape.global_batch, shape.seq_len)
        ts = steps.abstract_state(tcfg, shape.global_batch, shape.seq_len)
        assert ts["pos"] == 0 and tuple(js["pos"].shape) == ()
        per = [{k: {kk: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for kk, t in v.items()} for k, v in c.items()}
               for c in ts["caches"]]
        stacked = jax.tree.map(lambda *xs: ((len(xs),) + xs[0][0], xs[0][1]),
                               *per, is_leaf=lambda x: isinstance(x, tuple))
        assert stacked == _jstacked(js["caches"])
        if cfg.encoder_layers:
            assert (tuple(ts["enc"].shape),
                    str(ts["enc"].dtype).replace("torch.", "")) == \
                _jstacked(js["enc"])


# ---------------------------------------------------------------------------
# Analysis and planner (host copies)
# ---------------------------------------------------------------------------

HLO_SAMPLE = """
  %all-reduce.1 = bf16[16,4096,448]{2,1,0} all-reduce(%x), replica_groups=...
  %ag = f32[1024,512]{1,0} all-gather(%y), dimensions={0}
  %rs = bf16[64,128]{1,0} reduce-scatter(%z), dimensions={0}
  %cp-start = (f32[8,8]{1,0}, f32[8,8]{1,0}) collective-permute-start(%w)
  %dot.5 = f32[128,128]{1,0} dot(%a, %b)
"""


def test_collective_bytes_parsing():
    coll = analysis.collective_bytes(HLO_SAMPLE)
    assert coll == janalysis.collective_bytes(HLO_SAMPLE)
    assert coll["all-reduce"] == 16 * 4096 * 448 * 2
    assert coll["all-gather"] == 1024 * 512 * 4
    assert coll["reduce-scatter"] == 64 * 128 * 2
    assert coll["collective-permute"] == 2 * 8 * 8 * 4
    assert coll["all-to-all"] == 0
    assert coll["count"] == 4


def test_roofline_terms_dominance():
    cost = {"flops": 197e12, "bytes accessed": 819e9 / 2}
    coll = {"all-reduce": 0, "all-gather": 0, "reduce-scatter": 0,
            "all-to-all": 0, "collective-permute": 0}
    t = analysis.roofline_terms(cost, coll)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.dominant == "compute"
    t2 = analysis.roofline_terms(cost, coll, extra_link_bytes=200e9)
    assert t2.dominant == "collective"
    assert t2.as_dict() == janalysis.roofline_terms(
        cost, coll, extra_link_bytes=200e9).as_dict()
    h = analysis.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12},
                                dict(coll, **{"all-reduce": 25e9}),
                                analysis.H100)
    assert (h.compute_s, h.memory_s, h.collective_s) == \
        pytest.approx((1.0, 1.0, 1.0))


def test_model_flops_train_vs_decode():
    cfg = TARCHS["phi3-medium-14b"]
    tr = analysis.model_flops(cfg, TSHAPES["train_4k"], 256)
    de = analysis.model_flops(cfg, TSHAPES["decode_32k"], 256)
    n = cfg.param_count()
    assert tr == pytest.approx(6 * n * 256 * 4096 / 256)
    assert de == pytest.approx(2 * n * 128 / 256)


def test_moe_active_params_subtracts_inactive_experts():
    cfg = TARCHS["olmoe-1b-7b"]
    assert analysis._active_params(cfg) < 0.35 * cfg.param_count()


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_analysis_and_planner_match_reference(name):
    """``model_flops``, ``_active_params``, ``flash_addons`` (every head
    choice, two pod sizes) and ``plan_parallelism`` (its stages, step
    and rate, or its refusal) over the 4 standard shapes."""
    cfg, tcfg = ARCHS[name], TARCHS[name]
    assert analysis._active_params(tcfg) == janalysis._active_params(cfg)
    for s in STANDARD_SHAPES:
        js, ts = STANDARD_SHAPES[s], TSHAPES[s]
        assert analysis.model_flops(tcfg, ts, 256) == \
            janalysis.model_flops(cfg, js, 256)
        for n, tp in ((256, 16), (512, 16), (256, 1)):
            for choice in ("heads", "head_dim", "replicated", "sequence"):
                assert analysis.flash_addons(tcfg, ts, n, tp, choice) == \
                    janalysis.flash_addons(cfg, js, n, tp, choice)
        try:
            want = jplanner.plan_parallelism(cfg, js)
        except ValueError as e:
            with pytest.raises(ValueError, match="no feasible plan"):
                planner.plan_parallelism(tcfg, ts)
            assert "no feasible plan" in str(e)
            continue
        got = planner.plan_parallelism(tcfg, ts)
        assert [dataclasses.astuple(x) for x in got.stages] == \
            [dataclasses.astuple(x) for x in want.stages]
        assert (got.est_step_s, got.tokens_per_s, got.describe()) == \
            (want.est_step_s, want.tokens_per_s, want.describe())
        assert dataclasses.astuple(planner.PodSpec()) == \
            dataclasses.astuple(jplanner.PodSpec())


def _check_plan(cfg, plan):
    covered = []
    for s in plan.stages:
        covered.extend(range(*s.blocks))
    assert covered == list(range(cfg.n_blocks))
    pod = plan.pod
    for s in plan.stages:
        assert s.bytes_per_chip <= pod.hbm_bytes * pod.hbm_budget_frac \
            * 1.001
        assert s.chips <= pod.n_chips
        assert s.tp <= pod.max_tp
    assert sum(s.chips for s in plan.stages) <= pod.n_chips * 1.001 + 1
    assert plan.est_step_s > 0 and plan.tokens_per_s > 0


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_planner_default_pod(name):
    """The reference's planner tests on the port's copy."""
    cfg = TARCHS[name]
    _check_plan(cfg, planner.plan_parallelism(cfg, TSHAPES["train_4k"]))


def test_planner_big_models_and_duplication():
    small = planner.plan_parallelism(TARCHS["mamba2-780m"],
                                     TSHAPES["train_4k"])
    big = planner.plan_parallelism(TARCHS["deepseek-v3-671b"],
                                   TSHAPES["train_4k"])
    assert big.pp > small.pp and big.pp >= 4
    assert small.stages[0].dup >= 32


@pytest.mark.parametrize("shape", sorted(TSHAPES))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_planner_h100_preset(name, shape):
    """Under the H100 preset the stages tile the blocks, each fits its
    80 GB budget, TP stays inside one 8-GPU node, the chips stay within
    the pod."""
    pod = planner.H100_POD
    assert pod == planner.PodSpec.h100()
    assert (pod.peak_flops, pod.hbm_bytes, pod.hbm_bw, pod.max_tp) == \
        (989e12, 80e9, 3.35e12, 8)
    assert pod.ici_bw * pod.ici_links == planner.NVLINK4_BW == 450e9
    assert planner.IB_NDR_BW == 50e9
    cfg = TARCHS[name]
    _check_plan(cfg, planner.plan_parallelism(cfg, TSHAPES[shape], pod))


def test_hw_presets():
    assert analysis.HW() == analysis.HW(197e12, 819e9, 50e9, 4, 16e9)
    assert dataclasses.astuple(analysis.HW()) == \
        dataclasses.astuple(janalysis.HW())
    h = analysis.H100
    assert h == analysis.HW.h100()
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes, h.ici_bw, h.ici_links) == \
        (989e12, 3.35e12, 80e9, 50e9, 1)


# ---------------------------------------------------------------------------
# The production mesh and placements, on the fake backend
# ---------------------------------------------------------------------------

_FAKE = textwrap.dedent(r"""
    import sys
    sys.modules["jax"] = None
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.configs import ARCHS
    from repro_torch.launch import sharding as SH, steps
    from repro_torch.launch.mesh import make_production_mesh
    try:
        make_production_mesh()
    except RuntimeError as e:
        assert "exactly 256 ranks" in str(e) and "none" in str(e), e
    else:
        raise AssertionError("a mesh without a process group")
    for world, multi in ((256, False), (512, True)):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
        try:
            make_production_mesh(multi_pod=not multi)
        except RuntimeError as e:
            assert f"one of {world}" in str(e), e
        else:
            raise AssertionError("a mesh of the wrong size")
        mesh = make_production_mesh(multi_pod=multi)
        want = (2, 16, 16) if multi else (16, 16)
        assert tuple(mesh.shape) == want and mesh.size() == world
        assert mesh.mesh_dim_names == (("pod", "data", "model") if multi
                                       else ("data", "model"))
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        for name in ("phi4-mini-3.8b", "olmoe-1b-7b", "mamba2-780m"):
            cfg = ARCHS[name]
            params = steps.abstract_params(cfg)
            specs = SH.fsdp_specs(SH.param_specs(cfg, mesh), params, mesh)
            placed = SH.distribute(mesh, params, specs)
            flat = SH.spec_map(lambda s: s, specs)
            n = 0
            for key in params.keys():
                blocks = key in ("blocks", "enc_blocks")
                got, full = placed[key], params[key]
                spec = flat[key]
                pairs = []
                def walk(g, f, s, blocks=blocks):
                    if hasattr(g, "shape"):
                        pairs.append((g, f, s[1:] if blocks else s))
                    else:
                        for k in g.keys():
                            walk(g[k], f[k], s[k])
                if blocks:
                    for g, f in zip(got, full):
                        walk(g, f, spec)
                else:
                    walk(got, full, spec)
                for g, f, s in pairs:
                    local = list(f.shape)
                    for d, entry in enumerate(s):
                        for ax in (() if entry is None else entry
                                   if isinstance(entry, tuple) else (entry,)):
                            local[d] //= sizes[ax]
                    assert tuple(g.to_local().shape) == tuple(local), \
                        (name, s, f.shape, g.to_local().shape)
                    assert tuple(g.placements) == SH.placements(mesh, s)
                    n += 1
            assert n > 10
        dist.destroy_process_group()
    print("ok")
""")


def test_production_mesh_and_placements_on_fake_group():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _FAKE], env=env,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), \
        r.stderr[-4000:]


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    m = LocalMesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements(m, sharding.P(("pod", "data"), "model")) == \
        (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(m, sharding.P(None, None)) == \
        (Replicate(),) * 3
    assert sharding.placements(m, sharding.P("data", None, "model")) == \
        (Replicate(), Shard(0), Shard(2))
    with pytest.raises(ValueError, match="not an axis"):
        sharding.placements(m, sharding.P("expert"))
    tree = {"w": torch.zeros(2)}
    assert sharding.distribute(m, tree, {"w": sharding.P(None)}) is tree
    assert sharding.distribute(None, tree, {"w": sharding.P(None)}) is tree
