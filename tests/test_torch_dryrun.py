"""The port's dry run (``repro_torch.launch.dryrun``): its records, its
counts and its CLI.

Counts on a distributed mesh run in a subprocess on the single-process
``"fake"`` backend (it is process-global); the one-device counts run
here on the launchers' ``LocalMesh``.  What is held:

* a record has the reference's keys (``fits_16g`` named ``fits_hbm``)
  plus ``sources``;
* its argument bytes equal a sum of the local shards' bytes computed
  here from the spec trees, the abstract shapes and the mesh sizes;
* on (1, 1) its FLOPs equal ``FlopCounterMode`` over a real CPU run of
  the same step on the same shapes, exactly;
* on a fake (2, 2) mesh, for reduced phi4-mini (every sharded dim
  divides), the per-chip FLOPs times 4 are within 1% of the one-chip
  count (train, prefill, decode);
* collectives are zero on (1, 1) and nonzero over a model axis of 2;
* one full-size cell through the CLI: ``status: "ok"`` in under 60 s;
  a cell that fails is recorded as an error and the CLI exits 1.
"""

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch import dryrun, sharding, steps
from repro_torch.launch.mesh import LocalMesh, make_mesh
from repro_torch.models import analysis_flags, model_zoo, transformer as T
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
B, SEQ = 4, 64
KINDS = ("train", "prefill", "decode")
# the reference's record (src/repro/launch/dryrun.py run_cell)
REF_KEYS = {"arch", "shape", "mesh", "n_chips", "kind", "lower_s",
            "compile_s", "memory", "cost_raw", "collectives_raw", "probe_s",
            "cost", "collectives", "head_sharding", "flash_extra",
            "roofline", "model_flops", "useful_flops_frac", "status"}
REF_MEMORY = {"argument_gib", "output_gib", "temp_gib", "alias_gib",
              "live_gib"}

_FAKE = textwrap.dedent(r"""
    import json, sys
    sys.modules["jax"] = None
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    B, SEQ = int(sys.argv[1]), int(sys.argv[2])
    out = {}
    with dryrun.fake_group(4):
        mesh = make_mesh((2, 2), ("data", "model"))
        for name in ("phi4-mini-3.8b", "olmoe-1b-7b"):
            for kind in ("train", "prefill", "decode"):
                rec = dryrun.cost_cell(reduced(ARCHS[name]),
                                       ShapeConfig("s", SEQ, B, kind), mesh)
                out[f"{name}|{kind}"] = rec
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_records():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _FAKE, str(B), str(SEQ)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _local_cell(name, kind):
    return dryrun.cost_cell(reduced(ARCHS[name]),
                            ShapeConfig("s", SEQ, B, kind),
                            make_mesh((1, 1), ("data", "model")))


def _check_record(rec):
    assert REF_KEYS - {"arch", "shape"} <= set(rec), REF_KEYS - set(rec)
    assert REF_MEMORY | {"fits_hbm", "hbm_gib"} <= set(rec["memory"])
    assert "fits_16g" not in rec["memory"]
    assert rec["memory"]["hbm_gib"] == pytest.approx(80e9 / 2**30)
    assert rec["hw"]["name"] == "h100"
    assert rec["status"] == "ok"
    for key in ("memory.argument_gib", "memory.temp_gib", "cost.flops",
                "cost.bytes accessed", "collectives", "roofline"):
        assert key in rec["sources"]
    r = rec["roofline"]
    assert r["compute_s"] == pytest.approx(rec["cost"]["flops"] / 989e12)
    assert r["memory_s"] == pytest.approx(
        rec["cost"]["bytes accessed"] / 3.35e12)
    assert rec["flash_extra"] == {"hbm": 0.0, "link": 0.0}


@pytest.mark.parametrize("kind", KINDS)
def test_records_have_the_reference_keys(fake_records, kind):
    for name in ("phi4-mini-3.8b", "olmoe-1b-7b"):
        _check_record(fake_records[f"{name}|{kind}"])
        _check_record(_local_cell(name, kind))


def _local_bytes(cfg, kind, sizes):
    """Rank 0's argument bytes from the spec trees: each leaf's shape
    divided by the sizes of the axes its spec names."""
    mesh = LocalMesh(tuple(sizes.values()), tuple(sizes))
    pspecs = sharding.param_specs(cfg, mesh)
    abstract = steps.abstract_params(cfg)
    shapes = sharding.stacked_shapes(abstract)

    def leaf_bytes(spec, shape, itemsize):
        n = 1
        for d, size in enumerate(shape):
            entry = spec[d] if d < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            div = int(np.prod([sizes[a] for a in axes])) if axes else 1
            n *= size // div
        return n * itemsize

    def tree_bytes(specs, shapes, itemsize):
        total = 0

        def add(spec, shape):
            nonlocal total
            total += leaf_bytes(spec, shape, itemsize)
            return None

        sharding.spec_map(add, specs, shapes)
        return total

    # float32 parameters (and moments)
    p = tree_bytes(pspecs, shapes, 4)
    dp = int(np.prod([sizes[a] for a in sharding.usable_data_axes(mesh, B)]))
    if kind == "train":
        return 3 * p + 4 + B // dp * SEQ * 4
    if kind == "prefill":
        return p + B // dp * SEQ * 4
    st = sharding.decode_state_specs(cfg, mesh, B)
    state = steps.abstract_state(cfg, B, SEQ)
    per = state["caches"]
    cshapes = {k: {kk: (len(per),) + tuple(t.shape) for kk, t in v.items()}
               for k, v in per[0].items()}
    itemsize = {k: {kk: t.element_size() for kk, t in v.items()}
                for k, v in per[0].items()}
    c = 0
    for k in cshapes:
        for kk in cshapes[k]:
            c += leaf_bytes(st["caches"][k][kk], cshapes[k][kk],
                            itemsize[k][kk])
    return p + c + B // dp * 4


@pytest.mark.parametrize("kind", KINDS)
def test_argument_bytes_are_the_local_shards(fake_records, kind):
    for name in ("phi4-mini-3.8b", "olmoe-1b-7b"):
        cfg = reduced(ARCHS[name])
        got = fake_records[f"{name}|{kind}"]["memory"]["argument_gib"]
        want = _local_bytes(cfg, kind, {"data": 2, "model": 2})
        assert got * 2**30 == pytest.approx(want, rel=0, abs=0.5)
        one = _local_cell(name, kind)["memory"]["argument_gib"]
        assert one * 2**30 == pytest.approx(
            _local_bytes(cfg, kind, {"data": 1, "model": 1}), rel=0, abs=0.5)


def _real_flops(name, kind):
    """FlopCounterMode over a real CPU run of the same step, shapes and
    flags (the balanced MoE probe path)."""
    cfg = reduced(ARCHS[name])
    shape = ShapeConfig("s", SEQ, B, kind)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = model_zoo.dummy_batch(cfg, B, SEQ, device="cpu")
    prev = dict(analysis_flags.FLAGS)
    analysis_flags.FLAGS.update(balanced_moe=True)
    try:
        if kind == "train":
            fn, _ = steps.make_train_step(cfg, "cpu", shape)
            opt = adamw_init(params, AdamWConfig())
            with FlopCounterMode(display=False) as fc:
                fn(params, opt, batch, 0)
        elif kind == "prefill":
            fn, _ = steps.make_prefill_step(cfg, "cpu", shape)
            with FlopCounterMode(display=False) as fc:
                fn(params, batch)
        else:
            fn, _ = steps.make_decode_step(cfg, "cpu", shape)
            state = T.init_decode_state(cfg, params, B, SEQ, device="cpu")
            fn(params, state, batch["tokens"][:, :1])     # the cast, once
            with FlopCounterMode(display=False) as fc:
                fn(params, state, batch["tokens"][:, 1:2])
    finally:
        analysis_flags.FLAGS.clear()
        analysis_flags.FLAGS.update(prev)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "olmoe-1b-7b"])
def test_one_device_flops_equal_flop_counter(name, kind):
    assert _local_cell(name, kind)["cost"]["flops"] == _real_flops(name,
                                                                   kind)


def test_one_device_decode_flops_equal_flop_counter():
    """The decode cell casts the parameters inside its step (a first
    call); the real run's count is taken after the cast, so the cast's
    FLOPs (none: a dtype conversion) do not differ."""
    for name in ("phi4-mini-3.8b", "olmoe-1b-7b"):
        assert _local_cell(name, "decode")["cost"]["flops"] == \
            _real_flops(name, "decode")


@pytest.mark.parametrize("kind", KINDS)
def test_per_chip_flops_split_over_four_chips(fake_records, kind):
    one = _local_cell("phi4-mini-3.8b", kind)["cost"]["flops"]
    four = fake_records[f"phi4-mini-3.8b|{kind}"]["cost"]["flops"]
    assert abs(4 * four - one) <= 0.01 * one, (four, one)


@pytest.mark.parametrize("kind", KINDS)
def test_collectives_only_over_a_wide_mesh(fake_records, kind):
    for name in ("phi4-mini-3.8b", "olmoe-1b-7b"):
        one = _local_cell(name, kind)
        assert one["collectives"]["count"] == 0
        assert one["roofline"]["collective_s"] == 0.0
        wide = fake_records[f"{name}|{kind}"]
        assert wide["collectives"]["count"] > 0
        assert wide["collectives"]["all-reduce"] > 0
        assert wide["comm_debug_count"] > 0
        assert wide["roofline"]["collective_s"] > 0.0


def test_cli_full_size_cell(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.time()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "phi4-mini-3.8b", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=120)
    wall = time.time() - t0
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(out.read_text())["phi4-mini-3.8b|decode_32k|1pod"]
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["n_chips"] == 256 and rec["head_sharding"] == "head_dim"
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert wall < 60, wall
    assert "-> ok dominant=" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "decode_32k", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    bad = json.loads(out.read_text())["no-such-arch|decode_32k|1pod"]
    assert bad["status"] == "error" and "KeyError" in bad["error"]
