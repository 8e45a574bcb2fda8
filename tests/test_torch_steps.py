"""The port's steps (``repro_torch.launch.steps``) against the JAX
package's: the prefill step on one device for every reduced arch, and
the train, decode and prefill steps and an ``attn_seq_parallel`` forward
over 2-member meshes.

Parameters come from ``repro.models.model_zoo.init`` and cross to the
port with ``convert.from_jax_params``; batches are the reference's data
stream's (``repro.data.make_batch``) or dummy batches.  The sharded
steps run in a 2-process gloo group (``python -c`` workers that cannot
import ``jax``, ``file://`` init in ``tmp_path``) on (2, 1) and (1, 2)
``("data", "model")`` meshes, each rank's result gathered
(``full_tensor``); the reference runs its jitted, sharded steps on 2
host devices in a subprocess, under its mesh context (MoE through
``shard_map``).  Tolerances, fp32 reduced configs (the two frameworks
and the two layouts sum in other orders):

* prefill and forward logits within ``TOL`` (2e-4) of the largest
  reference logit; decode logits likewise, after the prompt is stepped;
* two train steps: the losses within ``TOL``, ``grad_norm`` within 1e-5
  relative, every parameter within ``PARAM_TOL_LR`` * lr of the
  reference's (the step's lr is 1e-3 at the second step);
* on (2, 1) olmoe's aux loss is the mean over the two batch halves', on
  both sides (``shard_map``'s data-parallel semantics); at capacity 1.25
  a rank packs only its experts' hits, so tokens drop as they do on the
  reference's 2 devices (not as on one).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, ShapeConfig as JShapeConfig, reduced
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import layers as JL
from repro.models import model_zoo as jzoo

from repro_torch import tree as tree_util
from repro_torch.configs import ARCHS as TARCHS, ShapeConfig, \
    reduced as treduced
from repro_torch.convert import from_jax_params
from repro_torch.launch import steps
from repro_torch.models import layers as L

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
TOL = 2e-4
PARAM_TOL_LR = 0.01
LR = 1e-3
B, S = 4, 16
PREFILL_SEQ = 32
SHARDED_ARCHS = ("phi4-mini-3.8b", "olmoe-1b-7b")
TIMEOUT = 400


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# make_prefill_step on one device, every reduced arch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True], ids=["naive", "blockwise"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_prefill_step_matches_reference(name, flash, monkeypatch):
    """Last-token logits (B, vocab) fp32 of the reference's jitted
    ``make_prefill_step`` on a (1, 1) mesh and the port's on the CPU.
    ``blockwise`` lowers ``FLASH_THRESHOLD`` in both packages' layers
    below the sequence, so attention takes the blockwise loop."""
    if flash:
        monkeypatch.setattr(JL, "FLASH_THRESHOLD", PREFILL_SEQ // 2)
        monkeypatch.setattr(L, "FLASH_THRESHOLD", PREFILL_SEQ // 2)
    cfg, tcfg = reduced(ARCHS[name]), treduced(TARCHS[name])
    mesh = make_mesh((1, 1), ("data", "model"))
    jfn, _ = jsteps.make_prefill_step(
        cfg, mesh, JShapeConfig("p", PREFILL_SEQ, 2, "prefill"))
    tfn, spec = steps.make_prefill_step(
        tcfg, "cpu", ShapeConfig("p", PREFILL_SEQ, 2, "prefill"))
    assert spec["tokens"] == ((2, PREFILL_SEQ), torch.int32)
    params = jzoo.init(cfg)
    batch = _np_tree(jzoo.dummy_batch(cfg, 2, PREFILL_SEQ))
    want = np.asarray(jfn(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    got = tfn(from_jax_params(tcfg, _np_tree(params), "cpu"),
              {k: torch.from_numpy(np.array(v)) for k, v in batch.items()})
    assert got.dtype == torch.float32 and got.shape == (2, tcfg.vocab)
    _close(got.numpy(), want, TOL, name)


# ---------------------------------------------------------------------------
# Sharded steps: gloo (port) against 2 host devices (reference)
# ---------------------------------------------------------------------------

# (case, arch, mesh, what): train steps on both meshes, under fsdp_params
# on (2, 1); decode, prefill and the seq-parallel forward on (1, 2); and
# deepseek-v3's train step on (1, 2) (MLA's region: its replicated
# weights serve one rank's heads, so their gradients are partial sums)
CASES = [(f"{n}|{m}|{w}", n, m, w)
         for n in SHARDED_ARCHS
         for m, w in (("2x1", "train"), ("1x2", "train"), ("2x1", "fsdp"),
                      ("1x2", "decode"), ("1x2", "prefill"),
                      ("1x2", "seqpar"))] + [
    ("deepseek-v3-671b|1x2|train", "deepseek-v3-671b", "1x2", "train")]

_JAX = textwrap.dedent(r"""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    assert len(jax.devices()) == 2, jax.devices()
    from repro.configs import ARCHS, ShapeConfig, reduced
    from repro.launch import meshctx, steps, tuning
    from repro.launch.mesh import make_mesh
    from repro.launch.sharding import usable_data_axes
    from repro.models import transformer as T
    from repro.optim import AdamWConfig, adamw_init
    inp, outp, B, S, LR = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
        int(sys.argv[4]), float(sys.argv[5])
    data = np.load(inp)
    res = {}

    def tree(prefix):
        p = {}
        for k in data.files:
            if k.startswith(prefix):
                node = p
                *head, last = k[len(prefix):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = jnp.asarray(data[k])
        return p

    def flat(prefix, t):
        for path, v in jax.tree_util.tree_flatten_with_path(t)[0]:
            res[prefix + "/".join(str(q.key) for q in path)] = np.asarray(v)

    for case in sys.argv[6:]:
        name, m, what = case.split("|")
        cfg = reduced(ARCHS[name])
        shape_m = tuple(int(v) for v in m.split("x"))
        mesh = make_mesh(shape_m, ("data", "model"))
        dp = usable_data_axes(mesh, B)
        params = tree(name + "/p/")
        batches = [{k: jnp.asarray(data[f"{name}/b{s}/{k}"])
                    for k in ("tokens",)} for s in range(2)]
        with meshctx.use_mesh(mesh, data_axes=dp), \
                tuning.tuned(fsdp_params=what == "fsdp",
                             attn_seq_parallel=what == "seqpar"):
            if what in ("train", "fsdp"):
                fn, _ = steps.make_train_step(
                    cfg, mesh, ShapeConfig("t", S, B, "train"),
                    AdamWConfig(), lr_peak=LR, warmup=1, total_steps=4)
                opt = adamw_init(params, AdamWConfig())
                for s in range(2):
                    params, opt, met = fn(params, opt, batches[s],
                                          jnp.int32(s))
                    res[f"{case}/loss{s}"] = np.asarray(met["loss"])
                    res[f"{case}/gnorm{s}"] = np.asarray(met["grad_norm"])
                flat(case + "/p/", params)
            elif what == "decode":
                fn, _ = steps.make_decode_step(
                    cfg, mesh, ShapeConfig("d", S, B, "decode"))
                state = T.init_decode_state(cfg, {}, B, S)
                toks = batches[0]["tokens"]
                for t in range(S):
                    logits, state = fn(params, state, toks[:, t:t + 1])
                res[case + "/logits"] = np.asarray(logits)
            elif what == "prefill":
                fn, _ = steps.make_prefill_step(
                    cfg, mesh, ShapeConfig("p", S, B, "prefill"))
                res[case + "/logits"] = np.asarray(fn(params, batches[0]))
            else:
                fwd = jax.jit(lambda p, b: T.forward(cfg, p, b, remat=False))
                res[case + "/logits"] = np.asarray(fwd(params, batches[0]))
    np.savez(outp, **res)
""")

_TORCH = textwrap.dedent(r"""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None
    torch.set_num_threads(1)
    from repro_torch import tree as tree_util
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.convert import from_jax_params
    from repro_torch.launch import sharding as SH, steps, tuning
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init
    rank, world, init, inp, outp = int(sys.argv[1]), int(sys.argv[2]), \
        sys.argv[3], sys.argv[4], sys.argv[5]
    B, S, LR = int(sys.argv[6]), int(sys.argv[7]), float(sys.argv[8])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    data = np.load(inp)
    res = {}
    meshes = {}

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t) \
            .detach().numpy()

    def tree(prefix):
        p = {}
        for k in data.files:
            if k.startswith(prefix):
                node = p
                *head, last = k[len(prefix):].split("/")
                for h in head:
                    node = node.setdefault(h, {})
                node[last] = data[k]
        return p

    for case in sys.argv[9:]:
        name, m, what = case.split("|")
        cfg = reduced(ARCHS[name])
        shape_m = tuple(int(v) for v in m.split("x"))
        if shape_m not in meshes:
            meshes[shape_m] = make_mesh(shape_m, ("data", "model"))
        mesh = meshes[shape_m]
        params = from_jax_params(cfg, tree(name + "/p/"), "cpu")
        batches = [{"tokens": torch.from_numpy(data[f"{name}/b{s}/tokens"])}
                   for s in range(2)]
        with tuning.tuned(fsdp_params=what == "fsdp",
                          attn_seq_parallel=what == "seqpar"):
            if what in ("train", "fsdp"):
                fn, _ = steps.make_train_step(
                    cfg, "cpu", ShapeConfig("t", S, B, "train"),
                    AdamWConfig(), lr_peak=LR, warmup=1, total_steps=4,
                    mesh=mesh)
                opt = adamw_init(params, AdamWConfig())
                for s in range(2):
                    params, opt, met = fn(params, opt, batches[s], s)
                    res[f"{case}/loss{s}"] = met["loss"].numpy()
                    res[f"{case}/gnorm{s}"] = met["grad_norm"].numpy()
                for path, leaf in tree_util.flatten_with_paths(params):
                    res[f"{case}/p/{path}"] = full(leaf)
            elif what == "decode":
                fn, _ = steps.make_decode_step(
                    cfg, "cpu", ShapeConfig("d", S, B, "decode"), mesh=mesh)
                state = T.init_decode_state(cfg, params, B, S, device="cpu")
                toks = batches[0]["tokens"]
                for t in range(S):
                    logits, state = fn(params, state, toks[:, t:t + 1])
                res[case + "/logits"] = full(logits)
            elif what == "prefill":
                fn, _ = steps.make_prefill_step(
                    cfg, "cpu", ShapeConfig("p", S, B, "prefill"), mesh=mesh)
                res[case + "/logits"] = full(fn(params, batches[0]))
            else:
                p = SH.distribute(mesh, params, SH.param_specs(cfg, mesh))
                b = SH.distribute(mesh, batches[0],
                                  SH.batch_specs(cfg, mesh, B))
                with torch.no_grad():
                    res[case + "/logits"] = full(T.forward(cfg, p, b))
    np.savez(outp, **res)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case run once: the reference in one subprocess (2 host
    devices), the port in one 2-rank gloo group."""
    from repro.data import make_batch
    tmp = tmp_path_factory.mktemp("steps")
    inputs = {}
    for name in sorted({n for _, n, _, _ in CASES}):
        cfg = reduced(ARCHS[name])
        params = jzoo.init(cfg)
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(str(q.key) for q in path)
            inputs[f"{name}/p/{key}"] = np.asarray(v)
        for s in range(2):
            inputs[f"{name}/b{s}/tokens"] = make_batch(cfg, B, S, seed=0,
                                                       step=s)["tokens"]
    inp = tmp / "inputs.npz"
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    cases = [c for c, *_ in CASES]
    jout = tmp / "jax.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX, str(inp), str(jout), str(B), str(S),
         str(LR)] + cases, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)]
    init = f"file://{tmp / 'pg_init'}"
    touts = [tmp / f"torch{r}.npz" for r in range(2)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _TORCH, str(r), "2", init, str(inp),
         str(touts[r]), str(B), str(S), str(LR)] + cases, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, (_, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]
    return dict(np.load(jout)), [dict(np.load(t)) for t in touts]


@pytest.mark.parametrize("case,name,mesh,what", CASES,
                         ids=[c for c, *_ in CASES])
def test_sharded_step_matches_reference(sharded, case, name, mesh, what):
    jres, tres = sharded
    for res in tres:                 # every rank gathers the same result
        if what in ("train", "fsdp"):
            for s in range(2):
                assert abs(float(res[f"{case}/loss{s}"])
                           - float(jres[f"{case}/loss{s}"])) <= TOL
                np.testing.assert_allclose(float(res[f"{case}/gnorm{s}"]),
                                           float(jres[f"{case}/gnorm{s}"]),
                                           rtol=1e-5, atol=0)
            tcfg = treduced(TARCHS[name])
            prefix = case + "/p/"
            want_tree = {}
            for k, v in jres.items():
                if k.startswith(prefix):
                    node = want_tree
                    *head, last = k[len(prefix):].split("/")
                    for h in head:
                        node = node.setdefault(h, {})
                    node[last] = v
            want = dict(tree_util.flatten_with_paths(
                from_jax_params(tcfg, want_tree, "cpu")))
            got = {k[len(prefix):]: v for k, v in res.items()
                   if k.startswith(prefix)}
            assert sorted(got) == sorted(want)
            for k, v in got.items():
                err = float(np.abs(v - want[k].numpy()).max())
                assert err <= PARAM_TOL_LR * LR, (case, k, err)
        else:
            _close(res[case + "/logits"], jres[case + "/logits"], TOL, case)
