"""The port's training path (``repro_torch`` ``loss_fn``, ``launch.steps.
make_train_step``, ``launch.train``) against the JAX package's.

Parameters come from ``repro.models.model_zoo.init`` and cross to the
port with ``convert.from_jax_params`` (the AdamW state with
``convert.from_jax_opt_state``); inputs are the reference's dummy
batches or its data stream's batches.  On the CPU the cross-entropy and
AdamW kernels run their plain versions.  Tolerances (float32 reduced
configs; the two frameworks sum in other orders):

* ``loss_fn`` within 2e-4 (the largest gap seen is 1.4e-6) and every
  gradient leaf within 2e-4 of that leaf's largest reference gradient
  (largest seen: 3.3e-5 of it, jamba);
* remat and no remat bit for bit (the same operations, recomputed);
* three train steps: losses within 2e-4, ``grad_norm`` and ``lr`` within
  1e-5 relative, every parameter within ``PARAM_TOL_LR`` * lr of the
  reference's (largest seen: 5.3e-4 * lr, mamba2);
* the CLI's resume bit for bit (the CPU run is deterministic);
* at bf16 compute, the loss within ``BF16_LOSS_RTOL`` (3e-3) relative
  (see ``test_loss_at_bf16_compute``).
"""

import dataclasses
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, ShapeConfig as JShapeConfig, reduced
from repro.data import make_batch as jmake_batch
from repro.launch import meshctx as jmeshctx, steps as jsteps
from repro.launch.mesh import make_mesh
from repro.models import model_zoo as jzoo
from repro.models import transformer as JT
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as jinit

from repro_torch import tree as tree_util
from repro_torch.checkpoint import load_pytree
from repro_torch.configs import (ARCHS as TARCHS, ShapeConfig,
                                 reduced as treduced)
from repro_torch.convert import from_jax_opt_state, from_jax_params
from repro_torch.kernels import adamw as KA, cross_entropy as KX
from repro_torch.launch import meshctx, steps, train, tuning
from repro_torch.launch.mesh import data_axes_of
from repro_torch.models import model_zoo, transformer as T
from repro_torch.optim import AdamWConfig, adamw_init

torch.set_num_threads(1)

TOL = 2e-4
BATCH, SEQ = 2, 32
CPU = "cpu"
PARAM_TOL_LR = 0.01          # a step moves a parameter by about lr
BF16_LOSS_RTOL = 3e-3
TRAIN_ARCHS = ["phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b",
               "deepseek-v3-671b"]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _paths(tree):
    return dict(tree_util.flatten_with_paths(tree))


def _port(name, params):
    tcfg = treduced(TARCHS[name])
    return tcfg, from_jax_params(tcfg, _np_tree(params), CPU)


# ---------------------------------------------------------------------------
# loss_fn and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_and_grads_match_reference(name):
    """All 10 reduced archs (deepseek-v3's MTP term, the MoE aux of
    olmoe, jamba and deepseek-v3, whisper's encoder, llava's vision
    prefix): the loss, and every gradient leaf reached through the
    differentiable cast."""
    cfg = reduced(ARCHS[name])
    params = jzoo.init(cfg)
    batch = jzoo.dummy_batch(cfg, BATCH, SEQ)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(cfg, p, batch)))(params)
    tcfg, tparams = _port(name, params)
    tparams.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tloss = T.loss_fn(tcfg, tparams, tbatch)
    assert tloss.dtype == torch.float32 and tloss.dim() == 0
    assert abs(float(tloss.detach()) - float(loss)) <= TOL
    leaves = tree_util.leaves(tparams)
    got = _paths(tree_util.unflatten(
        tparams, torch.autograd.grad(tloss, leaves)))
    want = _paths(from_jax_params(tcfg, _np_tree(grads), CPU))
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k]
        assert g.dtype == torch.float32 and g.shape == w.shape
        scale = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= TOL * max(scale, 1e-30), (k, err, scale)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_loss_at_bf16_compute(name):
    """At the published compute dtype (bf16) the loss runs for every
    arch with finite gradients (mamba2's chunk scan once failed there on
    the conv bias's dtype) and stays within ``BF16_LOSS_RTOL`` of the
    reference's.  The cast rounds a block's 1-D parameters to bf16 as the
    reference's stacked cast does (before that repair jamba read 7.7e-3).
    Largest gaps measured: jamba 2.86e-3 relative, every other arch within
    1.7e-4 (olmoe 1.6e-4, whisper 1.6e-4, phi3 1.4e-4).  jamba's remainder:
    XLA's and PyTorch's bf16 sigmoid / silu / exp round apart by one ulp
    in about 30% of elements, and over its 7 SSD and 8 MoE sublayers
    (4 experts, top 2, close router scores at random init) that flips
    2-6 of 64 routings a layer (ROADMAP §3)."""
    cfg = dataclasses.replace(reduced(ARCHS[name]),
                              compute_dtype="bfloat16")
    params = jzoo.init(cfg)
    batch = jzoo.dummy_batch(cfg, BATCH, SEQ)
    want = float(jax.jit(lambda p: JT.loss_fn(cfg, p, batch))(params))
    tcfg = dataclasses.replace(treduced(TARCHS[name]),
                               compute_dtype="bfloat16")
    tparams = from_jax_params(tcfg, _np_tree(params), CPU)
    tparams.requires_grad_(True)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss = T.loss_fn(tcfg, tparams, tbatch)
    grads = torch.autograd.grad(loss, tree_util.leaves(tparams))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert abs(float(loss.detach()) - want) <= BF16_LOSS_RTOL * want


def _loss_and_grads(cfg, params, batch, remat):
    loss = T.loss_fn(cfg, params, batch, remat=remat)
    return loss, torch.autograd.grad(loss, tree_util.leaves(params))


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_remat_bitwise(name, policy):
    """Rematerialized blocks recompute the very operations: loss and
    grads equal to the run that keeps every activation, under both
    policies."""
    cfg = treduced(TARCHS[name])
    params = model_zoo.init(cfg, seed=3, device=CPU).requires_grad_(True)
    batch = model_zoo.dummy_batch(cfg, BATCH, SEQ, device=CPU)
    with tuning.tuned(remat_policy=policy):
        l1, g1 = _loss_and_grads(cfg, params, batch, remat=True)
    l0, g0 = _loss_and_grads(cfg, params, batch, remat=False)
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


def test_gradients_reach_fp32_masters_through_the_cast():
    """The fault this slice repaired: the bf16 compute tree was cut off
    from the fp32 masters (``ParamTree.map`` read ``.data`` and the cast
    leaves became fresh leaf parameters).  At bf16 compute every master
    now receives an fp32 gradient through its cast leaf."""
    cfg = dataclasses.replace(treduced(TARCHS["phi4-mini-3.8b"]),
                              compute_dtype="bfloat16")
    params = model_zoo.init(cfg, seed=0, device=CPU).requires_grad_(True)
    cast = T.cast_params(cfg, params)
    wq = cast["blocks"][0]["attn0"]["wq"]
    assert wq.dtype == torch.bfloat16 and wq.grad_fn is not None
    assert cast["final_norm"]["w"] is params["final_norm"]["w"]
    batch = model_zoo.dummy_batch(cfg, BATCH, SEQ, device=CPU)
    T.loss_fn(cfg, params, batch).backward()
    for k, p in tree_util.flatten_with_paths(params):
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert bool(torch.isfinite(p.grad).all()), k
    assert float(params["blocks"][0]["attn0"]["wq"].grad.abs().max()) > 0


def test_decode_cast_once_on_trainable_params():
    """The decode step's cast-once cache keeps working on a tree whose
    masters require grad: no graph is built, the cast is reused."""
    cfg = treduced(TARCHS["phi4-mini-3.8b"])
    params = model_zoo.init(cfg, seed=0, device=CPU).requires_grad_(True)
    fn, _ = steps.make_decode_step(cfg, CPU, ShapeConfig("d", 8, 2,
                                                         "decode"))
    state = T.init_decode_state(cfg, params, 2, 8)
    tok = torch.ones((2, 1), dtype=torch.int32)
    logits, state = fn(params, state, tok)
    assert logits.grad_fn is None and not logits.requires_grad
    want, _ = T.decode_step(cfg, params.map(lambda t: t.detach()),
                            T.init_decode_state(cfg, params, 2, 8), tok)
    assert torch.equal(logits, want)


def test_cross_entropy_plain_path_on_cpu():
    """On the CPU the wrapper is the reference's xent (mean of logsumexp
    minus the gold logit) under autograd; no launch is counted."""
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((12, 50)).astype(np.float32),
                          requires_grad=True)
    labels = torch.tensor(rng.integers(0, 50, 12), dtype=torch.int32)
    KX.cross_entropy.launches = 0
    loss = KX.cross_entropy(logits, labels)
    jl = jnp.asarray(logits.detach().numpy())
    want = jnp.mean(jax.nn.logsumexp(jl, -1) - jnp.take_along_axis(
        jl, jnp.asarray(labels.numpy())[:, None], -1)[:, 0])
    assert abs(float(loss.detach()) - float(want)) <= 1e-6
    (g,) = torch.autograd.grad(loss, logits)
    sm = torch.softmax(logits.detach(), -1)
    sm[torch.arange(12), labels.long()] -= 1
    torch.testing.assert_close(g, sm / 12, rtol=1e-5, atol=1e-7)
    assert KX.cross_entropy.launches == 0


# ---------------------------------------------------------------------------
# make_train_step against the reference's, three steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_step_matches_reference(name):
    lr_peak = 1e-3
    cfg = reduced(ARCHS[name])
    mesh = make_mesh((1, 1), ("data", "model"))
    jfn, _ = jsteps.make_train_step(cfg, mesh, JShapeConfig("t", SEQ, BATCH,
                                                            "train"),
                                    JAdamWConfig(), lr_peak=lr_peak,
                                    warmup=1, total_steps=3)
    params = jzoo.init(cfg)
    opt = jinit(params, JAdamWConfig())
    tcfg, tp = _port(name, params)
    to = from_jax_opt_state(tcfg, _np_tree(opt), CPU)
    tfn, spec = steps.make_train_step(tcfg, CPU, ShapeConfig(
        "t", SEQ, BATCH, "train"), AdamWConfig(), lr_peak=lr_peak,
        warmup=1, total_steps=3)
    assert spec["tokens"] == ((BATCH, SEQ), torch.int32)
    assert spec["step"] == ((), torch.int32)
    KA.grad_norm.launches = KA.adamw_step.launches = 0
    # both sides under their launchers' (1, 1) mesh: the MoE archs take
    # moe_ep (shard_map + ragged_dot; the port's grouped GEMM)
    tmesh = train.local_mesh()
    with jmeshctx.use_mesh(mesh, data_axes=("data",)), \
            meshctx.use_mesh(tmesh, data_axes=data_axes_of(tmesh)):
        _three_steps(cfg, tcfg, jfn, tfn, params, opt, tp, to, lr_peak)
    assert KA.grad_norm.launches == KA.adamw_step.launches == 0


def _three_steps(cfg, tcfg, jfn, tfn, params, opt, tp, to, lr_peak):
    for s in range(3):
        b = jmake_batch(cfg, BATCH, SEQ, seed=0, step=s)
        params, opt, m = jfn(params, opt, {k: jnp.asarray(v)
                                           for k, v in b.items()},
                             jnp.int32(s))
        tp, to, tm = tfn(tp, to, {k: torch.from_numpy(v)
                                  for k, v in b.items()}, s)
        assert sorted(tm) == ["grad_norm", "loss", "lr"]
        assert all(v.dim() == 0 and v.dtype == torch.float32
                   for v in tm.values())
        assert abs(float(tm["loss"]) - float(m["loss"])) <= TOL
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(m[key]),
                                       rtol=1e-5, atol=0)
        assert int(to["step"]) == int(opt["step"]) == s + 1
        want = _paths(from_jax_params(tcfg, _np_tree(params), CPU))
        got = _paths(tp)
        assert sorted(got) == sorted(want)
        for k, p in got.items():
            err = float((p.detach() - want[k]).abs().max())
            assert err <= PARAM_TOL_LR * lr_peak, (s, k, err)


# ---------------------------------------------------------------------------
# python -m repro_torch.launch.train
# ---------------------------------------------------------------------------

_ARGS = ["--arch", "mamba2-780m", "--reduced", "--batch", "2", "--seq",
         "16", "--device", "cpu", "--log-every", "1", "--ckpt-every", "3"]
# the reference's formats (src/repro/launch/train.py)
_STEP = re.compile(r"step  {0,4}\d+ loss \d+\.\d{4} lr \d\.\d{2}e[+-]\d{2} "
                   r"gnorm \d+\.\d{3} \d+ ms")
_DONE = re.compile(r"done: \d+ steps, median \d+ ms/step")


def _main(argv, capsys):
    assert train.main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()


def test_train_cli_resume_bit_identical(tmp_path, capsys):
    """6 steps with checkpoints at 3 and 6; then the checkpoint of step 3
    alone in a new directory, resumed to 6: the state and the stream
    position equal the uninterrupted run's, bit for bit."""
    full = str(tmp_path / "full")
    lines = _main(_ARGS + ["--steps", "6", "--ckpt-dir", full], capsys)
    assert [int(line.split()[1]) for line in lines[:-1]] == list(range(6))
    assert all(_STEP.fullmatch(line) for line in lines[:-1]), lines
    assert _DONE.fullmatch(lines[-1]) and lines[-1].startswith("done: 6 ")
    assert sorted(os.listdir(full)) == ["LATEST", "step_0000000003",
                                        "step_0000000006"]
    part = str(tmp_path / "part")
    os.makedirs(part)
    shutil.copytree(os.path.join(full, "step_0000000003"),
                    os.path.join(part, "step_0000000003"))
    lines = _main(_ARGS + ["--steps", "6", "--ckpt-dir", part], capsys)
    assert lines[0] == "[resume] from step 3"
    assert [int(line.split()[1]) for line in lines[1:-1]] == [3, 4, 5]
    assert lines[-1].startswith("done: 3 steps, median ")

    cfg = treduced(TARCHS["mamba2-780m"])
    params = T.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    template = {"params": params, "opt": adamw_init(params)}
    a, meta_a = load_pytree(template, os.path.join(full, "step_0000000006"))
    b, meta_b = load_pytree(template, os.path.join(part, "step_0000000006"))
    assert meta_a == meta_b == {"stream": {"step": 6, "seed": 0},
                                "step": 6}
    for (k, x), (_, y) in zip(tree_util.flatten_with_paths(a),
                              tree_util.flatten_with_paths(b)):
        assert torch.equal(x, y), k
    assert int(a["opt"]["step"]) == 6
    c, meta_c = load_pytree(template, os.path.join(full, "step_0000000003"))
    assert meta_c == {"stream": {"step": 3, "seed": 0}, "step": 3}
    assert int(c["opt"]["step"]) == 3


def test_train_cli_log_format_and_refusals(capsys):
    """The reference's log lines (every ``--log-every`` steps and the
    last); ``--production-mesh`` exits 1 without a 256-rank process
    group, as ``launch.serve`` does; a
    simulated chip loss plans over the one-device mesh as the
    reference's ``plan_remesh`` does there (no survivor: it raises)."""
    lines = _main(_ARGS + ["--steps", "5", "--log-every", "2"], capsys)
    assert [int(line.split()[1]) for line in lines[:-1]] == [0, 2, 4]
    assert all(_STEP.fullmatch(line) for line in lines[:-1]), lines
    assert _DONE.fullmatch(lines[-1])
    assert train.main(_ARGS + ["--steps", "1", "--production-mesh"]) == 1
    out, err = capsys.readouterr()
    assert not out and "--production-mesh" in err and "256 ranks" in err
    with pytest.raises(ValueError, match="cannot host"):
        train.main(_ARGS + ["--steps", "2", "--simulate-loss", "1"])
