"""The port's expert-parallel MoE (``repro_torch.models.moe_ep``) and its
grouped expert GEMM (``repro_torch.kernels.grouped_gemm``) against the
JAX package's ``moe_ep`` and ``lax.ragged_dot``.

Parameters come from ``repro.models.model_zoo.init`` and cross to the
port with ``convert.from_jax_params``; inputs and cotangents are numpy
draws from a seed.  On the CPU ``ragged_dot`` runs its plain versions
(a loop of matmuls over the groups) under its autograd function.
Tolerances, fp32 throughout (the two frameworks sum in other orders):

* ``ragged_dot`` and its two backward products within ``RD_TOL`` (1e-5)
  of each output's largest magnitude; rows past the groups' sum and the
  ``dw`` of an empty group exactly 0;
* ``moe_apply`` (output, aux and the gradient of every parameter and of
  ``x``) within ``TOL`` (2e-5) of each leaf's largest reference magnitude
  (largest seen: about 1e-6), at tp 1 under the launchers' local mesh
  and at tp 2 over a gloo process group of 2 ranks, on (1, 2) and
  (2, 1) meshes, the JAX side in a subprocess with 2 host devices;
* at capacity factor 4.0 nothing drops, so tp 2 equals tp 1 within
  ``TOL`` as well (output, and on (1, 2) every gradient; on (2, 1) the
  aux loss is the mean of two batch halves' and differs by definition);
  at 0.5 tokens drop (even at tp 1).
"""

import dataclasses
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

from repro.configs import ARCHS, reduced
from repro.launch import meshctx as jmeshctx
from repro.launch.mesh import make_mesh as jmake_mesh
from repro.models import analysis_flags as janalysis
from repro.models import layers as JL
from repro.models import model_zoo as jzoo

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import grouped_gemm as GG
from repro_torch.launch import meshctx
from repro_torch.launch.mesh import (LocalMesh, data_axes_of, make_mesh,
                                     make_production_mesh)
from repro_torch.models import analysis_flags, layers as L

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
RD_TOL = 1e-5
TOL = 2e-5
CAUX = 0.37                  # the aux loss's weight in the test's loss
ARCHS_MOE = ["olmoe-1b-7b", "deepseek-v3-671b", "jamba-1.5-large-398b"]
CFS = (1.25, 0.5)
TP2_CFS = (0.5, 4.0)
TP2_MESHES = ((1, 2), (2, 1))
B, S = 4, 6
TIMEOUT = 240                # s, each subprocess


def _close(got, want, tol, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# ragged_dot against lax.ragged_dot
# ---------------------------------------------------------------------------

RD_CASES = [
    # (M, K, N, group sizes): zeros among the groups and rows past the sum
    (24, 12, 10, [5, 0, 7, 0, 6]),
    (16, 8, 8, [0, 16, 0]),                 # every row in one group
    (20, 7, 9, [3, 4, 2, 0, 11]),           # sum == M, K and N odd
    (33, 16, 24, "random"),
]


@pytest.mark.parametrize("case", range(len(RD_CASES)))
def test_ragged_dot_matches_lax(case):
    m, k, n, sizes = RD_CASES[case]
    rng = np.random.default_rng(case)
    if sizes == "random":
        sizes = list(rng.multinomial(m - 5, np.ones(7) / 7))
        sizes[2] = 0
        sizes[-1] += sizes[2]
    g = len(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((g, k, n)).astype(np.float32)
    gs = np.asarray(sizes, np.int32)
    cot = rng.standard_normal((m, n)).astype(np.float32)

    def f(x_, w_):
        return jnp.sum(jax.lax.ragged_dot(x_, w_, jnp.asarray(gs)) * cot)

    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(gs)))
    wgx, wgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tgs = torch.from_numpy(gs)
    GG.ragged_dot.launches = 0
    got = GG.ragged_dot(tx, tw, tgs)
    _close(got.detach(), want, RD_TOL, "y")
    end = int(gs.sum())
    assert bool((got[end:] == 0).all())
    gx, gw = torch.autograd.grad((got * torch.from_numpy(cot)).sum(),
                                 (tx, tw))
    _close(gx, wgx, RD_TOL, "dx")
    _close(gw, wgw, RD_TOL, "dw")
    assert bool((gx[end:] == 0).all())
    for e in np.flatnonzero(gs == 0):
        assert bool((gw[e] == 0).all()), e       # an empty group's dw
    # the plain versions of the backward products, directly
    tcot = torch.from_numpy(cot)
    _close(GG.ragged_dot_dx_ref(tcot, tw.detach(), tgs), wgx, RD_TOL)
    _close(GG.ragged_dot_dw_ref(tx.detach(), tcot, tgs), wgw, RD_TOL)
    assert GG.ragged_dot.launches == 0           # CPU: no kernel


def test_ragged_dot_refusals():
    x = torch.zeros(4, 3)
    w = torch.zeros(2, 3, 5)
    gs = torch.tensor([2, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match="no grouped-GEMM kernel"):
        GG.ragged_dot_cuda(GG.FWD, x, w, gs)
    with pytest.raises(ValueError):
        GG.ragged_dot(x, torch.zeros(2, 4, 5), gs)
    with pytest.raises(ValueError):
        GG.ragged_dot(x, w, torch.tensor([4], dtype=torch.int32))
    with pytest.raises(TypeError):
        GG.ragged_dot(x, w.double(), gs)
    with pytest.raises(TypeError):
        GG.ragged_dot(x, w, gs.float())
    # a float sum past M is cut at M (sizes 3 + 3 over 4 rows)
    over = GG.ragged_dot_ref(torch.ones(4, 3), torch.ones(2, 3, 5),
                             torch.tensor([3, 3]))
    assert over.shape == (4, 5) and bool((over == 3).all())


def test_kernel_grid_covers_every_tile():
    """The kernel's grid has ceil(M / BM) + G row-tile slots: enough for
    every group's tiles and the tiles that zero the rows past the sum."""
    rng = np.random.default_rng(0)
    bm = GG.BM
    for _ in range(200):
        g = int(rng.integers(1, 70))
        m = int(rng.integers(1, 5 * bm))
        sizes = rng.multinomial(int(rng.integers(0, m + 1)),
                                np.ones(g) / g)
        tiles = sum(-(-int(n) // bm) for n in sizes)
        tail = -(-(m - int(sizes.sum())) // bm)
        assert tiles + tail <= -(-m // bm) + g


# ---------------------------------------------------------------------------
# moe_apply under the local mesh against the reference's, tp 1
# ---------------------------------------------------------------------------


def _cfgs(name, cf):
    cfg = reduced(ARCHS[name])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))
    tcfg = treduced(TARCHS[name])
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    return cfg, tcfg


def _flat(tree, prefix=""):
    out = {}
    for k in tree.keys():
        v = tree[k]
        if hasattr(v, "keys"):
            out.update(_flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split(".")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return tree


@pytest.fixture(scope="module")
def moe_params():
    """Per arch: the reference's block-0 MoE parameters (numpy, flat) and
    the port's, through ``convert.from_jax_params``; with x and the
    output's cotangent."""
    out = {}
    rng = np.random.default_rng(7)
    for name in ARCHS_MOE:
        cfg = reduced(ARCHS[name])
        params = jax.tree.map(np.asarray, jzoo.init(cfg))
        tparams = from_jax_params(treduced(TARCHS[name]), params, "cpu")
        jflat = {k: np.asarray(v[0]) for k, v in
                 _flat(params["blocks"]["moe0"]).items()}
        tflat = _flat(tparams["blocks"][0]["moe0"])
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:                      # convert carries them over
            assert np.array_equal(tflat[k].detach().numpy(), jflat[k]), k
        x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        cot = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        out[name] = (jflat, x, cot)
    return out


def _jax_moe(cfg, jflat, x, cot, shape=(1, 1)):
    mesh = jmake_mesh(shape, ("data", "model"))

    def f(p, x_):
        with jmeshctx.use_mesh(mesh, data_axes=("data",)):
            o, a = JL.moe_apply(cfg, p, x_)
        return jnp.sum(o * cot) + CAUX * a, (o, a)

    p = jax.tree.map(jnp.asarray, _unflat(jflat))
    (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    return (np.asarray(o), float(a),
            {k: np.asarray(v) for k, v in _flat(gp).items()},
            np.asarray(gx))


def _torch_moe(tcfg, jflat, x, cot, mesh=None):
    p = {k: torch.from_numpy(v.copy()).requires_grad_(True)
         for k, v in jflat.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    mesh = mesh or make_mesh((1, 1), ("data", "model"))
    with meshctx.use_mesh(mesh, data_axes=data_axes_of(mesh)):
        o, a = L.moe_apply(tcfg, _unflat(p), tx)
    loss = (o * torch.from_numpy(cot)).sum() + CAUX * a
    keys = sorted(p)
    grads = torch.autograd.grad(loss, [p[k] for k in keys] + [tx])
    return (o.detach().numpy(), float(a.detach()),
            dict(zip(keys, (g.numpy() for g in grads[:-1]))),
            grads[-1].numpy())


def _same(got, want, what):
    o, a, gp, gx = got
    wo, wa, wgp, wgx = want
    _close(o, wo, TOL, f"{what} out")
    _close(a, wa, TOL, f"{what} aux")
    _close(gx, wgx, TOL, f"{what} dx")
    assert sorted(gp) == sorted(wgp)
    for k in gp:
        _close(gp[k], wgp[k], TOL, f"{what} d{k}")


@pytest.mark.parametrize("cf", CFS)
@pytest.mark.parametrize("name", ARCHS_MOE)
def test_moe_apply_local_mesh_matches_reference(moe_params, name, cf):
    """olmoe (softmax router, 4 experts top 2), deepseek-v3 (sigmoid
    router, a shared expert) and jamba (the MoE of its Mamba-2 hybrid),
    reduced: the port's ``moe_apply`` under the local (1, 1) mesh (the
    grouped GEMM's plain versions) against the reference's ``shard_map``
    path under its (1, 1) mesh, output, aux and every gradient.  At
    capacity factor 0.5 tokens drop at tp 1, and the dense path (no
    mesh) differs."""
    cfg, tcfg = _cfgs(name, cf)
    jflat, x, cot = moe_params[name]
    want = _jax_moe(cfg, jflat, x, cot)
    got = _torch_moe(tcfg, jflat, x, cot)
    _same(got, want, f"{name} cf {cf}")
    dense, _ = L.moe_apply(tcfg, _unflat({k: torch.from_numpy(v.copy())
                                          for k, v in jflat.items()}),
                           torch.from_numpy(x.copy()))
    gap = float(np.abs(dense.numpy() - got[0]).max())
    if cf < 1:
        assert gap > 1e-2, gap               # dropped tokens show
    else:
        assert gap <= TOL * float(np.abs(got[0]).max()), gap


def test_balanced_moe_flag_matches_reference(moe_params):
    """The cost-probe ``balanced_moe`` branch (equal-capacity batched
    matmuls) on both sides."""
    name = "olmoe-1b-7b"
    cfg, tcfg = _cfgs(name, 1.25)
    jflat, x, cot = moe_params[name]
    janalysis.FLAGS["balanced_moe"] = True
    analysis_flags.FLAGS["balanced_moe"] = True
    try:
        GG.ragged_dot.launches = 0
        want = _jax_moe(cfg, jflat, x, cot)
        got = _torch_moe(tcfg, jflat, x, cot)
    finally:
        janalysis.FLAGS["balanced_moe"] = False
        analysis_flags.FLAGS["balanced_moe"] = False
    _same(got, want, "balanced")


def test_local_mesh_and_refusals():
    mesh = make_mesh((1, 1), ("data", "model"))
    assert isinstance(mesh, LocalMesh) and mesh.shape == (1, 1)
    assert data_axes_of(mesh) == ("data",)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(RuntimeError, match="exactly 256 ranks"):
        make_production_mesh()
    cfg = treduced(TARCHS["olmoe-1b-7b"])
    x = torch.zeros(1, 2, cfg.d_model)
    with meshctx.use_mesh(object()):
        with pytest.raises(TypeError, match="not a mesh"):
            L.moe_apply(cfg, {}, x)


def test_launchers_take_moe_ep(monkeypatch, capsys):
    """``launch.train`` and ``launch.serve`` enter the local mesh, as the
    reference's launchers do, so an MoE arch runs ``moe_ep`` (one call
    an MoE layer a forward); without a mesh context the dense dispatch
    runs and ``moe_ep`` is not called."""
    from repro_torch.launch import serve, train
    from repro_torch.models import moe_ep
    calls = []
    real = moe_ep.moe_ep_apply_local

    def counted(*a, **kw):
        calls.append(meshctx.current().mesh)
        return real(*a, **kw)

    monkeypatch.setattr(moe_ep, "moe_ep_apply_local", counted)
    assert train.main(["--arch", "olmoe-1b-7b", "--reduced", "--steps", "1",
                       "--batch", "2", "--seq", "8", "--device", "cpu"]) == 0
    n_train = len(calls)
    assert n_train >= 1
    assert serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                       "cpu", "--batch", "1", "--prompt-len", "2", "--gen",
                       "2"]) == 0
    assert len(calls) > n_train
    assert all(isinstance(m, LocalMesh) for m in calls)
    capsys.readouterr()
    cfg = treduced(TARCHS["olmoe-1b-7b"])
    p = {k: torch.zeros(v) for k, v in (("router", (cfg.d_model, 4)),
                                        ("wi", (4, cfg.d_model, 8)),
                                        ("wg", (4, cfg.d_model, 8)),
                                        ("wo", (4, 8, cfg.d_model)))}
    before = len(calls)
    L.moe_apply(cfg, p, torch.zeros(1, 2, cfg.d_model))
    assert len(calls) == before


# ---------------------------------------------------------------------------
# tp 2 over gloo against the reference's shard_map over 2 host devices
# ---------------------------------------------------------------------------

_JAX_TP2 = textwrap.dedent(r"""
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    assert len(jax.devices()) == 2, jax.devices()
    from repro.configs import ARCHS, reduced
    from repro.launch import meshctx
    from repro.launch.mesh import make_mesh
    from repro.models import layers as JL
    inp, outp, caux = sys.argv[1], sys.argv[2], float(sys.argv[3])
    data = np.load(inp)
    res = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        name, cf, sh = case.split("|")
        shape = tuple(int(v) for v in sh.split("x"))
        cfg = reduced(ARCHS[name])
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
        flat = {k.split("/", 2)[2]: data[k] for k in data.files
                if k.startswith(case + "/p/")}
        p = {}
        for k, v in flat.items():
            node = p
            *head, last = k.split(".")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        x, cot = data[case + "/x"], data[case + "/cot"]
        mesh = make_mesh(shape, ("data", "model"))

        def f(p, x_):
            with meshctx.use_mesh(mesh, data_axes=("data",)):
                o, a = JL.moe_apply(cfg, p, x_)
            return jnp.sum(o * cot) + caux * a, (o, a)

        (_, (o, a)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
        res[case + "/out"] = np.asarray(o)
        res[case + "/aux"] = np.asarray(a)
        res[case + "/dx"] = np.asarray(gx)
        for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]:
            key = ".".join(str(q.key) for q in path)
            res[case + "/dp/" + key] = np.asarray(v)
    np.savez(outp, **res)
""")

_TORCH_TP2 = textwrap.dedent(r"""
    import dataclasses, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.modules["jax"] = None
    torch.set_num_threads(1)
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import meshctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init, inp, outp, caux = sys.argv[3], sys.argv[4], sys.argv[5], \
        float(sys.argv[6])
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    data = np.load(inp)
    meshes = {}
    res = {}
    for case in sorted({k.split("/")[0] for k in data.files}):
        name, cf, sh = case.split("|")
        shape = tuple(int(v) for v in sh.split("x"))
        if shape not in meshes:
            meshes[shape] = make_mesh(shape, ("data", "model"))
        mesh = meshes[shape]
        cfg = reduced(ARCHS[name])
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cf)))
        flat = {k.split("/", 2)[2]: torch.from_numpy(data[k].copy())
                .requires_grad_(True) for k in data.files
                if k.startswith(case + "/p/")}
        p = {}
        for k, v in flat.items():
            node = p
            *head, last = k.split(".")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = v
        dr = mesh.get_local_rank("data")
        n_data = shape[0]
        x, cot = data[case + "/x"], data[case + "/cot"]
        rows = x.shape[0] // n_data
        x = torch.from_numpy(x[dr * rows:(dr + 1) * rows].copy()) \
            .requires_grad_(True)
        cot = torch.from_numpy(cot[dr * rows:(dr + 1) * rows].copy())
        with meshctx.use_mesh(mesh, data_axes=("data",)):
            o, a = L.moe_apply(cfg, p, x)
        keys = sorted(flat)
        grads = torch.autograd.grad((o * cot).sum() + caux * a,
                                    [flat[k] for k in keys] + [x])
        res[case + "/out"] = o.detach().numpy()
        res[case + "/aux"] = a.detach().numpy()
        res[case + "/dx"] = grads[-1].numpy()
        for k, g in zip(keys, grads[:-1]):
            res[case + "/dp/" + k] = g.numpy()
    np.savez(outp, **res)
    dist.destroy_process_group()
""")


def _run_all(procs):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se[-4000:]


@pytest.fixture(scope="module")
def tp2(moe_params, tmp_path_factory):
    """Every tp-2 case run once: the reference in one subprocess (2 host
    devices), the port in one 2-rank gloo group; and the port at tp 1."""
    tmp = tmp_path_factory.mktemp("moe_tp2")
    inputs = {}
    for name in ARCHS_MOE:
        jflat, x, cot = moe_params[name]
        for cf in TP2_CFS:
            for shape in TP2_MESHES:
                case = f"{name}|{cf}|{shape[0]}x{shape[1]}"
                inputs[case + "/x"] = x
                inputs[case + "/cot"] = cot
                for k, v in jflat.items():
                    inputs[case + "/p/" + k] = v
    inp = tmp / "inputs.npz"
    np.savez(inp, **inputs)
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               OMP_NUM_THREADS="1")
    jout = tmp / "jax.npz"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_TP2, str(inp), str(jout), str(CAUX)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    init = f"file://{tmp / 'pg_init'}"
    touts = [tmp / f"torch{r}.npz" for r in range(2)]
    procs += [subprocess.Popen(
        [sys.executable, "-c", _TORCH_TP2, str(r), "2", init, str(inp),
         str(touts[r]), str(CAUX)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    _run_all(procs)
    tp1 = {}
    for name in ARCHS_MOE:
        jflat, x, cot = moe_params[name]
        _, tcfg = _cfgs(name, 4.0)
        tp1[name] = _torch_moe(tcfg, jflat, x, cot)
    return (dict(np.load(jout)), [dict(np.load(t)) for t in touts], tp1)


@pytest.mark.parametrize("shape", TP2_MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("cf", TP2_CFS)
@pytest.mark.parametrize("name", ARCHS_MOE)
def test_moe_tp2_gloo_matches_reference(tp2, name, cf, shape):
    """Two ranks: on (1, 2) each holds 2 of the 4 experts and all of x;
    on (2, 1) each holds half the batch and every expert.  Each rank's
    output and x gradient equal the reference's rows; the aux loss equals
    it on every rank; the parameter gradients summed over the ranks (a
    data-parallel step's all-reduce; a model rank's expert gradient is
    zero outside its slice) equal the reference's, and on (1, 2) every
    rank's router and shared-expert gradients equal it whole."""
    jres, tres, tp1 = tp2
    case = f"{name}|{cf}|{shape[0]}x{shape[1]}"
    rows = B // shape[0]
    for r, res in enumerate(tres):
        dr = r if shape[0] == 2 else 0
        sl = slice(dr * rows, (dr + 1) * rows)
        _close(res[case + "/out"], jres[case + "/out"][sl], TOL,
               f"{case} rank {r} out")
        _close(res[case + "/dx"], jres[case + "/dx"][sl], TOL,
               f"{case} rank {r} dx")
        _close(res[case + "/aux"], jres[case + "/aux"], TOL, "aux")
    keys = sorted(k for k in jres if k.startswith(case + "/dp/"))
    assert keys == sorted(k for k in tres[0] if k.startswith(case + "/dp/"))
    o1, _, gp1, _ = tp1[name]
    for k in keys:
        leaf = k.split("/")[-1]
        if shape == (1, 2) and (leaf == "router"
                                or leaf.startswith("shared.")):
            for res in tres:               # replicated: whole on each rank
                _close(res[k], jres[k], TOL, f"{k} on each rank")
            got = tres[0][k]
        else:
            got = tres[0][k] + tres[1][k]
            _close(got, jres[k], TOL, k)
        if cf == 4.0 and shape == (1, 2):
            # (2, 1) is tp 1 with the aux loss averaged over two batch
            # halves, another function of the router
            _close(got, gp1[leaf], TOL, f"{k} against tp 1")
    if cf == 4.0:
        # nothing drops: tp 2 == tp 1
        full = np.concatenate([tres[r][case + "/out"] for r in range(2)]) \
            if shape[0] == 2 else tres[0][case + "/out"]
        _close(full, o1, TOL, "out against tp 1")
