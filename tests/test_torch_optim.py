"""The port's optimizer (``repro_torch.optim``) against the JAX
package's, and the port's versions of the optimizer tests of
``tests/test_substrates.py``.

Inputs are numpy draws from a seed, handed to both.  On the CPU the
AdamW kernels run their plain versions.  Tolerances: the update of
params, ``m`` and ``v`` within 2 ulp of the reference's (the same fp32
operations in the same order; the bias corrections' ``b ** t`` and the
norm's sum may round an ulp apart between XLA and PyTorch), the global
norm within 1e-6 relative; ``cosine_warmup`` within 1e-6 relative (its
warmup half bit-exact; XLA's and PyTorch's fp32 ``cos`` differ in the
last ulps, which the decay's ``1 + cos`` magnifies near its end).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import (AdamWConfig as JAdamWConfig,
                         adamw_init as jadamw_init,
                         adamw_update as jadamw_update,
                         cosine_warmup as jcosine_warmup,
                         global_norm as jglobal_norm)

from repro_torch import tree as tree_util
from repro_torch.kernels import adamw as K
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_warmup, global_norm)

torch.set_num_threads(1)

ULPS = 2
NORM_RTOL = 1e-6
CLIP_MV_RTOL, CLIP_P_ATOL = 4 * NORM_RTOL, 1e-4


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 / bfloat16 values on a monotone integer line: the ulp
    distance of two values is the difference of their images."""
    if a.dtype == np.float32:
        i, sign = a.view(np.int32).astype(np.int64), 1 << 31
    else:
        i, sign = a.view(np.int16).astype(np.int64), 1 << 15
    return np.where(i < 0, -(i + sign), i)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ulps(got: torch.Tensor, want) -> int:
    g = _np(got)
    w = np.asarray(want).astype(g.dtype)
    return int(np.abs(_ordered(g) - _ordered(w)).max()) if g.size else 0


def _tree(rng, scale=1.0):
    """A nested tree of float32 arrays of assorted shapes."""
    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": [{"w": a(8, 12), "b": a(12)} for _ in range(2)],
            "embed": a(33, 16), "norm": {"scale": a(16)}, "head": a(5)}


# ---------------------------------------------------------------------------
# cosine_warmup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("peak,warmup,total", [(1e-3, 10, 100),
                                               (3e-4, 2, 6), (3e-4, 5, 50),
                                               (1e-2, 0, 20)])
def test_cosine_warmup_matches_reference(peak, warmup, total):
    want = np.array([jcosine_warmup(s, peak=peak, warmup=warmup,
                                    total=total) for s in range(total + 1)],
                    np.float32)
    got = torch.stack([cosine_warmup(s, peak=peak, warmup=warmup,
                                     total=total)
                       for s in range(total + 1)])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    # the warmup half is the same operations exactly
    w = min(warmup, total + 1)
    np.testing.assert_array_equal(got.numpy()[:w], want[:w])
    # a tensor step (int32, as the train step passes it) gives the same
    st = cosine_warmup(torch.arange(total + 1, dtype=torch.int32),
                       peak=peak, warmup=warmup, total=total)
    np.testing.assert_array_equal(st.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# AdamW against the reference
# ---------------------------------------------------------------------------


def _flat(tree):
    return dict(tree_util.flatten_with_paths(tree))


def _jflat(tree):
    return _flat(jax.tree.map(np.asarray, tree))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0],
                         ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(moment_dtype, grad_scale):
    """Four steps on a random tree.  Each step's leaf arithmetic, from
    the reference's state and with its norm, within 2 ulp of the
    reference's result (params, m and v); the port's own trajectory:
    the global norm within 1e-6 relative, ``step`` counted alike, and
    params, m and v within 2 ulp when no clipping scales the gradients.
    With clipping the norm's last digits (1e-6 relative) scale every
    gradient, and sums in m and v that cancel magnify them: m and v
    within ``CLIP_MV_RTOL`` of each leaf's largest value, params within
    ``CLIP_P_ATOL`` * lr (an update moves a parameter by about lr)."""
    rng = np.random.default_rng(7)
    params = _tree(rng)
    jcfg = JAdamWConfig(moment_dtype=moment_dtype)
    cfg = AdamWConfig(moment_dtype=moment_dtype)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw_init(jp, jcfg)
    tp = tree_util.map_tree(torch.tensor, params)
    tstate = adamw_init(tp, cfg)
    assert tstate["step"].dtype == torch.int32
    assert all(m.dtype == getattr(torch, moment_dtype)
               for m in tree_util.leaves(tstate["m"]))
    hyper = dict(b1=cfg.b1, b2=cfg.b2, eps=cfg.eps,
                 weight_decay=cfg.weight_decay)
    for step, lr in enumerate((1e-3, 5e-4, 2e-3, 1e-4)):
        grads = _tree(rng, grad_scale)
        prev = (_jflat(jp), _jflat(jstate["m"]), _jflat(jstate["v"]))
        jp, jstate, jm = jadamw_update(jax.tree.map(jnp.asarray, grads),
                                       jstate, jp, jnp.float32(lr), jcfg)
        tp, tstate, tm = adamw_update(
            tree_util.map_tree(torch.tensor, grads), tstate, tp,
            torch.tensor(lr, dtype=torch.float32), cfg)
        gn = float(jm["grad_norm"])
        assert abs(float(tm["grad_norm"]) - gn) <= NORM_RTOL * gn
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        after = (_jflat(jp), _jflat(jstate["m"]), _jflat(jstate["v"]))
        # the leaf arithmetic, from the reference's state and norm
        scalars = K.adamw_scalars(
            torch.tensor(gn, dtype=torch.float32), lr,
            torch.tensor(step + 1, dtype=torch.int32), b1=cfg.b1,
            b2=cfg.b2, clip_norm=cfg.clip_norm)
        g = _flat(grads)
        for k in g:
            out = K.adamw_leaf_ref(*(_to_torch(t[k]) for t in prev[:1]),
                                   torch.from_numpy(g[k]),
                                   *(_to_torch(t[k]) for t in prev[1:]),
                                   scalars, **hyper)
            for name, got, want in zip("pmv", out, after):
                assert _ulps(got, want[k]) <= ULPS, (step, name, k)
        # the port's own trajectory
        clipped = gn > cfg.clip_norm
        for name, got, want in zip("pmv", (_flat(tp), _flat(tstate["m"]),
                                           _flat(tstate["v"])), after):
            assert sorted(got) == sorted(want)
            for k in got:
                if not clipped:
                    assert _ulps(got[k], want[k]) <= ULPS, (step, name, k)
                    continue
                w = np.asarray(want[k], np.float32)
                atol = (CLIP_P_ATOL * lr if name == "p"
                        else CLIP_MV_RTOL * float(np.abs(w).max()))
                np.testing.assert_allclose(got[k].float().numpy(), w,
                                           rtol=0, atol=atol,
                                           err_msg=f"{step} {name} {k}")


def test_adamw_update_in_place_and_shared_scalars():
    """The port updates the leaves in place (the same tensors come
    back) and the plain leaf update reads the scalars vector the kernel
    reads."""
    rng = np.random.default_rng(3)
    tp = tree_util.map_tree(torch.tensor, _tree(rng))
    before = [p.clone() for p in tree_util.leaves(tp)]
    state = adamw_init(tp)
    ids = [id(p) for p in tree_util.leaves(tp)]
    grads = tree_util.map_tree(torch.tensor, _tree(rng))
    out, state, m = adamw_update(grads, state, tp, 1e-3)
    assert [id(p) for p in tree_util.leaves(out)] == ids
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_util.leaves(out)))
    gl = tree_util.leaves(grads)
    gnorm = K.grad_norm(gl)
    np.testing.assert_array_equal(gnorm.numpy(), m["grad_norm"].numpy())
    s = K.adamw_scalars(gnorm, 1e-3, torch.tensor(1, dtype=torch.int32),
                        b1=0.9, b2=0.95, clip_norm=1.0)
    assert s.shape == (4,) and s.dtype == torch.float32
    assert float(s[2]) == pytest.approx(0.1) and \
        float(s[3]) == pytest.approx(0.05)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(11)
    t = _tree(rng, 3.0)
    want = float(jglobal_norm(jax.tree.map(jnp.asarray, t)))
    got = global_norm(tree_util.map_tree(torch.tensor, t))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= NORM_RTOL * want


# ---------------------------------------------------------------------------
# The port's versions of tests/test_substrates.py:31-68
# ---------------------------------------------------------------------------


def test_adamw_reduces_quadratic_loss():
    params = {"w": torch.tensor([3.0, -2.0], requires_grad=True),
              "b": torch.tensor(1.5, requires_grad=True)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    cfg = AdamWConfig(weight_decay=0.0)
    state = adamw_init(params, cfg)
    l0 = float(loss(params).detach())
    m = None
    for _ in range(200):
        leaves = tree_util.leaves(params)
        g = tree_util.unflatten(params,
                                torch.autograd.grad(loss(params), leaves))
        params, state, m = adamw_update(g, state, params,
                                        torch.tensor(0.05), cfg)
    assert float(loss(params).detach()) < 1e-2 * l0
    assert np.isfinite(float(m["grad_norm"]))


def test_adamw_clip_and_bf16_moments():
    params = {"w": torch.ones((4,))}
    cfg = AdamWConfig(clip_norm=0.5, moment_dtype="bfloat16")
    state = adamw_init(params, cfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    g = {"w": torch.full((4,), 100.0)}
    _, state, m = adamw_update(g, state, params, torch.tensor(0.1), cfg)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_cosine_warmup_shape():
    lr0 = float(cosine_warmup(0, peak=1e-3, warmup=10, total=100))
    lrw = float(cosine_warmup(10, peak=1e-3, warmup=10, total=100))
    lre = float(cosine_warmup(100, peak=1e-3, warmup=10, total=100))
    assert lr0 == 0.0 and lrw == pytest.approx(1e-3)
    assert lre == pytest.approx(1e-4, rel=1e-3)


def test_kernel_wrappers_take_the_plain_path_on_cpu():
    """CPU tensors never reach a kernel: no launch is counted."""
    K.grad_norm.launches = 0
    K.adamw_step.launches = 0
    rng = np.random.default_rng(5)
    tp = tree_util.map_tree(torch.tensor, _tree(rng))
    state = adamw_init(tp)
    adamw_update(tree_util.map_tree(torch.tensor, _tree(rng)), state,
                 tp, 1e-3)
    assert K.grad_norm.launches == 0 and K.adamw_step.launches == 0


def test_dense_gives_the_kernels_their_layout():
    """Autograd can hand back a permuted gradient (an einsum's over a
    3-D expert weight) or one that starts inside a larger buffer: the
    CUDA path copies those to contiguous tensors on 16-byte boundaries
    before its kernels run; a gradient already so is passed as is."""
    g = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    assert K.dense(g) is g
    for view in (g.permute(0, 2, 1), g.reshape(-1)[1:97].reshape(12, 8)):
        out = K.dense(view)
        assert out.is_contiguous() and out.data_ptr() % 16 == 0
        assert torch.equal(out, view)
