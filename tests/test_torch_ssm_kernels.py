"""Mamba-2's causal conv front and gated output norm: the Triton
kernels' plain versions, autograd wiring and contracts, on the CPU.

:func:`causal_conv_silu_ref` and :func:`gated_norm_ref` are the
reference's arithmetic (``repro.models.ssm._causal_conv`` and the tail
of ``ssm_apply``, ssm.py:140-143), held to it on the same inputs: the
port's conv reads a strided view of one ``in_proj`` row where the
reference concatenates ``x``, ``B`` and ``C``.  The backward kernels'
algorithms (:func:`causal_conv_silu_bwd_ref`, :func:`gated_norm_bwd_ref`,
plain fp32 tensor code) are held to autograd of the plain forwards and
to ``jax.vjp`` of the reference's functions.  The autograd Functions run
on CPU tensors with their CUDA entry points patched to the plain
versions; on the CPU and ``meta`` the wrappers and the layer never
reach the kernels.  Inputs are numpy draws from a seed, in float32
unless said.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels import causal_conv as CC, gated_norm as GN
from repro_torch.kernels import triton_source
from repro_torch.models import ssm as S

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
# the plain versions against the reference (fp32): the same operations,
# but jax's silu is x * sigmoid(x) and torch's x / (1 + exp(-x)): an ulp
# apart; the norm's mean sums in another order
REF_TOL = dict(rtol=1e-5, atol=1e-6)
# at bf16 XLA's and PyTorch's silu round one ulp apart in about a third
# of the elements (ROADMAP section 3); the gate rounds that silu and its
# product with y, then the norm's output: up to 2 ulps apart, 2^-6
# relative (the largest gap seen: 0.03125 on an output near 2)
REF_TOL_BF16 = dict(rtol=2.0 ** -6, atol=2.0 ** -7)
# the port's layer against repro's (fp32), as tests/test_torch_models.py
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
# the plain backwards against autograd of the plain forwards (fp32): the
# same terms in another order; relative to each gradient's largest
# magnitude (dw's and dD's are sums over every row)
BWD_RTOL = 2e-5
K = 4


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _proj_row(rng, b, s, d_in, conv):
    """One ``in_proj`` output row (B, S, 2 d_in + 2 g N + nh) as numpy:
    z, the conv's columns and dt's, as the layer splits it."""
    return _draw(rng, b, s, 2 * d_in + conv + 3)


def _conv_inputs(seed, b, s, c, dtype=torch.float32):
    """The conv's input as a strided view of one ``in_proj`` row (torch)
    and as the reference's contiguous array (numpy), w (K, C), bias
    (C,): normal draws rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    d_in = 8
    row = torch.from_numpy(_proj_row(rng, b, s, d_in, c)).to(dtype)
    x = row[..., d_in:d_in + c]
    w = torch.from_numpy(_draw(rng, K, c, scale=0.5)).to(dtype)
    bias = torch.from_numpy(_draw(rng, c, scale=0.1)).to(dtype)
    return x, w, bias, _draw(rng, b, s, c)


def _np(t):
    return t.detach().float().numpy()


def _jx(t, dtype):
    """A torch tensor's values as a JAX array of ``dtype`` (exact: the
    values are already ``dtype``'s)."""
    return jnp.asarray(_np(t)).astype(dtype)


CONV_SHAPES = [(2, 1, 6), (2, 2, 6), (1, 3, 7), (2, 17, 37), (3, 40, 16)]
CONV_IDS = ["S 1", "S < K - 1", "S = K - 1", "odd C", "3 sequences"]


@pytest.mark.parametrize("b,s,c", CONV_SHAPES, ids=CONV_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv_ref_matches_reference(b, s, c, dtype):
    """``causal_conv_silu_ref`` on a strided view of one ``in_proj`` row
    == ``repro``'s ``_causal_conv`` on the same values concatenated
    (fp32: REF_TOL; bf16: REF_TOL_BF16)."""
    tdt = getattr(torch, dtype)
    x, w, bias, _ = _conv_inputs(1, b, s, c, tdt)
    assert not x.is_contiguous()
    got = CC.causal_conv_silu_ref(x, w, bias)
    assert got.dtype == tdt and got.shape == x.shape
    jdt = getattr(jnp, dtype)
    want = JS._causal_conv(_jx(x, jdt), _jx(w, jdt), _jx(bias, jdt))
    tol = REF_TOL if dtype == "float32" else REF_TOL_BF16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("seed", [1, 5])
@pytest.mark.parametrize("b,s,c", CONV_SHAPES, ids=CONV_IDS)
def test_conv_pre_chain_is_the_references_bits(monkeypatch, b, s, c, seed):
    """At bf16 ``causal_conv_pre_ref`` (the chain the kernels and their
    backward compute) == the pre-activation of ``repro``'s
    ``_causal_conv`` (its SiLU made the identity), bit for bit: every
    tap's product and partial sum rounded in the reference's order, the
    bias last."""
    x, w, bias, _ = _conv_inputs(seed, b, s, c, torch.bfloat16)
    got = CC.causal_conv_pre_ref(x, w, bias)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    monkeypatch.setattr(jax.nn, "silu", lambda v: v)
    want = JS._causal_conv(*(_jx(t, jnp.bfloat16) for t in (x, w, bias)))
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))


def _bf16_bits(a):
    """fp32 ``a`` rounded to bf16 (to nearest even) on its bits, as the
    conv kernel's ``_round`` rounds, back in fp32."""
    u = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("b,s,c", CONV_SHAPES, ids=CONV_IDS)
def test_conv_kernel_chain_model(b, s, c):
    """A numpy model of the conv kernel's bf16 ``_pre`` (fp32 products of
    bf16 values, each product and partial sum rounded on its bits, the
    bias last) == ``causal_conv_pre_ref`` bit for bit."""
    x, w, bias, _ = _conv_inputs(9, b, s, c, torch.bfloat16)
    xs, ws, bs = _np(x), _np(w), _np(bias)
    xp = np.concatenate([np.zeros((b, K - 1, c), np.float32), xs], 1)
    acc = _bf16_bits(xp[:, 0:s] * ws[0])
    for i in range(1, K):
        acc = _bf16_bits(acc + _bf16_bits(xp[:, i:i + s] * ws[i]))
    acc = _bf16_bits(acc + bs)
    np.testing.assert_array_equal(acc, _np(CC.causal_conv_pre_ref(x, w,
                                                                   bias)))


@pytest.mark.parametrize("b,s,c", CONV_SHAPES, ids=CONV_IDS)
def test_conv_bwd_ref_matches_autograd_and_vjp(b, s, c):
    """``causal_conv_silu_bwd_ref``'s dx, dw, db == autograd of
    ``causal_conv_silu_ref`` and ``jax.vjp`` of ``_causal_conv`` (fp32,
    BWD_RTOL of each gradient's largest magnitude)."""
    x, w, bias, dy = _conv_inputs(2, b, s, c)
    dy = torch.from_numpy(dy)
    got = CC.causal_conv_silu_bwd_ref(dy, x, w, bias)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    CC.causal_conv_silu_ref(*leaves).backward(dy)
    _, vjp = jax.vjp(JS._causal_conv, *(jnp.asarray(_np(t))
                                        for t in (x, w, bias)))
    for name, g, leaf, jg in zip(("dx", "dw", "db"), got, leaves,
                                 vjp(jnp.asarray(dy.numpy()))):
        assert g.dtype == torch.float32 and g.shape == leaf.shape, name
        want = leaf.grad.numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(g), want, rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=name)
        np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=name)


def test_conv_bwd_ref_bf16():
    """At bf16 inputs ``causal_conv_silu_bwd_ref`` returns dx, dw, db in
    bf16, within one rounding (2^-8 of each gradient's largest
    magnitude) of autograd of the plain forward on fp32 upcasts."""
    x, w, bias, dy = _conv_inputs(3, 2, 24, 37, torch.bfloat16)
    dy = torch.from_numpy(dy).bfloat16()
    got = CC.causal_conv_silu_bwd_ref(dy, x, w, bias)
    leaves = [t.float().clone().requires_grad_() for t in (x, w, bias)]
    CC.causal_conv_silu_ref(*leaves).backward(dy.float())
    for name, g, leaf in zip(("dx", "dw", "db"), got, leaves):
        assert g.dtype == torch.bfloat16, name
        scale = float(leaf.grad.abs().max())
        np.testing.assert_allclose(_np(g), leaf.grad.numpy(),
                                   rtol=2.0 ** -8, atol=2.0 ** -8 * scale,
                                   err_msg=name)


def _gate_inputs(seed, b, s, heads, hp, dtype=torch.float32, skip=True):
    """y (the scan's output), x (a view of one conv row), z (a view of one
    ``in_proj`` row), D (heads,) fp32 and w (d,): normal draws rounded to
    ``dtype`` (D and w near 1, as the layer initialises them)."""
    rng = np.random.default_rng(seed)
    d = heads * hp
    y = torch.from_numpy(_draw(rng, b, s, d)).to(dtype)
    conv = torch.from_numpy(_draw(rng, b, s, d + 6)).to(dtype)
    row = torch.from_numpy(_proj_row(rng, b, s, d, d + 6)).to(dtype)
    x, z = conv[..., :d], row[..., :d]
    D = torch.from_numpy(1.0 + _draw(rng, heads, scale=0.3))
    w = torch.from_numpy(1.0 + _draw(rng, d, scale=0.2)).to(dtype)
    dout = torch.from_numpy(_draw(rng, b, s, d)).to(dtype)
    return y, z, w, (x, D) if skip else (None, None), dout


def _ref_gate(y, z, w, x, D, heads):
    """The reference's lines (ssm.py:140-143) on (B, S, d) arrays."""
    b, s, d = y.shape
    if x is not None:
        y = (y.reshape(b, s, heads, d // heads)
             + x.reshape(b, s, heads, d // heads)
             * D[..., None].astype(y.dtype)).reshape(b, s, d)
    return JL.rmsnorm(y * jax.nn.silu(z), w)


GATE_SHAPES = [(2, 8, 4, 16, True), (1, 1, 3, 8, True), (2, 5, 4, 16, False)]
GATE_IDS = ["skip", "S 1, 3 heads", "no skip"]


@pytest.mark.parametrize("b,s,heads,hp,skip", GATE_SHAPES, ids=GATE_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gate_ref_matches_reference(b, s, heads, hp, skip, dtype):
    """``gated_norm_ref`` == the reference's ``rmsnorm((y + x * D) *
    silu(z), norm_w)`` (without the skip: decode's) on the same values
    (fp32: REF_TOL; bf16: REF_TOL_BF16)."""
    tdt = getattr(torch, dtype)
    y, z, w, (x, D), _ = _gate_inputs(4, b, s, heads, hp, tdt, skip)
    got = GN.gated_norm_ref(y, z, w, heads, x, D)
    assert got.dtype == tdt and got.shape == y.shape
    jdt = getattr(jnp, dtype)
    want = _ref_gate(_jx(y, jdt), _jx(z, jdt), _jx(w, jdt),
                     None if x is None else _jx(x, jdt),
                     None if D is None else jnp.asarray(D.numpy()), heads)
    tol = REF_TOL if dtype == "float32" else REF_TOL_BF16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,s,heads,hp,skip", GATE_SHAPES, ids=GATE_IDS)
def test_gate_bwd_ref_matches_autograd_and_vjp(b, s, heads, hp, skip):
    """``gated_norm_bwd_ref``'s dy, dz, dw, dx, dD == autograd of
    ``gated_norm_ref`` and ``jax.vjp`` of the reference's lines (fp32,
    BWD_RTOL of each gradient's largest magnitude)."""
    y, z, w, (x, D), dout = _gate_inputs(5, b, s, heads, hp, skip=skip)
    got = GN.gated_norm_bwd_ref(dout, y, z, w, heads, x, D)
    ins = [y, z, w] + ([x, D] if skip else [])
    leaves = [t.clone().requires_grad_() for t in ins]
    GN.gated_norm_ref(*leaves[:3], heads, *leaves[3:]).backward(dout)

    def ref(*a):
        return _ref_gate(*a[:3], *(a[3:] if skip else (None, None)), heads)

    _, vjp = jax.vjp(ref, *(jnp.asarray(_np(t)) for t in ins))
    names = ("dy", "dz", "dw", "dx", "dD")
    assert (got[3] is None) == (got[4] is None) == (not skip)
    for name, g, leaf, jg in zip(names, got, leaves,
                                 vjp(jnp.asarray(dout.numpy()))):
        assert g.dtype == leaf.dtype and g.shape == leaf.shape, name
        want = leaf.grad.numpy()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(g), want, rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=name)
        np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=name)


def test_gate_bwd_ref_bf16():
    """At bf16 ``gated_norm_bwd_ref`` rounds v = y + x * D as the forward
    does and returns the compute dtype's gradients (D's in fp32): within
    2^-6 of each gradient's largest magnitude of autograd of the plain
    forward on fp32 upcasts, where v is not rounded (two roundings of v,
    one of each output)."""
    y, z, w, (x, D), dout = _gate_inputs(6, 2, 8, 4, 16, torch.bfloat16)
    got = GN.gated_norm_bwd_ref(dout, y, z, w, 4, x, D)
    leaves = [t.float().clone().requires_grad_() for t in (y, z, w, x, D)]
    GN.gated_norm_ref(*leaves[:3], 4, *leaves[3:]).backward(dout.float())
    for name, g, leaf, dt in zip(("dy", "dz", "dw", "dx", "dD"), got, leaves,
                                 (torch.bfloat16,) * 4 + (torch.float32,)):
        assert g.dtype == dt, name
        scale = float(leaf.grad.abs().max())
        np.testing.assert_allclose(_np(g), leaf.grad.numpy(),
                                   rtol=2.0 ** -6, atol=2.0 ** -6 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_functions_wiring(monkeypatch, dtype):
    """``CausalConvSilu`` and ``GatedNorm`` on CPU tensors, their CUDA
    entry points patched to the plain versions: the outputs are the plain
    forwards' bit for bit and the gradients the plain backwards' (each
    within BWD_RTOL of autograd at fp32, 2^-8 at bf16)."""
    monkeypatch.setattr(CC, "causal_conv_silu_fwd_cuda",
                        lambda x, w, b, plant=0:
                        CC.causal_conv_silu_ref(x, w, b))
    monkeypatch.setattr(CC, "causal_conv_silu_bwd_cuda",
                        CC.causal_conv_silu_bwd_ref)
    monkeypatch.setattr(GN, "gated_norm_fwd_cuda",
                        lambda y, z, w, heads, x=None, D=None, plant=0:
                        GN.gated_norm_ref(y, z, w, heads, x, D))
    monkeypatch.setattr(GN, "gated_norm_bwd_cuda", GN.gated_norm_bwd_ref)
    tdt = getattr(torch, dtype)
    rtol = BWD_RTOL if dtype == "float32" else 2.0 ** -8
    x, w, bias, dy = _conv_inputs(7, 2, 12, 10, tdt)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    out = CC.CausalConvSilu.apply(*leaves)
    assert torch.equal(out, CC.causal_conv_silu_ref(x, w, bias))
    out.backward(torch.from_numpy(dy).to(tdt))
    for leaf, want in zip(leaves, CC.causal_conv_silu_bwd_ref(
            torch.from_numpy(dy).to(tdt), x, w, bias)):
        assert torch.equal(leaf.grad, want)
    plain = [t.float().clone().requires_grad_() for t in (x, w, bias)]
    CC.causal_conv_silu_ref(*plain).backward(torch.from_numpy(dy))
    for name, got, want in zip(("x", "w", "b"), leaves, plain):
        scale = float(want.grad.abs().max())
        np.testing.assert_allclose(_np(got.grad), want.grad.numpy(),
                                   rtol=rtol, atol=rtol * scale,
                                   err_msg=name)
    y, z, gw, (gx, D), dout = _gate_inputs(8, 2, 6, 4, 8, tdt)
    leaves = [t.clone().requires_grad_() for t in (y, z, gw, gx, D)]
    out = GN.GatedNorm.apply(*leaves[:3], 4, *leaves[3:])
    assert torch.equal(out, GN.gated_norm_ref(y, z, gw, 4, gx, D))
    out.backward(dout)
    want = GN.gated_norm_bwd_ref(dout, y, z, gw, 4, gx, D)
    for leaf, g in zip(leaves, want):
        assert leaf.grad.dtype == leaf.dtype and torch.equal(leaf.grad, g)


def _layer_cfgs(groups=1):
    cfg, tcfg = reduced(ARCHS["mamba2-780m"]), treduced(TARCHS["mamba2-780m"])
    if groups != cfg.ssm.n_groups:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, n_groups=groups))
    return cfg, tcfg


@pytest.mark.parametrize("groups,seq", [(1, 1), (1, 3), (2, 32)],
                         ids=["S 1", "S < K", "2 groups"])
def test_ssm_apply_and_grads_match_reference(groups, seq):
    """The port's ``ssm_apply`` through the two wrappers (their CPU path)
    and its gradients w.r.t. u and every SSM parameter == ``repro``'s and
    ``jax.vjp`` (LAYER_TOL), the conv bias and D moved off their initial
    constants so that every gradient is exercised."""
    cfg, tcfg = _layer_cfgs(groups)
    p = {k: np.asarray(v) for k, v in
         JS.ssm_init(cfg, jax.random.PRNGKey(9), jnp.float32).items()}
    rng = np.random.default_rng(13)
    for k in ("conv_b", "dt_bias", "D", "norm_w"):
        p[k] = (p[k] + rng.standard_normal(p[k].shape) * 0.3).astype(
            np.float32)
    u = _draw(rng, 2, seq, cfg.d_model, scale=0.5)
    dy = _draw(rng, 2, seq, cfg.d_model)
    want, vjp = jax.vjp(lambda uu, pp: JS.ssm_apply(cfg, pp, uu),
                        jnp.asarray(u), {k: jnp.asarray(v)
                                         for k, v in p.items()})
    du_want, dp_want = vjp(jnp.asarray(dy))
    tu = torch.from_numpy(u).requires_grad_()
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    got = S.ssm_apply(tcfg, tp, tu)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LAYER_TOL)
    got.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(du_want),
                               **LAYER_TOL)
    for k, v in tp.items():
        scale = float(np.abs(np.asarray(dp_want[k])).max())
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(dp_want[k]),
                                   rtol=2e-4, atol=2e-4 * max(1.0, scale),
                                   err_msg=k)


def _refuse(*a, **k):
    raise AssertionError("a CUDA entry point was called")


def test_cpu_and_meta_never_reach_the_kernels(monkeypatch):
    """On CPU tensors (forward and backward) and ``meta`` tensors (the
    dry run) the wrappers and the layer (its decode step too) run the
    plain versions: the CUDA entry points (patched to raise) are never
    called and no launch is counted."""
    conv_fn, gate_fn = CC.causal_conv_silu_cuda, GN.gated_norm_cuda
    before = (conv_fn.launches, dict(CC.launches_by_pass),
              gate_fn.launches, dict(GN.launches_by_pass))
    for mod, names in ((CC, ("causal_conv_silu_cuda",
                             "causal_conv_silu_fwd_cuda",
                             "causal_conv_silu_bwd_cuda")),
                       (GN, ("gated_norm_cuda", "gated_norm_fwd_cuda",
                             "gated_norm_bwd_cuda"))):
        for name in names:
            monkeypatch.setattr(mod, name, _refuse)
    x, w, bias, _ = _conv_inputs(10, 2, 9, 12)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
    CC.causal_conv_silu(*leaves).sum().backward()
    y, z, gw, (gx, D), _ = _gate_inputs(11, 2, 5, 2, 8)
    gl = [t.clone().requires_grad_() for t in (y, z, gw, gx, D)]
    GN.gated_norm(*gl[:3], 2, *gl[3:]).sum().backward()
    assert all(t.grad is not None for t in leaves + gl)
    meta = CC.causal_conv_silu(*(t.to("meta") for t in (x, w, bias)))
    assert meta.device.type == "meta" and meta.shape == x.shape
    meta = GN.gated_norm(y.to("meta"), z.to("meta"), gw.to("meta"), 2)
    assert meta.device.type == "meta" and meta.shape == y.shape
    _, tcfg = _layer_cfgs()
    p = S.ssm_init(tcfg, torch.Generator().manual_seed(0), torch.float32)
    u = torch.randn((2, 16, tcfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    S.ssm_apply(tcfg, p, u.requires_grad_()).sum().backward()
    state = S.ssm_state_init(tcfg, 2, torch.float32)
    out, _ = S.ssm_decode(tcfg, p, u[:, :1].detach(), state)
    assert out.shape == (2, 1, tcfg.d_model)
    pm = {k: v.detach().to("meta") for k, v in p.items()}
    assert S.ssm_apply(tcfg, pm, u.detach().to("meta")).device.type == "meta"
    assert (conv_fn.launches, CC.launches_by_pass, gate_fn.launches,
            GN.launches_by_pass) == before


def _meta_views(b, s, d_in, g, n, nh, dtype=torch.bfloat16):
    """The layer's operands on ``meta``: the conv's columns and z as views
    of one ``in_proj`` row, x as a view of the conv's output."""
    conv = d_in + 2 * g * n
    row = torch.empty((b, s, 2 * d_in + 2 * g * n + nh), dtype=dtype,
                      device="meta")
    xbc = torch.empty((b, s, conv), dtype=dtype, device="meta")
    return row[..., d_in:d_in + conv], row[..., :d_in], xbc[..., :d_in]


@pytest.mark.parametrize("b,s,d_in,g,n,nh", [
    (4, 2048, 3072, 1, 128, 48), (1, 4096, 16384, 8, 128, 128),
    (2, 64, 128, 1, 16, 8)], ids=["mamba2-780m", "jamba-1.5", "reduced"])
def test_checks_take_the_layers_views(b, s, d_in, g, n, nh):
    """The kernels take the layer's views as they lie (no copy), at
    mamba2-780m's and jamba's widths and the reduced configs'."""
    conv_in, z, x = _meta_views(b, s, d_in, g, n, nh)
    conv = conv_in.shape[-1]
    CC._check(conv_in, torch.empty((K, conv), dtype=torch.bfloat16,
                                   device="meta"),
              torch.empty(conv, dtype=torch.bfloat16, device="meta"))
    y = torch.empty((b, s, d_in), dtype=torch.bfloat16, device="meta")
    w = torch.empty(d_in, dtype=torch.bfloat16, device="meta")
    GN._check(y, z, w, nh, x, torch.empty(nh, device="meta"))
    GN._check(y, z, w, nh, None, None)


@pytest.mark.parametrize("bad", ["float16", "w's dtype", "w's shape",
                                 "last dim strided", "b's shape",
                                 "w strided", "3 taps"])
def test_conv_check_refuses_on_meta(bad):
    """The conv's ``_check`` raises on what its kernels do not take (the
    plain version takes any K; the kernels Mamba-2's K = 4)."""
    x = torch.empty((2, 8, 16), dtype=torch.bfloat16, device="meta")
    w = torch.empty((K, 16), dtype=torch.bfloat16, device="meta")
    b = torch.empty(16, dtype=torch.bfloat16, device="meta")
    if bad == "float16":
        x, w = x.half(), w.half()
    elif bad == "w's dtype":
        w = w.float()
    elif bad == "w's shape":
        w = w[:, :8]
    elif bad == "last dim strided":
        x = torch.empty((2, 16, 8), dtype=torch.bfloat16,
                        device="meta").transpose(1, 2)
    elif bad == "b's shape":
        b = b[:8]
    elif bad == "w strided":
        w = torch.empty((16, K), dtype=torch.bfloat16, device="meta").t()
    elif bad == "3 taps":
        w = w[:3]
    with pytest.raises((ValueError, TypeError)):
        CC._check(x, w, b)


@pytest.mark.parametrize("bad", ["float16", "z's dtype", "heads", "x alone",
                                 "D's shape", "last dim strided",
                                 "z's shape"])
def test_gate_check_refuses_on_meta(bad):
    """The gate's ``_check`` raises on what its kernels do not take."""
    args = dict(y=torch.empty((2, 8, 64), dtype=torch.bfloat16,
                              device="meta"),
                z=torch.empty((2, 8, 64), dtype=torch.bfloat16,
                              device="meta"),
                w=torch.empty(64, dtype=torch.bfloat16, device="meta"),
                heads=4,
                x=torch.empty((2, 8, 64), dtype=torch.bfloat16,
                              device="meta"),
                D=torch.empty(4, device="meta"))
    if bad == "float16":
        args.update(y=args["y"].half(), z=args["z"].half(),
                    x=args["x"].half())
    elif bad == "z's dtype":
        args["z"] = args["z"].float()
    elif bad == "heads":
        args["heads"] = 5
    elif bad == "x alone":
        args["D"] = None
    elif bad == "D's shape":
        args["D"] = args["D"][:2]
    elif bad == "last dim strided":
        args["y"] = torch.empty((2, 64, 8), dtype=torch.bfloat16,
                                device="meta").transpose(1, 2)
    elif bad == "z's shape":
        args["z"] = args["z"][:, :4]
    with pytest.raises((ValueError, TypeError)):
        GN._check(**args)


def test_gate_plan_pinned():
    """A row up to ``MAX_BLOCK`` columns is one block; jamba's 16384 is 4
    blocks of 32 heads."""
    assert GN.plan(48, 64) == (64, 64, 1, 8, 4)        # mamba2-780m
    assert GN.plan(128, 128) == (32, 128, 4, 8, 16)    # jamba-1.5
    assert GN.plan(8, 16) == (8, 16, 1, 1, 1)          # the reduced configs
    assert GN.plan(3, 8) == (4, 8, 1, 1, 1)
    for heads, hp in ((48, 64), (128, 128), (8, 16), (3, 8), (200, 96)):
        bh, bp, nb, _, _ = GN.plan(heads, hp)
        assert bh * bp <= GN.MAX_BLOCK and bp >= hp and nb * bh >= heads \
            and (nb - 1) * bh < heads


def test_conv_plan_pinned():
    """The conv's chunks: at least 64 rows, a multiple of 4, about
    ``PARTS`` of them over the batch; every row in one chunk."""
    assert CC.plan(4, 2048) == (64, 32)             # 11c's shape
    assert CC.plan(1, 32768) == (256, 128)          # prefill_32k's
    assert CC.plan(1, 4096) == (64, 64)
    assert CC.plan(4, 1) == (64, 1)
    for bsz, s in ((4, 2048), (1, 32768), (2, 3), (3, 1000), (1, 129)):
        chunk, n = CC.plan(bsz, s)
        assert chunk % 4 == 0 and chunk >= 64 and (n - 1) * chunk < s \
            <= n * chunk


_BLOCKED = r"""
import sys
sys.modules["triton"] = None
from repro_torch.kernels import causal_conv, gated_norm, triton_source
from repro_torch.models import ssm
for name in ("causal_conv", "gated_norm"):
    try:
        triton_source.load(name)
    except ImportError:
        print("refused", name)
"""


def test_triton_sources_load_only_at_launch():
    """With ``triton`` missing the wrappers and the layer import; only
    loading a source (at the first CUDA launch) needs it."""
    for name in ("causal_conv", "gated_norm"):
        assert "import triton" in (triton_source.CSRC
                                   / f"{name}.py").read_text()
    proc = subprocess.run([sys.executable, "-c", _BLOCKED],
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["refused", "causal_conv", "refused",
                                   "gated_norm"]
