"""Mamba-2's decode mixer (``repro_torch.kernels.ssm_decode``) on the
CPU: its plain versions, planner, router and contracts.

The port's ``ssm_decode`` and ``decode_step`` run the mixer between
``in_proj`` and ``out_proj``; on the CPU that is
:func:`ssm_decode_mixer_ref`, held here to ``repro``'s ``ssm_decode`` /
``decode_step`` over several steps (both states), and bit for bit to the
arithmetic the layer ran before the mixer (a copy of those lines is kept
below).  :func:`ssm_decode_mixer_splits_ref`, the CUDA kernel's algorithm
as plain fp32 tensor code (the conv's sum rounded once, each block's
partial sum of squares and their fixed-order sum), is held to the plain
version at mamba2-780m's and jamba-1.5's published widths.  The kernel
itself runs on the card only (``chip_smoke.py``, phase 10a).  Inputs are
numpy draws from a seed.
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS, reduced
from repro.models import model_zoo as jzoo
from repro.models import ssm as JS
from repro.models import transformer as JT

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ssm_decode as M
from repro_torch.kernels.gated_norm import gated_norm
from repro_torch.kernels.ssd_decode import ssd_decode_step
from repro_torch.models import layers as L, ssm as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)

# the port against the reference (fp32): the same operations summed in
# other orders, as tests/test_torch_models.py
TOL = dict(rtol=2e-4, atol=2e-4)
STEPS = 6
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _cfgs(name, groups=None):
    cfg, tcfg = reduced(ARCHS[name]), treduced(TARCHS[name])
    if groups is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, n_groups=groups))
        tcfg = dataclasses.replace(
            tcfg, ssm=dataclasses.replace(tcfg.ssm, n_groups=groups))
    return cfg, tcfg


def _layer_params(cfg):
    """The first block's first SSM sublayer of ``model_zoo.init``."""
    blocks = jax.tree.map(lambda a: np.asarray(a[0]),
                          jzoo.init(cfg)["blocks"])
    key = f"ssm{cfg.block_pattern.index('M')}"
    p = blocks[key]
    # nonzero conv bias, dt bias and D: every term of the mixer counts
    rng = np.random.default_rng(3)
    for k in ("conv_b", "dt_bias"):
        p[k] = (rng.standard_normal(p[k].shape) * 0.3).astype(p[k].dtype)
    p["D"] = (1.0 + rng.standard_normal(p["D"].shape) * 0.3).astype(
        p["D"].dtype)
    return p


@pytest.mark.parametrize("name,groups", [("mamba2-780m", None),
                                         ("jamba-1.5-large-398b", 2)])
def test_ssm_decode_matches_reference(name, groups):
    """``STEPS`` tokens through the layer's decode: the output and both
    states against ``repro``'s ``ssm_decode`` (fp32, reduced widths;
    jamba's with 2 groups)."""
    cfg, tcfg = _cfgs(name, groups)
    p = _layer_params(cfg)
    tp = {k: _t(v) for k, v in p.items()}
    x = (np.random.default_rng(4).standard_normal((2, STEPS, cfg.d_model))
         * 0.5).astype(np.float32)
    state = S.ssm_state_init(tcfg, 2, torch.float32, CPU)
    jstate = JS.ssm_state_init(cfg, 2, jnp.float32)
    jstep = jax.jit(lambda u, st: JS.ssm_decode(cfg, p, u, st))
    for t in range(STEPS):
        y, state = S.ssm_decode(tcfg, tp, _t(x[:, t:t + 1]), state)
        jy, jstate = jstep(jnp.asarray(x[:, t:t + 1]), jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        for k in ("h", "conv"):
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(jstate[k]), **TOL)


@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_decode_step_matches_reference(name):
    """``STEPS`` decode steps of the whole model: the logits and every
    SSM sublayer's ``h`` and conv window against ``repro``'s
    ``decode_step`` (fp32, reduced widths)."""
    cfg, tcfg = _cfgs(name)
    params = jzoo.init(cfg)
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, params), CPU)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (2, STEPS)).astype(np.int32)
    jstate = JT.init_decode_state(cfg, params, 2, STEPS)
    state = T.init_decode_state(tcfg, tparams, 2, STEPS)
    step = jax.jit(lambda st, tok: JT.decode_step(cfg, params, st, tok))
    for t in range(STEPS):
        want, jstate = step(jstate, jnp.asarray(tokens[:, t:t + 1]))
        got, state = T.decode_step(tcfg, tparams, state,
                                   _t(tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        n_ssm = 0
        for i, ch in enumerate(cfg.block_pattern):
            if ch != "M":
                continue
            for b in range(cfg.n_blocks):
                for k in ("h", "conv"):
                    np.testing.assert_allclose(
                        state["caches"][b][f"ssm{i}"][k].numpy(),
                        np.asarray(jstate["caches"][f"ssm{i}"][k][b]),
                        **TOL)
                n_ssm += 1
        assert n_ssm >= 1


def _parent_decode_local(cfg, p, u, state):
    """The layer's decode before the mixer, kept as it was: the
    tensor code around the SSD step and the gated norm."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    bsz = u.shape[0]
    g, hp = s.n_groups, s.head_dim

    z, x, B, C, dt_raw = torch.split(
        u @ p["in_proj"], [d_in, d_in, g * s.d_state, g * s.d_state, nh],
        dim=-1)
    xbc = torch.cat([x, B, C], -1)                          # (B,1,conv)
    window = torch.cat([state["conv"], xbc.to(state["conv"].dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window.to(u.dtype),
                            p["conv_w"]) + p["conv_b"]
    xbc1 = F.silu(conv_out)[:, None, :]
    x, B, C = torch.split(xbc1, [d_in, g * s.d_state, g * s.d_state],
                          dim=-1)

    dt = L.softplus(dt_raw.to(torch.float32) + p["dt_bias"])[:, 0]
    y, h = ssd_decode_step(state["h"], x.reshape(bsz, nh, hp), dt,
                           p["A_log"].to(torch.float32),
                           B.reshape(bsz, g, s.d_state),
                           C.reshape(bsz, g, s.d_state),
                           p["D"].to(torch.float32))
    y = y.reshape(bsz, 1, d_in).to(u.dtype)
    y = gated_norm(y, z, p["norm_w"], nh)
    out = y @ p["out_proj"]
    new_state = {"h": h, "conv": window[:, 1:].to(state["conv"].dtype)}
    return out, new_state


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,groups", [("mamba2-780m", None),
                                         ("jamba-1.5-large-398b", 2)])
def test_plain_mixer_bit_identical_to_parent(name, groups, dtype):
    """The layer's decode through the plain mixer equals the parent's
    lines bit for bit, output and both states, over ``STEPS`` tokens, at
    fp32 and with every floating parameter cast to bf16."""
    _, tcfg = _cfgs(name, groups)
    p = {k: _t(v).to(dtype) for k, v in _layer_params(
        _cfgs(name, groups)[0]).items()}
    x = _t((np.random.default_rng(6).standard_normal(
        (2, STEPS, tcfg.d_model)) * 0.5).astype(np.float32)).to(dtype)
    st_new = S.ssm_state_init(tcfg, 2, dtype, CPU)
    st_old = {k: v.clone() for k, v in st_new.items()}
    for t in range(STEPS):
        got, st_new = S.ssm_decode(tcfg, p, x[:, t:t + 1], st_new)
        want, st_old = _parent_decode_local(tcfg, p, x[:, t:t + 1], st_old)
        assert got.dtype == dtype
        assert torch.equal(got, want)
        assert torch.equal(st_new["h"], st_old["h"])
        assert torch.equal(st_new["conv"], st_old["conv"])


def test_repro_bf16_conv_rounds_the_fp32_sum_once():
    """``repro``'s bf16 decode conv (``jnp.einsum("bkc,kc->bc")`` over the
    window) equals the taps' fp32 sum rounded once, element for element
    (the kernel's conv, :func:`conv_once_rounded`), as does the plain
    version's ``torch.einsum``; a chain that rounds each tap does not."""
    rng = np.random.default_rng(7)
    win = rng.standard_normal((4, 4, 3328)).astype(np.float32)
    w = (rng.standard_normal((4, 3328)) / 2).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(jnp.einsum("bkc,kc->bc", jnp.asarray(win, bf),
                                 jnp.asarray(w, bf)).astype(jnp.float32))
    twin, tw = _t(win).bfloat16(), _t(w).bfloat16()
    got = M.conv_once_rounded(twin, tw, torch.bfloat16)
    np.testing.assert_array_equal(got.numpy(), want)
    plain = torch.einsum("bkc,kc->bc", twin, tw).float()
    np.testing.assert_array_equal(plain.numpy(), want)
    chain = twin[:, 0] * tw[0]
    for k in range(1, 4):
        chain = chain + twin[:, k] * tw[k]
    assert not np.array_equal(chain.float().numpy(), want)


# published widths of the mixer: (heads, d_state, head_dim, groups)
WIDTHS = {"mamba2-780m": (48, 128, 64, 1),
          "jamba-1.5-large-398b": (128, 128, 128, 8)}


def _mixer_inputs(name, bsz, dtype, seed=0, pdtype=None):
    """A batch of ``bsz`` rows of the mixer's inputs at ``name``'s
    widths: the ``in_proj`` row, a window, a state, the parameters (in
    ``pdtype``, default ``dtype``)."""
    nh, n, hp, g = WIDTHS[name]
    d_in = nh * hp
    conv_dim = d_in + 2 * g * n
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0, shift=0.0):
        return _t((rng.standard_normal(shape) * scale + shift).astype(
            np.float32))

    pd = pdtype or dtype
    zx = draw(bsz, 1, 2 * d_in + 2 * g * n + nh).to(dtype)
    window = draw(bsz, 3, conv_dim).to(dtype)
    h = draw(bsz, nh, n, hp).to(dtype)
    params = dict(conv_w=draw(4, conv_dim, scale=0.5).to(dtype),
                  conv_b=draw(conv_dim, scale=0.3).to(dtype),
                  dt_bias=draw(nh, scale=0.5).to(pd),
                  A_log=torch.log(torch.linspace(1.0, 16.0, nh)).to(pd),
                  D=draw(nh, scale=0.3, shift=1.0).to(pd),
                  norm_w=draw(d_in, scale=0.2, shift=1.0).to(pd))
    return zx, window, h, params, g


def _mixer(fn, zx, window, h, params, g, **kw):
    return fn(zx, window, h, params["conv_w"], params["conv_b"],
              params["dt_bias"], params["A_log"], params["D"],
              params["norm_w"], g, **kw)


def _bf16_ulps(got, want):
    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i + 32768), i)
    return int((line(got) - line(want)).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["mamba2-780m", "jamba-1.5-large-398b"])
def test_splits_ref_matches_plain(name, dtype):
    """The kernel's algorithm against the plain version at the published
    widths, one layer, B 2.  fp32: sums in other orders, within 1e-5 of
    the output's rms and 1e-5 relative.  bf16: the conv, y and g round
    where the plain version rounds, but an fp32 sum in another order can
    flip a rounding: within 2^-6 relative and 0.02 of the rms (a flip of
    an x column moves y by D x's ulp).  The new window is equal in both;
    the state within one bf16 ulp."""
    zx, window, h, params, g = _mixer_inputs(name, 2, dtype)
    h_plain = h.clone()
    want, want_win = _mixer(M.ssm_decode_mixer_ref, zx, window, h_plain,
                            params, g)
    w0, h0 = window.clone(), h.clone()
    out, new_win, new_h, part = _mixer(M.ssm_decode_mixer_splits_ref, zx,
                                       window, h, params, g)
    assert torch.equal(window, w0) and torch.equal(h, h0)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert torch.equal(new_win, want_win)
    assert part.shape == (2, WIDTHS[name][0])
    o, w = out.float(), want.float()
    rms = float(w.square().mean().sqrt())
    atol, rtol = (1e-5, 1e-5) if dtype == torch.float32 \
        else (0.02, 2.0 ** -6)
    assert bool(((o - w).abs() <= atol * rms + rtol * w.abs()).all())
    if dtype == torch.float32:
        torch.testing.assert_close(new_h, h_plain, rtol=1e-5, atol=1e-5)
    else:
        assert _bf16_ulps(new_h, h_plain) <= 1
    # the planted faults of chip_smoke.py move what they must
    bad = _mixer(M.ssm_decode_mixer_splits_ref, zx, window, h, params, g,
                 plant=M.PLANT_PARTIAL)[0].float()
    # the row's scale grows by about half the share of the slot left out
    scale = float((bad * w).sum() / (w * w).sum())
    share = float(part[:, 0].sum() / part.sum())
    assert scale - 1.0 > max(0.4 * share, 5e-4)
    unshifted = _mixer(M.ssm_decode_mixer_splits_ref, zx, window, h, params,
                       g, plant=M.PLANT_SHIFT)[1]
    assert not torch.equal(unshifted, want_win)


@pytest.mark.parametrize("bsz,nh,n,hp,g,itemsize", [
    (2, 48, 128, 64, 1, 2), (128, 48, 128, 64, 1, 2),
    (4, 128, 128, 128, 8, 2), (2, 4, 16, 16, 1, 4), (3, 8, 16, 32, 2, 4),
    (1, 6, 96, 128, 3, 4), (1, 4, 128, 128, 2, 2)])
def test_plan_covers_every_column_once(bsz, nh, n, hp, g, itemsize):
    """Every (b, head, column) in exactly one block, the blocks numbered
    0 .. blocks - 1, one writer of the B and C window channels per (b,
    group), 16-byte state rows of a power-of-two count of vectors that a
    block's threads tile, two front jobs a thread at most."""
    pl = M.plan(bsz, nh, n, hp, g, 4, itemsize)
    assert pl is not None
    assert pl.vpr * 16 == hp * itemsize and pl.vpr <= 32
    assert pl.vpr & (pl.vpr - 1) == 0 and M.THREADS % pl.vpr == 0
    assert 2 * hp + 2 * n <= 2 * M.THREADS
    seen = np.zeros((bsz, nh * hp), np.int32)
    writers = np.zeros((bsz, g), np.int32)
    ids = []
    for blk, b, head, cols, bc in M.blocks(bsz, nh, hp, g):
        ids.append(blk)
        assert cols.start // hp == head and (cols.stop - 1) // hp == head
        seen[b, cols.start:cols.stop] += 1
        writers[b, head // (nh // g)] += bc
    assert sorted(ids) == list(range(pl.blocks))
    assert (seen == 1).all() and (writers == 1).all()


def test_plan_pinned_and_refusals():
    """The launches of phase 10a's cases (one block a head: a head cut
    over two blocks measured slower at mamba2's B 2 on an H100), the
    shared memory within the card's 227 KB, and the shapes the kernel does
    not take."""
    assert M.plan(2, 48, 128, 64, 1, 4, 2) == (8, 96, 20160)
    assert M.plan(128, 48, 128, 64, 1, 4, 2) == (8, 6144, 20160)
    assert M.plan(4, 128, 128, 128, 8, 4, 2) == (16, 512, 39104)
    assert M.plan(2, 8, 16, 16, 2, 4, 4) == (4, 16, 1984)
    assert M.plan(1, 1, 128, 128, 1, 4, 4).smem <= 232448
    for args in [(4, 48, 128, 64, 1, 3, 2), (4, 48, 256, 64, 1, 4, 2),
                 (4, 48, 128, 96, 1, 4, 2), (4, 48, 128, 256, 1, 4, 2),
                 (4, 48, 128, 4, 1, 4, 2), (4, 48, 128, 64, 5, 4, 2),
                 (M.MAX_B + 1, 48, 128, 64, 1, 4, 2),
                 (4, 48, 128, 64, 1, 4, 8)]:
        assert M.plan(*args) is None, args


def _meta_inputs(nh=8, n=16, hp=16, g=2, bsz=2, dtype=torch.bfloat16,
                 k=4, **dtypes):
    d_in = nh * hp
    conv_dim = d_in + 2 * g * n

    def e(*shape, name=None):
        return torch.empty(shape, dtype=dtypes.get(name, dtype),
                           device="meta")

    return dict(zxbcdt=e(bsz, 1, 2 * d_in + 2 * g * n + nh, name="zx"),
                window=e(bsz, k - 1, conv_dim, name="window"),
                h=e(bsz, nh, n, hp, name="h"),
                conv_w=e(k, conv_dim, name="conv_w"),
                conv_b=e(conv_dim, name="conv_b"),
                dt_bias=e(nh, name="dt_bias"), A_log=e(nh, name="A_log"),
                D=e(nh, name="D"), norm_w=e(d_in, name="norm_w"), groups=g)


def test_route_by_shape_dtype_and_layout():
    """``sm90`` for bf16 and fp32 calls the plan takes (the 1-D
    parameters bf16 or fp32); ``unfused`` for d_conv 3, d_state 256, a
    head_dim of 96, a conv bias or window in another dtype, a
    non-contiguous state or a strided last dim."""
    assert M.route(**_meta_inputs()) == "sm90"
    assert M.route(**_meta_inputs(dtype=torch.float32)) == "sm90"
    f32 = torch.float32
    assert M.route(**_meta_inputs(dt_bias=f32, A_log=f32, D=f32,
                                  norm_w=f32)) == "sm90"
    assert M.route(**_meta_inputs(k=3)) == "unfused"
    assert M.route(**_meta_inputs(n=256)) == "unfused"
    assert M.route(**_meta_inputs(hp=96)) == "unfused"
    assert M.route(**_meta_inputs(conv_b=f32)) == "unfused"
    assert M.route(**_meta_inputs(window=f32)) == "unfused"
    assert M.route(**_meta_inputs(dt_bias=torch.float16)) == "unfused"
    kw = _meta_inputs()
    kw["h"] = kw["h"].transpose(2, 3)
    assert M.route(**kw) == "unfused"
    kw = _meta_inputs()
    kw["zxbcdt"] = torch.empty(2, 1, 2 * kw["zxbcdt"].shape[2],
                               dtype=torch.bfloat16, device="meta")[..., ::2]
    assert M.route(**kw) == "unfused"


def test_old_window_untouched_new_tensor():
    """The new window is a new tensor (no storage shared with the old
    one); the old window is only read; ``h`` is updated in place."""
    zx, window, h, params, g = _mixer_inputs("mamba2-780m", 2,
                                             torch.float32, seed=8)
    w0, h0 = window.clone(), h.clone()
    out, new_win = _mixer(M.ssm_decode_mixer, zx, window, h, params, g)
    assert torch.equal(window, w0)
    assert new_win.untyped_storage().data_ptr() \
        != window.untyped_storage().data_ptr()
    assert torch.equal(new_win[:, :-1], w0[:, 1:])
    assert not torch.equal(h, h0)
    assert out.shape == (2, 1, 48 * 64)


def test_chosen_route_on_meta():
    """A call's route argument: ``None`` takes the planned route,
    ``"unfused"`` takes any call, ``"sm90"`` raises on a call it does
    not plan, and a name that is no route raises."""
    def ts(**kw):
        m = _meta_inputs(**kw)
        return tuple(m[k] for k in ("zxbcdt", "window", "h", "conv_w",
                                    "conv_b", "dt_bias", "A_log", "D",
                                    "norm_w")), m["groups"]

    ok, g = ts()
    assert M._route(ok, g, None) == "sm90"
    assert M._route(ok, g, "sm90") == "sm90"
    assert M._route(ok, g, "unfused") == "unfused"
    off, g = ts(k=3)
    assert M._route(off, g, None) == "unfused"
    assert M._route(off, g, "unfused") == "unfused"
    with pytest.raises(ValueError, match="sm90 route takes no call"):
        M._route(off, g, "sm90")
    with pytest.raises(ValueError, match="is not one of"):
        M._route(ok, g, "triton")


def test_cpu_and_meta_never_reach_kernel(monkeypatch):
    """On CPU and ``meta`` tensors the mixer, and the layer's decode
    through it, run the plain version: the CUDA entry points (patched to
    raise) are never reached and no launch is counted."""
    def boom(*a, **kw):
        raise AssertionError("reached the CUDA mixer")

    monkeypatch.setattr(M, "ssm_decode_mixer_cuda", boom)
    monkeypatch.setattr(M, "_sm90", boom)
    monkeypatch.setattr(M, "_library", boom)
    M.reset_launches()
    zx, window, h, params, g = _mixer_inputs("mamba2-780m", 2,
                                             torch.bfloat16, seed=9)
    _mixer(M.ssm_decode_mixer, zx, window, h, params, g)
    meta = _meta_inputs()
    out, new_win = M.ssm_decode_mixer(**meta)
    assert out.device.type == "meta" and new_win.shape == meta["window"].shape
    _, tcfg = _cfgs("mamba2-780m")
    tp = {k: _t(v) for k, v in _layer_params(_cfgs("mamba2-780m")[0]).items()}
    state = S.ssm_state_init(tcfg, 2, torch.float32, CPU)
    S.ssm_decode(tcfg, tp, torch.ones(2, 1, tcfg.d_model), state)
    assert M.ssm_decode_mixer.launches == 0
    assert M.launches_by_route == {r: 0 for r in M.ROUTES}


def test_cuda_entry_refuses_cpu_tensors():
    """The CUDA entry point never runs a CPU call (no fallback)."""
    zx, window, h, params, g = _mixer_inputs("mamba2-780m", 1,
                                             torch.bfloat16)
    with pytest.raises(ValueError):
        _mixer(M.ssm_decode_mixer_cuda, zx, window, h, params, g)


@pytest.mark.parametrize("what", ["zx width", "window rows", "norm_w",
                                  "groups", "conv_b", "int state"])
def test_check_refuses_bad_inputs_on_meta(what):
    """``_check`` on ``meta`` tensors refuses shapes that do not fit one
    another and non-floating tensors, before any route is chosen."""
    kw = _meta_inputs()
    e = kw["zxbcdt"]
    if what == "zx width":
        kw["zxbcdt"] = torch.empty(e.shape[0], 1, e.shape[2] + 8,
                                   dtype=e.dtype, device="meta")
    elif what == "window rows":
        kw["window"] = kw["window"][:, :2]
    elif what == "norm_w":
        kw["norm_w"] = kw["norm_w"][:-16]
    elif what == "groups":
        kw["groups"] = 3
    elif what == "conv_b":
        kw["conv_b"] = kw["conv_b"][:-1]
    else:
        kw["h"] = torch.empty(kw["h"].shape, dtype=torch.int32,
                              device="meta")
    with pytest.raises((ValueError, TypeError)):
        M.ssm_decode_mixer(**kw)


def test_source_constants_match_wrapper():
    """The .cu's block, taps, limits, fixed-order lanes and planted
    faults are the wrapper's."""
    src = M.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == M.THREADS
    assert const("kTaps") == M.D_CONV
    assert const("kMaxN") == M.MAX_N and const("kMaxHp") == M.MAX_HP
    assert const("kLanes") == M.LANES
    assert const("kPlantShift") == M.PLANT_SHIFT
    assert const("kPlantPartial") == M.PLANT_PARTIAL
