"""The SSD chunk-scan kernel's plain versions, autograd wiring and
contract, on the CPU.

:func:`ssd_chunk_scan_ref` is the reference's arithmetic
(``repro.models.ssm.ssm_apply``'s chunked SSD, moved out of the layer):
held to the stepped recurrence of ``ssd_decode_step_ref`` (the model of
``tests/test_models_smoke.py:124``), and through the port's ``ssm_apply``
(forward and every gradient) to ``repro``'s ``ssm_apply`` and
``jax.vjp``.  :func:`ssd_chunk_scan_bwd_ref`, the kernel's backward
algorithm as plain fp32 tensor code, is held to autograd of
:func:`ssd_chunk_scan_ref`.  :class:`SSDChunkScan` is run on CPU tensors
with its CUDA entry points patched to the plain versions.  On the CPU
and ``meta`` the layer never reaches the kernel's wrapper; its
``_check`` refuses what the kernel does not take, on ``meta`` tensors.
Inputs are numpy draws from a seed, in float32 unless said.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import ssm as JS

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels import ssd_decode as SD, ssd_scan as K
from repro_torch.models import ssm as S

torch.set_num_threads(1)

# the chunked scan against the stepped recurrence (fp32): the same sums
# in another order, the decays as exp(cum_i - cum_j) against products of
# per-step factors; the largest gap seen is about 1.4e-5 on outputs of
# magnitude up to 19
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
# the port's layer against repro's (fp32), as tests/test_torch_models.py
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
# the plain backward against autograd of the plain forward (fp32): the
# same terms summed in another order; the largest gap seen is 4.4e-7 of
# an output's largest magnitude (dA's, a sum over every position)
BWD_RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, b, s, nh, hp, g, n):
    """x, dt, A, B, C and y's gradient, normal draws (dt through a
    softplus, A = -exp(A_log) over the layer's initial A_log range)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, B, C = draw(b, s, nh, hp), draw(b, s, g, n), draw(b, s, g, n)
    dt = torch.nn.functional.softplus(draw(b, s, nh) - 1.0)
    A = -torch.from_numpy(np.linspace(1.0, 16.0, nh).astype(np.float32)) \
        * 0.25
    return x, dt, A, B, C, draw(b, s, nh, hp)


@pytest.mark.parametrize("g,chunk", [(1, 16), (2, 8), (4, 32)])
def test_ref_matches_stepped_recurrence(g, chunk):
    """y_diag + y_off == the recurrence h_t = exp(dt_t A) h_{t-1} +
    dt_t B_t x_t^T, y_t = C_t h_t, stepped by ``ssd_decode_step_ref``
    with D = 0 (tests/test_models_smoke.py:124)."""
    b, s, nh, hp, n = 2, 32, 4, 8, 16
    x, dt, A, B, C, _ = _inputs(3, b, s, nh, hp, g, n)
    got = K.ssd_chunk_scan_ref(x, dt, A, B, C, chunk)
    h = torch.zeros((b, nh, n, hp))
    a_log = torch.log(-A)
    ys = []
    for t in range(s):
        y, h = SD.ssd_decode_step_ref(h, x[:, t], dt[:, t], a_log, B[:, t],
                                      C[:, t], torch.zeros(nh))
        ys.append(y)
    np.testing.assert_allclose(got.numpy(), torch.stack(ys, 1).numpy(),
                               **STEP_TOL)


def _layer_cfgs(groups):
    cfg, tcfg = reduced(ARCHS["mamba2-780m"]), treduced(TARCHS["mamba2-780m"])
    if groups != cfg.ssm.n_groups:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, n_groups=groups))
        tcfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(
            tcfg.ssm, n_groups=groups))
    return cfg, tcfg


@pytest.mark.parametrize("groups,seq", [(1, 64), (1, 8), (2, 48)],
                         ids=["4 chunks", "Q < chunk", "2 groups"])
def test_ssm_apply_and_grads_match_reference(groups, seq):
    """The port's ``ssm_apply`` (the scan's CPU path) and its gradients
    w.r.t. u and every SSM parameter == ``repro``'s and ``jax.vjp``."""
    cfg, tcfg = _layer_cfgs(groups)
    p = {k: np.asarray(v) for k, v in
         JS.ssm_init(cfg, jax.random.PRNGKey(5), jnp.float32).items()}
    rng = np.random.default_rng(11)
    # A_log and dt_bias away from their initial constants, so that every
    # gradient is exercised
    p["dt_bias"] = (rng.standard_normal(p["dt_bias"].shape) * 0.5).astype(
        np.float32)
    u = (rng.standard_normal((2, seq, cfg.d_model)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    want, vjp = jax.vjp(lambda uu, pp: JS.ssm_apply(cfg, pp, uu),
                        jnp.asarray(u), {k: jnp.asarray(v)
                                         for k, v in p.items()})
    du_want, dp_want = vjp(jnp.asarray(dy))
    tu = _t(u).requires_grad_()
    tp = {k: _t(v).requires_grad_() for k, v in p.items()}
    got = S.ssm_apply(tcfg, tp, tu)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LAYER_TOL)
    got.backward(_t(dy))
    np.testing.assert_allclose(tu.grad.numpy(), np.asarray(du_want),
                               **LAYER_TOL)
    assert set(tp) == set(dp_want)
    for k, v in tp.items():
        scale = float(np.abs(np.asarray(dp_want[k])).max())
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(dp_want[k]),
                                   rtol=2e-4, atol=2e-4 * max(1.0, scale),
                                   err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunks", [1, 8])
@pytest.mark.parametrize("g", [1, 2])
def test_bwd_ref_matches_autograd(g, chunks, dtype):
    """``ssd_chunk_scan_bwd_ref`` == autograd of ``ssd_chunk_scan_ref`` on
    fp32 upcasts, at S = Q and S = 8Q, one group and two; bf16 inputs are
    compared in fp32 (dx, dB, dC come back in bf16: one rounding, 2^-8
    of their magnitude, on top)."""
    Q = 16
    x, dt, A, B, C, dy = _inputs(7, 2, Q * chunks, 4, 16, g, 16)
    dt_ = getattr(torch, dtype)
    x, B, C, dy = (t.to(dt_) for t in (x, B, C, dy))
    leaves = [t.float().clone().requires_grad_() for t in (x, dt, A, B, C)]
    K.ssd_chunk_scan_ref(*leaves, Q).backward(dy.float())
    got = K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, Q)
    for name, gt, want, out_dt in zip(("dx", "ddt", "dA", "dB", "dC"), got,
                                      [t.grad for t in leaves],
                                      (dt_, torch.float32, torch.float32,
                                       dt_, dt_)):
        assert gt.shape == want.shape and gt.dtype == out_dt, name
        scale = float(want.abs().max())
        rtol = BWD_RTOL if out_dt == torch.float32 else 2.0 ** -8
        np.testing.assert_allclose(gt.float().numpy(), want.numpy(),
                                   rtol=rtol, atol=rtol * scale,
                                   err_msg=name)


def test_chunk_states_ref_are_the_carried_state():
    """``ssd_chunk_states_ref``: cum the in-chunk cumsum of dt * A and the
    state entering each chunk the stepped recurrence's state at the chunk
    boundary (0 for the first)."""
    b, s, nh, hp, g, n, Q = 1, 48, 2, 8, 1, 16, 16
    x, dt, A, B, C, _ = _inputs(9, b, s, nh, hp, g, n)
    cum, state = K.ssd_chunk_states_ref(x, dt, A, B, C, Q)
    assert cum.shape == (b, s // Q, nh, Q) and cum.is_contiguous()
    np.testing.assert_allclose(
        cum.numpy(), torch.cumsum((dt * A).reshape(b, s // Q, Q, nh),
                                  2).permute(0, 1, 3, 2).numpy(),
        rtol=1e-6, atol=1e-6)
    h = torch.zeros((b, nh, n, hp))
    for t in range(s):
        if t % Q == 0:
            np.testing.assert_allclose(state[:, t // Q].numpy(), h.numpy(),
                                       **STEP_TOL)
        _, h = SD.ssd_decode_step_ref(h, x[:, t], dt[:, t], torch.log(-A),
                                      B[:, t], C[:, t], torch.zeros(nh))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_function_wiring(monkeypatch, dtype):
    """``SSDChunkScan`` on CPU tensors, its CUDA entry points patched to
    the plain versions: y is the plain forward's and the gradients are
    autograd's of it (fp32: BWD_RTOL; bf16 inputs, compared in fp32 after
    dx, dB, dC come back in bf16: 2^-8)."""
    monkeypatch.setattr(K, "ssd_chunk_scan_fwd_cuda",
                        lambda x, dt, A, B, C, chunk, plant=0: (
                            K.ssd_chunk_scan_ref(x, dt, A, B, C, chunk),
                            *K.ssd_chunk_states_ref(x, dt, A, B, C, chunk)))
    monkeypatch.setattr(K, "ssd_chunk_scan_bwd_cuda",
                        lambda dy, x, dt, A, B, C, cum, state, chunk:
                        K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, chunk))
    dt_ = getattr(torch, dtype)
    x, dt, A, B, C, dy = _inputs(13, 2, 64, 4, 16, 2, 16)
    x, B, C, dy = (t.to(dt_) for t in (x, B, C, dy))
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y = K.SSDChunkScan.apply(*leaves, 16)
    assert torch.equal(y, K.ssd_chunk_scan_ref(x, dt, A, B, C, 16))
    y.backward(dy)
    plain = [t.float().clone().requires_grad_() for t in (x, dt, A, B, C)]
    K.ssd_chunk_scan_ref(*plain, 16).backward(dy.float())
    for name, got, want in zip("x dt A B C".split(), leaves, plain):
        assert got.grad.dtype == got.dtype, name
        rtol = BWD_RTOL if got.dtype == torch.float32 else 2.0 ** -8
        scale = float(want.grad.abs().max())
        np.testing.assert_allclose(got.grad.float().numpy(),
                                   want.grad.numpy(), rtol=rtol,
                                   atol=rtol * scale, err_msg=name)


def test_layer_cpu_and_meta_never_reach_the_kernel(monkeypatch):
    """On CPU tensors (forward and backward) and ``meta`` tensors (the dry
    run) the layer runs the plain scan: the kernel's wrapper (patched to
    raise) is never called and no launch is counted."""
    def refuse(*a, **k):
        raise AssertionError("the CUDA kernel's wrapper was called")

    cuda_fn = K.ssd_chunk_scan_cuda
    before = (cuda_fn.launches, dict(K.launches_by_pass))
    monkeypatch.setattr(K, "ssd_chunk_scan_cuda", refuse)
    monkeypatch.setattr(K, "ssd_chunk_scan_fwd_cuda", refuse)
    monkeypatch.setattr(K, "ssd_chunk_scan_bwd_cuda", refuse)
    _, tcfg = _layer_cfgs(1)
    p = S.ssm_init(tcfg, torch.Generator().manual_seed(0), torch.float32)
    p = {k: v.requires_grad_() for k, v in p.items()}
    u = torch.randn((2, 32, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1), requires_grad=True)
    S.ssm_apply(tcfg, p, u).sum().backward()
    assert u.grad is not None and all(v.grad is not None for v in p.values())
    meta = {k: v.detach().to("meta") for k, v in p.items()}
    out = S.ssm_apply(tcfg, meta, u.detach().to("meta"))
    assert out.device.type == "meta" and out.shape == u.shape
    assert (cuda_fn.launches, K.launches_by_pass) == before


def _meta(b=2, s=64, nh=4, hp=16, g=1, n=16, dtype=torch.bfloat16):
    """x, dt, A, B, C on ``meta``: x, B and C views of one conv row, as
    the layer splits them."""
    xbc = torch.empty((b, s, nh * hp + 2 * g * n), dtype=dtype,
                      device="meta")
    x = xbc[..., :nh * hp].reshape(b, s, nh, hp)
    B = xbc[..., nh * hp:nh * hp + g * n].reshape(b, s, g, n)
    C = xbc[..., nh * hp + g * n:].reshape(b, s, g, n)
    dt = torch.empty((b, s, nh), device="meta")
    A = torch.empty((nh,), device="meta")
    return x, dt, A, B, C


def test_check_takes_the_layers_views():
    """The kernel takes the layer's split views as they lie (no copy), at
    mamba2-780m's and jamba's widths and the reduced configs'."""
    assert K._check(*_meta(4, 2048, 48, 64, 1, 128), 256) == 256
    assert K._check(*_meta(1, 4096, 128, 128, 8, 128), 256) == 256
    assert K._check(*_meta(2, 64, 4, 16, 1, 16, torch.float32), 16) == 16
    assert K._check(*_meta(4, 64, 48, 64, 1, 128), 256) == 64


@pytest.mark.parametrize("bad", [
    "Q not a multiple of 16", "Q over 256", "S not a multiple of Q",
    "N of 8", "hp of 136", "float16", "fp64 dt", "g not dividing nh",
    "B's shape", "last dim strided", "a row stride off 16 bytes",
    "dt strided"])
def test_check_refuses_on_meta(bad):
    """``_check`` raises on what the kernel does not take, on ``meta``
    tensors (the dry run's)."""
    args = list(_meta())
    chunk = 16
    if bad == "Q not a multiple of 16":
        args, chunk = list(_meta(s=24)), 24
    elif bad == "Q over 256":
        args, chunk = list(_meta(s=512)), 512
    elif bad == "S not a multiple of Q":
        args, chunk = list(_meta(s=40)), 16
    elif bad == "N of 8":
        args = list(_meta(n=8))
    elif bad == "hp of 136":
        args = list(_meta(hp=136))
    elif bad == "float16":
        args = list(_meta(dtype=torch.float16))
    elif bad == "fp64 dt":
        args[1] = args[1].double()
    elif bad == "g not dividing nh":
        args = list(_meta(nh=6, g=4))
    elif bad == "B's shape":
        args[3] = args[3][:, :32]
    elif bad == "last dim strided":
        args[0] = torch.empty((2, 64, 16, 4), dtype=torch.bfloat16,
                              device="meta").transpose(-1, -2)
    elif bad == "a row stride off 16 bytes":
        args[0] = torch.empty((2, 64, 4 * 16 + 4), dtype=torch.bfloat16,
                              device="meta")[..., :64].reshape(2, 64, 4, 16)
    elif bad == "dt strided":
        args[1] = torch.empty((2, 4, 64), device="meta").transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        K._check(*args, chunk)


def test_chunk_len():
    assert K.chunk_len(2048, 256) == 256
    assert K.chunk_len(64, 256) == 64
    with pytest.raises(ValueError):
        K.chunk_len(100, 64)
