"""The flash-attention kernel's planners, routes, plain versions and
contract, on the CPU.

Both routes walk, for each query block, the key blocks that
:func:`kv_block_range` plans (their backward's dK/dV walk
:func:`q_block_range`'s query blocks), at their own blocks:
``csrc/flash_attention.cu`` (the ``mma`` route, fp32) 64-row query
blocks (128 in its bf16 forward up to head dim 128) and 64-key blocks,
``csrc/flash_attention_sm90.cu`` (the ``sm90`` route, bf16)
:data:`SM90_BLOCKS`; :func:`route` picks by dtype.  The planners must cover
every (query, key) pair the mask lets through and visit no block that it
masks whole.  :func:`flash_attention_fwd_ref` and
:func:`flash_attention_bwd_ref` are the kernel's algorithm as plain
tensor code: held on float32 inputs to the reference's attention core
(``repro.models.layers._gqa_scores_ctx`` and ``flash_attention`` through
JAX on the CPU, ``jax.vjp`` for the gradients) within rtol = atol =
2e-5 (the same sums in another order and blocking; the largest gap seen
is about 1e-6), and lse to ``logsumexp`` of the reference's masked
scores.  On the CPU the layers keep the reference's switch: they never
reach the kernel's wrapper.  Its ``_check`` refuses what the kernel does
not take, on ``meta`` tensors.
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL

from repro_torch.configs import ARCHS, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import layers as L

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jmask(causal, window):
    def fn(qi, ki):
        ok = jnp.ones(jnp.broadcast_shapes(qi.shape, ki.shape), bool)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= ki > qi - window
        return ok
    return fn


def _valid(sq, sk, causal, window, q_pos0):
    qi = q_pos0 + np.arange(sq)[:, None]
    ki = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    return ok


def test_block_constants_match_the_source():
    src = FA.SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBQ"], consts["kBK"]) == (FA.BLOCK_Q, FA.BLOCK_K)
    # the padded head dims of the source's dispatch
    assert re.findall(r"case (\d+):", src) == ["64", "128", "192"]
    assert [FA.padded_dims(d, dv) for d, dv in
            [(16, 16), (64, 64), (120, 120), (128, 128), (64, 128),
             (192, 128), (192, 192), (256, 256)]] == \
        [64, 64, 128, 128, 128, 192, None, None]


def test_sm90_block_constants_match_the_source():
    """``csrc/flash_attention_sm90.cu``'s blocks and padded head dims
    against :data:`SM90_BLOCKS`."""
    src = FA.SOURCE_SM90.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    for dp, blocks in FA.SM90_BLOCKS.items():
        bq = consts["kBwdBQWide"] if dp > 128 else consts["kBwdBQ"]
        assert blocks == {"fwd": (consts["kFwdBQ"], consts["kFwdBK"]),
                          "dkdv": (bq, consts["kBwdBK"]),
                          "dq": (consts["kDqBQ"], consts["kDqBK"])}
    assert re.findall(r"case (\d+):", src) == ["64", "128", "192"]
    assert sorted(FA.SM90_BLOCKS) == [64, 128, 192]
    # two consumer warpgroups of 64 rows (forward, dQ) or keys (dK, dV)
    assert consts["kFwdBQ"] == consts["kDqBQ"] == consts["kBwdBK"] == 128
    assert FA.SM90_BLOCKS[FA.padded_dims(120, 120)] == FA.SM90_BLOCKS[128]
    assert FA.SM90_BLOCKS[FA.padded_dims(192, 128)]["dkdv"] == (32, 128)


@pytest.mark.parametrize("d,dv", [(64, 64), (120, 120), (128, 128),
                                  (192, 128), (16, 16), (64, 128)])
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "sm90"),
                                        (torch.float32, "mma")])
def test_route_planner(d, dv, dtype, want):
    assert FA.route(dtype, d, dv) == want
    assert want in FA.ROUTES


@pytest.mark.parametrize("dtype,d,dv", [(torch.float16, 128, 128),
                                        (torch.bfloat16, 256, 256),
                                        (torch.float32, 192, 192)])
def test_route_planner_refuses(dtype, d, dv):
    with pytest.raises((TypeError, ValueError)):
        FA.route(dtype, d, dv)


def test_route_choice():
    """``route=`` picks the planned route (``None``), the mma route for
    either dtype, and never sm90 for fp32 or an unknown route."""
    bf = _meta((1, 8, 1, 1, 64))
    f32 = _meta((1, 8, 1, 1, 64), torch.float32)
    assert FA._route(bf, 64, 64, None) == "sm90"
    assert FA._route(bf, 64, 64, "mma") == "mma"
    assert FA._route(f32, 64, 64, None) == "mma"
    assert FA._route(f32, 64, 64, "mma") == "mma"
    with pytest.raises(ValueError):
        FA._route(f32, 64, 64, "sm90")
    with pytest.raises(ValueError):
        FA._route(bf, 64, 64, "wgmma")


@pytest.mark.parametrize("bq,bk", [(4, 4), (4, 8), (8, 4), (3, 5), (2, 8),
                                   (8, 8)])
def test_planner_covers_every_valid_pair_and_no_masked_block(bq, bk):
    """Exhaustive over Sq, Sk up to 13, causal or not, windows and
    query offsets (a sequence-parallel slice; negative: rows that see no
    key)."""
    n = 0
    for sq in range(1, 14):
        for sk in range(1, 14):
            for causal in (True, False):
                for window in (None, 1, 3, 7):
                    for q_pos0 in (0, 2, 5, -3):
                        ok = _valid(sq, sk, causal, window, q_pos0)
                        pairs = set()
                        for i in range(-(-sq // bq)):
                            lo, hi = FA.kv_block_range(
                                i, sq, sk, bq, bk, causal, window, q_pos0)
                            rows = ok[i * bq:(i + 1) * bq]
                            for j in range(-(-sk // bk)):
                                blk = rows[:, j * bk:(j + 1) * bk]
                                assert (lo <= j < hi) == bool(blk.any()), \
                                    (sq, sk, causal, window, q_pos0, i, j)
                                if lo <= j < hi:
                                    pairs.add((i, j))
                        back = set()
                        for j in range(-(-sk // bk)):
                            lo, hi = FA.q_block_range(
                                j, sq, sk, bq, bk, causal, window, q_pos0)
                            back |= {(i, j) for i in range(lo, hi)}
                        assert back == pairs, (sq, sk, causal, window,
                                               q_pos0)
                        n += 1
    assert n == 13 * 13 * 2 * 4 * 4


# (B, Sq, Sk, KV, G, D, Dv, causal, window, q_pos0, block_q, block_k)
CASES = [
    ("causal G3", (2, 40, 40, 2, 3, 16, 16, True, None, 0, 8, 16)),
    ("window G2", (1, 50, 50, 2, 2, 16, 16, True, 7, 0, 8, 8)),
    ("D != Dv (MLA)", (1, 33, 33, 3, 1, 24, 16, True, None, 0, 16, 8)),
    ("q_pos0 slice", (2, 20, 48, 1, 2, 8, 8, True, None, 28, 8, 16)),
    ("cross", (2, 12, 37, 2, 2, 16, 16, False, None, 0, 8, 8)),
    ("window non-causal", (1, 30, 30, 1, 2, 8, 8, False, 5, 0, 8, 8)),
    ("kernel blocks", (1, 150, 150, 2, 2, 16, 16, True, 70, 0, 64, 64)),
    ("bf16 forward blocks", (1, 300, 300, 2, 2, 16, 16, True, 100, 0, 128,
                             64)),
    # the sm90 route's blocks: forward, dK/dV (D <= 128, and D 192), dQ
    ("sm90 forward blocks", (1, 300, 300, 2, 2, 16, 16, True, 100, 0, 128,
                             128)),
    ("sm90 dkdv blocks", (1, 300, 300, 2, 2, 16, 16, True, 100, 0, 64,
                          128)),
    ("sm90 dkdv MLA blocks", (1, 200, 200, 2, 1, 24, 16, True, None, 0, 32,
                              128)),
    ("sm90 dq blocks", (2, 150, 280, 1, 2, 16, 16, True, None, 130, 128,
                        64)),
]


def _inputs(case, seed=0):
    b, sq, sk, kvh, g, d, dv = case[:7]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, kvh, g, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kvh, dv)).astype(np.float32)
    do = rng.standard_normal((b, sq, kvh, g, dv)).astype(np.float32)
    return q, k, v, do


def _jax_ref(q, k, v, causal, window, q_pos0):
    return JL._gqa_scores_ctx(q, k, v, _jmask(causal, window), q_pos0)


@pytest.mark.parametrize("name,case", CASES, ids=[c[0] for c in CASES])
def test_fwd_ref_matches_reference(name, case):
    causal, window, q_pos0, bq, bk = case[7:]
    q, k, v, _ = _inputs(case)
    out, lse = FA.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal,
                                          window, q_pos0, bq, bk)
    want = _jax_ref(q, k, v, causal, window, q_pos0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    want_flash = JL.flash_attention(q, k, v, _jmask(causal, window), q_pos0,
                                    block_q=bq, block_k=bk)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_flash), **TOL)
    # lse: logsumexp of the masked scores
    scores = jnp.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(q.shape[-1])
    qi = q_pos0 + jnp.arange(q.shape[1])[:, None]
    ki = jnp.arange(k.shape[1])[None, :]
    masked = jnp.where(_jmask(causal, window)(qi, ki), scores, -jnp.inf)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(masked, -1)),
                               **TOL)


@pytest.mark.parametrize("name,case", CASES, ids=[c[0] for c in CASES])
def test_bwd_ref_matches_jax_vjp(name, case):
    causal, window, q_pos0, bq, bk = case[7:]
    q, k, v, do = _inputs(case, seed=1)
    out, lse = FA.flash_attention_fwd_ref(_t(q), _t(k), _t(v), causal,
                                          window, q_pos0, bq, bk)
    dq, dk, dv = FA.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, lse,
                                            _t(do), causal, window, q_pos0,
                                            bq, bk)
    _, vjp = jax.vjp(lambda a, b, c: _jax_ref(a, b, c, causal, window,
                                              q_pos0), q, k, v)
    for got, want in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_refs_on_bf16_inputs_round_like_the_kernel():
    """bf16 inputs: the plain versions keep fp32 scores and sums and
    round only P (dS) before each second product and the outputs, so
    they stay within bf16 rounding of the fp32 results on the same
    (bf16-representable) inputs."""
    case = CASES[0][1]
    causal, window, q_pos0, bq, bk = case[7:]
    q, k, v, do = (_t(a).bfloat16() for a in _inputs(case, seed=2))
    o16, lse16 = FA.flash_attention_fwd_ref(q, k, v, causal, window, q_pos0,
                                            bq, bk)
    o32, lse32 = FA.flash_attention_fwd_ref(q.float(), k.float(), v.float(),
                                            causal, window, q_pos0, bq, bk)
    assert o16.dtype == torch.bfloat16 and lse16.dtype == torch.float32
    torch.testing.assert_close(o16.float(), o32, rtol=2 ** -7, atol=2e-2)
    torch.testing.assert_close(lse16, lse32, rtol=1e-6, atol=1e-6)
    g16 = FA.flash_attention_bwd_ref(q, k, v, o16, lse16, do, causal,
                                     window, q_pos0, bq, bk)
    g32 = FA.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o32,
                                     lse32, do.float(), causal, window,
                                     q_pos0, bq, bk)
    for a, b in zip(g16, g32):
        assert a.dtype == torch.bfloat16
        scale = float(b.abs().max())
        assert float((a.float() - b).abs().max()) <= 0.03 * scale


def test_rows_that_see_no_key_are_zero():
    """A causal slice whose first rows sit before key 0 (q_pos0 < 0):
    those rows come out 0 with lse -inf, and their gradients are 0."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((1, 12, 1, 2, 8)).astype(np.float32))
    k = _t(rng.standard_normal((1, 12, 1, 8)).astype(np.float32))
    v = _t(rng.standard_normal((1, 12, 1, 8)).astype(np.float32))
    out, lse = FA.flash_attention_fwd_ref(q, k, v, True, None, -4, 4, 4)
    assert bool((out[:, :4] == 0).all()) and bool(
        (lse[..., :4] == -math.inf).all())
    assert bool(torch.isfinite(lse[..., 4:]).all())
    dq, dk, dv = FA.flash_attention_bwd_ref(q, k, v, out, lse,
                                            torch.ones_like(out), True, None,
                                            -4, 4, 4)
    assert bool((dq[:, :4] == 0).all())
    assert all(bool(torch.isfinite(t).all()) for t in (dq, dk, dv))


def _switch_cfgs():
    return {name: reduced(ARCHS[name]) for name in
            ("phi4-mini-3.8b", "h2o-danube-3-4b", "deepseek-v3-671b")}


@pytest.mark.parametrize("threshold", [None, 4])
@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "h2o-danube-3-4b",
                                  "deepseek-v3-671b"])
def test_cpu_layers_never_reach_the_kernel(monkeypatch, name, threshold):
    """``_attention_local`` and ``_mla_apply_local`` on CPU tensors take
    the reference's switch (naive scores, or the blockwise loop past the
    threshold) and never the kernel's wrapper."""
    def refuse(*a, **kw):
        raise AssertionError("flash_attention_cuda reached on the CPU")

    monkeypatch.setattr(L, "flash_attention_cuda", refuse)
    if threshold is not None:
        monkeypatch.setattr(L, "FLASH_THRESHOLD", threshold)
    cfg = _switch_cfgs()[name]
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 12, cfg.d_model), generator=gen)
    if cfg.mla is not None:
        p = L.mla_init(cfg, gen, torch.float32)
        y = L.mla_apply(cfg, p, x)
    else:
        p = L.attention_init(cfg, gen, torch.float32)
        y = L.attention_apply(cfg, p, x)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def test_meta_tensors_take_the_plain_switch(monkeypatch):
    """The dry run's ``meta`` tensors keep the plain versions too."""
    monkeypatch.setattr(L, "flash_attention_cuda", None)
    cfg = _switch_cfgs()["phi4-mini-3.8b"]
    q = torch.empty((1, 16, 2, 2, 16), device="meta")
    k = torch.empty((1, 16, 2, 16), device="meta")
    out = L._attention_core_ctx(cfg, q, k, k, True)
    assert out.device.type == "meta" and tuple(out.shape) == (1, 16, 2, 2, 16)


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("label,d,dv,dtype,ok", [
    ("phi4 D 128", 128, 128, torch.bfloat16, True),
    ("danube D 120", 120, 120, torch.bfloat16, True),
    ("whisper D 64", 64, 64, torch.bfloat16, True),
    ("MLA 192/128", 192, 128, torch.bfloat16, True),
    ("fp32 D 16", 16, 16, torch.float32, True),
    ("fp16", 128, 128, torch.float16, False),
    ("int8", 128, 128, torch.int8, False),
    ("D 256", 256, 256, torch.bfloat16, False),
    ("D 4 bf16: 8-byte rows", 4, 4, torch.bfloat16, False),
    ("D 100 bf16: 200-byte rows", 100, 100, torch.bfloat16, False),
    ("Dv 192", 192, 192, torch.bfloat16, False),
])
def test_check_on_meta_tensors(label, d, dv, dtype, ok):
    q = _meta((2, 64, 4, 3, d), dtype)
    k = _meta((2, 64, 4, d), dtype)
    v = _meta((2, 64, 4, dv), dtype)
    if ok:
        FA._check(q, k, v, window=16)
    else:
        with pytest.raises((TypeError, ValueError)):
            FA._check(q, k, v)


def test_check_strides_shapes_and_window():
    q = _meta((1, 32, 4, 1, 192))
    k = _meta((1, 32, 4, 192))
    kv = _meta((1, 32, 4, 256))
    FA._check(q, k, kv[..., 128:])        # MLA's v: a strided slice, taken
    with pytest.raises(ValueError):       # a slice off 16-byte columns
        FA._check(q, k, kv[..., 3:131])
    with pytest.raises(ValueError):       # the last dim not contiguous
        FA._check(q, k, _meta((1, 32, 128, 4)).transpose(2, 3))
    with pytest.raises(ValueError):       # k's head dim differs from q's
        FA._check(q, _meta((1, 32, 4, 128)), kv[..., 128:])
    with pytest.raises(ValueError):       # KV heads differ
        FA._check(q, _meta((1, 32, 2, 192)), _meta((1, 32, 2, 128)))
    with pytest.raises(TypeError):        # mixed dtypes
        FA._check(q, k, _meta((1, 32, 4, 128), torch.float32))
    with pytest.raises(ValueError):
        FA._check(q, k, kv[..., 128:], window=0)


def test_cuda_wrapper_refuses_cpu_tensors():
    FA.reset_launches()
    q = torch.zeros((1, 8, 1, 1, 16))
    k = torch.zeros((1, 8, 1, 16))
    with pytest.raises(ValueError):
        FA.flash_attention_cuda(q, k, k)
    with pytest.raises(ValueError):
        FA.flash_attention_fwd_cuda(q, k, k)
    assert FA.flash_attention_cuda.launches == 0
    assert FA.launches_by_pass == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("rt", [None, "sm90", "mma"])
def test_no_route_launch_counted_on_the_cpu(rt):
    """The CUDA entry points refuse CPU tensors on every route and count
    no launch on any."""
    FA.reset_launches()
    q = torch.zeros((1, 8, 1, 1, 16), dtype=torch.bfloat16)
    k = torch.zeros((1, 8, 1, 16), dtype=torch.bfloat16)
    o = torch.zeros((1, 8, 1, 1, 16), dtype=torch.bfloat16)
    lse = torch.zeros((1, 1, 1, 8))
    with pytest.raises(ValueError):
        FA.flash_attention_fwd_cuda(q, k, k, route=rt)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd_cuda(q, k, k, o, lse, o, route=rt)
    assert FA.flash_attention_cuda.launches == 0
    assert FA.launches_by_route == {"sm90": 0, "mma": 0}
    assert FA.launches_by_pass == {"fwd": 0, "bwd": 0}
