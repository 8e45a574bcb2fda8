"""The port's LM (``repro_torch.models``) against the JAX package's.

Parameters come from ``repro.models.model_zoo.init`` and cross to the
port with ``convert.from_jax_params``; inputs are the reference's dummy
batches or numpy draws from a seed.  On the CPU the decode kernels run
their plain versions.  Tolerance: float32 reduced configs agree within
rtol = atol = 2e-4 (the two frameworks sum in other orders; the largest
gap seen is about 3e-5 on logits of magnitude up to 5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.launch import tuning as jtuning
from repro.models import layers as JL
from repro.models import model_zoo as jzoo
from repro.models import ssm as JS
from repro.models import transformer as JT

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.convert import from_jax_params
from repro_torch.kernels import decode_attention as DA, ssd_decode as SD
from repro_torch.launch import meshctx, tuning
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import layers as L, model_zoo, ssm as S
from repro_torch.models import transformer as T

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
BATCH, SEQ, STEPS = 2, 32, 6
CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def built():
    """Per arch: the reference's config, params, batch, forward logits
    and ``STEPS`` decode steps' logits, and the port's params."""
    out = {}
    for name, full in ARCHS.items():
        cfg = reduced(full)
        params = jzoo.init(cfg)
        batch = jzoo.dummy_batch(cfg, BATCH, SEQ)
        fwd = np.asarray(JT.forward(cfg, params, batch, remat=False))
        enc = (JT._run_encoder(cfg, params, batch["frames"])
               if cfg.encoder_layers else None)
        state = JT.init_decode_state(cfg, params, BATCH, SEQ, enc=enc)
        step = jax.jit(lambda st, tok, cfg=cfg, params=params:
                       JT.decode_step(cfg, params, st, tok))
        dec = []
        for t in range(STEPS):
            logits, state = step(state, batch["tokens"][:, t:t + 1])
            dec.append(np.asarray(logits))
        tparams = from_jax_params(treduced(TARCHS[name]),
                                  jax.tree.map(np.asarray, params), CPU)
        tbatch = {k: _t(v) for k, v in batch.items()}
        out[name] = (cfg, tparams, tbatch, fwd, dec)
    return out


def test_configs_copied():
    assert sorted(TARCHS) == sorted(ARCHS)
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(TARCHS[name]) == dataclasses.asdict(cfg)
        assert TARCHS[name].param_count() == cfg.param_count()
        assert dataclasses.asdict(treduced(TARCHS[name])) \
            == dataclasses.asdict(reduced(cfg))


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_forward_matches_reference(built, name):
    cfg, tparams, tbatch, fwd, _ = built[name]
    tcfg = treduced(TARCHS[name])
    got = T.forward(tcfg, tparams, tbatch, remat=False)
    assert got.shape == (BATCH, SEQ, cfg.vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), fwd, **TOL)


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_decode_matches_reference(built, name):
    """``STEPS`` decode steps' logits, the caches carried by the port."""
    cfg, tparams, tbatch, _, dec = built[name]
    tcfg = treduced(TARCHS[name])
    enc = (T._run_encoder(tcfg, T.cast_params(tcfg, tparams),
                          tbatch["frames"]) if tcfg.encoder_layers else None)
    state = T.init_decode_state(tcfg, tparams, BATCH, SEQ, enc=enc)
    assert state["pos"] == 0 and len(state["caches"]) == tcfg.n_blocks
    for t in range(STEPS):
        logits, state = T.decode_step(tcfg, tparams, state,
                                      tbatch["tokens"][:, t:t + 1])
        np.testing.assert_allclose(logits.numpy(), dec[t], **TOL)
    assert state["pos"] == STEPS


def _attn_case(name, seed):
    cfg = reduced(ARCHS[name])
    params = jzoo.init(cfg, seed=seed)
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"])["attn0"]
    tp = {k: _t(v) for k, v in p.items()}
    return cfg, treduced(TARCHS[name]), p, tp


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_attention_decode_ring_matches_reference(int8):
    """h2o-danube's 16-slot ring (window 16) over 40 steps, past two
    wraps (tests/test_models_smoke.py:78), with and without the INT8
    cache; the caches must match the reference's too."""
    cfg, tcfg, p, tp = _attn_case("h2o-danube-3-4b", 3)
    s_cache = JT.cache_len_for(cfg, 64)
    assert s_cache == 16
    rng = np.random.default_rng(0)
    dt = jnp.int8 if int8 else jnp.float32
    shape = (BATCH, s_cache, cfg.n_kv_heads, cfg.hd)
    cache = {"k": jnp.zeros(shape, dt), "v": jnp.zeros(shape, dt)}
    tcache = {"k": torch.zeros(shape, dtype=torch.int8 if int8
                               else torch.float32),
              "v": torch.zeros(shape, dtype=torch.int8 if int8
                               else torch.float32)}
    fn = jax.jit(lambda x, c, pos: JL.attention_decode(cfg, p, x, c, pos))
    for pos in range(40):
        x = rng.standard_normal((BATCH, 1, cfg.d_model)).astype(np.float32)
        want, cache = fn(jnp.asarray(x), cache, jnp.int32(pos))
        got, tcache = L.attention_decode(tcfg, tp, _t(x), tcache, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("k", "v"):
        if int8:
            assert np.array_equal(tcache[k].numpy(), np.asarray(cache[k]))
        else:
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(cache[k]), **TOL)


@pytest.mark.parametrize("pos", [0, 5, 15, 16, 37])
@pytest.mark.parametrize("window", [None, 16, 7])
def test_gqa_decode_attention_plain_matches_reference_core(pos, window):
    """The kernel's plain version == the reference's scores/mask/softmax
    /context (layers.py:305-325) on random caches, ring positions before
    and after a wrap, with and without a window."""
    rng = np.random.default_rng(pos * 7 + (window or 0))
    b, s_cache, kv, g, d = 2, 16, 2, 3, 8
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    idx = jnp.arange(s_cache)
    slot = pos % s_cache
    wraps = (pos // s_cache) * s_cache
    abs_pos = jnp.where(idx <= slot, wraps + idx, wraps - s_cache + idx)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    scores = jnp.einsum("bkgd,bskd->bkgs", q, k) / np.sqrt(d)
    scores = jnp.where(valid, scores, -1e30)
    want = jnp.einsum("bkgs,bskd->bkgd", jax.nn.softmax(scores, -1), v)
    got = DA.gqa_decode_attention(_t(q), _t(k), _t(v), pos, window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert DA.ring_valid(pos, s_cache, window, CPU).numpy().tolist() \
        == np.asarray(valid).tolist()


def test_decode_kernels_count_no_cpu_launch():
    before = (DA.gqa_decode_attention.launches, SD.ssd_decode_step.launches)
    q = torch.zeros((1, 1, 1, 8))
    c = torch.zeros((1, 4, 1, 8))
    DA.gqa_decode_attention(q, c, c, 2)
    h = torch.zeros((1, 2, 4, 8))
    SD.ssd_decode_step(h, torch.zeros((1, 2, 8)), torch.zeros((1, 2)),
                       torch.zeros(2), torch.zeros((1, 1, 4)),
                       torch.zeros((1, 1, 4)), torch.zeros(2))
    assert (DA.gqa_decode_attention.launches,
            SD.ssd_decode_step.launches) == before
    with pytest.raises(TypeError):
        DA.gqa_decode_attention(q, c.to(torch.float64), c, 2)


def test_flash_attention_matches_naive_and_reference():
    """tests/test_models_smoke.py:90: causal, blocks 64 x 32."""
    rng = np.random.default_rng(0)
    b, s, kv, g, d = 2, 256, 2, 2, 16
    q = rng.standard_normal((b, s, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)

    def causal(qi, ki):
        return ki <= qi

    naive = L._gqa_scores_ctx(_t(q), _t(k), _t(v), causal, 0)
    flash = L.flash_attention(_t(q), _t(k), _t(v), causal, block_q=64,
                              block_k=32)
    np.testing.assert_allclose(flash.numpy(), naive.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = JL.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal, block_q=64, block_k=32)
    np.testing.assert_allclose(flash.numpy(), np.asarray(want), **TOL)


def test_flash_attention_sliding_window():
    """tests/test_models_smoke.py:107: window 37, blocks 48 x 64."""
    rng = np.random.default_rng(3)
    b, s, kv, g, d = 1, 192, 1, 2, 8
    q = rng.standard_normal((b, s, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    win = 37

    def mfn(qi, ki):
        return (ki <= qi) & (ki > qi - win)

    naive = L._gqa_scores_ctx(_t(q), _t(k), _t(v), mfn, 0)
    flash = L.flash_attention(_t(q), _t(k), _t(v), mfn, block_q=48,
                              block_k=64)
    np.testing.assert_allclose(flash.numpy(), naive.numpy(), rtol=1e-5,
                               atol=1e-5)
    want = JL._gqa_scores_ctx(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), mfn, 0)
    np.testing.assert_allclose(naive.numpy(), np.asarray(want), **TOL)


def test_ssd_chunked_matches_stepped_and_reference():
    """tests/test_models_smoke.py:125: chunked SSD == the stepped
    recurrence (through the SSD-step kernel's plain version), and both
    == the reference's."""
    cfg = reduced(ARCHS["mamba2-780m"])
    tcfg = treduced(TARCHS["mamba2-780m"])
    params = jzoo.init(cfg)
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["blocks"])["ssm0"]
    tp = {k: _t(v) for k, v in p.items()}
    x = (np.random.default_rng(9).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    y_chunked = S.ssm_apply(tcfg, tp, _t(x))
    state = S.ssm_state_init(tcfg, 2, torch.float32, CPU)
    jstate = JS.ssm_state_init(cfg, 2, jnp.float32)
    jstep = jax.jit(lambda u, st: JS.ssm_decode(cfg, p, u, st))
    ys = []
    for t in range(32):
        y, state = S.ssm_decode(tcfg, tp, _t(x[:, t:t + 1]), state)
        jy, jstate = jstep(jnp.asarray(x[:, t:t + 1]), jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        ys.append(y)
    np.testing.assert_allclose(state["h"].numpy(), np.asarray(jstate["h"]),
                               **TOL)
    y_steps = torch.cat(ys, dim=1)
    np.testing.assert_allclose(y_chunked.numpy(), y_steps.numpy(),
                               rtol=2e-3, atol=2e-4)
    want = JS.ssm_apply(cfg, p, jnp.asarray(x))
    np.testing.assert_allclose(y_chunked.numpy(), np.asarray(want), **TOL)


def test_ssd_decode_step_plain_bf16_state():
    """The plain version stores the state in its own dtype after an fp32
    update (ssm.py:186,192), as the reference does for a bf16 state."""
    rng = np.random.default_rng(1)
    b, nh, g, n, p = 2, 4, 1, 16, 8
    h = rng.standard_normal((b, nh, n, p)).astype(np.float32)
    x = rng.standard_normal((b, nh, p)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, nh))).astype(np.float32)
    a_log = np.log(np.linspace(1, 16, nh)).astype(np.float32)
    bb = rng.standard_normal((b, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, g, n)).astype(np.float32)
    d = np.ones(nh, np.float32)
    bf = jnp.bfloat16
    hj = jnp.asarray(h, bf).astype(jnp.float32)
    hj = hj * jnp.exp(dt * -jnp.exp(a_log))[..., None, None] \
        + dt[..., None, None] * jnp.asarray(bb, bf)[..., :, None] \
        * jnp.asarray(x, bf)[..., None, :].astype(jnp.float32)
    yj = jnp.einsum("bhn,bhnp->bhp",
                    jnp.asarray(cc, bf).astype(jnp.float32), hj) \
        + d[..., None] * jnp.asarray(x, bf).astype(jnp.float32)
    y, hn = SD.ssd_decode_step(_t(h).bfloat16(), _t(x).bfloat16(), _t(dt),
                               _t(a_log), _t(bb).bfloat16(),
                               _t(cc).bfloat16(), _t(d))
    assert hn.dtype == torch.bfloat16 and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(
        hn.float().numpy(), np.asarray(hj.astype(bf).astype(jnp.float32)))


def test_ssd_state_updated_in_place():
    """The SSD step writes the new state over the caller's on the CPU as
    the kernel does on CUDA, through ``ssm_decode`` too."""
    rng = np.random.default_rng(2)
    b, nh, g, n, p = 2, 4, 1, 16, 8
    h = _t(rng.standard_normal((b, nh, n, p)).astype(np.float32))
    args = (_t(rng.standard_normal((b, nh, p)).astype(np.float32)),
            _t(np.abs(rng.standard_normal((b, nh))).astype(np.float32)),
            _t(np.log(np.linspace(1, 16, nh)).astype(np.float32)),
            _t(rng.standard_normal((b, g, n)).astype(np.float32)),
            _t(rng.standard_normal((b, g, n)).astype(np.float32)),
            torch.ones(nh))
    want_y, want_h = SD.ssd_decode_step_ref(h, *args)
    y, hn = SD.ssd_decode_step(h, *args)
    assert hn is h
    assert torch.equal(h, want_h) and torch.equal(y, want_y)

    tcfg = treduced(TARCHS["mamba2-780m"])
    params = jax.tree.map(lambda a: np.asarray(a[0]),
                          jzoo.init(reduced(ARCHS["mamba2-780m"]))["blocks"])
    tp = {k: _t(v) for k, v in params["ssm0"].items()}
    state = S.ssm_state_init(tcfg, 2, torch.float32, CPU)
    h0 = state["h"]
    u = _t(rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32))
    _, new = S.ssm_decode(tcfg, tp, u, state)
    assert new["h"] is h0 and bool(h0.abs().sum() > 0)


def test_phi4_mini_published_widths_one_layer():
    """phi4-mini-3.8b at its published widths (d_model 3072, 24/8 heads
    of 128, d_ff 8192), one layer, vocab 512, float32: 3 decode steps.
    Tolerance 1e-3: K = 8192-deep float32 sums in other orders."""
    cfg = dataclasses.replace(ARCHS["phi4-mini-3.8b"], n_layers=1,
                              vocab=512, compute_dtype="float32")
    tcfg = dataclasses.replace(TARCHS["phi4-mini-3.8b"], n_layers=1,
                               vocab=512, compute_dtype="float32")
    params = jzoo.init(cfg, seed=4)
    tparams = from_jax_params(tcfg, jax.tree.map(np.asarray, params), CPU)
    tokens = np.random.default_rng(4).integers(1, 512, (1, 3)) \
        .astype(np.int32)
    state = JT.init_decode_state(cfg, params, 1, 8)
    tstate = T.init_decode_state(tcfg, tparams, 1, 8)
    step = jax.jit(lambda st, tok: JT.decode_step(cfg, params, st, tok))
    for t in range(3):
        want, state = step(state, jnp.asarray(tokens[:, t:t + 1]))
        got, tstate = T.decode_step(tcfg, tparams, tstate,
                                    _t(tokens[:, t:t + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-3, atol=1e-3)


def test_int8_kv_cache_knob_decodes_like_reference(built):
    """Under ``tuned(int8_kv_cache=True)`` both packages allocate INT8
    caches; 6 steps of phi4-mini (reduced) agree."""
    name = "phi4-mini-3.8b"
    cfg, tparams, tbatch, _, _ = built[name]
    tcfg = treduced(TARCHS[name])
    params = jzoo.init(cfg)
    with jtuning.tuned(int8_kv_cache=True):
        state = JT.init_decode_state(cfg, params, BATCH, SEQ)
    with tuning.tuned(int8_kv_cache=True):
        tstate = T.init_decode_state(tcfg, tparams, BATCH, SEQ)
    assert tstate["caches"][0]["attn0"]["k"].dtype == torch.int8
    step = jax.jit(lambda st, tok: JT.decode_step(cfg, params, st, tok))
    for t in range(STEPS):
        tok = tbatch["tokens"][:, t:t + 1]
        want, state = step(state, jnp.asarray(tok.numpy()))
        got, tstate = T.decode_step(tcfg, tparams, tstate, tok)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cast_params_once_and_idempotent(built):
    cfg = dataclasses.replace(treduced(TARCHS["phi4-mini-3.8b"]),
                              compute_dtype="bfloat16")
    tparams = built["phi4-mini-3.8b"][1]
    cast = T.cast_params(cfg, tparams)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["final_norm"]["w"].dtype == torch.float32   # 1-D stays
    # a block's 1-D leaves are cast, as the reference's stacked ones are
    assert cast["blocks"][0]["norm0"]["w"].dtype == torch.bfloat16
    assert T.cast_params(cfg, cast) is cast
    assert tparams["embed"].dtype == torch.float32


def test_model_zoo_and_mesh_context():
    cfg = treduced(TARCHS["olmoe-1b-7b"])
    params = model_zoo.init(cfg, seed=0, device=CPU)
    batch = model_zoo.dummy_batch(cfg, 2, 8, device=CPU)
    assert model_zoo.batch_spec(cfg, 2, 8) == {
        "tokens": ((2, 8), torch.int32)}
    logits = T.forward(cfg, params, batch)
    assert logits.shape == (2, 8, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    # under the launchers' local mesh MoE takes moe_ep (capacity 1.25:
    # nothing drops here), equal to the dense dispatch
    mesh = make_mesh((1, 1), ("data", "model"))
    with meshctx.use_mesh(mesh, data_axes=("data",)):
        assert meshctx.current().mesh is mesh
        torch.testing.assert_close(T.forward(cfg, params, batch), logits,
                                   **TOL)
    with meshctx.use_mesh(object()):
        assert meshctx.current() is not None
        with pytest.raises(TypeError, match="not a mesh"):
            T.forward(cfg, params, batch)
    assert meshctx.current() is None
