"""The port's LM serving entry point (``python -m repro_torch.launch.serve``)
and what it stands on (``data``, ``launch.steps``, ``launch.tuning``,
``launch.meshctx``) against the JAX package's.

The CLI runs on the CPU (``--device cpu``: the decode kernels' plain
versions) on reduced configs.  For the greedy run the served
parameters are the reference's, carried across with
``convert.from_jax_params``; its tokens must equal the reference loop's
and its last logits agree within rtol = atol = 2e-4 (float32).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.data import SyntheticStream as JStream, make_batch as jmake_batch
from repro.models import transformer as JT

from repro_torch.configs import ARCHS as TARCHS, ShapeConfig
from repro_torch.convert import from_jax_params
from repro_torch.data import SyntheticStream, make_batch
from repro_torch.launch import serve as S
from repro_torch.launch import steps, tuning
from repro_torch.models import transformer as T

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ["whisper-small", "llava-next-mistral-7b",
                                  "phi4-mini-3.8b"])
def test_make_batch_copied(name):
    cfg = reduced(ARCHS[name])
    for step in (0, 3):
        want = jmake_batch(cfg, 4, 16, seed=7, step=step, shard=1,
                           n_shards=2)
        got = make_batch(reduced(TARCHS[name]), 4, 16, seed=7, step=step,
                         shard=1, n_shards=2)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_synthetic_stream_restores():
    cfg = reduced(TARCHS["phi4-mini-3.8b"])
    s = SyntheticStream(cfg, 2, 8, seed=3)
    first = [next(s)["tokens"] for _ in range(3)]
    state = s.state_dict()
    s.close()
    r = SyntheticStream.restore(cfg, 2, 8, state)
    nxt = next(r)["tokens"]
    r.close()
    j = JStream(reduced(ARCHS["phi4-mini-3.8b"]), 2, 8, seed=3,
                start_step=3)
    np.testing.assert_array_equal(nxt, next(j)["tokens"])
    j.close()
    assert state == {"step": 3, "seed": 3}
    assert len(first) == 3


def test_cli_prints_reference_lines(capsys):
    """The documented CPU command prints the reference's three lines."""
    argv = ["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "8", "--gen", "8"]
    assert S.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "arch=mamba2-780m-smoke batch=2 prompt=8 gen=8"
    assert re.fullmatch(r"prefill: \d+\.\d\ds  decode: \d+\.\d\ds "
                        r"\(\d+\.\d tok/s\)", lines[1]), lines[1]
    ids = re.fullmatch(r"sample token ids: \[(.*)\]", lines[2])
    assert ids and len(ids.group(1).split(",")) == 8


def _reference_greedy(cfg, params, batch_size, prompt_len, gen, seed):
    """The reference serve.py's loop (launch/serve.py:57-86) at
    temperature 0 on one device."""
    batch = {k: jnp.asarray(v) for k, v in jmake_batch(
        cfg, batch_size, prompt_len, seed=seed, step=0).items()}
    enc = (JT._run_encoder(cfg, JT.cast_params(cfg, params),
                           batch["frames"]) if cfg.encoder_layers else None)
    state = JT.init_decode_state(cfg, params, batch_size, prompt_len + gen,
                                 enc=enc)
    step = jax.jit(lambda st, tok: JT.decode_step(cfg, params, st, tok))
    logits = None
    for t in range(prompt_len):
        logits, state = step(state, batch["tokens"][:, t:t + 1])
    out = []
    for _ in range(gen):
        nxt = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
        out.append(np.asarray(nxt))
        logits, state = step(state, nxt)
    return np.asarray(logits), np.concatenate(out, axis=1)


@pytest.mark.parametrize("name", ["phi4-mini-3.8b", "h2o-danube-3-4b",
                                  "mamba2-780m"])
def test_greedy_serve_matches_reference(name, monkeypatch):
    """Greedy decoding through ``serve`` (h2o-danube's 16-slot ring
    wraps: prompt 12 + gen 12) equals the reference's loop."""
    cfg = reduced(ARCHS[name])
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(reduced(TARCHS[name]),
                              jax.tree.map(np.asarray, params), "cpu")
    monkeypatch.setattr(S.T, "init_params", lambda *a, **k: tparams)
    args = S.parser().parse_args(
        ["--arch", name, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "12", "--gen", "12", "--temperature", "0"])
    out = S.serve(args)
    want_logits, want_tokens = _reference_greedy(cfg, params, 2, 12, 12, 0)
    np.testing.assert_array_equal(out["tokens"], want_tokens)
    np.testing.assert_allclose(out["logits"].numpy(), want_logits, **TOL)


def test_sampling_is_seeded():
    argv = ["--arch", "phi4-mini-3.8b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "4", "--gen", "6"]
    a = S.serve(S.parser().parse_args(argv))["tokens"]
    b = S.serve(S.parser().parse_args(argv))["tokens"]
    c = S.serve(S.parser().parse_args(argv + ["--seed", "1"]))["tokens"]
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 6) and not np.array_equal(a, c)


def test_int8_kv_cache_serves():
    argv = ["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "10", "--gen", "10",
            "--temperature", "0"]
    with tuning.tuned(int8_kv_cache=True):
        out = S.serve(S.parser().parse_args(argv))
    assert tuning.FLAGS["int8_kv_cache"] is False
    assert bool(torch.isfinite(out["logits"]).all())


def test_production_mesh_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        S.main(["--reduced", "--device", "cpu", "--production-mesh"])


def test_decode_step_casts_once():
    cfg = dataclasses.replace(reduced(TARCHS["phi4-mini-3.8b"]),
                              compute_dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    fn, spec = steps.make_decode_step(cfg, "cpu",
                                      ShapeConfig("t", 8, 2, "decode"))
    assert spec == {"token": ((2, 1), torch.int32)}
    casts = []
    real = T.cast_params
    try:
        T.cast_params = lambda c, p: casts.append(1) or real(c, p)
        state = T.init_decode_state(cfg, params, 2, 8)
        tok = torch.zeros((2, 1), dtype=torch.int32)
        for _ in range(3):
            logits, state = fn(params, state, tok)
    finally:
        T.cast_params = real
    assert state["pos"] == 3 and logits.dtype == torch.float32
    # one cast by the step, then decode_step's no-op checks
    assert len(casts) == 4
    assert state["caches"][0]["attn0"]["k"].dtype == torch.bfloat16
