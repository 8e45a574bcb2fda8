"""The LM decode kernels' grid planners and the attention kernel's split
algorithm, on the CPU.

The CUDA attention kernel cuts the slots it reads into splits
(:func:`attention_splits`) and combines the splits' (m, l, acc)
partials in its last block; :func:`gqa_decode_attention_splits_ref` is
that algorithm as plain tensor code.  It is held to the plain version
and to the reference's attention core (``repro.models.layers``
:305-325, with its ``_kv_load``) on float32 inputs within rtol = atol =
2e-4 (the same sums in another order and split; the largest gap seen is
about 1e-6).  The SSD step's planner (:func:`ssd_grid`) must cover the
head dimension exactly.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
from repro.models import layers as JL

from repro_torch.kernels import decode_attention as DA, ssd_decode as SD

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
H100_SMS = 132
# chip_smoke.py's 10a cases: (B, KV, slots read, D, cache bytes)
CASES_10A = [(2, 8, 8, 128, 2), (4, 8, 64, 128, 2), (32, 8, 4096, 128, 2),
             (32, 8, 4096, 128, 1), (8, 8, 32768, 128, 2),
             (8, 8, 32768, 128, 1), (4, 8, 4096, 120, 2),
             (4, 8, 4096, 120, 1), (4, 8, 5120, 120, 2),
             (4, 8, 5120, 120, 1), (2, 8, 8, 128, 4)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_plan(b, kv, s_end, d, elem):
    boxes = DA.row_boxes(kv, d, elem)
    # every head's columns fit its boxes from their 16-byte aligned start
    assert all((h * d * elem) % 16 + d * elem <= boxes * DA.BOX
               for h in range(kv))
    nsp, chunk = DA.attention_splits(b * kv, s_end, boxes, H100_SMS)
    per_stage = DA.stage_slots(boxes)
    assert per_stage % 8 == 0 and per_stage >= 8
    assert 2 * per_stage * boxes * DA.BOX <= DA.STAGE_BYTES
    assert chunk % per_stage == 0 and 1 <= nsp <= 65535
    # the last block's combine keeps each split's m and l for up to 8
    # query heads, and 16 more floats, in a 2-stage ring
    assert 2 * nsp * 8 + 16 <= 2 * DA.STAGE_BYTES // 4
    covered = np.zeros(s_end, dtype=int)
    for sp in range(nsp):
        lo, hi = sp * chunk, min((sp + 1) * chunk, s_end)
        assert lo < hi, (sp, lo, hi)               # no split is empty
        covered[lo:hi] += 1
    assert (covered == 1).all()                    # every slot once
    return nsp


@pytest.mark.parametrize("b,kv,s_end,d,elem", CASES_10A)
def test_attention_splits_cover_the_10a_cases(b, kv, s_end, d, elem):
    nsp = _check_plan(b, kv, s_end, d, elem)
    if (b, s_end) == (4, 64):
        assert nsp == 1                            # 10c's serving shape
    if s_end == 32768:
        assert nsp > 1


@settings(max_examples=200, deadline=None)
@given(b=st.integers(1, 128), kv=st.integers(1, 32),
       s_end=st.integers(1, 1 << 17), elem=st.sampled_from([1, 2, 4]),
       d4=st.integers(1, 32))
def test_attention_splits_cover_drawn_shapes(b, kv, s_end, elem, d4):
    _check_plan(b, kv, s_end, 4 * d4, elem)


def _reference_core(q, k, v, pos, window):
    """repro's attention_decode core (layers.py:305-325) on given q and
    caches, in jnp."""
    s_cache = k.shape[1]
    idx = jnp.arange(s_cache)
    slot = pos % s_cache
    wraps = (pos // s_cache) * s_cache
    abs_pos = jnp.where(idx <= slot, wraps + idx, wraps - s_cache + idx)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= abs_pos > pos - window
    q = jnp.asarray(q)
    scores = jnp.einsum("bkgd,bskd->bkgs", q,
                        JL._kv_load(jnp.asarray(k), q.dtype)) / np.sqrt(
                            q.shape[-1])
    scores = jnp.where(valid, scores.astype(jnp.float32), -1e30)
    probs = jax.nn.softmax(scores, -1).astype(q.dtype)
    return np.asarray(jnp.einsum("bkgs,bskd->bkgd", probs,
                                 JL._kv_load(jnp.asarray(v), q.dtype)))


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("pos", [0, 5, 15, 16, 37])
@pytest.mark.parametrize("window", [None, 16, 7])
def test_split_combine_matches_plain_and_reference_core(chunk, pos, window):
    """The kernel's split partials and combine == the plain version and
    repro's core, ring positions before and after a wrap, with and
    without a window, on float32 caches."""
    rng = np.random.default_rng(pos * 7 + (window or 0) + chunk)
    b, s_cache, kv, g, d = 2, 16, 2, 3, 8
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s_cache, kv, d)).astype(np.float32)
    got = DA.gqa_decode_attention_splits_ref(_t(q), _t(k), _t(v), pos,
                                             window, chunk)
    plain = DA.gqa_decode_attention_ref(_t(q), _t(k), _t(v), pos, window)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(),
                               _reference_core(q, k, v, pos, window), **TOL)


@pytest.mark.parametrize("pos", [4, 40])
def test_split_combine_int8_cache_matches_reference_core(pos):
    """An INT8 cache (scale 1/64) through the split combine, cut every
    5 slots, under a 16-slot window."""
    rng = np.random.default_rng(pos)
    b, s_cache, kv, g, d = 2, 24, 2, 4, 16
    q = rng.standard_normal((b, kv, g, d)).astype(np.float32)
    k = rng.integers(-127, 128, (b, s_cache, kv, d), dtype=np.int8)
    v = rng.integers(-127, 128, (b, s_cache, kv, d), dtype=np.int8)
    got = DA.gqa_decode_attention_splits_ref(_t(q), _t(k), _t(v), pos, 16, 5)
    np.testing.assert_allclose(got.numpy(),
                               _reference_core(q, k, v, pos, 16), **TOL)


@pytest.mark.parametrize("batch", [2, 4, 128])
def test_ssd_grid_covers_head_dim(batch):
    """mamba2-780m's 48 heads, d_state 128, head_dim 64: the slices
    cover P exactly, rows stay at least 32 columns, every SM gets a
    program (B 2 is cut), and B 4 and 128 keep whole rows."""
    nh, n, p = 48, 128, 64
    bp = SD.ssd_grid(batch * nh, p, H100_SMS)
    blocks = math.ceil(p / bp)
    assert bp >= 32 and bp & (bp - 1) == 0
    assert (blocks - 1) * bp < p <= blocks * bp
    covered = np.zeros(p, dtype=int)
    for i in range(blocks):
        covered[i * bp:min((i + 1) * bp, p)] += 1
    assert (covered == 1).all()
    assert batch * nh * blocks >= H100_SMS
    assert (bp == p) == (batch * nh >= H100_SMS)
