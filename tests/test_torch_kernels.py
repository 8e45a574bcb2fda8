"""The port's bit-serial MVM (plain path) against the JAX package.

Same inputs, drawn with numpy from a fixed seed, go through
``repro.kernels`` (Pallas in interpret mode, the jnp oracles) and
``repro_torch.kernels`` on the CPU, where the wrapper runs the kernel's
plain PyTorch version.  Digital CIM arithmetic is exact: every
comparison is integer equality (tolerance 0).  The CUDA kernel itself is
held to the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.codegen import QuantParams as JQuantParams
from repro.core.ref import quantize as j_quantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import bitserial_mvm as bsm
from repro_torch.kernels.bitserial_mvm import bitserial_mvm

RNG = np.random.default_rng(11)

ALIGNED = [(128, 128, 128), (256, 128, 384), (128, 512, 128)]
RAGGED = [(1, 1, 1), (37, 100, 59), (128, 129, 130), (200, 64, 1000),
          (5, 4096, 8), (511, 27, 64)]
# (M, K, N) of every MVM the main path launches: resnet18@224 batch 4
# and the default transformer (PERF.md's per-shape table)
MAIN_PATH = [(50176, 147, 64), (12544, 576, 64), (3136, 576, 128),
             (3136, 1152, 128), (3136, 64, 128), (784, 1152, 256),
             (784, 2304, 256), (784, 128, 256), (196, 2304, 512),
             (196, 4608, 512), (196, 256, 512), (4, 512, 1000),
             (128, 512, 512), (128, 512, 1024), (128, 1024, 512),
             (128, 512, 2048), (128, 2048, 512), (128, 512, 32000)]
DEEP_K = [(196, 4608, 512), (784, 2304, 256), (128, 2048, 512),
          (128, 1024, 512), (128, 512, 512)]


def _rand(m, k, n, lo=-128, hi=128):
    x = RNG.integers(lo, hi, (m, k)).astype(np.int8)
    w = RNG.integers(-128, 128, (k, n)).astype(np.int8)
    return x, w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("m,k,n", ALIGNED + RAGGED)
def test_cim_mvm_matches_pallas(m, k, n):
    x, w = _rand(m, k, n)
    got = ops.cim_mvm(_t(x), _t(w))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    want = np.asarray(jops.cim_mvm(jnp.asarray(x), jnp.asarray(w),
                                   interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.mvm_ref(jnp.asarray(x),
                                             jnp.asarray(w))))


@pytest.mark.parametrize("m,k,n", [(64, 96, 32), (37, 100, 59)])
def test_refs_match_jax_refs(m, k, n):
    x, w = _rand(m, k, n)
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    np.testing.assert_array_equal(ref.mvm_ref(_t(x), _t(w)).numpy(),
                                  np.asarray(jref.mvm_ref(jx, jw)))
    np.testing.assert_array_equal(
        ref.bitserial_mvm_ref(_t(x), _t(w)).numpy(),
        np.asarray(jref.bitserial_mvm_ref(jx, jw)))


@pytest.mark.parametrize("act_bits", [4, 6, 8])
def test_reduced_precision_matches_pallas(act_bits):
    """Every act_bits, on full-range int8 activations: the planes above
    act_bits are dropped the same way on both sides."""
    x, w = _rand(64, 128, 64)
    got = ops.cim_mvm(_t(x), _t(w), act_bits=act_bits)
    want = np.asarray(jops.cim_mvm(jnp.asarray(x), jnp.asarray(w),
                                   act_bits=act_bits, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ref.bitserial_mvm_ref(_t(x), _t(w), act_bits=act_bits).numpy(),
        np.asarray(jref.bitserial_mvm_ref(jnp.asarray(x), jnp.asarray(w),
                                          act_bits=act_bits)))


def test_unsigned_seven_planes():
    x, w = _rand(32, 64, 16, lo=0, hi=128)
    got = ops.cim_mvm(_t(x), _t(w), act_bits=7, signed=False)
    want = np.asarray(jops.cim_mvm(jnp.asarray(x), jnp.asarray(w),
                                   act_bits=7, signed=False,
                                   interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("blocks", [(128, 128, 128), (32, 64, 96),
                                    (8, 8, 4), (64, 32, 256)])
def test_blocks_affect_nothing(blocks):
    x, w = _rand(160, 192, 96)
    bm, bn, bk = blocks
    got = ops.cim_mvm(_t(x), _t(w), block_m=bm, block_n=bn, block_k=bk)
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int32) @ w.astype(np.int32))


def test_int32_wraparound():
    """|sum| past 2**31 wraps as int32 arithmetic does (K = 2**17 + 1
    products of (-128)*(-128))."""
    k = (1 << 17) + 1
    x = np.full((2, k), -128, np.int8)
    w = np.full((k, 3), -128, np.int8)
    want = ((np.int64(k) * 16384 + 2**31) % 2**32 - 2**31).astype(np.int32)
    for out in (ref.mvm_ref(_t(x), _t(w)),
                ref.bitserial_mvm_ref(_t(x), _t(w))):
        assert out.dtype == torch.int32
        assert (out.numpy() == want).all()


def test_requant_is_int64_quantize():
    """requant_ref == repro.core.ref.quantize in true int64, including
    products acc*scale past int32."""
    acc = np.concatenate([RNG.integers(-100000, 100000, 64),
                          RNG.integers(-2**31, 2**31, 64)]).astype(np.int32)
    for scale, shift, div in [(1, 8, 1), (3, 12, 1), (1, 4, 49),
                              (32767, 30, 1), (7, 0, 1)]:
        got = ref.requant_ref(_t(acc), scale, shift, div)
        want = j_quantize(acc, JQuantParams(scale=scale, shift=shift),
                          div=div)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)


def test_quantized_linear_ref_matches_jax():
    x = RNG.normal(0, 1, (8, 32)).astype(np.float32)
    w = RNG.integers(-128, 128, (32, 16)).astype(np.int8)
    got = ref.quantized_linear_ref(_t(x), _t(w), 0.01, 0.02)
    want = jref.quantized_linear_ref(jnp.asarray(x), jnp.asarray(w),
                                     0.01, 0.02)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_plain_path_counts_no_launch():
    x, w = _rand(128, 128, 128)
    before = bitserial_mvm.launches
    bitserial_mvm(_t(x), _t(w))
    assert bitserial_mvm.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "blocks", "device"])
def test_wrapper_rejects(bad):
    x, w = _t(_rand(128, 128, 128)[0]), _t(_rand(128, 128, 128)[1])
    kw = {}
    if bad == "dtype":
        x = x.to(torch.int32)
        err = TypeError
    elif bad == "shape":
        x = x[:100]
        err = ValueError
    elif bad == "blocks":
        kw = dict(block_m=12)
        err = ValueError
    else:
        x, w = x.to("meta"), w.to("meta")
        err = ValueError
    with pytest.raises(err):
        bitserial_mvm(x, w, **kw)


def test_pad_to():
    a = torch.arange(6, dtype=torch.int8).reshape(2, 3)
    p = ops.pad_to(a, (4, 4))
    assert tuple(p.shape) == (4, 4)
    assert torch.equal(p[:2, :3], a) and int(p.abs().sum()) == 15
    np.testing.assert_array_equal(
        ops.pad_to(a, (2, 3)).numpy(),
        np.asarray(jops.pad_to(jnp.asarray(a.numpy()), (2, 3))))


@pytest.mark.parametrize("m,k,n", MAIN_PATH + RAGGED + ALIGNED)
def test_chooser_legal(m, k, n):
    """The tile/split chooser returns a configuration the kernel takes,
    and no K slice is empty."""
    bm, bn, bk = bsm.choose_blocks(m, n, k)
    bsm.check_tile(bm, bn, bk)
    split = -(-k // bk)
    assert split >= 1 and (split - 1) * bk < k
    assert split <= 65535 and -(-n // bn) <= 65535


def test_chooser_small_m_takes_the_16_row_tile():
    """M <= 16 always, and M <= 128 when no larger tile fills the card;
    larger M keeps a 64-row tile, and a grid that fills the card with
    big tiles keeps them (the LM head)."""
    assert bsm.choose_blocks(4, 1000, 512)[:2] == (16, 64)
    assert bsm.choose_blocks(4, 32000, 512)[:2] == (16, 64)
    assert bsm.choose_blocks(1, 1, 1)[:2] == (16, 64)
    assert bsm.choose_blocks(128, 512, 512, sms=132)[:2] == (16, 64)
    assert bsm.choose_blocks(129, 64, 64, sms=132)[:2] == (64, 64)
    assert bsm.choose_blocks(196, 512, 4608, sms=132)[:2] == (64, 64)
    assert bsm.choose_blocks(128, 32000, 512, sms=132)[:2] == (128, 128)
    assert bsm.choose_blocks(50176, 64, 147, sms=132)[:2] == (128, 64)


@pytest.mark.parametrize("m,k,n", DEEP_K)
def test_chooser_fills_the_card(m, k, n):
    """Deep-K shapes with few output tiles split K to >= 132 blocks (one
    for each H100 SM), or to one 64-deep step per block where K is too
    shallow for that ((128,512) @ (512,512): 16 tiles x 8 steps)."""
    bm, bn, bk = bsm.choose_blocks(m, n, k, sms=132)
    tiles = -(-m // bm) * -(-n // bn)
    blocks = tiles * -(-k // bk)
    assert blocks >= min(132, tiles * -(-k // bsm.BK))
    assert blocks >= 128


@pytest.mark.parametrize("blocks,ok", [
    ((128, 128, 128), True), ((64, 64, 256), True), ((16, 64, 64), True),
    ((64, 32, 256), False), ((8, 8, 4), False), ((128, 128, 96), False),
    ((64, 64, 0), False)])
def test_check_tile(blocks, ok):
    if ok:
        bsm.check_tile(*blocks)
    else:
        with pytest.raises(ValueError):
            bsm.check_tile(*blocks)


@pytest.mark.parametrize("m,k,n", RAGGED)
def test_cim_mvm_chosen_blocks_match_pallas(m, k, n):
    """cim_mvm with default blocks (the chooser's) on ragged shapes: the
    plain path, held to the JAX cim_mvm in interpret mode on the same
    blocks."""
    x, w = _rand(m, k, n)
    bm, bn, bk = bsm.choose_blocks(m, n, k)
    got = ops.cim_mvm(_t(x), _t(w))
    assert tuple(got.shape) == (m, n)
    want = np.asarray(jops.cim_mvm(jnp.asarray(x), jnp.asarray(w),
                                   block_m=bm, block_n=bn, block_k=bk,
                                   interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_launcher_refuses_cpu_tensors():
    x, w = _rand(16, 64, 16)
    with pytest.raises(ValueError):
        bsm.bitserial_mvm_cuda(_t(x), _t(w))
