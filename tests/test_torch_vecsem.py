"""The port's integer vector semantics and batched im2col / max-pool
against the JAX package's numpy definitions.

Inputs are drawn with numpy from a fixed seed; every comparison is
integer equality (tolerance 0).
"""

import numpy as np
import pytest
import torch

from repro.core import ref as jref
from repro.core import vecsem as jvs
from repro_torch.core import ref, vecsem

# small tensors: one intra-op thread keeps the parallel test processes
# from crowding each other's cores (the timing-sensitive tests among them)
torch.set_num_threads(1)

RNG = np.random.default_rng(5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rows(n):
    """Random rows plus the corner rows: all -128, all equal, extremes."""
    r = RNG.integers(-128, 128, (6, n)).astype(np.int8)
    corner = np.stack([np.full(n, -128), np.full(n, 7), np.full(n, 127),
                       np.where(np.arange(n) % 2, 127, -128)]
                      ).astype(np.int8)
    return np.concatenate([r, corner])


@pytest.mark.parametrize("n", [1, 2, 16, 128, 257])
def test_softmax_i8(n):
    x = _rows(n)
    np.testing.assert_array_equal(vecsem.softmax_i8(_t(x)).numpy(),
                                  jvs.softmax_i8(x))


@pytest.mark.parametrize("n", [1, 2, 16, 512, 1000])
def test_layernorm_i8(n):
    x = _rows(n)
    np.testing.assert_array_equal(vecsem.layernorm_i8(_t(x)).numpy(),
                                  jvs.layernorm_i8(x))


def test_isqrt_exact_near_squares():
    r = np.arange(0, 3_000_000_000, 7_777_777, dtype=np.int64)
    v = np.concatenate([r * r - 1, r * r, r * r + 1,
                        np.array([2**62 - 1, 2**53 + 1])]).clip(0)
    np.testing.assert_array_equal(vecsem._isqrt(_t(v)).numpy(),
                                  jvs._isqrt(v))


def test_gelu_i8_all_inputs():
    x = np.arange(-128, 128, dtype=np.int8).reshape(4, 64)
    np.testing.assert_array_equal(vecsem.gelu_i8(_t(x)).numpy(),
                                  jvs.gelu_i8(x))


def test_luts_identical():
    np.testing.assert_array_equal(vecsem.EXP2_LUT, jvs.EXP2_LUT)
    np.testing.assert_array_equal(vecsem.GELU_LUT, jvs.GELU_LUT)
    assert vecsem.LN_GAIN == jvs.LN_GAIN


@pytest.mark.parametrize("transpose,rows,k,n,groups", [
    (True, 16, 32, 16, 4),       # Q·Kᵀ: rows are positions
    (False, 16, 16, 32, 4),      # P·V: rows are weight rows
    (True, 8, 8, 8, 1),
    (False, 1, 1, 24, 3),        # single-row producer
])
def test_dynamic_weight_matrix(transpose, rows, k, n, groups):
    w = k if transpose else n
    bsz = 3
    buf = RNG.integers(-128, 128, (bsz, rows, groups * w)).astype(np.int8)
    got = vecsem.dynamic_weight_matrix(_t(buf), k, n, groups, transpose)
    assert tuple(got.shape) == (bsz, groups * k, groups * n)
    for s in range(bsz):
        np.testing.assert_array_equal(
            got[s].numpy(),
            jvs.dynamic_weight_matrix(buf[s], k, n, groups, transpose))


@pytest.mark.parametrize("hwc,k,stride,pad,dw", [
    ((8, 8, 3), 3, 1, 1, False),
    ((9, 9, 4), 3, 2, 1, False),
    ((7, 5, 2), 1, 1, 0, False),
    ((11, 11, 3), 7, 2, 3, False),
    ((8, 8, 16), 3, 1, 1, True),
    ((9, 9, 6), 3, 2, 1, True),
    ((6, 6, 4), 5, 1, 2, True),
])
def test_im2col(hwc, k, stride, pad, dw):
    x = RNG.integers(-128, 128, (2,) + hwc).astype(np.int8)
    got = ref.im2col(_t(x), k, k, stride, pad, dw)
    for s in range(2):
        np.testing.assert_array_equal(
            got[s].numpy(), jref.im2col(x[s], k, k, stride, pad, dw))


@pytest.mark.parametrize("hw,k,stride,pad", [
    ((8, 8), 3, 2, 1), ((112, 112), 3, 2, 1), ((7, 7), 2, 2, 0),
    ((5, 6), 3, 1, 1), ((9, 9), 3, 3, 0),
])
def test_maxpool_zero_init(hw, k, stride, pad):
    """max(0, max over the valid positions), negatives included."""
    h, w = hw
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    y = RNG.integers(-128, 128, (2, h, w, 3)).astype(np.int8)
    got = ref._maxpool(_t(y), k, stride, pad, ho, wo)
    for s in range(2):
        want = np.zeros((ho, wo, 3), np.int8)
        for py in range(ho):
            for px in range(wo):
                for jy in range(k):
                    for jx in range(k):
                        iy, ix = py * stride - pad + jy, px * stride - pad + jx
                        if 0 <= iy < h and 0 <= ix < w:
                            want[py, px] = np.maximum(want[py, px],
                                                      y[s, iy, ix])
        np.testing.assert_array_equal(got[s].numpy(), want)


def test_quantize_and_saturation():
    acc = RNG.integers(-2**31, 2**31, (4, 33)).astype(np.int32)
    for scale, shift, div in [(1, 0, 1), (5, 9, 1), (1, 3, 49)]:
        q = ref.QuantParams(scale=scale, shift=shift)
        np.testing.assert_array_equal(
            ref.quantize(_t(acc), q, div).numpy(),
            jref.quantize(acc, jref.QuantParams(scale=scale, shift=shift),
                          div))
    a = RNG.integers(-128, 128, (64,)).astype(np.int8)
    b = RNG.integers(-128, 128, (64,)).astype(np.int8)
    np.testing.assert_array_equal(ref._sat_add(_t(a), _t(b)).numpy(),
                                  jref._sat_add(a, b))
    np.testing.assert_array_equal(ref._sat_mul(_t(a), _t(b)).numpy(),
                                  jref._sat_mul(a, b))


def test_weight_matrix_builders():
    ker = RNG.integers(-6, 7, (3, 3, 4, 8)).astype(np.int8)
    np.testing.assert_array_equal(ref.conv_weight_matrix(ker),
                                  jref.conv_weight_matrix(ker))
    dker = RNG.integers(-6, 7, (3, 3, 5)).astype(np.int8)
    np.testing.assert_array_equal(ref.dwconv_weight_matrix(dker),
                                  jref.dwconv_weight_matrix(dker))
