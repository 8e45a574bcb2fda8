"""The port's INT8 quantization (``repro_torch.quant``) and its INT8
linear (``repro_torch.kernels.ops``: ``int8_matmul``,
``quantized_linear``) against the JAX package's.

Inputs are numpy draws from a seed.  On the CPU ``int8_matmul`` runs its
plain version and ``cim_mvm`` the bit-serial plain version.  Integer
results are exact (tolerance 0); float32 results agree within
rtol = 1e-6 (the same float32 operations on the same integers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.quant import (dequantize as jdequantize, fake_quant as jfake,
                         quantize_tensor as jquantize,
                         quantize_tree as jquantize_tree)

from repro_torch.kernels import bitserial_mvm as bsm
from repro_torch.kernels import ops, ref
from repro_torch.quant import (QTensor, dequantize, fake_quant,
                               quantize_tensor, quantize_tree)

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rand_int8(rng, m, k, n):
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_tensor_matches_reference(axis, seed):
    """tests/test_substrates.py:109: the int8 codes are identical, the
    scales and the dequantized values equal within float32 rounding."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (16, 8)) * (1 + 9 * seed)).astype(np.float32)
    want = jquantize(jnp.asarray(x), axis)
    got = quantize_tensor(_t(x), axis)
    assert isinstance(got, QTensor) and got.axis == axis
    assert got.q.dtype == torch.int8
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(dequantize(got).numpy(),
                               np.asarray(jdequantize(want)), rtol=1e-6,
                               atol=1e-7)
    err = (dequantize(got) - _t(x)).abs()
    if axis is None:
        assert float(err.max()) <= float(got.scale) * 0.5 + 1e-6


def test_per_channel_beats_per_tensor():
    """tests/test_substrates.py:117."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, 8)).astype(np.float32)
    x[:, 0] *= 100.0                      # one loud channel
    xt = _t(x)
    e_tensor = (dequantize(quantize_tensor(xt)) - xt).abs().mean()
    e_chan = (dequantize(quantize_tensor(xt, axis=1)) - xt).abs().mean()
    assert e_chan < e_tensor


def test_fake_quant_value_and_straight_through_grad():
    """tests/test_substrates.py:128: the value is the reference's, the
    gradient the straight-through one (that of the identity)."""
    x = np.linspace(-1, 1, 32).astype(np.float32)
    want_v = jfake(jnp.asarray(x))
    want_g = jax.grad(lambda v: jnp.sum(jfake(v) ** 2))(jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = fake_quant(xt)
    (y ** 2).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_v),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g),
                               rtol=1e-6, atol=1e-7)


def test_quantize_tree_matches_reference():
    rng = np.random.default_rng(5)
    tree = {"layer": {"w": rng.normal(0, 1, (4, 6)).astype(np.float32),
                      "b": rng.normal(0, 1, (6,)).astype(np.float32)},
            "ids": np.arange(6, dtype=np.int32).reshape(2, 3)}
    want = jquantize_tree(jax.tree.map(jnp.asarray, tree))
    got = quantize_tree({"layer": {k: _t(v) for k, v in
                                   tree["layer"].items()},
                         "ids": _t(tree["ids"])})
    np.testing.assert_array_equal(got["layer"]["w"].q.numpy(),
                                  np.asarray(want["layer"]["w"].q))
    assert isinstance(got["layer"]["b"], torch.Tensor)
    np.testing.assert_array_equal(got["ids"].numpy(), tree["ids"])


@pytest.mark.parametrize("shape", [(96, 160, 72), (1, 147, 64),
                                   (37, 100, 59), (4, 3072, 1024)])
def test_int8_matmul_identical_to_cim_mvm_and_reference(shape):
    """tests/test_kernels.py:97, plus the ragged K = 147 of the first
    conv and a decode projection: bit-identical everywhere."""
    x, w = _rand_int8(np.random.default_rng(sum(shape)), *shape)
    got = ops.int8_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ops.cim_mvm(_t(x),
                                                           _t(w)).numpy())
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.int8_matmul(x, w)))


def test_int8_matmul_wraps_like_int32():
    """K * 16384 = 2^31 + 16384 products of (-128)(-128) wrap modulo
    2^32, as the reference's int32 accumulation does."""
    k = (1 << 17) + 1
    x = torch.full((1, k), -128, dtype=torch.int8)
    w = torch.full((k, 2), -128, dtype=torch.int8)
    want = (k * 16384 + 2**31) % 2**32 - 2**31
    assert ops.int8_matmul(x, w).tolist() == [[want, want]]


def test_int8_matmul_casts_and_counts_no_cpu_launch():
    before = bsm.int8_matmul_cuda.launches
    x = torch.tensor([[1, -2, 3]], dtype=torch.int32)
    w = torch.tensor([[1], [1], [1]], dtype=torch.int64)
    assert ops.int8_matmul(x, w).tolist() == [[2]]
    assert bsm.int8_matmul_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        bsm.int8_matmul_cuda(x.to(torch.int8), w.to(torch.int8))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["int8_matmul", "cim_mvm"])
def test_quantized_linear_forward_and_grads(use_pallas):
    """tests/test_kernels.py:132: the forward of both routes equals the
    reference's and ``quantized_linear_ref``; the straight-through
    gradients equal the reference's ``custom_vjp`` (tolerance 1e-6)."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 1, (8, 32)).astype(np.float32)
    w = rng.integers(-128, 128, (32, 16)).astype(np.int8)
    a_s, w_s = np.float32(0.02), np.float32(0.01)
    jscales = (jnp.float32(a_s), jnp.float32(w_s))
    want = jops.quantized_linear(jnp.asarray(x), jnp.asarray(w), jscales,
                                 use_pallas)
    xt = _t(x).requires_grad_(True)
    y = ops.quantized_linear(xt, _t(w), (float(a_s), float(w_s)),
                             use_pallas=use_pallas)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want),
                               rtol=1e-6)
    np.testing.assert_allclose(
        y.detach().numpy(),
        ref.quantized_linear_ref(_t(x), _t(w), float(w_s),
                                 float(a_s)).numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jref.quantized_linear_ref(jnp.asarray(x), jnp.asarray(w),
                                             w_s, a_s)), rtol=1e-6)
    # straight-through dx via autograd, against jax.grad of the custom_vjp
    g = rng.normal(0, 1, (8, 16)).astype(np.float32)
    y.backward(_t(g))
    jdx = jax.grad(lambda xx: jnp.sum(jops.quantized_linear(
        xx, jnp.asarray(w), jscales, use_pallas) * g))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jdx), rtol=1e-5,
                               atol=1e-6)
    # the whole backward rule, dw included, against the reference's
    dx, dw, (da, dws) = ops._ql_bwd(use_pallas, (_t(x), _t(w),
                                                 (float(a_s), float(w_s))),
                                    _t(g))
    jdx2, jdw, _ = jops._ql_bwd(use_pallas, (jnp.asarray(x), jnp.asarray(w),
                                             jscales), jnp.asarray(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx2), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), rtol=1e-5,
                               atol=1e-4)
    assert float(da) == 0.0 and float(dws) == 0.0


def test_quantized_linear_float_weight_view_gets_ste_grad():
    """A float weight holding int8 values (a QAT view) receives the
    straight-through ``dw``; an int8 weight receives none."""
    rng = np.random.default_rng(2)
    x = _t(rng.normal(0, 1, (4, 8)).astype(np.float32))
    w = _t(rng.integers(-128, 128, (8, 3)).astype(np.float32))
    w.requires_grad_(True)
    y = ops.quantized_linear(x, w, (0.05, 0.01))
    y.sum().backward()
    np.testing.assert_allclose(w.grad.numpy(),
                               (x.T @ torch.ones(4, 3) / 0.01).numpy(),
                               rtol=1e-6)
