"""The direct INT8 GEMM's planner, its split algorithm and its CPU route
(``repro_torch.kernels.int8_matmul``) against the JAX package's
``int8_matmul``.

The planner sends each shape to the decode-shape stream kernel
(``csrc/int8_matmul.cu``) or to the bit-serial source's tiles; its grid
must cut K into non-empty slices that cover it exactly and fit the card
in one wave.  :func:`int8_matmul_splits_ref` (the kernels' per-slice
int32 partials, then their wrapped sum) and ``ops.int8_matmul`` on the
CPU equal ``repro.kernels.ops.int8_matmul`` bit for bit (tolerance 0) on
seeded numpy inputs, the int32 wrap-around included.
"""

import pkgutil
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops

import repro_torch
from repro_torch.kernels import bitserial_mvm as bsm
from repro_torch.kernels import int8_matmul as I8
from repro_torch.kernels import ops

torch.set_num_threads(1)

H100_SMS = 132
# chip_smoke.py's QL_SHAPES: phi4-mini's decode projections, (M, K, N)
QL_SHAPES = [(4, 3072, 3072), (4, 3072, 1024), (4, 3072, 8192),
             (4, 8192, 3072)]
WRAP_K = (1 << 17) + 1
WRAPPED = (WRAP_K * 16384 + 2**31) % 2**32 - 2**31


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8))


def _jax(x, w):
    return np.asarray(jops.int8_matmul(jnp.asarray(x), jnp.asarray(w)))


@pytest.mark.parametrize("n", [1000, 1024, 3072, 8192])
@pytest.mark.parametrize("m", [1, 4, 16, I8.MAX_M + 1])
def test_plan_routes_by_shape(m, n):
    """The stream kernel takes M <= MAX_M rows with N a multiple of 16;
    large M and ragged N go to the bit-serial source's tiles, with the
    tile and K split of its chooser."""
    p = I8.plan(m, n, 3072, H100_SMS)
    stream = m <= I8.MAX_M and n % 16 == 0
    assert p.route == ("stream" if stream else "tile")
    if not stream:
        bm, bn, bk = bsm.choose_blocks(m, n, 3072, H100_SMS)
        assert p.tile == (bm, bn) and p.k_per_slice == bk


def test_unaligned_view_routes_to_the_tiles():
    """A view one byte into its storage is not 16-byte aligned: the
    wrapper sees it (on any device) and the planner routes it away."""
    base = torch.zeros(4 * 3072 + 16, dtype=torch.int8)
    w = torch.zeros((3072, 1024), dtype=torch.int8)
    x = base[1:1 + 4 * 3072].view(4, 3072)
    assert x.is_contiguous() and not I8.operands_aligned(x, w)
    assert I8.operands_aligned(base[16:16 + 4 * 3072].view(4, 3072), w)
    assert not I8.operands_aligned(w[:4].t(), w)
    assert I8.plan(4, 1024, 3072, H100_SMS, False).route == "tile"
    assert I8.plan(4, 1024, 3072, H100_SMS, True).route == "stream"


PLAN_SHAPES = QL_SHAPES + [
    (1, 64, 16), (3, 3000, 1008), (16, 3000, 1008), (16, 64, 16),
    (1, 1, 16), (8, 63, 48), (9, 4096, 256), (2, WRAP_K, 16),
    (16, 8192, 3072), (16, 3072, 3072), (1, 8192, 256), (4, 14336, 4096)]
# chip_smoke.py's cluster edges, (M, K, N) and (K rows a slice, slices):
# every slice one stage, and the largest (non-portable) cluster
CLUSTER_EDGES = [((4, 256, 1024), (128, 2)), ((16, 65536, 16), (4096, 16))]
PLAN_SHAPES += [shape for shape, _ in CLUSTER_EDGES]


# the most dynamic shared memory an H100 block can opt in to, less the
# kernel's static mbarriers
H100_DYN_SMEM = 232448 - 1024


def _stream_smem(m, k_per_slice):
    """A stream block's shared memory, as the .cu's smem_bytes counts it:
    the ring at a 1024-byte boundary, x's slice twice (as copied and as
    staged), the slots of the partials the block sums."""
    return (1024 + I8.STAGES * I8.ROWS * I8.BOX + 2 * m * k_per_slice
            + m * (I8.BOX // 4 + I8.MAX_SLICES) * 16)


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_stream_plan_covers_k_in_one_wave(m, k, n):
    """Every K slice is non-empty, whole stages but the last, and the
    slices cover K exactly; the grid fits the card at once (one block an
    SM at most), each block's x and shared memory within the kernel's
    limits, one cluster a strip."""
    p = I8.plan(m, n, k, H100_SMS)
    assert p.route == "stream"
    assert p.k_per_slice % I8.ROWS == 0
    assert 1 <= p.slices <= I8.MAX_SLICES
    lows = [s * p.k_per_slice for s in range(p.slices)]
    assert all(lo < k for lo in lows)                  # no slice is empty
    assert (p.slices - 1) * p.k_per_slice < k <= p.slices * p.k_per_slice
    assert p.strips * I8.BOX >= n > (p.strips - 1) * I8.BOX
    assert m * p.k_per_slice <= I8.X_MAX
    assert _stream_smem(m, p.k_per_slice) <= H100_DYN_SMEM
    assert p.blocks <= H100_SMS


def test_stream_smem_fits_at_the_x_limit():
    """x's limit bounds a block's shared memory: at M = MAX_M and the
    largest slice it allows, the block still fits an H100 SM, so the
    planner need not check shared memory on its own."""
    assert _stream_smem(I8.MAX_M, I8.X_MAX // I8.MAX_M) <= H100_DYN_SMEM
    assert _stream_smem(1, I8.X_MAX) <= H100_DYN_SMEM


@pytest.mark.parametrize("shape,split", CLUSTER_EDGES)
def test_cluster_edges_plans(shape, split):
    """The edge cases chip_smoke.py launches for the cluster's combine:
    two slices of one 128-row stage each, and 16 slices (x's limit raises
    the split past SLICES)."""
    m, k, n = shape
    p = I8.plan(m, n, k, H100_SMS)
    assert (p.route, p.k_per_slice, p.slices) == ("stream",) + split


def test_raised_split_may_take_more_waves():
    """Where x's limit raises the split, the grid is not held to one
    wave: 16 x 65536 x 3072 takes 16 slices of its 24 strips."""
    p = I8.plan(16, 3072, 65536, H100_SMS)
    assert (p.route, p.slices, p.strips) == ("stream", 16, 24)
    assert p.blocks > H100_SMS


def test_ql_shapes_plans_pinned():
    """The plans of phi4-mini's decode projections, as chip_smoke.py
    asserts them on the card: (K rows a slice, slices, blocks)."""
    got = [(p.route, p.k_per_slice, p.slices, p.blocks)
           for p in (I8.plan(m, n, k, H100_SMS) for m, k, n in QL_SHAPES)]
    assert got == PINNED


CASES = [(m, k, n) for m, (k, n) in zip(
    range(1, 17), [(k, n) for k in (1, 63, 64, 3000) for n in (16, 48, 1008)]
    + [(3000, 1008), (64, 48), (63, 16), (1, 1008)])]
CASES += [(m, k, n) for m in (4, 16) for k in (1, 63, 64, 3000)
          for n in (16, 48, 1008)]
CASES += [shape for shape, _ in CLUSTER_EDGES]


@pytest.mark.parametrize("m,k,n", CASES)
def test_matches_reference(m, k, n):
    """``ops.int8_matmul`` on the CPU and the kernels' split algorithm
    under the shape's plan equal the JAX package's int8_matmul."""
    x, w = _rand(m * 7919 + k * 31 + n, m, k, n)
    want = _jax(x, w)
    got = ops.int8_matmul(_t(x), _t(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    p = I8.plan(m, n, k, H100_SMS)
    np.testing.assert_array_equal(
        I8.int8_matmul_splits_ref(_t(x), _t(w), p).numpy(), want)


@pytest.mark.parametrize("slices", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("m,k,n", [(5, 3000, 1008), (16, 4096, 48)])
def test_splits_ref_any_split(m, k, n, slices):
    """The split algorithm is exact whatever the split: per-slice int32
    partials of whole 128-row stages, summed with wrap-around."""
    x, w = _rand(slices, m, k, n)
    steps = -(-k // I8.ROWS)
    per = -(-steps // slices)
    p = I8.Plan("stream", per * I8.ROWS, -(-steps // per), -(-n // I8.BOX))
    np.testing.assert_array_equal(
        I8.int8_matmul_splits_ref(_t(x), _t(w), p).numpy(), _jax(x, w))


def test_int32_wraparound():
    """K = 2^17 + 1 products of (-128)(-128) wrap modulo 2^32 in the CPU
    route, in the split algorithm under the tile plan (N = 3) and under
    the stream plan of N = 16 (8 slices, each partial exact), as in the
    reference's int32 accumulation."""
    x = np.full((2, WRAP_K), -128, dtype=np.int8)
    for n in (3, 16):
        w = np.full((WRAP_K, n), -128, dtype=np.int8)
        want = _jax(x, w)
        assert (want == WRAPPED).all()
        assert (ops.int8_matmul(_t(x), _t(w)).numpy() == WRAPPED).all()
        p = I8.plan(2, n, WRAP_K, H100_SMS)
        assert p.route == ("tile" if n == 3 else "stream")
        assert n == 3 or p.slices == I8.SLICES
        np.testing.assert_array_equal(
            I8.int8_matmul_splits_ref(_t(x), _t(w), p).numpy(), want)


def test_cpu_call_launches_nothing():
    """On the CPU, ops.int8_matmul runs the plain version: no route's
    counter moves, and the CUDA launcher refuses CPU tensors."""
    before = dict(I8.launches_by_route)
    tile_before = bsm.int8_matmul_cuda.launches
    x, w = _rand(0, 4, 64, 16)
    ops.int8_matmul(_t(x), _t(w))
    assert I8.launches_by_route == before
    assert bsm.int8_matmul_cuda.launches == tile_before
    with pytest.raises(ValueError, match="CUDA"):
        I8.int8_matmul_cuda(_t(x), _t(w))
    assert I8.launches_by_route == before


def test_isolation_walk_finds_the_module():
    """tests/test_torch_isolation.py imports what walk_packages lists: the
    new wrapper is among it."""
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.kernels.int8_matmul" in names


def test_source_matches_the_wrapper():
    """The .cu has the strip width, stage depth, ring, x limit and cluster
    size the wrapper's planner assumes."""
    src = I8.SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kBox"]) == I8.BOX
    assert int(consts["kRows"]) == I8.ROWS
    assert int(consts["kStages"]) == I8.STAGES
    assert int(consts["kXMax"]) == I8.X_MAX
    assert int(consts["kMaxSlices"]) == I8.MAX_SLICES
    assert I8.MAX_M == 16        # the kernel's two MMA column groups


PINNED = [("stream", 768, 4, 96), ("stream", 384, 8, 64),
          ("stream", 1536, 2, 128), ("stream", 2048, 4, 96)]
