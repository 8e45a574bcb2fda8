"""The grouped expert GEMM's routes, work list and tile algorithm
(``repro_torch.kernels.grouped_gemm``) against ``lax.ragged_dot``.

On the CPU no kernel runs: these tests pin the planner :func:`route` (the
kernel each product goes to on the card), :func:`tile_schedule` (the work
items the new kernel ``csrc/grouped_gemm_sm90.cu`` walks) and
:func:`ragged_dot_tiles_ref` (its algorithm as plain tensor code: full
boxes that run into the next group, masked at the store; ``dw``'s last
reduction step zeroed in both operands; zero tiles past the groups' sum).
Inputs are numpy draws from a seed, fp32; ``ragged_dot_tiles_ref`` and
its gradients' counterparts are held to ``jax.lax.ragged_dot`` and
``jax.grad`` of it within ``RD_TOL`` (1e-5) of each output's largest
magnitude (the two sum in other orders), with exact zeros past the sum
and in an empty group's ``dw``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_gemm as GG

torch.set_num_threads(1)

RD_TOL = 1e-5
BF16 = torch.bfloat16
# (label, M, K, N, mode, route): the main path's buffers at tp 1 (cap =
# 1.25 x hits rounded up to 8) and the widths of the MoE archs
PLANNED = [
    ("olmoe train fwd", 81920, 2048, 1024, GG.FWD, "wgmma"),
    ("olmoe train dx", 81920, 2048, 1024, GG.DX, "wgmma"),
    ("olmoe train dw", 81920, 2048, 1024, GG.DW, "wgmma"),
    ("olmoe train down fwd", 81920, 1024, 2048, GG.FWD, "wgmma"),
    ("olmoe decode fwd", 40, 2048, 1024, GG.FWD, "stream"),
    ("olmoe decode dx", 40, 2048, 1024, GG.DX, "wgmma"),
    ("olmoe decode dw", 40, 2048, 1024, GG.DW, "wgmma"),
    ("olmoe prefill B 4 x 32", 1280, 2048, 1024, GG.FWD, "wgmma"),
    ("deepseek-v3 T 4 fwd", 40, 7168, 2048, GG.FWD, "stream"),
    ("deepseek-v3 T 4096 fwd", 40960, 7168, 2048, GG.FWD, "wgmma"),
    ("deepseek-v3 T 4096 dw", 40960, 7168, 2048, GG.DW, "wgmma"),
    ("jamba-1.5 T 4 fwd", 16, 8192, 24576, GG.FWD, "stream"),
    ("jamba-1.5 T 4 dx", 16, 8192, 24576, GG.DX, "wgmma"),
]


@pytest.mark.parametrize("case", PLANNED, ids=[c[0] for c in PLANNED])
def test_route_pins_the_main_path(case):
    _, m, k, n, mode, want = case
    assert GG.route(mode, BF16, m, k, n, True) == want


@pytest.mark.parametrize("mode", [GG.FWD, GG.DX, GG.DW])
def test_route_sends_the_rest_to_tile(mode):
    for m in (40, 81920):
        assert GG.route(mode, torch.float32, m, 2048, 1024, True) == "tile"
        assert GG.route(mode, BF16, m, 2048, 1024, False) == "tile"
        assert GG.route(mode, BF16, m, 2044, 1024, True) == "tile"
        assert GG.route(mode, BF16, m, 2048, 1020, True) == "tile"
        assert GG.route(mode, BF16, m, 147, 99, True) == "tile"


def test_route_threshold_is_pinned():
    """The stream route takes fwd up to STREAM_MAX_M rows (where it and
    the wgmma route cross on the card, PERF.md); dx and dw never (the
    wgmma route was faster at every decode shape)."""
    assert GG.STREAM_MAX_M == 192
    t = GG.STREAM_MAX_M
    assert GG.route(GG.FWD, BF16, 1, 8, 8, True) == "stream"
    assert GG.route(GG.FWD, BF16, t, 2048, 1024, True) == "stream"
    assert GG.route(GG.FWD, BF16, t + 1, 2048, 1024, True) == "wgmma"
    for mode in (GG.DX, GG.DW):
        assert GG.route(mode, BF16, 1, 8, 8, True) == "wgmma"
        assert GG.route(mode, BF16, t, 2048, 1024, True) == "wgmma"


def test_operands_aligned_sees_an_unaligned_view():
    x = torch.zeros((6, 8), dtype=BF16)
    assert GG.operands_aligned(x, x[2:])            # 32 bytes in
    assert not GG.operands_aligned(x.view(-1)[1:])  # 2 bytes in
    assert not GG.operands_aligned(x, x[:, 1:])


def test_constants_match_the_source():
    src = GG.SM90_SOURCE.read_text()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert (consts["kBM"], consts["kBN"], consts["kBK"]) == \
        (GG.WG_BM, GG.WG_BN, GG.WG_BK)
    assert (consts["kSRows"], consts["kSCols"]) == \
        (GG.STREAM_BM, GG.STREAM_BN)
    assert consts["kMaxGroups"] == GG.MAX_GROUPS
    assert set(GG.ROUTES) == set(GG.launches_by_route)


# ---------------------------------------------------------------------------
# the work list covers every output element once
# ---------------------------------------------------------------------------

def _sizes_cases(seed: int, count: int):
    """Group-size vectors with their buffer's rows: random draws plus the
    named edges (empty groups, one group holding every row, a sum below M,
    a sum cut at M, 1-row groups, negative sizes, edges off the tile)."""
    rng = np.random.default_rng(seed)
    cases = [([0, 0, 300, 0], 300), ([0, 70, 0, 0, 90, 0, 0, 31], 300),
             ([1, 1, 1, 0, 1], 9), ([200, 200], 300), ([129, 1, 127], 257),
             ([5, -3, 7], 20), ([0, 0], 17), ([128, 128], 256)]
    for _ in range(count):
        g = int(rng.integers(1, 12))
        m = int(rng.integers(1, 700))
        total = int(rng.integers(0, m + m // 3 + 1))
        sizes = rng.multinomial(total, np.ones(g) / g)
        if rng.random() < 0.3:
            sizes[rng.integers(0, g)] = 0
        if rng.random() < 0.2:
            sizes[rng.integers(0, g)] = 1
        cases.append((list(int(s) for s in sizes), m))
    return cases


def _cover(tiles, mode, m, k, n, bm, bn, groups):
    if mode == GG.DW:
        count = np.zeros((groups, k, n), np.int64)
        for t in tiles:
            count[t.group, t.r0:min(t.r0 + bm, k), t.c0:t.c0 + bn] += 1
    else:
        count = np.zeros((m, n), np.int64)
        for t in tiles:
            count[t.r0:min(t.r0 + bm, t.r_end), t.c0:t.c0 + bn] += 1
    return count


@pytest.mark.parametrize("bm,bn", [(GG.WG_BM, GG.WG_BN),
                                   (GG.STREAM_BM, GG.STREAM_BN), (16, 24)])
def test_schedule_covers_every_output_once(bm, bn):
    for sizes, m in _sizes_cases(bm * 7 + bn, 120):
        gs = torch.tensor(sizes)
        g = len(sizes)
        for mode, k, n in ((GG.FWD, 40, 300), (GG.DX, 300, 40),
                           (GG.DW, 136, 264)):
            cols = n if mode != GG.DX else k
            tiles = GG.tile_schedule(gs, m, cols, bm, bn, mode, k)
            count = _cover(tiles, mode, m, k, cols, bm, bn, g)
            assert (count == 1).all(), (sizes, m, mode)


@pytest.mark.parametrize("bm,bn", [(GG.WG_BM, GG.WG_BN),
                                   (GG.STREAM_BM, GG.STREAM_BN)])
def test_schedule_order_and_bound(bm, bn):
    """Items run group-major, then column tile, then row tile; zero tiles
    last, row tile-major; a group's tiles start at its first row and
    store only its rows; the row-tile slots fit the host's bound
    ceil(M / bm) + G."""
    for sizes, m in _sizes_cases(3, 150):
        gs = torch.tensor(sizes)
        bounds = GG._bounds(gs, m)
        tiles = GG.tile_schedule(gs, m, 300, bm, bn)
        keys = [(t.group, t.c0, t.r0) if t.group >= 0
                else (len(sizes), t.r0, t.c0) for t in tiles]
        assert keys == sorted(keys)
        for t in tiles:
            if t.group >= 0:
                lo, hi = bounds[t.group]
                assert (t.r0 - lo) % bm == 0 and lo <= t.r0 < hi == t.r_end
            else:
                assert t.r_end == m and t.r0 >= (bounds[-1][1])
        slots = len({(t.group, t.r0) for t in tiles})
        assert slots <= -(-m // bm) + len(sizes)
        dw = GG.tile_schedule(gs, m, 300, bm, bn, GG.DW, 200)
        assert len(dw) == len(sizes) * -(-200 // bm) * -(-300 // bn)


# ---------------------------------------------------------------------------
# the kernel's algorithm against lax.ragged_dot
# ---------------------------------------------------------------------------

TILES_CASES = [
    # (M, K, N, group sizes)
    (300, 40, 24, [0, 70, 0, 0, 90, 0, 0, 31]),   # rows past the sum
    (200, 16, 32, [0, 0, 200, 0]),                # every row in one group
    (257, 24, 40, [129, 1, 127]),                 # edges off 128, a 1-row group
    (50, 8, 16, [30, 40]),                        # a sum cut at M
    (37, 12, 20, [5, 0, 7, 1, 1, 6]),             # K, N off the tiles
    (140, 8, 8, "random"),
]
TILINGS = [(GG.WG_BM, GG.WG_BN, GG.WG_BK), (GG.STREAM_BM, GG.STREAM_BN, 64),
           (4, 8, 3)]


def _operands(case, seed):
    m, k, n, sizes = TILES_CASES[case]
    rng = np.random.default_rng(seed)
    if sizes == "random":
        sizes = list(rng.multinomial(m - 9, np.ones(9) / 9))
        sizes[4] = 0
    g = len(sizes)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((g, k, n)).astype(np.float32)
    cot = rng.standard_normal((m, n)).astype(np.float32)
    return x, w, np.asarray(sizes, np.int32), cot


def _close(got, want, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= RD_TOL * scale, (what, err, scale)


@pytest.mark.parametrize("tiling", TILINGS, ids=["wgmma", "stream", "small"])
@pytest.mark.parametrize("case", range(len(TILES_CASES)))
def test_tiles_ref_matches_lax(case, tiling):
    bm, bn, bk = tiling
    x, w, gs, cot = _operands(case, case)
    # the sizes as the port reads them (a sum past M cut at M)
    ends = np.minimum(np.cumsum(np.maximum(gs, 0)), x.shape[0])
    jgs = jnp.asarray(np.diff(ends, prepend=0).astype(np.int32))

    def f(x_, w_):
        return jnp.sum(jax.lax.ragged_dot(x_, w_, jgs) * cot)

    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(x), jnp.asarray(w), jgs))
    wgx, wgw = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw, tc = map(torch.from_numpy, (x, w, cot))
    tgs = torch.from_numpy(gs)
    y = GG.ragged_dot_tiles_ref(GG.FWD, tx, tw, tgs, bm, bn, bk)
    dx = GG.ragged_dot_tiles_ref(GG.DX, tc, tw, tgs, bm, bn, bk)
    dw = GG.ragged_dot_tiles_ref(GG.DW, tx, tc, tgs, bm, bn, bk)
    _close(y, want, "y")
    _close(dx, wgx, "dx")
    _close(dw, wgw, "dw")
    end = min(int(np.maximum(gs, 0).sum()), x.shape[0])
    assert bool((y[end:] == 0).all()) and bool((dx[end:] == 0).all())
    for e in np.flatnonzero(gs <= 0):
        assert bool((dw[e] == 0).all()), e


@pytest.mark.parametrize("tiling", TILINGS, ids=["wgmma", "stream", "small"])
def test_tiles_ref_does_not_depend_on_the_order(tiling, monkeypatch):
    """The blocks run the work items in no set order, so no item may
    store outside its own tile: the product equals itself bit for bit
    with the schedule reversed and shuffled."""
    bm, bn, bk = tiling
    x, w, gs, cot = _operands(2, 3)                 # sizes 129, 1, 127
    tx, tw, tc = map(torch.from_numpy, (x, w, cot))
    tgs = torch.from_numpy(gs)
    ops = ((GG.FWD, tx, tw), (GG.DX, tc, tw), (GG.DW, tx, tc))
    want = [GG.ragged_dot_tiles_ref(mode, a, b, tgs, bm, bn, bk)
            for mode, a, b in ops]
    schedule = GG.tile_schedule
    rng = np.random.default_rng(0)
    for reorder in (lambda t: t[::-1],
                    lambda t: [t[i] for i in rng.permutation(len(t))]):
        monkeypatch.setattr(GG, "tile_schedule",
                            lambda *a, **k: reorder(schedule(*a, **k)))
        for (mode, a, b), ref in zip(ops, want):
            got = GG.ragged_dot_tiles_ref(mode, a, b, tgs, bm, bn, bk)
            assert torch.equal(got, ref), mode


@pytest.mark.parametrize("tiling", TILINGS, ids=["wgmma", "stream", "small"])
def test_tiles_ref_keeps_a_neighbours_nan_out(tiling):
    """A NaN in the first row of a group sits in the previous group's
    last box (fwd) and last reduction step (dw): it must not reach any
    other group's output."""
    bm, bn, bk = tiling
    x, w, gs, cot = _operands(2, 7)                 # sizes 129, 1, 127
    bad_x, bad_dy = x.copy(), cot.copy()
    bad_x[130] = np.nan                             # group 2's first row
    bad_dy[129] = np.nan                            # group 1's one row
    tx, tdy, tw = map(torch.from_numpy, (bad_x, bad_dy, w))
    tgs = torch.from_numpy(gs)
    y = GG.ragged_dot_tiles_ref(GG.FWD, tx, tw, tgs, bm, bn, bk)
    assert bool(torch.isfinite(y[:130]).all())
    assert bool(torch.isnan(y[130]).all())
    dx = GG.ragged_dot_tiles_ref(GG.DX, tdy, tw, tgs, bm, bn, bk)
    assert bool(torch.isfinite(dx[:129]).all())
    assert bool(torch.isfinite(dx[130:]).all())
    dw = GG.ragged_dot_tiles_ref(GG.DW, tx, tdy, tgs, bm, bn, bk)
    assert bool(torch.isfinite(dw[0]).all())        # x's NaN, dy's NaN next
    assert bool(torch.isnan(dw[1]).any())           # its own NaN row of dy
    clean = GG.ragged_dot_tiles_ref(GG.DW, torch.from_numpy(x), tdy, tgs,
                                    bm, bn, bk)
    assert bool(torch.isfinite(clean[2]).all())


def test_cpu_calls_launch_nothing():
    x, w, gs, cot = _operands(0, 0)
    GG.reset_launches()
    GG.launches_by_route["stream"] = 5              # a count to keep
    before = (GG.ragged_dot.launches, dict(GG.launches_by_route))
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    y = GG.ragged_dot(tx, tw, torch.from_numpy(gs))
    (y * torch.from_numpy(cot)).sum().backward()
    GG.ragged_dot_tiles_ref(GG.FWD, tx.detach(), tw.detach(),
                            torch.from_numpy(gs), 8, 32)
    assert (GG.ragged_dot.launches, dict(GG.launches_by_route)) == before
    assert GG.ragged_dot.launches_by_route is GG.launches_by_route
    with pytest.raises(ValueError, match="no grouped-GEMM kernel"):
        GG.ragged_dot_cuda(GG.FWD, tx.detach(), tw.detach(),
                           torch.from_numpy(gs), route="wgmma")
    GG.reset_launches()
    assert GG.ragged_dot.launches == 0
    assert set(GG.launches_by_route.values()) == {0}
