"""The gated norm's ``sm90`` route on the CPU: its planner, its router and
its algorithm as plain tensor code.

The route's kernel (``csrc/gated_norm_sm90.cu``) runs only on the card;
what surrounds it is plain Python and is held here: :func:`plan` covers
every row and column of a call exactly once (over clusters, ranks and a
consumer thread's vectors) within the card's shared memory at
mamba2-780m's and jamba-1.5's widths; :func:`route` sends aligned bf16
rows to ``sm90`` and every other call (fp32, an unaligned view, a width
the planner refuses) to ``triton``; the wrappers never launch on CPU
tensors.  :func:`sm90_partials_ref` (each cluster's dw / dD partials
over its rows, summed over the clusters in order) is held to
:func:`gated_norm_bwd_ref`, to ``jax.vjp`` of the reference's lines and,
inside the port's ``ssm_apply``, to ``repro``'s layer gradients of
``norm_w`` and ``D``.  Inputs are numpy draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.models import layers as JL
from repro.models import ssm as JS

from repro_torch.configs import ARCHS as TARCHS, reduced as treduced
from repro_torch.kernels import gated_norm as GN
from repro_torch.kernels import gated_norm_sm90 as GS
from repro_torch.models import ssm as S

torch.set_num_threads(1)

# the plain backwards against autograd and jax.vjp (fp32), relative to
# each gradient's largest magnitude, as tests/test_torch_ssm_kernels.py
BWD_RTOL = 2e-5
# the port's layer against repro's (fp32), as tests/test_torch_models.py
LAYER_TOL = dict(rtol=2e-4, atol=2e-4)
# the H100's shared memory an SM, and what it reserves a block
SM_SMEM = 233472
BLOCK_RESERVED = 1024

# (label, rows, d, heads, skip, bwd, sms, max_clusters): 11c's shape,
# prefill_32k's, jamba's, decode's (no skip), S 3, a row of few heads,
# and a grid the device caps below the SMs' share
PLANS = [
    ("mamba2 B4 S2048 fwd", 8192, 3072, 48, True, False, 132, None),
    ("mamba2 B4 S2048 bwd", 8192, 3072, 48, True, True, 132, None),
    ("mamba2 B1 S32768 bwd", 32768, 3072, 48, True, True, 132, None),
    ("jamba B1 S4096 fwd", 4096, 16384, 128, True, False, 132, 62),
    ("jamba B1 S4096 bwd", 4096, 16384, 128, True, True, 132, 62),
    ("decode B4", 4, 3072, 48, False, False, 132, None),
    ("mamba2 B2 S3 bwd", 6, 3072, 48, True, True, 132, None),
    ("8 heads of 16 bwd", 100, 128, 8, True, True, 7, None),
]


def _draw(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("label,rows,d,heads,skip,bwd,sms,cap", PLANS,
                         ids=[p[0] for p in PLANS])
def test_plan_covers_every_row_and_column_once(label, rows, d, heads, skip,
                                               bwd, sms, cap):
    """Every (row, column) of a call falls to exactly one block of the
    plan, and every column of a block's share to exactly one vector of
    one consumer thread."""
    pl = GS.plan(rows, d, heads, skip, bwd, sms, cap)
    assert pl is not None
    assert pl["blocks"] == pl["clusters"] * pl["cluster"]
    assert pl["clusters"] <= min(rows, GS.BLOCKS_PER_SM * sms
                                 // pl["cluster"], cap or rows)
    rows_by_rank = {r: [] for r in range(pl["cluster"])}
    cols_by_rank = {}
    for c, r, rws, cols in GS.blocks(pl, rows):
        rows_by_rank[r] += list(rws)
        assert cols_by_rank.setdefault(r, cols) == cols
        assert len(rws) >= 1
    for r, rws in rows_by_rank.items():
        assert sorted(rws) == list(range(rows)), r
    tiled = sorted(c for cols in cols_by_rank.values() for c in cols)
    assert tiled == list(range(d))
    # head-aligned shares: each rank's columns are whole heads
    assert pl["share"] % (d // heads) == 0
    hits = np.zeros(pl["nvec"], int)
    for t in range(pl["warps"] * 32):
        for i in range(pl["vpt"]):
            j = t + i * pl["warps"] * 32
            if j < pl["nvec"]:
                hits[j] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("d,heads,want", [
    (3072, 48, {"fwd": (1, 3), "bwd": (1, 3)}),        # mamba2-780m
    (16384, 128, {"fwd": (4, 3), "bwd": (4, 3)}),      # jamba-1.5
], ids=["mamba2-780m", "jamba-1.5"])
def test_plan_fits_the_card(d, heads, want):
    """mamba2-780m's row on one block a row, jamba's 16384 columns on a
    cluster of 4 (its whole row staged would take 128 KB a backward
    stage); at least three stages a ring, two blocks an SM within 227 KB
    a block and 228 KB an SM."""
    for what, bwd in (("fwd", False), ("bwd", True)):
        pl = GS.plan(8192, d, heads, True, bwd)
        assert (pl["cluster"], pl["stages"]) == want[what], what
        assert pl["stages"] >= GS.MIN_STAGES
        assert pl["smem"] <= GS.SMEM_MAX
        assert GS.BLOCKS_PER_SM * (pl["smem"] + BLOCK_RESERVED) <= SM_SMEM
        assert pl["stages"] * pl["stage_bytes"] <= GS.RING_MAX
        assert pl["slot_bytes"] >= pl["share"] * 2
    # decode's rows (no skip): one block a row, a deeper ring
    pl = GS.plan(4, 3072, 48, False, False)
    assert (pl["cluster"], pl["clusters"], pl["nops"]) == (1, 4, 2)


def test_plan_refuses():
    """Heads of a width not a multiple of 8, a row wider than four blocks
    hold, and no heads."""
    assert GS.plan(8, 96 * 12, 96, True, True) is None     # hp 12
    assert GS.plan(8, 65536, 128, True, True) is None      # 4 x 16384
    assert GS.plan(8, 64, 0, True, True) is None


# z as the layer's view of one in_proj row (mamba2-780m: 6448 columns), x of
# one conv row (3328), y and dout contiguous; strides in elements
_MAMBA_STRIDES = [2048 * 6448, 6448, 2048 * 3328, 3328, 2048 * 3072, 3072]


@pytest.mark.parametrize("case,want", [
    ("aligned bf16", "sm90"),
    ("decode rows", "sm90"),
    ("fp32 w", "sm90"),
    ("fp32", "triton"),
    ("unaligned stride", "triton"),
    ("unaligned base", "triton"),
    ("fp16 w", "triton"),
    ("hp 12", "triton"),
    ("too wide", "triton"),
])
def test_route(case, want):
    """The router: bf16 operands on 16-byte boundaries (bases and row
    strides) at a width the planner takes go to ``sm90``; fp32, an
    unaligned view, an unsupported w and a width it refuses to
    ``triton``."""
    dtype, d, heads = torch.bfloat16, 3072, 48
    strides, ptrs = list(_MAMBA_STRIDES), [0, 1 << 20, 2 << 20, 3 << 20]
    aux = (torch.bfloat16, torch.float32)
    if case == "decode rows":
        strides = [6448, 3072]
        ptrs = ptrs[:2]
    elif case == "fp32 w":
        aux = (torch.float32, torch.float32)
    elif case == "fp32":
        dtype = torch.float32
    elif case == "unaligned stride":
        strides[1] = 6449
    elif case == "unaligned base":
        ptrs[1] += 2
    elif case == "fp16 w":
        aux = (torch.float16, torch.float32)
    elif case == "hp 12":
        d, heads = 576, 48
    elif case == "too wide":
        d, heads = 65536, 128
    assert GS.route(dtype, d, heads, strides, ptrs, aux) == want


def _gate_args(seed, b, s, heads, hp, dtype=torch.float32, skip=True):
    """y, z (a view of one in_proj row), w, x (a view of one conv row), D
    (fp32) and dout: normal draws rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    d = heads * hp
    y = torch.from_numpy(_draw(rng, b, s, d)).to(dtype)
    x = torch.from_numpy(_draw(rng, b, s, d + 16)).to(dtype)[..., :d]
    z = torch.from_numpy(_draw(rng, b, s, 2 * d + 24)).to(dtype)[..., :d]
    w = torch.from_numpy(1.0 + _draw(rng, d, scale=0.2)).to(dtype)
    D = torch.from_numpy(1.0 + _draw(rng, heads, scale=0.3))
    dout = torch.from_numpy(_draw(rng, b, s, d)).to(dtype)
    return y, z, w, (x, D) if skip else (None, None), dout


def test_router_takes_the_layers_views():
    """On the layer's own tensors (bf16 views of one in_proj row and one
    conv row) the wrapper plans ``sm90``; on fp32 ones and on a view one
    element off a 16-byte boundary, ``triton``."""
    y, z, w, (x, D), _ = _gate_args(0, 2, 8, 8, 16, torch.bfloat16)
    assert GN._route(y, z, w, 8, x, D, None) == "sm90"
    assert GN._route(y, z, w, 8, None, None, None) == "sm90"
    y32, z32, w32, (x32, D32), _ = _gate_args(0, 2, 8, 8, 16)
    assert GN._route(y32, z32, w32, 8, x32, D32, None) == "triton"
    wide = torch.zeros((2, 8, 8 * 16 + 1), dtype=torch.bfloat16)
    assert GN._route(wide[..., 1:], z, w, 8, x, D, None) == "triton"
    with pytest.raises(ValueError):
        GN._route(y32, z32, w32, 8, x32, D32, "sm90")
    assert GN._route(y, z, w, 8, x, D, "triton") == "triton"


def test_no_cpu_launch(monkeypatch):
    """On CPU tensors the wrappers run the plain versions: the sm90
    library is never loaded, no launch is counted by route, and the
    routes' CUDA entry points refuse CPU tensors."""
    def refuse(*a, **k):
        raise AssertionError("the sm90 library was loaded")

    monkeypatch.setattr(GS, "library", refuse)
    before = dict(GN.launches_by_route)
    y, z, w, (x, D), dout = _gate_args(1, 2, 5, 4, 8, torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in (y, z, w, x, D)]
    GN.gated_norm(*leaves[:3], 4, *leaves[3:]).sum().backward()
    assert all(t.grad is not None for t in leaves)
    for rt in GN.ROUTES:
        with pytest.raises(ValueError):
            GN.gated_norm_fwd_cuda(y, z, w, 4, x, D, route=rt)
        with pytest.raises(ValueError):
            GN.gated_norm_bwd_cuda(dout, y, z, w, 4, x, D, route=rt)
    assert GN.launches_by_route == before


def _ref_gate(y, z, w, x, D, heads):
    """The reference's lines (ssm.py:140-143) on (B, S, d) arrays."""
    b, s, d = y.shape
    if x is not None:
        y = (y.reshape(b, s, heads, d // heads)
             + x.reshape(b, s, heads, d // heads)
             * D[..., None].astype(y.dtype)).reshape(b, s, d)
    return JL.rmsnorm(y * jax.nn.silu(z), w)


@pytest.mark.parametrize("ring_max,sms,skip", [
    (None, 2, True), (None, 3, False), (2048, 2, True)],
    ids=["one block a row", "no skip", "a cluster of 2"])
def test_partials_match_bwd_ref_and_vjp(monkeypatch, ring_max, sms, skip):
    """Each cluster's dw / dD partials over its rows, summed over the
    clusters in order (the sm90 route's algorithm), == the plain
    backward's dw and dD and ``jax.vjp`` of the reference's lines (fp32,
    BWD_RTOL of each gradient's largest magnitude); a small ring budget
    puts the row on a cluster of 2, each block a head-aligned half."""
    if ring_max is not None:
        monkeypatch.setattr(GS, "RING_MAX", ring_max)
    y, z, w, (x, D), dout = _gate_args(2, 2, 12, 8, 16, skip=skip)
    part, dw, dD = GN.sm90_partials_ref(dout, y, z, w, 8, x, D, sms=sms)
    pl = GS.plan(24, 128, 8, skip, True, sms)
    assert part.shape == (pl["clusters"], 128 + 8) and pl["clusters"] > 1
    assert pl["cluster"] == (2 if ring_max else 1)
    want = GN.gated_norm_bwd_ref(dout, y, z, w, 8, x, D)
    ins = [y, z, w] + ([x, D] if skip else [])

    def ref(*a):
        return _ref_gate(*a[:3], *(a[3:] if skip else (None, None)), 8)

    _, vjp = jax.vjp(ref, *(jnp.asarray(_np(t)) for t in ins))
    jg = vjp(jnp.asarray(_np(dout)))
    pairs = [("dw", dw, want[2], jg[2])]
    if skip:
        pairs.append(("dD", dD, want[4], jg[4]))
    else:
        assert dD is None and not part[:, 128:].any()
    for name, got, plain, jax_g in pairs:
        scale = float(plain.abs().max())
        np.testing.assert_allclose(_np(got), _np(plain), rtol=BWD_RTOL,
                                   atol=BWD_RTOL * scale, err_msg=name)
        np.testing.assert_allclose(_np(got), np.asarray(jax_g),
                                   rtol=BWD_RTOL, atol=BWD_RTOL * scale,
                                   err_msg=name)


def test_partials_in_the_layer_match_reference(monkeypatch):
    """Inside the port's ``ssm_apply`` (the reduced mamba2-780m, fp32),
    the gate's inputs and its output's gradient captured: the sm90
    route's partials summed in order == ``repro``'s ``jax.vjp`` gradients
    of ``norm_w`` and ``D`` (LAYER_TOL)."""
    cfg, tcfg = reduced(ARCHS["mamba2-780m"]), treduced(TARCHS["mamba2-780m"])
    p = {k: np.asarray(v) for k, v in
         JS.ssm_init(cfg, jax.random.PRNGKey(3), jnp.float32).items()}
    rng = np.random.default_rng(17)
    for k in ("conv_b", "D", "norm_w"):
        p[k] = (p[k] + rng.standard_normal(p[k].shape) * 0.3).astype(
            np.float32)
    u = _draw(rng, 2, 32, cfg.d_model, scale=0.5)
    dy = _draw(rng, 2, 32, cfg.d_model)
    _, vjp = jax.vjp(lambda pp: JS.ssm_apply(cfg, pp, jnp.asarray(u)),
                     {k: jnp.asarray(v) for k, v in p.items()})
    (dp,) = vjp(jnp.asarray(dy))
    seen = {}
    real = S.gated_norm

    def spy(y, z, w, heads, x=None, D=None):
        seen.update(y=y.detach(), z=z.detach(), w=w.detach(), heads=heads,
                    x=x.detach(), D=D.detach())
        out = real(y, z, w, heads, x, D)
        out.register_hook(lambda g: seen.__setitem__("dout", g.detach()))
        return out

    monkeypatch.setattr(S, "gated_norm", spy)
    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    S.ssm_apply(tcfg, tp, torch.from_numpy(u)).backward(torch.from_numpy(dy))
    _, dw, dD = GN.sm90_partials_ref(
        seen["dout"], seen["y"], seen["z"], seen["w"], seen["heads"],
        seen["x"], seen["D"], sms=3)
    for name, got in (("norm_w", dw), ("D", dD)):
        want = np.asarray(dp[name])
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, rtol=LAYER_TOL["rtol"],
                                   atol=LAYER_TOL["atol"] * max(1.0, scale),
                                   err_msg=name)
        np.testing.assert_allclose(_np(tp[name].grad), want,
                                   rtol=LAYER_TOL["rtol"],
                                   atol=LAYER_TOL["atol"] * max(1.0, scale),
                                   err_msg=name)


def test_header_matches_the_source():
    """The planner's shared-memory header and launch constants are the
    .cu's (kRingOff, kWarps, kVec, kMaxVpt, kMaxStages, kMaxCluster)."""
    src = GS.SOURCE.read_text()

    def const(name):
        line = next(ln for ln in src.splitlines()
                    if ln.startswith(f"constexpr int {name} ="))
        return line.split("=")[1].split(";")[0].strip()

    env = {}
    for name in ("kMaxStages", "kWarps", "kCons", "kMaxCluster", "kMaxVpt",
                 "kVec", "kSumBufs", "kLocOff", "kClOff", "kVaccOff",
                 "kRingOff"):
        env[name] = eval(const(name), {}, env)
    assert env["kRingOff"] == GS.HEADER
    assert env["kWarps"] == GS.WARPS
    assert env["kVec"] == GS.VEC
    assert env["kMaxVpt"] == max(GS.VPT)
    assert env["kMaxStages"] == GS.MAX_STAGES
    assert env["kMaxCluster"] == max(GS.CLUSTERS)
    assert env["kRingOff"] % GS.SLOT == 0
