"""The SSD chunk scan's route planner and the ``sm90`` route's wiring, on
the CPU.

:func:`route` is pinned: bf16 at mamba2-780m's, jamba-1.5's and the
one-chunk geometries takes ``sm90``; fp32 and the bf16 shapes outside the
new kernel's contract take ``mma``; a shape neither takes raises.
:func:`band_heads` and :func:`scratch_shapes` are pinned at the smoke
check's shapes.  :class:`SSDChunkScan` runs on CPU tensors with each
route's library replaced by a stand-in that records its arguments and
writes the plain versions' results through the pointers it is given
(``ctypes.memmove``): a bf16 call reaches the ``sm90`` entry points with
the planned scratch and is counted in ``launches_by_route``; a nonzero
return code raises, and nothing falls back.  CPU and ``meta`` tensors
never reach either library.  Inputs are numpy draws from a seed.
"""

import ctypes

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import ssd_scan as K

torch.set_num_threads(1)


def _inputs(seed, b, s, nh, hp, g, n, dtype):
    """x, dt, A, B, C and y's gradient: normal draws (dt through a
    softplus, A = -exp(A_log) over the layer's initial A_log range); x,
    B, C and dy in ``dtype``."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    x, B, C, dy = (draw(b, s, nh, hp), draw(b, s, g, n), draw(b, s, g, n),
                   draw(b, s, nh, hp))
    dt = torch.nn.functional.softplus(draw(b, s, nh) - 1.0)
    A = -torch.exp(torch.from_numpy(
        rng.uniform(np.log(1.0), np.log(16.0), nh).astype(np.float32)))
    return (x.to(dtype), dt, A, B.to(dtype), C.to(dtype), dy.to(dtype))


def _geometry(name):
    """(Q, N, hp) of a config's SSD at its chunk."""
    s = ARCHS[name].ssm
    return s.chunk, s.d_state, s.head_dim


@pytest.mark.parametrize("dtype,Q,N,hp,want", [
    (torch.bfloat16, *_geometry("mamba2-780m"), "sm90"),
    (torch.bfloat16, *_geometry("jamba-1.5-large-398b"), "sm90"),
    (torch.bfloat16, K.chunk_len(64, 256), 128, 64, "sm90"),   # S = Q = 64
    (torch.bfloat16, K.chunk_len(256, 256), 128, 64, "sm90"),  # S = Q = 256
    (torch.bfloat16, 128, 64, 128, "sm90"),
    (torch.float32, *_geometry("mamba2-780m"), "mma"),
    (torch.float32, *_geometry("jamba-1.5-large-398b"), "mma"),
    (torch.bfloat16, 16, 16, 16, "mma"),      # the reduced configs
    (torch.bfloat16, 16, 128, 64, "mma"),     # Q 16
    (torch.bfloat16, 256, 16, 64, "mma"),     # N 16
    (torch.bfloat16, 48, 64, 64, "mma"),      # Q not a multiple of 64
    (torch.bfloat16, 256, 128, 96, "mma"),    # hp 96
    (torch.bfloat16, 256, 32, 64, "mma"),     # N 32
])
def test_route_is_pinned(dtype, Q, N, hp, want):
    assert K.route(dtype, Q, N, hp) == want


@pytest.mark.parametrize("dtype,Q,N,hp,err", [
    (torch.bfloat16, 512, 128, 64, ValueError),   # Q past 256
    (torch.bfloat16, 8, 64, 64, ValueError),      # Q under 16
    (torch.bfloat16, 256, 256, 64, ValueError),   # N past 128
    (torch.float32, 256, 128, 40, ValueError),    # hp not a multiple of 16
    (torch.float16, 256, 128, 64, TypeError),
])
def test_route_raises_where_neither_takes(dtype, Q, N, hp, err):
    with pytest.raises(err):
        K.route(dtype, Q, N, hp)


def test_route_override():
    """``route=`` takes ``mma`` for any call and ``sm90`` only where it is
    planned; an unknown name raises."""
    x = torch.empty((1, 64, 4, 16), dtype=torch.bfloat16)
    assert K._route(x, 64, 16, 16, None) == "mma"
    assert K._route(x, 64, 64, 64, None) == "sm90"
    assert K._route(x, 64, 64, 64, "mma") == "mma"
    with pytest.raises(ValueError):
        K._route(x, 64, 16, 16, "sm90")
    with pytest.raises(ValueError):
        K._route(x, 64, 64, 64, "tile")


@pytest.mark.parametrize("shape,want", [
    ((4, 8, 48, 1, 256), 8),       # mamba2-780m, 11c's B 4 x S 2048
    ((1, 128, 48, 1, 256), 8),     # mamba2-780m, B 1 x S 32768
    ((1, 16, 128, 8, 256), 8),     # jamba-1.5's geometry, B 1 x S 4096
    ((4, 1, 48, 1, 64), 1),        # S = Q = 64: too few jobs to share
    ((2, 1, 48, 1, 256), 1),       # S = Q = 256
])
def test_band_heads_is_pinned(shape, want):
    assert K.band_heads(*shape) == want


def test_band_heads_divides_and_fills():
    """Over a grid of shapes: the band divides a group's heads, is at most
    8, and leaves two waves of jobs where it is more than 1."""
    for bsz in (1, 2, 4, 8):
        for nc in (1, 2, 8, 64):
            for nh, g in ((48, 1), (128, 8), (24, 2), (7, 1), (64, 4)):
                for Q in (64, 128, 256):
                    d = K.band_heads(bsz, nc, nh, g, Q)
                    hpg = nh // g
                    assert 1 <= d <= 8 and hpg % d == 0
                    if d > 1:
                        jobs = bsz * nc * g * (Q // 64) * (hpg // d)
                        assert jobs >= 4 * K._SMS


def test_scratch_shapes_at_mamba2():
    """The scratch of a call at 11c's shape (mamba2-780m, B 4 x S 2048):
    the sm90 route's bf16 states and C B^T (4.2 MB), its band sums (six
    bands of 8 heads) in place of the mma route's per-head dB and dC."""
    bf, f32 = torch.bfloat16, torch.float32
    args = (4, 2048, 48, 64, 1, 128, 256)
    st = (4, 8, 48, 128, 64)
    assert K.scratch_shapes("sm90", "fwd", *args) == {
        "hbf": (st, bf), "cb": ((4, 8, 1, 256, 256), bf)}
    assert K.scratch_shapes("mma", "fwd", *args) == {}
    sm90 = K.scratch_shapes("sm90", "bwd", *args)
    assert list(sm90) == ["dstate", "dcl", "rows", "hbf", "dbf", "cb", "cbt",
                          "dbs", "dcs", "dap"]
    assert sm90["dbs"] == sm90["dcs"] == ((4, 2048, 1, 6, 128), f32)
    assert sm90["cb"] == sm90["cbt"] == ((4, 8, 1, 256, 256), bf)
    assert sm90["dcl"] == ((4, 8, 48, 128 * 64 // 128), f32)   # a warp's
    mma = K.scratch_shapes("mma", "bwd", *args)
    assert list(mma) == ["dstate", "dcl", "rows", "dbp", "dcp", "dap"]
    assert mma["dbp"] == ((4, 2048, 48, 128), f32)
    nbytes = {k: np.prod(s) * torch.finfo(d).bits // 8
              for k, (s, d) in sm90.items()}
    assert nbytes["cb"] == 4 * 8 * 256 * 256 * 2          # 4.2 MB


class _Lib:
    """A stand-in for a route's shared library: records each entry point's
    arguments and writes the plain versions' results through the output
    pointers (CPU tensors), or returns ``rc``."""

    def __init__(self, rt, inputs, chunk, rc=0):
        self.rt, self.inputs, self.chunk, self.rc = rt, inputs, chunk, rc
        self.calls = []
        prefix = "ssd_sm90" if rt == "sm90" else "ssd_chunk_scan"
        setattr(self, prefix + "_fwd", self._fwd)
        setattr(self, prefix + "_bwd", self._bwd)
        setattr(self, prefix + "_error_string", lambda code: b"boom")

    @staticmethod
    def _put(ptr, t):
        t = t.contiguous()
        ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())

    def _fwd(self, *args):
        self.calls.append(("fwd", args))
        if self.rc:
            return self.rc
        ptrs = args[1:] if self.rt == "mma" else args
        x, dt, A, B, C, _ = self.inputs
        y = K.ssd_chunk_scan_ref(x, dt, A, B, C, self.chunk)
        cum, state = K.ssd_chunk_states_ref(x, dt, A, B, C, self.chunk)
        for ptr, t in zip(ptrs[5:8], (y, cum, state)):
            self._put(ptr, t)
        return 0

    def _bwd(self, *args):
        self.calls.append(("bwd", args))
        if self.rc:
            return self.rc
        ptrs = args[1:] if self.rt == "mma" else args
        n_ptr = 23 if self.rt == "sm90" else 19
        x, dt, A, B, C, dy = self.inputs
        grads = K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, self.chunk)
        for ptr, t in zip(ptrs[n_ptr - 5:n_ptr], grads):
            self._put(ptr, t)
        return 0


@pytest.fixture
def as_if_on_card(monkeypatch):
    """CPU tensors let through the entry points' device checks."""
    monkeypatch.setattr(K, "_on_card", lambda *ts: 0)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    K.reset_launches()
    yield
    K.reset_launches()


def _refuse(*a, **k):
    raise AssertionError("the other route or a plain version was reached")


@pytest.mark.parametrize("rt,dtype,shape", [
    ("sm90", torch.bfloat16, (2, 128, 4, 64, 2, 64, 64)),
    ("sm90", torch.bfloat16, (1, 256, 4, 128, 1, 128, 128)),
    ("mma", torch.float32, (2, 128, 4, 64, 2, 64, 64)),
    ("mma", torch.bfloat16, (2, 64, 4, 16, 1, 16, 16)),
])
def test_entry_points_wiring(monkeypatch, as_if_on_card, rt, dtype, shape):
    """``SSDChunkScan`` on CPU tensors with the planned route's library
    stood in: the call reaches that route's entry points with the shape,
    the planned scratch (``scratch_shapes``; the band of ``band_heads``)
    and the plant off, the other route is never reached, y and the
    gradients are what the stand-in wrote (the plain versions'), and
    ``launches_by_route`` counts ``ROUTE_LAUNCHES`` for the route."""
    b, s, nh, hp, g, n, Q = shape
    inputs = _inputs(5, b, s, nh, hp, g, n, dtype)
    x, dt, A, B, C, dy = inputs
    lib = _Lib(rt, inputs, Q)
    other = "mma" if rt == "sm90" else "sm90"
    monkeypatch.setattr(K, "_sm90_library" if rt == "sm90" else "_library",
                        lambda: lib)
    monkeypatch.setattr(K, "_SM90_LIB" if rt == "sm90" else "_LIB", None)
    monkeypatch.setattr(K, "_library" if rt == "sm90" else "_sm90_library",
                        _refuse)
    seen = []
    real = K._scratch
    monkeypatch.setattr(K, "_scratch", lambda *a: seen.append(
        [(tuple(t.shape), t.dtype) for t in real(*a)]) or real(*a))
    assert K.route(dtype, Q, n, hp) == rt
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y = K.SSDChunkScan.apply(*leaves, Q)
    assert torch.equal(y, K.ssd_chunk_scan_ref(x, dt, A, B, C, Q))
    y.backward(dy)
    for got, want in zip([t.grad for t in leaves],
                         K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, Q)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert [c[0] for c in lib.calls] == ["fwd", "bwd"]
    fwd_args, bwd_args = lib.calls[0][1], lib.calls[1][1]
    dims = (b, s, nh, hp, g, n, Q)
    assert tuple(fwd_args[-9:-1]) == dims + (0,)             # plant off
    if rt == "sm90":
        band = K.band_heads(b, s // Q, nh, g, Q)
        assert tuple(bwd_args[-9:-1]) == dims + (band,)
        assert len(fwd_args) == 10 + 1 + 8 + 1
        assert len(bwd_args) == 23 + 1 + 8 + 1
    else:
        assert tuple(bwd_args[-8:-1]) == dims
        assert fwd_args[0] == bwd_args[0] == K._DTYPES[dtype]
        assert len(fwd_args) == 1 + 8 + 1 + 8 + 1
        assert len(bwd_args) == 1 + 19 + 1 + 7 + 1
    want = [[s_ for s_ in K.scratch_shapes(rt, w, b, s, nh, hp, g, n,
                                            Q).values()]
            for w in ("fwd", "bwd")]
    assert seen == want
    nf, nb = K.ROUTE_LAUNCHES[rt]
    assert K.launches_by_route == {rt: nf + nb, other: 0}
    assert K.launches_by_pass == {"fwd": 1, "bwd": 1}
    assert K.ssd_chunk_scan_cuda.launches == nf + nb


@pytest.mark.parametrize("rt,dtype,shape", [
    ("sm90", torch.bfloat16, (1, 128, 2, 64, 1, 64, 64)),
    ("mma", torch.float32, (1, 32, 2, 16, 1, 16, 16)),
])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_nonzero_return_code_raises(monkeypatch, as_if_on_card, rt, dtype,
                                    shape, which):
    """An entry point that returns an error code raises with the library's
    message; neither the other route nor a plain version is reached, and
    the failed call is not counted."""
    b, s, nh, hp, g, n, Q = shape
    inputs = _inputs(6, b, s, nh, hp, g, n, dtype)
    x, dt, A, B, C, dy = inputs
    lib = _Lib(rt, inputs, Q)
    monkeypatch.setattr(K, "_sm90_library" if rt == "sm90" else "_library",
                        lambda: lib)
    monkeypatch.setattr(K, "_SM90_LIB" if rt == "sm90" else "_LIB", None)
    monkeypatch.setattr(K, "_library" if rt == "sm90" else "_sm90_library",
                        _refuse)
    y, cum, state = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q)
    K.reset_launches()
    lib.rc = 3
    for name in ("ssd_chunk_scan_ref", "ssd_chunk_states_ref",
                 "ssd_chunk_scan_bwd_ref"):
        monkeypatch.setattr(K, name, _refuse)
    with pytest.raises(RuntimeError, match="boom"):
        if which == "fwd":
            K.SSDChunkScan.apply(x, dt, A, B, C, Q)
        else:
            K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cum, state, Q)
    assert K.launches_by_route == {"sm90": 0, "mma": 0}
    assert K.launches_by_pass == {"fwd": 0, "bwd": 0}


@pytest.mark.parametrize("dtype,shape", [
    (torch.bfloat16, (1, 128, 4, 64, 1, 64, 64)),     # sm90's geometry
    (torch.float32, (1, 128, 4, 64, 1, 64, 64)),      # mma's
    (torch.bfloat16, (2, 64, 4, 16, 1, 16, 16)),      # mma's, bf16
])
def test_no_launch_on_cpu_or_meta(monkeypatch, dtype, shape):
    """CPU and ``meta`` tensors run the plain scan on either route's
    geometry: neither library is loaded and no launch is counted."""
    monkeypatch.setattr(K, "_sm90_library", _refuse)
    monkeypatch.setattr(K, "_library", _refuse)
    K.reset_launches()
    b, s, nh, hp, g, n, Q = shape
    x, dt, A, B, C, dy = _inputs(7, b, s, nh, hp, g, n, dtype)
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    K.ssd_chunk_scan(*leaves, Q).backward(dy)
    assert all(t.grad is not None for t in leaves)
    meta = [t.to("meta") for t in (x, dt, A, B, C)]
    assert K.ssd_chunk_scan(*meta, Q).device.type == "meta"
    assert K.launches_by_route == {"sm90": 0, "mma": 0}
    assert K.launches_by_pass == {"fwd": 0, "bwd": 0}
    assert K.ssd_chunk_scan_cuda.launches == 0
