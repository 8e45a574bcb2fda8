"""The Mamba-2 SSD chunk scan of training and prefill, forward and
backward: the CUDA kernel's wrapper, its autograd and its plain PyTorch
versions.

Counterpart of the chunked SSD in :func:`repro.models.ssm.ssm_apply`
(ssm.py:93-141, XLA einsums and a ``lax.scan``, not a Pallas kernel):
``x`` (b, S, nh, hp) and ``B`` / ``C`` (b, S, g, N) in the compute dtype,
``dt`` (b, S, nh) fp32 after the softplus, ``A`` (nh,) fp32 (``-exp(A_log)``)
-> ``y = y_diag + y_off`` (b, S, nh, hp) in x's dtype, over chunks of
``Q = min(chunk, S)`` positions, from a zero state, with no final state.
The ``D`` skip, the gate and norm stay in :mod:`repro_torch.models.ssm`.

:func:`ssd_chunk_scan` dispatches on the tensors' device: CUDA tensors go
through :class:`SSDChunkScan` to the kernel (``csrc/ssd_chunk_scan.cu``,
CUDA C++ for ``sm_90a`` built by ``nvcc`` at first use; a build or launch
failure raises): three forward launches (chunk states, the state pass,
the scan), which save the in-chunk cumsum and the state entering each
chunk (fp32) and never a (Q, Q) tensor, and six backward launches.  CPU
and ``meta`` tensors (the dry run) run :func:`ssd_chunk_scan_ref`, the
reference's arithmetic, under autograd.

x, B and C are read where they lie (the last dim contiguous, every other
stride a multiple of 16 bytes): the layer hands the kernel its
``torch.split`` views of the conv output with no copy.

:func:`ssd_chunk_states_ref` and :func:`ssd_chunk_scan_bwd_ref` are the
kernel's algorithm as plain fp32 tensor code: the in-chunk cumsum and the
states entering each chunk; the backward (``dH_c = G_c + exp(cum_L)
dH_{c+1}``, then dx, dB, dC and d(cum), the latter turned into ddt and dA
by a reverse cumsum).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import nvcc
from .flash_attention import _layout_ok

__all__ = ["ssd_chunk_scan", "ssd_chunk_scan_cuda", "ssd_chunk_scan_ref",
           "ssd_chunk_states_ref", "ssd_chunk_scan_bwd_ref",
           "ssd_chunk_scan_fwd_cuda", "ssd_chunk_scan_bwd_cuda",
           "SSDChunkScan", "build_library", "SOURCE", "launches_by_pass",
           "reset_launches", "chunk_len", "PLANT_STATE", "PLANT_DIAG",
           "FWD_LAUNCHES", "BWD_LAUNCHES"]

SOURCE = nvcc.CSRC / "ssd_chunk_scan.cu"
# the kernel's dtypes and their codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# kernel launches of a forward and of a backward call
FWD_LAUNCHES = 3
BWD_LAUNCHES = 6
# must match the .cu (kMaxQ, kSlice)
MAX_Q = 256
_SLICE = 1024
# planted faults (``plant=``), for the smoke check only: chunk 1's
# carried state dropped; the intra-chunk mask's diagonal dropped
PLANT_STATE = 1
PLANT_DIAG = 2

_LIB: Optional[ctypes.CDLL] = None
# calls since the last reset (CPU calls excluded): "fwd" FWD_LAUNCHES
# launches each, "bwd" BWD_LAUNCHES
launches_by_pass: Dict[str, int] = {"fwd": 0, "bwd": 0}


def chunk_len(seq: int, chunk: int) -> int:
    """The chunk ``Q = min(chunk, seq)``; raises unless it divides
    ``seq``."""
    q = min(chunk, seq)
    if seq % q:
        raise ValueError(f"seq {seq} not divisible by SSD chunk {q}")
    return q


def ssd_chunk_scan_ref(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """The plain forward, the reference's arithmetic (ssm.py:103-138):
    ``y_diag + y_off`` (b, S, nh, hp) in x's dtype.  The (Q, Q) scores
    are fp32, rounded to x's dtype before the product with x; the
    carried state is in x's dtype."""
    bsz, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = chunk_len(S, chunk)
    nc = S // Q
    x = x.reshape(bsz, nc, Q, nh, hp)
    B = B.reshape(bsz, nc, Q, g, n)
    C = C.reshape(bsz, nc, Q, g, n)
    dt = dt.reshape(bsz, nc, Q, nh)
    hpg = nh // g                                           # heads per group
    dA = dt * A                                             # (b,c,Q,nh)
    cum = torch.cumsum(dA, dim=2)                           # (b,c,Q,nh)

    # ---- intra-chunk (dual quadratic form) --------------------------------
    # L[i,j] = exp(cum_i - cum_j) for i >= j; masked before exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (b,c,Q,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))
    L = torch.exp(diff.masked_fill(~mask[None, None, :, :, None],
                                   -math.inf))
    # scores[i,j] = (C_i . B_j) * L[i,j] * dt_j
    CB = torch.einsum("bcqgn,bcsgn->bcqsg", C, B)           # (b,c,Q,Q,g)
    CB = torch.repeat_interleave(CB, hpg, dim=-1)           # (b,c,Q,Q,nh)
    W = CB * L * dt[:, :, None, :, :]
    y_diag = torch.einsum("bcqsh,bcshp->bcqhp", W.to(x.dtype), x)

    # ---- chunk summary states ---------------------------------------------
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)          # (b,c,Q,nh)
    Bh = torch.repeat_interleave(B, hpg, dim=-2).reshape(
        bsz, nc, Q, nh, n)
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchnp",
                          (decay_end * dt).to(x.dtype), Bh, x)

    # ---- inter-chunk recurrence (emit h_{c-1}) ----------------------------
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,c,nh)
    h = torch.zeros((bsz, nh, n, hp), dtype=x.dtype, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) \
            + states[:, c]
    h_prev = torch.stack(prev, dim=1)                       # (b,c,nh,n,p)

    Ch = torch.repeat_interleave(C, hpg, dim=-2).reshape(
        bsz, nc, Q, nh, n)
    y_off = torch.einsum("bcqhn,bchnp,bcqh->bcqhp", Ch, h_prev,
                         torch.exp(cum).to(x.dtype))
    return (y_diag + y_off).reshape(bsz, S, nh, hp)


def _heads(t, nh: int, nc: int, Q: int):
    """(b, S, g, N) -> fp32 (b, nc, Q, nh, N), each group's rows repeated
    over its heads."""
    bsz, _, g, n = t.shape
    return torch.repeat_interleave(t.to(torch.float32), nh // g,
                                   dim=2).reshape(bsz, nc, Q, nh, n)


def ssd_chunk_states_ref(x, dt, A, B, C, chunk: int):
    """The kernel's forward state as plain fp32 tensor code: ``(cum,
    state)``, cum (b, nc, nh, Q) the in-chunk inclusive cumsum of dt * A,
    state (b, nc, nh, N, hp) the state entering each chunk (0 for the
    first), in the layouts the kernel writes."""
    bsz, S, nh, hp = x.shape
    Q = chunk_len(S, chunk)
    nc = S // Q
    f32 = torch.float32
    xf = x.to(f32).reshape(bsz, nc, Q, nh, hp)
    cum = torch.cumsum(dt.reshape(bsz, nc, Q, nh) * A, dim=2)
    w = torch.exp(cum[:, :, -1:, :] - cum) * dt.reshape(bsz, nc, Q, nh)
    states = torch.einsum("bcqhn,bcqhp->bchnp", _heads(B, nh, nc, Q),
                          xf * w[..., None])
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(nc):
        prev.append(h)
        h = torch.exp(cum[:, c, -1, :])[..., None, None] * h + states[:, c]
    return cum.permute(0, 1, 3, 2).contiguous(), torch.stack(prev, dim=1)


def ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, chunk: int):
    """The kernel's backward as plain fp32 tensor code: ``(dx, ddt, dA,
    dB, dC)`` (dx, dB and dC in the inputs' dtypes, ddt (b, S, nh) and dA
    (nh,) fp32) from y's gradient ``dy``.  With H_c the state entering
    chunk c and M = dy x^T, L the decay mask, W = (C B^T) o L o dt:
    G_c = C^T (exp(cum) dy), D_c = dH_{c+1}, dH_c = G_c + exp(cum_L)
    dH_{c+1}; dx = W^T dy + decay dt (B D), dB = (M o L o dt)^T C +
    decay dt (x D^T), dC = (M o L o dt) B + exp(cum) (dy H^T); d(cum)
    from the scores' row and column sums, y_off . dy, the states' decays
    and the chunk decays <D_c, H_c>, turned into ddt and dA by a reverse
    cumsum over the chunk."""
    bsz, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    Q = chunk_len(S, chunk)
    nc = S // Q
    f32 = torch.float32
    xf = x.to(f32).reshape(bsz, nc, Q, nh, hp)
    dyf = dy.to(f32).reshape(bsz, nc, Q, nh, hp)
    Bh, Ch = _heads(B, nh, nc, Q), _heads(C, nh, nc, Q)
    dtc = dt.reshape(bsz, nc, Q, nh)
    cum, H = ssd_chunk_states_ref(x, dt, A, B, C, chunk)
    cum = cum.permute(0, 1, 3, 2)                           # (b,c,Q,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    L = torch.exp((cum[:, :, :, None, :] - cum[:, :, None, :, :])
                  .masked_fill(~mask, -math.inf))           # (b,c,i,j,nh)
    CB = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh)
    M = torch.einsum("bcihp,bcjhp->bcijh", dyf, xf)
    W = CB * L * dtc[:, :, None]
    dsl = M * L * dtc[:, :, None]
    ecum = torch.exp(cum)
    G = torch.einsum("bcihn,bcihp->bchnp", Ch, dyf * ecum[..., None])
    # the reverse state pass
    chunk_decay = torch.exp(cum[:, :, -1, :])               # (b,c,nh)
    D = torch.zeros_like(H)
    dcl = torch.zeros_like(chunk_decay)
    dh = torch.zeros_like(H[:, 0])
    for c in reversed(range(nc)):
        D[:, c] = dh
        dcl[:, c] = chunk_decay[:, c] * (dh * H[:, c]).sum((-2, -1))
        dh = G[:, c] + chunk_decay[:, c, :, None, None] * dh
    wdec = torch.exp(cum[:, :, -1:, :] - cum) * dtc         # decay dt
    BD = torch.einsum("bcjhn,bchnp->bcjhp", Bh, D)
    xD = torch.einsum("bcjhp,bchnp->bcjhn", xf, D)
    dyH = torch.einsum("bcihp,bchnp->bcihn", dyf, H)
    dx = torch.einsum("bcijh,bcihp->bcjhp", W, dyf) + wdec[..., None] * BD
    dBh = torch.einsum("bcijh,bcihn->bcjhn", dsl, Ch) + wdec[..., None] * xD
    dCh = torch.einsum("bcijh,bcjhn->bcihn", dsl, Bh) + ecum[..., None] * dyH
    qsum = (CB * L * M).sum(2)                              # over i
    e = torch.exp(cum[:, :, -1:, :] - cum) * (xf * BD).sum(-1)
    psum = (W * M).sum(3)                                   # over j
    yd = ecum * (Ch * dyH).sum(-1)
    dcum = psum + yd - dtc * (qsum + e)
    dcum[:, :, -1] += (dtc * e).sum(2) + dcl
    da = dcum.flip(2).cumsum(2).flip(2)
    ddt = qsum + e + A * da
    dA = (dtc * da).sum((0, 1, 2))

    def per_group(t):
        return t.reshape(bsz, nc, Q, g, nh // g, n).sum(4).reshape(
            bsz, S, g, n)

    return (dx.reshape(bsz, S, nh, hp).to(x.dtype), ddt.reshape(bsz, S, nh),
            dA, per_group(dBh).to(B.dtype), per_group(dCh).to(C.dtype))


def _check(x, dt, A, B, C, chunk: int) -> int:
    """The kernel's contract, on any device (``meta`` included): raises on
    a shape, dtype or stride it does not take; returns the chunk Q."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 4 \
            or C.shape != B.shape:
        raise ValueError(f"need x (b,S,nh,hp), dt (b,S,nh), A (nh,) and B, "
                         f"C (b,S,g,N), got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(A.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    bsz, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (bsz, S, nh) or tuple(A.shape) != (nh,) \
            or tuple(B.shape[:2]) != (bsz, S) or g < 1 or nh % g:
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)} do not fit x {tuple(x.shape)}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype \
            or dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"no SSD chunk-scan kernel for x {x.dtype}, B "
                        f"{B.dtype}, C {C.dtype}, dt {dt.dtype}, A {A.dtype}"
                        f" (x, B, C bf16 or fp32 alike; dt, A fp32)")
    Q = chunk_len(S, chunk)
    if Q % 16 or Q > MAX_Q or n % 16 or not 16 <= n <= 128 or hp % 16 \
            or not 16 <= hp <= 128 or bsz * nh > 65535:
        raise ValueError(f"no SSD chunk-scan kernel for Q {Q}, N {n}, hp "
                         f"{hp}, b {bsz}, nh {nh} (Q a multiple of 16 up to "
                         f"{MAX_Q}; N, hp multiples of 16 up to 128)")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if not _layout_ok(t):
            raise ValueError(f"{name} strides {t.stride()}: the last dim "
                             f"must be contiguous and the others multiples "
                             f"of 16 bytes, 16-byte aligned")
    if not dt.is_contiguous() or not A.is_contiguous():
        raise ValueError("dt and A must be contiguous")
    return Q


def build_library():
    """Compile ``SOURCE`` (if not built yet); return the shared library's
    path."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.ssd_chunk_scan_fwd.argtypes = (
            [c_int] + [c_ptr] * 8 + [strides] + [c_int] * 8 + [c_ptr])
        lib.ssd_chunk_scan_fwd.restype = c_int
        lib.ssd_chunk_scan_bwd.argtypes = (
            [c_int] + [c_ptr] * 19 + [strides] + [c_int] * 7 + [c_ptr])
        lib.ssd_chunk_scan_bwd.restype = c_int
        lib.ssd_chunk_scan_error_string.argtypes = [c_int]
        lib.ssd_chunk_scan_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _strides(*ts) -> ctypes.Array:
    """The strides the kernel reads, in elements: each tensor's first
    three (0 for a dim of size 1), as a C array of 12."""
    vals = [0 if n == 1 else st for t in ts
            for n, st in zip(t.shape[:3], t.stride()[:3])]
    vals += [0] * (12 - len(vals))
    return (ctypes.c_longlong * 12)(*vals)


def _on_card(*ts) -> int:
    dev = ts[0].device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError(f"no SSD chunk-scan kernel for tensors on "
                         f"{sorted({str(t.device) for t in ts})}")
    return ts[0].get_device()


def _launch(fn, args, index: int, what: str) -> None:
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err:
        msg = _library().ssd_chunk_scan_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk_scan_{what} failed: {msg}")


def ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, chunk: int, plant: int = 0):
    """The forward's three launches on CUDA tensors: ``(y, cum, state)``,
    y (b, S, nh, hp) contiguous in x's dtype, cum (b, nc, nh, Q) and
    state (b, nc, nh, N, hp) fp32 (the state entering each chunk), which
    the backward reads.  ``plant``: 0, or the smoke check's planted
    faults (``PLANT_STATE``, ``PLANT_DIAG``)."""
    Q = _check(x, dt, A, B, C, chunk)
    index = _on_card(x, dt, A, B, C)
    bsz, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = S // Q
    y = torch.empty((bsz, S, nh, hp), dtype=x.dtype, device=x.device)
    cum = torch.empty((bsz, nc, nh, Q), dtype=torch.float32, device=x.device)
    state = torch.empty((bsz, nc, nh, n, hp), dtype=torch.float32,
                        device=x.device)
    lib = _LIB or _library()
    _launch(lib.ssd_chunk_scan_fwd,
            (_DTYPES[x.dtype], x.data_ptr(), B.data_ptr(), C.data_ptr(),
             dt.data_ptr(), A.data_ptr(), y.data_ptr(), cum.data_ptr(),
             state.data_ptr(), _strides(x, B, C), bsz, S, nh, hp, g, n, Q,
             int(plant), torch._C._cuda_getCurrentRawStream(index)),
            index, "fwd")
    ssd_chunk_scan_cuda.launches += FWD_LAUNCHES
    launches_by_pass["fwd"] += 1
    return y, cum, state


def ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cum, state, chunk: int):
    """The backward's six launches on CUDA tensors: ``(dx, ddt, dA, dB,
    dC)`` (dx, dB, dC contiguous in the inputs' dtype; ddt, dA fp32) from
    :func:`ssd_chunk_scan_fwd_cuda`'s ``cum`` and ``state`` and y's
    gradient ``dy`` (strided like x)."""
    Q = _check(x, dt, A, B, C, chunk)
    index = _on_card(dy, x, dt, A, B, C, cum, state)
    bsz, S, nh, hp = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = S // Q
    if dy.shape != x.shape or dy.dtype != x.dtype or not _layout_ok(dy) \
            or tuple(cum.shape) != (bsz, nc, nh, Q) \
            or tuple(state.shape) != (bsz, nc, nh, n, hp) \
            or cum.dtype != torch.float32 or state.dtype != torch.float32 \
            or not cum.is_contiguous() or not state.is_contiguous():
        raise ValueError(f"dy {tuple(dy.shape)} {dy.stride()} {dy.dtype}, "
                         f"cum {tuple(cum.shape)}, state "
                         f"{tuple(state.shape)} do not fit x "
                         f"{tuple(x.shape)}")
    dev, f32 = x.device, torch.float32
    dstate = torch.empty_like(state)
    dcl = torch.empty((bsz, nc, nh, -(-n * hp // _SLICE)), dtype=f32,
                      device=dev)
    rows = torch.empty((4, bsz, nc, nh, Q), dtype=f32, device=dev)
    dbp = torch.empty((bsz, S, nh, n), dtype=f32, device=dev)
    dcp = torch.empty((bsz, S, nh, n), dtype=f32, device=dev)
    dap = torch.empty((bsz, nc, nh), dtype=f32, device=dev)
    dx = torch.empty((bsz, S, nh, hp), dtype=x.dtype, device=dev)
    ddt = torch.empty((bsz, S, nh), dtype=f32, device=dev)
    dA = torch.empty((nh,), dtype=f32, device=dev)
    dB = torch.empty((bsz, S, g, n), dtype=B.dtype, device=dev)
    dC = torch.empty((bsz, S, g, n), dtype=C.dtype, device=dev)
    lib = _LIB or _library()
    ptrs = [t.data_ptr() for t in (x, B, C, dt, A, dy, cum, state, dstate,
                                   dcl, rows, dbp, dcp, dap, dx, ddt, dA, dB,
                                   dC)]
    _launch(lib.ssd_chunk_scan_bwd,
            (_DTYPES[x.dtype], *ptrs, _strides(x, B, C, dy), bsz, S, nh, hp,
             g, n, Q, torch._C._cuda_getCurrentRawStream(index)),
            index, "bwd")
    ssd_chunk_scan_cuda.launches += BWD_LAUNCHES
    launches_by_pass["bwd"] += 1
    return dx, ddt, dA, dB, dC


class SSDChunkScan(torch.autograd.Function):
    """The kernel with its backward: three forward launches, saving x,
    dt, A, B, C, the in-chunk cumsum and the state entering each chunk
    (fp32); six backward launches."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        y, cum, state = ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C, cum, state)
        ctx.chunk = chunk
        return y

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, B, C, cum, state = ctx.saved_tensors
        if not _layout_ok(dy):          # a broadcast gradient, say
            dy = dy.contiguous()
        dx, ddt, dA, dB, dC = ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C,
                                                      cum, state, ctx.chunk)
        return dx, ddt, dA, dB, dC, None


def ssd_chunk_scan_cuda(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """The scan of CUDA tensors (shapes and dtypes as
    :func:`ssd_chunk_scan_ref`) on the kernel, differentiable in x, dt,
    A, B and C.  Raises on what the kernel does not take
    (:func:`_check`)."""
    return SSDChunkScan.apply(x, dt, A, B, C, chunk)


# kernel launches since the last reset (a forward three, a backward six;
# CPU calls excluded); calls by pass in launches_by_pass
ssd_chunk_scan_cuda.launches = 0


def reset_launches() -> None:
    """Set :attr:`ssd_chunk_scan_cuda.launches` and each pass's count to
    0."""
    ssd_chunk_scan_cuda.launches = 0
    for k in launches_by_pass:
        launches_by_pass[k] = 0


def ssd_chunk_scan(x, dt, A, B, C, chunk: int) -> torch.Tensor:
    """``y_diag + y_off`` of the chunked SSD: the kernel for CUDA
    tensors, :func:`ssd_chunk_scan_ref` for CPU and ``meta`` tensors."""
    if x.device.type in ("cpu", "meta"):
        return ssd_chunk_scan_ref(x, dt, A, B, C, chunk)
    return ssd_chunk_scan_cuda(x, dt, A, B, C, chunk)
