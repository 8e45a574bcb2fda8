"""Mamba-2's decode mixer, one token: the CUDA kernel's wrapper, its
planner and router, and its plain PyTorch versions.

Counterpart of the body of :func:`repro.models.ssm.ssm_decode` between
``in_proj`` and ``out_proj`` (ssm.py:169-190; XLA, not a Pallas
kernel): the conv window (the 4 taps over the window and this token's
x, B, C columns, the bias and SiLU), dt (softplus with its bias), the
state update and readout ``h' = h exp(dt A) + dt B (x) x``, ``y = C h' +
D x``, and the gated norm ``rmsnorm(y silu(z), norm_w)``.
:func:`ssm_decode_mixer` takes the ``in_proj`` output row where it lies
and returns the gated, normed row that ``out_proj`` reads and the new
conv window (a new tensor); the state ``h`` is updated in place on every
device.  It dispatches on the tensors and their shapes:

* CUDA tensors that :func:`route` plans on ``"sm90"`` launch
  ``csrc/ssm_decode_sm90.cu`` (CUDA C++ for ``sm_90a``, built by ``nvcc``
  at first use, loaded with ``ctypes``): one launch a call, one block a
  (batch row, head), the head's state slice brought by a bulk TMA copy
  while the block computes its conv columns and dt, and the row norm
  finished by the block that draws a batch row's last ticket.
* every other CUDA call takes the ``"unfused"`` route: the tensor code
  of :func:`ssm_decode_mixer_ref` around the Triton SSD step
  (:func:`repro_torch.kernels.ssd_decode.ssd_decode_step_cuda`) and the
  gated norm's kernels (:func:`repro_torch.kernels.gated_norm.gated_norm_cuda`).
  The route is chosen by shape, dtype and layout, never on a failure: a
  build or launch failure raises.
* CPU and ``meta`` tensors (the dry run) run :func:`ssm_decode_mixer_ref`,
  the arithmetic that ``models/ssm.py`` ran before the kernel.

:func:`ssm_decode_mixer_splits_ref` is the kernel's algorithm as plain
fp32 tensor code: the conv's fp32 sum rounded once, each block's partial
sum of squares of the gated row and their fixed-order sum.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Iterator, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import nvcc
from .gated_norm import EPS, gated_norm_cuda, gated_norm_ref
from .ssd_decode import ssd_decode_step_cuda, ssd_decode_step_ref

__all__ = ["ssm_decode_mixer", "ssm_decode_mixer_ref",
           "ssm_decode_mixer_splits_ref", "ssm_decode_mixer_cuda",
           "conv_once_rounded", "plan", "route", "blocks", "Plan",
           "launches_by_route", "reset_launches", "build_library",
           "softplus",
           "SOURCE", "ROUTES", "THREADS", "D_CONV", "MAX_N", "MAX_HP",
           "MAX_B", "LANES", "PLANT_SHIFT", "PLANT_PARTIAL"]

SOURCE = nvcc.CSRC / "ssm_decode_sm90.cu"
ROUTES = ("sm90", "unfused")
# the .cu's constants: threads a block (kThreads), the conv's taps
# (kTaps), the largest d_state and head_dim a block holds (kMaxN,
# kMaxHp), the lanes of the fixed-order sum of a row's partials (kLanes)
THREADS = 256
D_CONV = 4
MAX_N = 128
MAX_HP = 128
LANES = 32
# batch rows a launch may hold: the per-device ticket counters, one a
# row, allocated once and never replaced (a captured CUDA graph keeps
# their address)
MAX_B = 1 << 16
# planted faults (chip_smoke.py): the new window written unshifted, or
# the first block's partial left out of the row's norm
PLANT_SHIFT = 1
PLANT_PARTIAL = 2
_DTYPES = (torch.bfloat16, torch.float32)
_LIB: Optional[ctypes.CDLL] = None
_COUNTERS: Dict[int, torch.Tensor] = {}

# mixer calls by route since the last reset (CPU and meta calls
# excluded): one kernel launch a call on sm90; the unfused route's
# kernels count their own launches
launches_by_route: Dict[str, int] = {r: 0 for r in ROUTES}


class Plan(NamedTuple):
    """A launch: ``vpr`` 16-byte vectors a row of a head's state slice
    (each of the block's :data:`THREADS` threads takes one vector of rows
    ``THREADS / vpr`` apart), ``blocks`` in all (one a (b, head), each
    leaving one partial of its row's norm), the dynamic shared memory a
    block (the .cu's ``smem_of``)."""
    vpr: int
    blocks: int
    smem: int


def plan(bsz: int, heads: int, n: int, hp: int, groups: int, d_conv: int,
         itemsize: int) -> Optional[Plan]:
    """The ``sm90`` launch for a batch of ``bsz`` rows of ``heads`` heads
    of ``hp`` columns, d_state ``n``, ``groups`` groups, a ``d_conv``-tap
    conv, in a compute dtype of ``itemsize`` bytes; ``None`` where the
    kernel does not take the shape (d_conv not 4, n or hp past 128, hp
    not a power of two of 16-byte rows, a batch past :data:`MAX_B`)."""
    if d_conv != D_CONV or itemsize not in (2, 4) or groups < 1 \
            or heads < 1 or heads % groups or not 1 <= bsz <= MAX_B \
            or not 1 <= n <= MAX_N or hp < 1 or hp & (hp - 1) \
            or hp > MAX_HP or hp * itemsize % 16:
        return None
    # the block's fp32 arrays after the state slice: x, silu(z) (hp
    # each), B, C (n each), the warps' y partials (8 x hp), 16 scalars
    smem = 128 + n * hp * itemsize + 4 * (2 * hp + 2 * n + 8 * hp + 16)
    return Plan(hp * itemsize // 16, bsz * heads, smem)


def blocks(bsz: int, heads: int, hp: int, groups: int
           ) -> Iterator[Tuple[int, int, int, range, bool]]:
    """``(block, b, head, columns, writes B and C)`` of each block of a
    launch: block ``b * heads + head`` takes the columns ``[head hp,
    (head + 1) hp)`` of the row's x, z and output, and writes those conv
    channels of the new window; the first block of each (b, group) also
    writes the group's B and C channels."""
    hpg = heads // groups
    for b in range(bsz):
        for head in range(heads):
            yield (b * heads + head, b, head,
                   range(head * hp, (head + 1) * hp), head % hpg == 0)


def _dims(zxbcdt, window, h, conv_w, norm_w, groups: int):
    bsz, nh, n, hp = h.shape
    d_in = norm_w.shape[0]
    return bsz, nh, n, hp, d_in, d_in + 2 * groups * n, conv_w.shape[0]


def _check(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w,
           groups: int) -> None:
    """The mixer's contract, on any device (``meta`` included): raises
    on shapes that do not fit one another or dtypes no route takes."""
    if h.dim() != 4 or zxbcdt.dim() != 3 or window.dim() != 3 \
            or conv_w.dim() != 2 or norm_w.dim() != 1:
        raise ValueError(f"need zxbcdt (B, 1, P), window (B, K - 1, C), h "
                         f"(B, H, N, P), conv_w (K, C), norm_w (d), got "
                         f"{tuple(zxbcdt.shape)}, {tuple(window.shape)}, "
                         f"{tuple(h.shape)}, {tuple(conv_w.shape)}, "
                         f"{tuple(norm_w.shape)}")
    bsz, nh, n, hp, d_in, conv_dim, k = _dims(zxbcdt, window, h, conv_w,
                                              norm_w, groups)
    width = 2 * d_in + 2 * groups * n + nh
    if groups < 1 or nh % groups or d_in != nh * hp \
            or tuple(zxbcdt.shape) != (bsz, 1, width) \
            or tuple(window.shape) != (bsz, k - 1, conv_dim) \
            or tuple(conv_w.shape) != (k, conv_dim) \
            or tuple(conv_b.shape) != (conv_dim,) \
            or any(tuple(t.shape) != (nh,) for t in (dt_bias, A_log, D)):
        raise ValueError(
            f"shapes do not fit {nh} heads of {hp}, d_state {n}, {groups} "
            f"group(s): zxbcdt {tuple(zxbcdt.shape)}, window "
            f"{tuple(window.shape)}, conv_w {tuple(conv_w.shape)}, conv_b "
            f"{tuple(conv_b.shape)}, dt_bias {tuple(dt_bias.shape)}, A_log "
            f"{tuple(A_log.shape)}, D {tuple(D.shape)}, norm_w "
            f"{tuple(norm_w.shape)}")
    ts = (zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w)
    if not all(t.is_floating_point() for t in ts):
        raise TypeError("the mixer's tensors must be floating point, got "
                        f"{[str(t.dtype) for t in ts]}")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn's softplus, ``logaddexp(x, 0)`` (``models.layers`` imports
    it from here)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _step_ref(h, x, dt, a_log, b, c, d):
    y, new = ssd_decode_step_ref(h, x, dt, a_log, b, c, d)
    return y, h.copy_(new)


def _chain(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w,
           groups: int, step, gate) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixer as tensor code around ``step`` (the SSD step: the
    state written over ``h``) and ``gate`` (the gated norm without the
    skip)."""
    bsz, nh, n, hp, d_in, _, _ = _dims(zxbcdt, window, h, conv_w, norm_w,
                                       groups)
    f32 = torch.float32
    z, x, B, C, dt_raw = torch.split(
        zxbcdt, [d_in, d_in, groups * n, groups * n, nh], dim=-1)
    xbc = torch.cat([x, B, C], -1)                          # (B,1,conv)
    win = torch.cat([window, xbc.to(window.dtype)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", win.to(zxbcdt.dtype),
                            conv_w) + conv_b
    xbc1 = F.silu(conv_out)[:, None, :]
    x, B, C = torch.split(xbc1, [d_in, groups * n, groups * n], dim=-1)

    dt = softplus(dt_raw.to(f32) + dt_bias)[:, 0]
    # the step takes A_log and D in fp32: at bf16 compute they are the
    # cast's bf16 values, converted exactly
    y, h = step(h, x.reshape(bsz, nh, hp), dt, A_log.to(f32),
                B.reshape(bsz, groups, n), C.reshape(bsz, groups, n),
                D.to(f32))
    y = y.reshape(bsz, 1, d_in).to(zxbcdt.dtype)
    y = gate(y, z, norm_w, nh)
    return y, win[:, 1:].to(window.dtype)


def ssm_decode_mixer_ref(zxbcdt: torch.Tensor, window: torch.Tensor,
                         h: torch.Tensor, conv_w: torch.Tensor,
                         conv_b: torch.Tensor, dt_bias: torch.Tensor,
                         A_log: torch.Tensor, D: torch.Tensor,
                         norm_w: torch.Tensor, groups: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version, the reference's arithmetic: ``(out (B, 1, d_in) in
    zxbcdt's dtype, the new window (B, K - 1, conv_dim) in window's)``,
    the new state written over ``h``.  ``zxbcdt`` is the ``in_proj``
    output (z, x, B, C, dt columns), ``window`` the last K - 1 conv
    inputs, ``h`` (B, heads, d_state, head_dim) the state."""
    return _chain(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D,
                  norm_w, groups, _step_ref, gated_norm_ref)


def conv_once_rounded(win: torch.Tensor, conv_w: torch.Tensor,
                      dtype: torch.dtype) -> torch.Tensor:
    """The conv as the kernel sums it: the taps' fp32 products of the
    window ``win`` (B, K, C) and ``conv_w`` (K, C) added in tap order,
    rounded once to ``dtype`` (returned in fp32)."""
    prod = win.to(torch.float32) * conv_w.to(torch.float32)
    acc = prod[:, 0]
    for k in range(1, prod.shape[1]):
        acc = acc + prod[:, k]
    return acc.to(dtype).to(torch.float32)


def _lane_sum(part: torch.Tensor) -> torch.Tensor:
    """The fixed-order sum of each row of ``part`` (B, heads) the kernel's
    last block takes: lane l of a warp adds partials l, l + 32, ... in
    order, then the lanes a butterfly (xor 16, 8, 4, 2, 1); lane 0's."""
    bsz, nblk = part.shape
    cols = -(-nblk // LANES) * LANES
    padded = torch.zeros((bsz, cols), dtype=torch.float32,
                         device=part.device)
    padded[:, :nblk] = part
    lanes = torch.zeros((bsz, LANES), dtype=torch.float32,
                        device=part.device)
    for j in range(cols // LANES):
        lanes = lanes + padded[:, j * LANES:(j + 1) * LANES]
    idx = torch.arange(LANES, device=part.device)
    off = LANES // 2
    while off:
        lanes = lanes + lanes[:, idx ^ off]
        off //= 2
    return lanes[:, 0]


def ssm_decode_mixer_splits_ref(zxbcdt: torch.Tensor, window: torch.Tensor,
                                h: torch.Tensor, conv_w: torch.Tensor,
                                conv_b: torch.Tensor, dt_bias: torch.Tensor,
                                A_log: torch.Tensor, D: torch.Tensor,
                                norm_w: torch.Tensor, groups: int,
                                plant: int = 0
                                ) -> Tuple[torch.Tensor, ...]:
    """The kernel's algorithm as plain fp32 tensor code, rounding where
    it rounds: ``(out, new window, new state, partials (B, heads))``; the
    inputs are left as they are.  The conv a fp32 sum rounded once
    (:func:`conv_once_rounded`), then the bias and SiLU each rounded to
    the compute dtype; dt, dA, the state and y in fp32 (the skip added
    before y's rounding); g = y silu(z) rounded; each block (a head) sums
    g^2 over its columns; the row's partials summed in the kernel's fixed
    order (:func:`_lane_sum`)."""
    _check(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w,
           groups)
    bsz, nh, n, hp, d_in, _, _ = _dims(zxbcdt, window, h, conv_w, norm_w,
                                       groups)
    dtype = zxbcdt.dtype
    if plan(bsz, nh, n, hp, groups, conv_w.shape[0], dtype.itemsize) is None:
        raise ValueError("no sm90 plan for this shape")
    f32 = torch.float32

    def rnd(t):
        return t.to(dtype).to(f32)

    row = zxbcdt[:, 0]
    gn = groups * n
    win = torch.cat([window, row[:, None, d_in:2 * d_in + 2 * gn]], dim=1)
    conv = conv_once_rounded(win, conv_w, dtype)
    xbc = rnd(F.silu(rnd(conv + conv_b.to(f32))))
    x = xbc[:, :d_in].reshape(bsz, nh, hp)
    hpg = nh // groups
    bb = xbc[:, d_in:d_in + gn].reshape(bsz, groups, n)
    cc = xbc[:, d_in + gn:].reshape(bsz, groups, n)
    bh = torch.repeat_interleave(bb, hpg, dim=1)
    ch = torch.repeat_interleave(cc, hpg, dim=1)
    dt = softplus(row[:, 2 * d_in + 2 * gn:].to(f32) + dt_bias.to(f32))
    da = torch.exp(dt * -torch.exp(A_log.to(f32)))
    h32 = h.to(f32) * da[..., None, None] \
        + (dt[..., None, None] * bh[..., :, None]) * x[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", ch, h32) + D.to(f32)[:, None] * x
    g = rnd(rnd(y.reshape(bsz, d_in)) * rnd(F.silu(row[:, :d_in].to(f32))))
    part = (g * g).reshape(bsz, nh, hp).sum(-1)
    if plant & PLANT_PARTIAL:
        part = part.clone()
        part[:, 0] = 0.0
    r = torch.rsqrt(_lane_sum(part) / d_in + EPS)
    out = rnd(g * r[:, None] * norm_w.to(f32))
    new_win = (window if plant & PLANT_SHIFT else win[:, 1:]).to(
        window.dtype)
    return (out.to(dtype)[:, None], new_win.clone(), h32.to(h.dtype),
            part)


def route(zxbcdt: torch.Tensor, window: torch.Tensor, h: torch.Tensor,
          conv_w: torch.Tensor, conv_b: torch.Tensor, dt_bias: torch.Tensor,
          A_log: torch.Tensor, D: torch.Tensor, norm_w: torch.Tensor,
          groups: int) -> str:
    """The route of a call on CUDA tensors: ``"sm90"`` where :func:`plan`
    takes the shape, zxbcdt, the window, h, conv_w and conv_b share a
    compute dtype of bf16 or fp32 (dt_bias, A_log, D and norm_w bf16 or
    fp32), h is contiguous, h and norm_w lie on 16-byte boundaries and
    the other tensors have their last dim contiguous (the 1-D ones
    contiguous); else ``"unfused"``."""
    bsz, nh, n, hp, _, _, k = _dims(zxbcdt, window, h, conv_w, norm_w,
                                    groups)
    dtype = zxbcdt.dtype
    if dtype not in _DTYPES \
            or any(t.dtype != dtype for t in (window, h, conv_w, conv_b)) \
            or any(t.dtype not in _DTYPES
                   for t in (dt_bias, A_log, D, norm_w)) \
            or plan(bsz, nh, n, hp, groups, k, dtype.itemsize) is None:
        return "unfused"
    if not h.is_contiguous() or h.data_ptr() % 16 \
            or norm_w.data_ptr() % 16 \
            or zxbcdt.stride(2) != 1 or window.stride(2) != 1 \
            or conv_w.stride(1) != 1 \
            or not all(t.is_contiguous()
                       for t in (conv_b, dt_bias, A_log, D, norm_w)):
        return "unfused"
    return "sm90"


def build_library():
    """Compile ``csrc/ssm_decode_sm90.cu`` (if not built yet); return the
    shared library's path."""
    return nvcc.build_library(SOURCE)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_library()))
        c_int, c_ll, c_ptr = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        lib.ssm_decode_sm90.argtypes = (
            [c_ptr, c_ll, c_ptr, c_ll, c_ll] + [c_ptr] * 11 + [c_int] * 8
            + [ctypes.c_float, c_int, c_ptr])
        lib.ssm_decode_sm90.restype = c_int
        lib.ssm_decode_sm90_error_string.argtypes = [c_int]
        lib.ssm_decode_sm90_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _counters(device: torch.device) -> torch.Tensor:
    """The :data:`MAX_B` ticket counters of ``device``, zeroed at the
    first call on it.  That call must not be captured: the zeroing would
    run only when the graph is replayed.  Batch row b's counter is shared
    by every launch on the device, so one ``sm90`` launch may be in
    flight on a device at a time: launches on concurrent streams of one
    device would interleave their tickets."""
    cnt = _COUNTERS.get(device.index)
    if cnt is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "ssm_decode_mixer: the first call on a device allocates its "
                "ticket counters and cannot be captured; make one call "
                "outside the CUDA graph first")
        cnt = torch.zeros(MAX_B, dtype=torch.int32, device=device)
        _COUNTERS[device.index] = cnt
    return cnt


def _sm90(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w,
          groups: int, plant: int):
    bsz, nh, n, hp, d_in, conv_dim, k = _dims(zxbcdt, window, h, conv_w,
                                              norm_w, groups)
    index = h.get_device()
    out = torch.empty((bsz, 1, d_in), dtype=zxbcdt.dtype, device=h.device)
    new_win = torch.empty((bsz, k - 1, conv_dim), dtype=window.dtype,
                          device=h.device)
    part = torch.empty(bsz * nh, dtype=torch.float32, device=h.device)
    cnt = _counters(h.device)
    f32 = [int(t.dtype == torch.float32) for t in (dt_bias, A_log, D,
                                                   norm_w)]
    flags = f32[0] | f32[1] << 1 | f32[2] << 2 | f32[3] << 3
    lib = _LIB or _library()
    args = (zxbcdt.data_ptr(), zxbcdt.stride(0), window.data_ptr(),
            window.stride(0), window.stride(1), conv_w.data_ptr(),
            conv_b.data_ptr(), dt_bias.data_ptr(), A_log.data_ptr(),
            D.data_ptr(), norm_w.data_ptr(), h.data_ptr(), out.data_ptr(),
            new_win.data_ptr(), part.data_ptr(), cnt.data_ptr(), bsz, nh, n,
            hp, groups, conv_w.stride(0),
            int(zxbcdt.dtype == torch.float32), flags, EPS, plant,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        err = lib.ssm_decode_sm90(*args)
    else:
        with torch.cuda.device(index):
            err = lib.ssm_decode_sm90(*args)
    if err:
        raise RuntimeError("ssm_decode_sm90 failed: "
                           f"{lib.ssm_decode_sm90_error_string(err).decode()}")
    ssm_decode_mixer.launches += 1
    return out, new_win


def _route(ts, groups: int, chosen: Optional[str]) -> str:
    """The planned route of a call (:func:`route`), or ``chosen`` where
    it takes the call (``"unfused"`` takes every call; ``"sm90"`` raises
    on a call it does not plan)."""
    if chosen is not None and chosen not in ROUTES:
        raise ValueError(f"route {chosen!r} is not one of {ROUTES}")
    planned = route(*ts, groups)
    if chosen == "sm90" and planned != "sm90":
        raise ValueError(f"the sm90 route takes no call of zxbcdt "
                         f"{ts[0].dtype} {tuple(ts[0].shape)}, h "
                         f"{ts[2].dtype} {tuple(ts[2].shape)}")
    return chosen or planned


def ssm_decode_mixer_cuda(zxbcdt: torch.Tensor, window: torch.Tensor,
                          h: torch.Tensor, conv_w: torch.Tensor,
                          conv_b: torch.Tensor, dt_bias: torch.Tensor,
                          A_log: torch.Tensor, D: torch.Tensor,
                          norm_w: torch.Tensor, groups: int, plant: int = 0,
                          route: Optional[str] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mixer on CUDA tensors.  ``route``: the one :func:`route`
    plans when ``None``; ``"unfused"`` runs any call on the chain the
    kernel replaces (timed beside it); ``"sm90"`` raises on a call it
    does not plan.  ``plant`` (:data:`PLANT_SHIFT`,
    :data:`PLANT_PARTIAL`) plants a fault in the kernel.  One ``sm90``
    launch may be in flight on a device at a time (:func:`_counters`)."""
    _check(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w,
           groups)
    ts = (zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D, norm_w)
    if not all(t.is_cuda and t.device == h.device for t in ts):
        raise ValueError("no decode-mixer kernel for "
                         f"{sorted({str(t.device) for t in ts})}")
    rt = _route(ts, groups, route)
    if plant and rt != "sm90":
        raise ValueError("faults are planted in the sm90 kernel only")
    if rt == "sm90":
        result = _sm90(*ts, groups, plant)
    else:
        result = _chain(*ts, groups, ssd_decode_step_cuda, gated_norm_cuda)
    launches_by_route[rt] += 1
    return result


def ssm_decode_mixer(zxbcdt: torch.Tensor, window: torch.Tensor,
                     h: torch.Tensor, conv_w: torch.Tensor,
                     conv_b: torch.Tensor, dt_bias: torch.Tensor,
                     A_log: torch.Tensor, D: torch.Tensor,
                     norm_w: torch.Tensor, groups: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token of Mamba-2's mixer: ``(out (B, 1, d_in), new window)``
    (shapes and dtypes as :func:`ssm_decode_mixer_ref`), the new state
    written over ``h`` on every device.  CUDA: the planned route (one
    ``sm90`` launch in flight on a device at a time); CPU and ``meta``:
    the plain version."""
    if h.device.type in ("cpu", "meta"):  # meta: the dry run
        _check(zxbcdt, window, h, conv_w, conv_b, dt_bias, A_log, D,
               norm_w, groups)
        return ssm_decode_mixer_ref(zxbcdt, window, h, conv_w, conv_b,
                                    dt_bias, A_log, D, norm_w, groups)
    return ssm_decode_mixer_cuda(zxbcdt, window, h, conv_w, conv_b, dt_bias,
                                 A_log, D, norm_w, groups)


# sm90 kernel launches since the last reset (CPU calls excluded)
ssm_decode_mixer.launches = 0


def reset_launches() -> None:
    """Set :attr:`ssm_decode_mixer.launches` and each route's count to
    0."""
    ssm_decode_mixer.launches = 0
    for k in launches_by_route:
        launches_by_route[k] = 0
