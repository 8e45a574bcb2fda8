"""Mamba-2's gated output norm, forward and backward: the kernels'
wrapper (two routes), its autograd and its plain PyTorch versions.

Counterpart of the tail of :func:`repro.models.ssm.ssm_apply`
(ssm.py:140-143; XLA, not a Pallas kernel): ``rmsnorm((y + x * D) *
silu(z), w)`` over rows of d = heads * hp columns, ``D`` (heads,)
broadcast over each head's hp columns; without ``x`` and ``D`` (decode,
whose step adds the skip itself, ssm.py:189-191) ``rmsnorm(y *
silu(z), w)``.  :func:`gated_norm` dispatches on the tensors' device:
CUDA tensors go through :class:`GatedNorm` to the kernels that
:func:`route` plans (one forward launch; a backward launch and the
fixed-order sum of its dw / dD partials; a build or launch failure
raises and never falls back to the other route or the plain version):
bf16 rows whose operands' bases and row strides are 16-byte aligned take
the ``sm90`` route, ``csrc/gated_norm_sm90.cu`` (CUDA C++ built by
``nvcc`` at first use: rows streamed by bulk TMA copies into a ring of
shared-memory stages, a row too wide for a block's ring split over a
thread-block cluster; its planner, router and binding in
:mod:`repro_torch.kernels.gated_norm_sm90`); fp32 and every other call
take the ``triton`` route, ``csrc/gated_norm.py``.  CPU and
``meta`` tensors (the dry run) run :func:`gated_norm_ref`, the
reference's arithmetic, under autograd.

y, x and z are read where they lie (the last dim contiguous, any row
stride): the layer hands the kernel the scan's output, its view of the
conv's output and its view of the ``in_proj`` output.  The output is a
new contiguous (B, S, d) tensor in y's dtype.

:func:`gated_norm_bwd_ref` is the backward kernels' algorithm as plain
fp32 tensor code, :func:`sm90_partials_ref` the ``sm90`` route's dw / dD
partials (a cluster's rows summed, then the clusters in order).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import gated_norm_sm90 as sm90
from . import triton_source
from .causal_conv import colsum

__all__ = ["gated_norm", "gated_norm_ref", "gated_norm_bwd_ref",
           "gated_norm_fwd_cuda", "gated_norm_bwd_cuda", "gated_norm_cuda",
           "GatedNorm", "launches_by_pass", "reset_launches", "plan",
           "PLANT_SKIP", "PLANT_EPS", "MAX_BLOCK", "BWD_ROWS", "EPS",
           "ROUTES", "ROUTE_LAUNCHES", "launches_by_route",
           "sm90_partials_ref"]

EPS = 1e-6                    # the reference's rmsnorm eps (its default)
# columns a program holds in registers at once: a wider row is walked in
# blocks of heads
MAX_BLOCK = 4096
# rows a backward program walks: one (d + heads) fp32 partial of dw and
# dD a program
BWD_ROWS = 16
# planted faults (chip_smoke.py): the forward drops the D skip, or eps
PLANT_SKIP = 1
PLANT_EPS = 2
_DTYPES = (torch.bfloat16, torch.float32)
# the routes (gated_norm_sm90.route plans a call's) and their kernel
# launches of a forward and of a backward call (the backward's second: the
# fixed-order sum of its partials)
ROUTES = ("sm90", "triton")
ROUTE_LAUNCHES = {"sm90": (1, 2), "triton": (1, 2)}

# calls by pass since the last reset (CPU calls excluded); the kernel
# launches in gated_norm_cuda.launches (1 a forward, 2 a backward), and by
# route in launches_by_route
launches_by_pass: Dict[str, int] = {"fwd": 0, "bwd": 0}
launches_by_route: Dict[str, int] = {r: 0 for r in ROUTES}


def _skip(y, x, D, heads: int):
    """``y + x * D`` as the reference rounds it: D cast to y's dtype,
    broadcast over each head's columns."""
    return y + (x.unflatten(-1, (heads, -1))
                * D[:, None].to(y.dtype)).flatten(-2)


def gated_norm_ref(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   heads: int, x: Optional[torch.Tensor] = None,
                   D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version, the reference's arithmetic: ``y`` (+ ``x * D``),
    times ``silu(z)`` in the compute dtype, then the fp32 rmsnorm with
    ``w``, back in the compute dtype."""
    if x is not None:
        y = _skip(y, x, D, heads)
    g = y * F.silu(z)
    g32 = g.to(torch.float32)
    var = torch.mean(g32 * g32, dim=-1, keepdim=True)
    out = g32 * torch.rsqrt(var + EPS) * w.to(torch.float32)
    return out.to(g.dtype)


def _bwd_terms(dout, y, z, w, heads: int, x, D):
    """The backward's per-row terms in fp32 (see :func:`gated_norm_bwd_ref`):
    ``(dv, dz, dx, dw's terms dout g r (B, S, d), dD's terms: dv x summed
    over each head's columns (B, S, heads))``, dx and dD's terms ``None``
    without the skip."""
    f32 = torch.float32
    ty = y.dtype
    v = _skip(y, x, D, heads).to(f32) if x is not None else y.to(f32)
    zf = z.to(f32)
    sig = torch.sigmoid(zf)
    s = F.silu(zf).to(ty).to(f32)
    g = (v * s).to(ty).to(f32)
    r = torch.rsqrt((g * g).mean(-1, keepdim=True) + EPS)
    dn = dout.to(f32) * w.to(f32)
    coef = r ** 3 * (dn * g).mean(-1, keepdim=True)
    dg = r * dn - g * coef
    dv = dg * s
    dz = dg * v * sig * (1 + zf * (1 - sig))
    dx = dd = None
    if x is not None:
        dvh = dv.unflatten(-1, (heads, -1))
        dx = (dvh * D.to(ty).to(f32)[:, None]).flatten(-2)
        dd = (dvh * x.to(f32).unflatten(-1, (heads, -1))).sum(-1)
    return dv, dz, dx, dout.to(f32) * g * r, dd


def gated_norm_bwd_ref(dout: torch.Tensor, y: torch.Tensor,
                       z: torch.Tensor, w: torch.Tensor, heads: int,
                       x: Optional[torch.Tensor] = None,
                       D: Optional[torch.Tensor] = None
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward kernels' algorithm as plain fp32 tensor code: ``(dy,
    dz, dw, dx, dD)`` in y's, z's, w's, x's and D's dtypes (dx and dD
    ``None`` without the skip).  v = y + x * D, s = silu(z) and g = v * s
    rounded to the compute dtype as the forward rounds them (the gradient
    passing the roundings), the rest in fp32, r = rsqrt(mean(g^2) + EPS):
    ``dg = r (dout w) - g r^3 mean(dout w g)``, ``dy = dg s``, ``dz = dg
    v silu'(z)``, ``dx = dy D``, ``dw = sum dout g r``, ``dD = sum dy x``
    over each head's columns."""
    dv, dz, dx, wt, dt = _bwd_terms(dout, y, z, w, heads, x, D)
    dw = wt.sum(tuple(range(wt.dim() - 1)))
    if x is not None:
        dx = dx.to(x.dtype)
        dt = dt.sum(tuple(range(dt.dim() - 1))).to(D.dtype)
    return dv.to(y.dtype), dz.to(z.dtype), dw.to(w.dtype), dx, dt


def sm90_partials_ref(dout: torch.Tensor, y: torch.Tensor,
                      z: torch.Tensor, w: torch.Tensor, heads: int,
                      x: Optional[torch.Tensor] = None,
                      D: Optional[torch.Tensor] = None, sms: int = 132,
                      max_clusters: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor]]:
    """The ``sm90`` route's dw / dD partials as plain fp32 tensor code:
    ``(part, dw, dD)``, part (clusters, d + heads) each cluster's sums over
    its rows (``gated_norm_sm90.blocks``: c, c + clusters, ...) of dout g
    r at dw's columns and of dy x over each head's columns at dD's (0 without
    the skip); dw and dD their sum over the clusters in order, in w's and
    D's dtypes (dD ``None`` without the skip)."""
    bsz, S, d = y.shape
    pl = sm90.plan(bsz * S, d, heads, x is not None, True, sms,
                   max_clusters)
    _, _, _, wt, dt = _bwd_terms(dout, y, z, w, heads, x, D)
    wt = wt.reshape(bsz * S, d)
    dt = torch.zeros((bsz * S, heads), device=y.device) if dt is None \
        else dt.reshape(bsz * S, heads)
    part = torch.zeros((pl["clusters"], d + heads), dtype=torch.float32,
                       device=y.device)
    for c, r, rows, cols in sm90.blocks(pl, bsz * S):
        hs = range(r * heads // pl["cluster"], (r + 1) * heads
                   // pl["cluster"])
        for row in rows:
            part[c, cols.start:cols.stop] += wt[row, cols.start:cols.stop]
            part[c, d + hs.start:d + hs.stop] += dt[row, hs.start:hs.stop]
    total = torch.zeros(d + heads, dtype=torch.float32, device=y.device)
    for c in range(pl["clusters"]):
        total += part[c]
    return (part, total[:d].to(w.dtype),
            None if D is None else total[d:].to(D.dtype))


def plan(heads: int, hp: int) -> Tuple[int, int, int, int, int]:
    """``(BH, BP, NB, forward warps, backward warps)``: a row as ``NB``
    blocks of ``BH`` heads by ``BP`` (hp to a power of two) columns, at
    most :data:`MAX_BLOCK` columns a block.  The backward of a row in one
    block takes 4 warps at most (its two row sums cross fewer warps), of
    a wider row 16."""
    bp = 1 << (hp - 1).bit_length()
    bh = min(1 << (heads - 1).bit_length(), max(1, MAX_BLOCK // bp))
    nb = -(-heads // bh)
    warps = max(1, min(8, bh * bp // 512))
    return bh, bp, nb, warps, min(warps, 4) if nb == 1 else 16


def _check(y, z, w, heads: int, x, D) -> None:
    """The kernels' contract, on any device (``meta`` included): raises
    on a shape, dtype or stride they do not take."""
    if y.dim() != 3 or tuple(z.shape) != tuple(y.shape) \
            or tuple(w.shape) != (y.shape[2],) or heads < 1 \
            or y.shape[2] % heads:
        raise ValueError(f"need y, z (B, S, d) and w (d,) with d a "
                         f"multiple of heads {heads}, got "
                         f"{tuple(y.shape)}, {tuple(z.shape)}, "
                         f"{tuple(w.shape)}")
    if (x is None) != (D is None) or (x is not None and (
            tuple(x.shape) != tuple(y.shape)
            or tuple(D.shape) != (heads,))):
        raise ValueError("x (B, S, d) and D (heads,) come together")
    ts = (y, z) + (() if x is None else (x,))
    if y.dtype not in _DTYPES or any(t.dtype != y.dtype for t in ts) \
            or not w.is_floating_point() \
            or (D is not None and not D.is_floating_point()):
        raise TypeError(f"no gated-norm kernel for y {y.dtype}, z "
                        f"{z.dtype}, x {None if x is None else x.dtype} "
                        f"(bf16 or fp32 alike)")
    if any(t.stride(2) != 1 for t in ts):
        raise ValueError("y, z and x need their last dim contiguous")
    if not w.is_contiguous() or (D is not None and not D.is_contiguous()):
        raise ValueError("w and D must be contiguous")


def _on_card(*ts) -> None:
    ts = [t for t in ts if t is not None]
    if not all(t.is_cuda and t.device == ts[0].device for t in ts):
        raise ValueError("no gated-norm kernel for "
                         f"{sorted({str(t.device) for t in ts})}")


def _rows(t: Optional[torch.Tensor], like: torch.Tensor):
    """A (B, S, d) operand's batch and sequence strides (``like``'s when
    it is absent: never read)."""
    t = like if t is None else t
    return t.stride(0), t.stride(1)


def _layout(*ts) -> Tuple[list, list]:
    """``(row strides, base pointers)`` of the (B, S, d) operands ``ts``
    (``None`` skipped): the batch and sequence strides of dims longer
    than 1, as :func:`route` reads them."""
    strides, ptrs = [], []
    for t in ts:
        if t is not None:
            strides += [st for n, st in zip(t.shape[:2], t.stride()[:2])
                        if n > 1]
            ptrs.append(t.data_ptr())
    return strides, ptrs


def _route(y, z, w, heads: int, x, D, chosen: Optional[str]) -> str:
    """The planned route of a call (``gated_norm_sm90.route``), or
    ``chosen`` where it takes the call (``triton`` takes every call;
    ``sm90`` only what it plans there)."""
    strides, ptrs = _layout(y, z, x)
    planned = sm90.route(y.dtype, y.shape[2], heads, strides, ptrs + [
        w.data_ptr()], (w.dtype,) + (() if D is None else (D.dtype,)))
    if chosen is None:
        return planned
    if chosen not in ROUTES:
        raise ValueError(f"route {chosen!r} is not one of {ROUTES}")
    if chosen == "sm90" and planned != "sm90":
        raise ValueError(f"the sm90 route takes no {y.dtype} call of "
                         f"strides {strides} at d {y.shape[2]}, {heads} "
                         f"heads")
    return chosen


def _sm90_args(y, z, x, dout, w, D, heads: int, bwd: bool, skip: bool):
    """The entry points' shared arguments: the strides (y's, z's, x's,
    dout's batch and sequence strides), the row shape, the plan's launch
    shape and the dtype flags."""
    bsz, S, d = y.shape
    pl = sm90.plan_on(y.get_device(), bsz * S, d, heads, skip, bwd)
    vals = [*_rows(y, y), *_rows(z, y), *_rows(x, y), *_rows(dout, y)]
    shape = (bsz * S, S, d, heads)
    flags = (int(skip), int(w.dtype == torch.float32),
             int(D is not None and D.dtype == torch.float32))
    launch = (pl["cluster"], pl["stages"], pl["blocks"], pl["vpt"])
    return pl, (ctypes.c_longlong * 8)(*vals), shape, flags, launch


def _count(rt: str, which: int, what: str) -> None:
    launches = ROUTE_LAUNCHES[rt][which]
    gated_norm_cuda.launches += launches
    launches_by_route[rt] += launches
    launches_by_pass[what] += 1


def gated_norm_fwd_cuda(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                        heads: int, x: Optional[torch.Tensor] = None,
                        D: Optional[torch.Tensor] = None,
                        plant: int = 0, route: Optional[str] = None
                        ) -> torch.Tensor:
    """The forward kernel on CUDA tensors: one launch, a new contiguous
    (B, S, d) output in y's dtype.  ``plant`` (:data:`PLANT_SKIP`,
    :data:`PLANT_EPS`) plants a fault.  ``route``: the planned one
    (``gated_norm_sm90.route``) when ``None``; ``"triton"`` runs a bf16
    call on the Triton kernel (a yardstick)."""
    _check(y, z, w, heads, x, D)
    _on_card(y, z, w, x, D)
    bsz, S, d = y.shape
    skip = x is not None and not plant & PLANT_SKIP
    eps = 0.0 if plant & PLANT_EPS else EPS
    rt = _route(y, z, w, heads, x, D, route)
    out = torch.empty((bsz, S, d), dtype=y.dtype, device=y.device)
    index = y.get_device()
    if rt == "sm90":
        _, strides, shape, flags, launch = _sm90_args(
            y, z, x if skip else None, None, w, D, heads, False, skip)
        sm90.launch("fwd", index, (
            y.data_ptr(), z.data_ptr(), x.data_ptr() if skip else None,
            D.data_ptr() if skip else None, w.data_ptr(), out.data_ptr(),
            strides, *shape, eps, *flags, *launch,
            torch._C._cuda_getCurrentRawStream(index)))
    else:
        bh, bp, nb, warps, _ = plan(heads, d // heads)
        mod = triton_source.load("gated_norm")
        with torch.cuda.device(index):
            mod.gate_fwd_kernel[(bsz * S,)](
                y, y if x is None else x, z, w if D is None else D, w, out,
                S, *_rows(y, y), *_rows(x, y), *_rows(z, y), eps, NH=heads,
                HP=d // heads, BH=bh, BP=bp, NB=nb, SKIP=skip,
                num_warps=warps)
    _count(rt, 0, "fwd")
    return out


def gated_norm_bwd_cuda(dout: torch.Tensor, y: torch.Tensor,
                        z: torch.Tensor, w: torch.Tensor, heads: int,
                        x: Optional[torch.Tensor] = None,
                        D: Optional[torch.Tensor] = None,
                        route: Optional[str] = None
                        ) -> Tuple[Optional[torch.Tensor], ...]:
    """The backward on CUDA tensors: ``(dy, dz, dw, dx, dD)`` (dy, dz,
    dx contiguous (B, S, d) in the compute dtype; dw, dD in w's and D's;
    dx and dD ``None`` without the skip) in two launches: the row
    gradients with fp32 dw / dD partials (a cluster's each on ``sm90``, a
    program's of :data:`BWD_ROWS` rows on ``triton``), then their sum in
    a fixed order.  ``route`` as :func:`gated_norm_fwd_cuda`'s."""
    _check(y, z, w, heads, x, D)
    _on_card(dout, y, z, w, x, D)
    if tuple(dout.shape) != tuple(y.shape) or dout.dtype != y.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} does not "
                         f"fit y {tuple(y.shape)} {y.dtype}")
    rt = _route(y, z, w, heads, x, D, route)
    if dout.stride(2) != 1 or (rt == "sm90"
                               and not sm90.aligned16(*_layout(dout))):
        dout = dout.contiguous()
    bsz, S, d = y.shape
    rows = bsz * S
    index = y.get_device()
    dy = torch.empty((bsz, S, d), dtype=y.dtype, device=y.device)
    dz = torch.empty_like(dy)
    dx = None if x is None else torch.empty_like(dy)
    dw = torch.empty_like(w)
    dD = torch.empty(heads, dtype=torch.float32, device=y.device) \
        if D is None else torch.empty_like(D)
    if rt == "sm90":
        pl, strides, shape, flags, launch = _sm90_args(
            y, z, x, dout, w, D, heads, True, x is not None)
        part = torch.empty((pl["clusters"], d + heads), dtype=torch.float32,
                           device=y.device)
        sm90.launch("bwd", index, (
            y.data_ptr(), z.data_ptr(), None if x is None else x.data_ptr(),
            None if D is None else D.data_ptr(), w.data_ptr(),
            dout.data_ptr(), dy.data_ptr(), dz.data_ptr(),
            None if dx is None else dx.data_ptr(), part.data_ptr(), strides,
            *shape, EPS, *flags, *launch,
            torch._C._cuda_getCurrentRawStream(index)))
        with torch.cuda.device(index):
            colsum(part, dw, dD)
    else:
        bh, bp, nb, _, warps = plan(heads, d // heads)
        progs = -(-rows // BWD_ROWS)
        part = torch.empty((progs, d + heads), dtype=torch.float32,
                           device=y.device)
        mod = triton_source.load("gated_norm")
        with torch.cuda.device(index):
            mod.gate_bwd_kernel[(progs,)](
                y, y if x is None else x, z, w if D is None else D, w, dout,
                dy, dy if dx is None else dx, dz, part, rows, S,
                *_rows(y, y), *_rows(x, y), *_rows(z, y), *_rows(dout, y),
                BWD_ROWS, EPS, NH=heads, HP=d // heads, BH=bh, BP=bp, NB=nb,
                SKIP=x is not None, num_warps=warps)
            colsum(part, dw, dD)
    _count(rt, 1, "bwd")
    return dy, dz, dw, dx, None if D is None else dD


class GatedNorm(torch.autograd.Function):
    """The kernels with their backward: the forward saves its inputs
    (views as given) and nothing else; the backward recomputes each row's
    statistics."""

    @staticmethod
    def forward(ctx, y, z, w, heads, x, D):
        ctx.save_for_backward(y, z, w, x, D)
        ctx.heads = heads
        return gated_norm_fwd_cuda(y, z, w, heads, x, D)

    @staticmethod
    def backward(ctx, dout):
        y, z, w, x, D = ctx.saved_tensors
        dy, dz, dw, dx, dD = gated_norm_bwd_cuda(dout, y, z, w, ctx.heads,
                                                 x, D)
        return dy, dz, dw, None, dx, dD


def gated_norm_cuda(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                    heads: int, x: Optional[torch.Tensor] = None,
                    D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The gated norm of CUDA tensors on the kernels, differentiable in
    y, z, w, x and D.  Raises on what the kernels do not take
    (:func:`_check`)."""
    return GatedNorm.apply(y, z, w, heads, x, D)


# kernel launches since the last reset (CPU calls excluded)
gated_norm_cuda.launches = 0


def reset_launches() -> None:
    """Set :attr:`gated_norm_cuda.launches`, each pass's count and each
    route's to 0."""
    gated_norm_cuda.launches = 0
    for k in launches_by_pass:
        launches_by_pass[k] = 0
    for k in launches_by_route:
        launches_by_route[k] = 0


def gated_norm(y: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
               heads: int, x: Optional[torch.Tensor] = None,
               D: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rmsnorm((y + x * D) * silu(z), w)`` (without the skip when ``x``
    and ``D`` are ``None``): the kernels for CUDA tensors,
    :func:`gated_norm_ref` for CPU and ``meta`` tensors."""
    if y.device.type in ("cpu", "meta"):
        return gated_norm_ref(y, z, w, heads, x, D)
    return gated_norm_cuda(y, z, w, heads, x, D)
