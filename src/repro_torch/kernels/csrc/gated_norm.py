"""Mamba-2's gated output norm, forward and backward, in Triton for
NVIDIA Hopper.

Replaces the XLA-lowered tail of ``ssm_apply``
(src/repro/models/ssm.py:140-143), a row of d = nh * hp columns at a
time:

    v   = y + x * D[head]            (optional: decode's y has its skip
                                      already)
    g   = v * silu(z)
    out = g * rsqrt(mean(g^2) + eps) * w

rounded to the compute dtype where the reference rounds: x * D, v,
silu(z) and g; the norm in fp32, its output rounded once (the roundings
on the bits of the fp32 values, see ``_round``).
Backward, with n = g * r, r = rsqrt(mean(g^2) + eps):
``dg = r * (dout * w) - g * r^3 * mean(dout * w * g)``, ``dv = dg *
silu(z)`` (y's gradient), ``dz = dg * v * silu'(z)``, x's gradient from
the skip ``dv * D``, all in the compute dtype; ``dw = sum_rows dout * n``
and ``dD[h] = sum_rows sum_(cols of h) dv * x`` as fp32 partials a
program (no atomics), summed in a fixed order by ``causal_conv.py``'s
``colsum_kernel``: graph replays are bit-equal.

The gate's ``triton`` route: fp32 calls and bf16 views off 16-byte
boundaries (``gated_norm_sm90.route``); aligned bf16 rows, the layer's,
take ``gated_norm_sm90.cu``, which streams rows by bulk TMA copies and
splits wide rows over a cluster.  No tensor-core work: a row reduction
over d plus elementwise work, and column reductions for dw and dD.

Bound on this card: bytes.  The forward reads y, x, z and writes the
output, the backward reads dout, y, x, z and writes dy, dx and dz (2
bytes each in bf16), against about 15 fp32 operations an element
forward and 30 backward.  Design: a row is a (heads, hp) tile, so D
broadcasts over a head's columns and dD reduces over them; y, x and z
are read where they lie (x a view of the conv's output row, z of the
``in_proj`` output).  A row of up to 4096 columns is one block held in
registers (mamba2-780m's 3072); a wider one (jamba's 16384) is walked
in ``BH``-head blocks, twice: once for its statistics, once for the
output (the second read served by L2).  A backward program walks
``rows_per_prog`` rows; its partials stay in registers in one block,
and in the program's own row of the partials otherwise.
"""

import triton
import triton.language as tl


@triton.jit
def _round(x, ty: tl.constexpr):
    """fp32 ``x`` rounded to ``ty``, to nearest even, and back: at bf16 on
    its bits (the compiler may fold a pair of conversions away)."""
    if ty == tl.bfloat16:
        u = x.to(tl.uint32, bitcast=True)
        u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
        return u.to(tl.float32, bitcast=True)
    else:
        return x


@triton.jit
def _gate_in(y_ptr, x_ptr, z_ptr, d_ptr, yo, xo, zo, h, p,
             NH: tl.constexpr, HP: tl.constexpr, BH: tl.constexpr,
             SKIP: tl.constexpr):
    """Heads ``h`` of one row: ``(v, z, x, D, mask, columns)`` in fp32, v
    with the skip added and rounded as the reference (x and D are 0
    without the skip)."""
    hm = h < NH
    m = hm[:, None] & (p < HP)[None, :]
    col = h[:, None] * HP + p[None, :]
    ty = y_ptr.dtype.element_ty
    yv = tl.load(y_ptr + yo + col, mask=m, other=0.0).to(tl.float32)
    zv = tl.load(z_ptr + zo + col, mask=m, other=0.0).to(tl.float32)
    if SKIP:
        xv = tl.load(x_ptr + xo + col, mask=m, other=0.0).to(tl.float32)
        dv = _round(tl.load(d_ptr + h, mask=hm, other=0.0).to(tl.float32),
                    ty)
        v = _round(yv + _round(xv * dv[:, None], ty), ty)
    else:
        xv = tl.zeros_like(yv)
        dv = tl.zeros([BH], tl.float32)
        v = yv
    return v, zv, xv, dv, m, col


@triton.jit
def _gate(v, zv, ty: tl.constexpr):
    """``g = v * silu(z)`` with silu(z) and the product rounded to ``ty``,
    as the reference rounds them."""
    return _round(v * _round(zv / (1.0 + tl.exp(-zv)), ty), ty)


@triton.jit
def _offsets(row, S, sb, ss):
    b = row // S
    return b.to(tl.int64) * sb + (row - b * S).to(tl.int64) * ss


@triton.jit
def gate_fwd_kernel(y_ptr, x_ptr, z_ptr, d_ptr, w_ptr, out_ptr, S, ysb, yss,
                    xsb, xss, zsb, zss, eps, NH: tl.constexpr,
                    HP: tl.constexpr, BH: tl.constexpr, BP: tl.constexpr,
                    NB: tl.constexpr, SKIP: tl.constexpr):
    row = tl.program_id(0)
    yo = _offsets(row, S, ysb, yss)
    xo = _offsets(row, S, xsb, xss)
    zo = _offsets(row, S, zsb, zss)
    oo = row.to(tl.int64) * (NH * HP)
    hh = tl.arange(0, BH)
    p = tl.arange(0, BP)
    ty = out_ptr.dtype.element_ty
    if NB == 1:
        v, zv, _, _, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr, yo, xo,
                                       zo, hh, p, NH, HP, BH, SKIP)
        g = _gate(v, zv, ty)
        r = tl.rsqrt(tl.sum(tl.sum(g * g, 1), 0) / (NH * HP) + eps)
        wv = tl.load(w_ptr + col, mask=m, other=0.0).to(tl.float32)
        tl.store(out_ptr + oo + col, (g * r * wv).to(ty), mask=m)
    else:
        ssq = tl.zeros([BH, BP], tl.float32)
        for hb in range(NB):
            v, zv, _, _, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr, yo,
                                           xo, zo, hb * BH + hh, p, NH, HP,
                                           BH, SKIP)
            g = _gate(v, zv, ty)
            ssq += g * g
        r = tl.rsqrt(tl.sum(tl.sum(ssq, 1), 0) / (NH * HP) + eps)
        for hb in range(NB):
            v, zv, _, _, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr, yo,
                                           xo, zo, hb * BH + hh, p, NH, HP,
                                           BH, SKIP)
            g = _gate(v, zv, ty)
            wv = tl.load(w_ptr + col, mask=m, other=0.0).to(tl.float32)
            tl.store(out_ptr + oo + col, (g * r * wv).to(ty), mask=m)


@triton.jit
def _gate_grads(v, zv, go, wv, r, coef, ty: tl.constexpr):
    """``(dv, dz)`` of one block from the row's ``r`` and ``coef = r^3 *
    mean(dout * w * g)``, with silu(z) and g rounded as the forward rounds
    them (their rounding passes the gradient through)."""
    sig = 1.0 / (1.0 + tl.exp(-zv))
    s = _round(zv * sig, ty)
    dg = r * (go * wv) - _round(v * s, ty) * coef
    return dg * s, dg * v * sig * (1.0 + zv * (1.0 - sig))


@triton.jit
def gate_bwd_kernel(y_ptr, x_ptr, z_ptr, d_ptr, w_ptr, do_ptr, dy_ptr, dx_ptr,
                    dz_ptr, part_ptr, R, S, ysb, yss, xsb, xss, zsb, zss,
                    osb, oss, rows_per_prog, eps, NH: tl.constexpr,
                    HP: tl.constexpr, BH: tl.constexpr, BP: tl.constexpr,
                    NB: tl.constexpr, SKIP: tl.constexpr):
    pid = tl.program_id(0)
    hh = tl.arange(0, BH)
    p = tl.arange(0, BP)
    ty = dy_ptr.dtype.element_ty
    # this program's partials: dw's NH * HP columns, then dD's NH
    pbase = part_ptr + pid.to(tl.int64) * (NH * HP + NH)
    acc_w = tl.zeros([BH, BP], tl.float32)
    acc_d = tl.zeros([BH], tl.float32)
    if NB > 1:
        for hb in range(NB):
            h = hb * BH + hh
            hm = h < NH
            tl.store(pbase + h[:, None] * HP + p[None, :], acc_w,
                     mask=hm[:, None] & (p < HP)[None, :])
            tl.store(pbase + NH * HP + h, acc_d, mask=hm)
    r_end = tl.minimum((pid + 1) * rows_per_prog, R)
    for row in range(pid * rows_per_prog, r_end):
        yo = _offsets(row, S, ysb, yss)
        xo = _offsets(row, S, xsb, xss)
        zo = _offsets(row, S, zsb, zss)
        go_o = _offsets(row, S, osb, oss)
        oo = row.to(tl.int64) * (NH * HP)
        if NB == 1:
            v, zv, xv, dv, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr, yo,
                                             xo, zo, hh, p, NH, HP, BH, SKIP)
            g = _gate(v, zv, ty)
            wv = tl.load(w_ptr + col, mask=m, other=0.0).to(tl.float32)
            go = tl.load(do_ptr + go_o + col, mask=m,
                         other=0.0).to(tl.float32)
            r = tl.rsqrt(tl.sum(tl.sum(g * g, 1), 0) / (NH * HP) + eps)
            coef = r * r * r * tl.sum(tl.sum(go * wv * g, 1), 0) / (NH * HP)
            dvv, dzz = _gate_grads(v, zv, go, wv, r, coef, ty)
            tl.store(dy_ptr + oo + col, dvv.to(ty), mask=m)
            tl.store(dz_ptr + oo + col, dzz.to(ty), mask=m)
            if SKIP:
                tl.store(dx_ptr + oo + col, (dvv * dv[:, None]).to(ty),
                         mask=m)
                acc_d += tl.sum(dvv * xv, 1)
            acc_w += go * (g * r)
        else:
            ssq = tl.zeros([BH, BP], tl.float32)
            sdg = tl.zeros([BH, BP], tl.float32)
            for hb in range(NB):
                v, zv, _, _, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr,
                                               yo, xo, zo, hb * BH + hh, p,
                                               NH, HP, BH, SKIP)
                g = _gate(v, zv, ty)
                wv = tl.load(w_ptr + col, mask=m, other=0.0).to(tl.float32)
                go = tl.load(do_ptr + go_o + col, mask=m,
                             other=0.0).to(tl.float32)
                ssq += g * g
                sdg += go * wv * g
            r = tl.rsqrt(tl.sum(tl.sum(ssq, 1), 0) / (NH * HP) + eps)
            coef = r * r * r * tl.sum(tl.sum(sdg, 1), 0) / (NH * HP)
            # the partials' previous row, stored by any thread, is seen
            tl.debug_barrier()
            for hb in range(NB):
                h = hb * BH + hh
                v, zv, xv, dv, m, col = _gate_in(y_ptr, x_ptr, z_ptr, d_ptr,
                                                 yo, xo, zo, h, p, NH, HP, BH,
                                                 SKIP)
                g = _gate(v, zv, ty)
                wv = tl.load(w_ptr + col, mask=m, other=0.0).to(tl.float32)
                go = tl.load(do_ptr + go_o + col, mask=m,
                             other=0.0).to(tl.float32)
                dvv, dzz = _gate_grads(v, zv, go, wv, r, coef, ty)
                tl.store(dy_ptr + oo + col, dvv.to(ty), mask=m)
                tl.store(dz_ptr + oo + col, dzz.to(ty), mask=m)
                pw = pbase + col
                tl.store(pw, tl.load(pw, mask=m, other=0.0) + go * (g * r),
                         mask=m)
                if SKIP:
                    tl.store(dx_ptr + oo + col, (dvv * dv[:, None]).to(ty),
                             mask=m)
                    hm = h < NH
                    pd = pbase + NH * HP + h
                    tl.store(pd, tl.load(pd, mask=hm, other=0.0)
                             + tl.sum(dvv * xv, 1), mask=hm)
    if NB == 1:
        hm = hh < NH
        tl.store(pbase + hh[:, None] * HP + p[None, :], acc_w,
                 mask=hm[:, None] & (p < HP)[None, :])
        tl.store(pbase + NH * HP + hh, acc_d, mask=hm)
