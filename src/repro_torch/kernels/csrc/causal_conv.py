"""Mamba-2's causal conv front, forward and backward, in Triton for
NVIDIA Hopper.

Replaces the XLA-lowered ``_causal_conv`` of ``ssm_apply``
(src/repro/models/ssm.py:68-75, called at :89): a depth-wise causal
conv1d of K = 4 taps (Mamba-2's ``d_conv``) over the sequence, a bias
and SiLU,

    pre[b, t, c] = bias[c] + sum_i w[i, c] * x[b, t - 3 + i, c]
    out[b, t, c] = silu(pre[b, t, c])

with x zero before t = 0 of each sequence.  The reference pads a copy
of ``concat([x, B, C])`` and rounds every tap's product and partial sum
to the compute dtype; these kernels read the columns of the ``in_proj``
output in place (any row stride, the last dim contiguous) and, at bf16,
round as the reference rounds, in its order (``_pre``):

    pre = ((((x[t-3] w0) + x[t-2] w1) + x[t-1] w2) + x[t] w3) + bias

every product and every sum rounded to bf16, by the card's own bf16
arithmetic (``mul.rn.bf16x2``, ``add.rn.bf16x2``: one rounding an
operation, two elements an instruction; a conversion pair in Triton
may be folded away, and rounding fp32 values on their bits cost the
forward 1.8x its time on an H100), the bias rounded to the compute
dtype as the reference casts it; then SiLU in fp32, rounded once, into
a contiguous (B, S, C) output.  fp32 sums in fp32.

Backward: ``dpre = dy * silu'(pre)`` with ``pre`` recomputed by the same
chain,
``dx[t] = sum_j dpre[t + j] * w[3 - j]`` in the input's dtype, and the
column sums ``dw[i] = sum_t dpre[t] * x[t - 3 + i]`` and ``db = sum_t
dpre[t]`` as fp32 partials a program (no atomics), summed by
``colsum_kernel`` in a fixed order: graph replays are bit-equal.

Why Triton: no tensor-core work.  The forward is an elementwise pass
with a 3-row halo, the backward the same plus column reductions over
B * S rows: fused elementwise work and reductions, which Triton's blocks
serve as well as CUDA C++.

Bound on this card: bytes.  The forward reads x and writes the output
(2 bytes each in bf16), the backward reads dy and x and writes dx,
against about 12 fp32 operations an element forward and 30 backward.
Design: a program walks a chunk of one sequence's rows for a block of
channels (a row's channels are one contiguous run), four rows a step,
keeping the last three rows of x (and, backward, of dpre) in registers:
each row of x and dy is read once, ``pre`` and ``silu`` are computed
once a row, and no value moves between threads.  A step issues its four
rows' loads before any of its stores, which the compiler may not move
past one another (else each row's loads wait on the last row's
stores).  The backward walks three rows past its chunk for the chunk's
last dx, and keeps its dw and db partials in registers until the
chunk's end.
"""

import triton
import triton.language as tl


@triton.jit
def _taps(w_ptr, c, cmask, C):
    """The four taps' weights at channels ``c``, in their dtype."""
    w0 = tl.load(w_ptr + c, mask=cmask, other=0.0)
    w1 = tl.load(w_ptr + C + c, mask=cmask, other=0.0)
    w2 = tl.load(w_ptr + 2 * C + c, mask=cmask, other=0.0)
    w3 = tl.load(w_ptr + 3 * C + c, mask=cmask, other=0.0)
    return w0, w1, w2, w3


@triton.jit
def _row(row_ptr, s, stride, m):
    """Row ``s`` in its dtype, 0 where not ``m``."""
    return tl.load(row_ptr + s.to(tl.int64) * stride, mask=m, other=0.0)


@triton.jit
def _chunk(pid, n_chunks, chunk, S):
    """``(batch, first row, end row)`` of program ``pid``'s chunk."""
    bb = pid // n_chunks
    t0 = (pid - bb * n_chunks) * chunk
    return bb, t0, tl.minimum(t0 + chunk, S)


@triton.jit
def _halo(xrow, t0, sxs, cmask):
    """x's three rows before ``t0`` (0 before the sequence)."""
    return (_row(xrow, t0 - 3, sxs, cmask & (t0 >= 3)),
            _row(xrow, t0 - 2, sxs, cmask & (t0 >= 2)),
            _row(xrow, t0 - 1, sxs, cmask & (t0 >= 1)))


@triton.jit
def _bmul(a, b):
    """``a * b`` of bf16 tensors, rounded once to bf16 (two a 32-bit
    register: ``mul.rn.bf16x2``)."""
    return tl.inline_asm_elementwise("mul.rn.bf16x2 $0, $1, $2;", "=r,r,r",
                                     [a, b], dtype=tl.bfloat16, is_pure=True,
                                     pack=2)


@triton.jit
def _badd(a, b):
    """``a + b`` of bf16 tensors, rounded once to bf16 (``add.rn.bf16x2``):
    the same bits as the fp32 sum rounded, as the reference rounds it."""
    return tl.inline_asm_elementwise("add.rn.bf16x2 $0, $1, $2;", "=r,r,r",
                                     [a, b], dtype=tl.bfloat16, is_pure=True,
                                     pack=2)


@triton.jit
def _pre(bias, w0, w1, w2, w3, xm3, xm2, xm1, x0, ty: tl.constexpr):
    """The pre-activation at one row, in fp32, from the rows and taps in
    their dtype: at bf16 the reference's chain in bf16 arithmetic, each
    tap's product and each partial sum rounded, the bias added last (the
    products of bf16 values are exact in fp32, so a bf16 operation's one
    rounding is the reference's fp32-then-bf16 rounding); fp32 in one
    sum."""
    if ty == tl.bfloat16:
        p = _bmul(w0, xm3)
        p = _badd(p, _bmul(w1, xm2))
        p = _badd(p, _bmul(w2, xm1))
        p = _badd(p, _bmul(w3, x0))
        return _badd(p, bias).to(tl.float32)
    else:
        return bias + w0 * xm3 + w1 * xm2 + w2 * xm1 + w3 * x0


@triton.jit
def _silu(pre):
    return pre / (1.0 + tl.exp(-pre))


@triton.jit
def _dpre(dy, pre):
    """``dy * silu'(pre)``."""
    sig = 1.0 / (1.0 + tl.exp(-pre))
    return dy * sig * (1.0 + pre * (1.0 - sig))


@triton.jit
def conv_fwd_kernel(x_ptr, w_ptr, b_ptr, out_ptr, S, C, sxb, sxs, chunk,
                    n_chunks, BLOCK_C: tl.constexpr,
                    FIRST_TAP: tl.constexpr):
    """Program (batch * chunk, channel block); ``FIRST_TAP`` 1 drops the
    oldest tap (a planted fault)."""
    bb, t0, t1 = _chunk(tl.program_id(0), n_chunks, chunk, S)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = c < C
    ty = out_ptr.dtype.element_ty
    bias = tl.load(b_ptr + c, mask=cmask, other=0.0).to(ty)
    w0, w1, w2, w3 = _taps(w_ptr, c, cmask, C)
    if FIRST_TAP == 1:
        w0 = tl.zeros_like(w0)
    xrow = x_ptr + bb.to(tl.int64) * sxb + c
    orow = out_ptr + (bb.to(tl.int64) * S) * C + c
    xm3, xm2, xm1 = _halo(xrow, t0, sxs, cmask)
    for s in range(t0, t1, 4):
        xa = _row(xrow, s, sxs, cmask & (s < t1))
        xb = _row(xrow, s + 1, sxs, cmask & (s + 1 < t1))
        xc = _row(xrow, s + 2, sxs, cmask & (s + 2 < t1))
        xd = _row(xrow, s + 3, sxs, cmask & (s + 3 < t1))
        ya = _silu(_pre(bias, w0, w1, w2, w3, xm3, xm2, xm1, xa, ty))
        yb = _silu(_pre(bias, w0, w1, w2, w3, xm2, xm1, xa, xb, ty))
        yc = _silu(_pre(bias, w0, w1, w2, w3, xm1, xa, xb, xc, ty))
        yd = _silu(_pre(bias, w0, w1, w2, w3, xa, xb, xc, xd, ty))
        tl.store(orow + s.to(tl.int64) * C, ya.to(ty), mask=cmask & (s < t1))
        tl.store(orow + (s + 1).to(tl.int64) * C, yb.to(ty),
                 mask=cmask & (s + 1 < t1))
        tl.store(orow + (s + 2).to(tl.int64) * C, yc.to(ty),
                 mask=cmask & (s + 2 < t1))
        tl.store(orow + (s + 3).to(tl.int64) * C, yd.to(ty),
                 mask=cmask & (s + 3 < t1))
        xm3 = xb
        xm2 = xc
        xm1 = xd


@triton.jit
def conv_bwd_kernel(x_ptr, w_ptr, b_ptr, dy_ptr, dx_ptr, part_ptr, S, C,
                    sxb, sxs, sdb, sds, chunk, n_chunks,
                    BLOCK_C: tl.constexpr):
    """Program (batch * chunk, channel block): dpre at rows s .. s + 3
    from x's window, dx at s - 3 .. s from dpre's; the chunk's dw and db
    into row ``program_id(0)`` of the partials."""
    pid = tl.program_id(0)
    bb, t0, t1 = _chunk(pid, n_chunks, chunk, S)
    c = tl.program_id(1) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = c < C
    ty = dx_ptr.dtype.element_ty
    bias = tl.load(b_ptr + c, mask=cmask, other=0.0).to(ty)
    w0, w1, w2, w3 = _taps(w_ptr, c, cmask, C)
    f0 = w0.to(tl.float32)
    f1 = w1.to(tl.float32)
    f2 = w2.to(tl.float32)
    f3 = w3.to(tl.float32)
    xrow = x_ptr + bb.to(tl.int64) * sxb + c
    drow = dy_ptr + bb.to(tl.int64) * sdb + c
    orow = dx_ptr + (bb.to(tl.int64) * S) * C + c
    xm3, xm2, xm1 = _halo(xrow, t0, sxs, cmask)
    dm3 = tl.zeros([BLOCK_C], tl.float32)
    dm2 = tl.zeros([BLOCK_C], tl.float32)
    dm1 = tl.zeros([BLOCK_C], tl.float32)
    a0 = tl.zeros([BLOCK_C], tl.float32)
    a1 = tl.zeros([BLOCK_C], tl.float32)
    a2 = tl.zeros([BLOCK_C], tl.float32)
    a3 = tl.zeros([BLOCK_C], tl.float32)
    ab = tl.zeros([BLOCK_C], tl.float32)
    end = tl.minimum(t1 + 3, S)
    for s in range(t0, t1 + 3, 4):
        ma = cmask & (s < end)
        mb = cmask & (s + 1 < end)
        mc = cmask & (s + 2 < end)
        md = cmask & (s + 3 < end)
        xa = _row(xrow, s, sxs, ma)
        xb = _row(xrow, s + 1, sxs, mb)
        xc = _row(xrow, s + 2, sxs, mc)
        xd = _row(xrow, s + 3, sxs, md)
        da = _dpre(_row(drow, s, sds, ma).to(tl.float32),
                   _pre(bias, w0, w1, w2, w3, xm3, xm2, xm1, xa, ty))
        db = _dpre(_row(drow, s + 1, sds, mb).to(tl.float32),
                   _pre(bias, w0, w1, w2, w3, xm2, xm1, xa, xb, ty))
        dc = _dpre(_row(drow, s + 2, sds, mc).to(tl.float32),
                   _pre(bias, w0, w1, w2, w3, xm1, xa, xb, xc, ty))
        dd = _dpre(_row(drow, s + 3, sds, md).to(tl.float32),
                   _pre(bias, w0, w1, w2, w3, xa, xb, xc, xd, ty))
        # dx[t] = dpre[t] w3 + dpre[t + 1] w2 + dpre[t + 2] w1
        #         + dpre[t + 3] w0, at t = s - 3 .. s
        for u in tl.static_range(4):
            t = s - 3 + u
            if u == 0:
                v = dm3 * f3 + dm2 * f2 + dm1 * f1 + da * f0
            elif u == 1:
                v = dm2 * f3 + dm1 * f2 + da * f1 + db * f0
            elif u == 2:
                v = dm1 * f3 + da * f2 + db * f1 + dc * f0
            else:
                v = da * f3 + db * f2 + dc * f1 + dd * f0
            tl.store(orow + t.to(tl.int64) * C, v.to(ty),
                     mask=cmask & (t >= t0) & (t < t1))
        # dw[i] gathers dpre[s] x[s - 3 + i] over the chunk's own rows
        oa = tl.where(s < t1, da, 0.0)
        ob = tl.where(s + 1 < t1, db, 0.0)
        oc = tl.where(s + 2 < t1, dc, 0.0)
        od = tl.where(s + 3 < t1, dd, 0.0)
        ym3 = xm3.to(tl.float32)
        ym2 = xm2.to(tl.float32)
        ym1 = xm1.to(tl.float32)
        ya = xa.to(tl.float32)
        yb = xb.to(tl.float32)
        yc = xc.to(tl.float32)
        yd = xd.to(tl.float32)
        a0 += ym3 * oa + ym2 * ob + ym1 * oc + ya * od
        a1 += ym2 * oa + ym1 * ob + ya * oc + yb * od
        a2 += ym1 * oa + ya * ob + yb * oc + yc * od
        a3 += ya * oa + yb * ob + yc * oc + yd * od
        ab += oa + ob + oc + od
        xm3 = xb
        xm2 = xc
        xm1 = xd
        dm3 = db
        dm2 = dc
        dm1 = dd
    pbase = part_ptr + pid.to(tl.int64) * (5 * C) + c
    tl.store(pbase, a0, mask=cmask)
    tl.store(pbase + C, a1, mask=cmask)
    tl.store(pbase + 2 * C, a2, mask=cmask)
    tl.store(pbase + 3 * C, a3, mask=cmask)
    tl.store(pbase + 4 * C, ab, mask=cmask)


@triton.jit
def colsum_kernel(part_ptr, a_ptr, b_ptr, P, N, NA, BLOCK_P: tl.constexpr,
                  BLOCK: tl.constexpr):
    """``sum_p part[p, :]`` over the ``P`` partial rows of ``N`` columns,
    ``BLOCK_P`` rows at a time in order (a fixed order: the same sum on
    every call): columns ``[0, NA)`` to ``a``, the rest to ``b``, each in
    its own dtype."""
    c = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = c < N
    acc = tl.zeros([BLOCK], tl.float32)
    for p0 in range(0, P, BLOCK_P):
        p = p0 + tl.arange(0, BLOCK_P)
        tile = tl.load(part_ptr + p.to(tl.int64)[:, None] * N + c[None, :],
                       mask=(p < P)[:, None] & m[None, :], other=0.0)
        acc += tl.sum(tile, 0)
    tl.store(a_ptr + c, acc.to(a_ptr.dtype.element_ty), mask=c < NA)
    tl.store(b_ptr + (c - NA), acc.to(b_ptr.dtype.element_ty),
             mask=m & (c >= NA))
