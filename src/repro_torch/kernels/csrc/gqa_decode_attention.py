"""GQA decode attention over a (ring-buffered, optionally INT8) KV cache,
in Triton for NVIDIA Hopper.

Replaces the XLA-lowered core of ``attention_decode``
(src/repro/models/layers.py:319-325: scores, the ring-valid mask,
softmax, probabilities times V), with ``_kv_load``'s INT8 dequantization
(:278) fused into the loads.  One query token per sequence attends to
``(B, S, KV, D)`` caches; the ``G = H / KV`` query heads of a KV head
share its cache rows.

Bound on this card: the cache.  Each step reads every valid cache slot
once (2 * S * KV * D elements per sequence) against 4 * G * D
operations per slot: far below the tensor cores' 295 operations a byte,
so the kernel is bound by its bytes at 3.35 TB/s.  Design:

* split-S: program (b * KV + kv, split) walks one stretch of the valid
  slots in blocks of ``BLOCK_S`` with an online softmax in fp32 (running
  max, sum and context), so ``B * KV * splits`` programs fill the 132
  SMs at small batch; a second pass combines the splits' partial
  (max, sum, context) per (b, kv).  Each cache byte is read once;
* only the slots that can be valid are read: ``min(S, pos + 1)`` of
  them (the ring is full after one wrap); validity of a slot
  (``abs_pos`` of its ring position within ``[pos - window, pos]``)
  masks the scores as in the reference; the position and the sizes are
  not specialized on, so decoding compiles nothing after the first step;
* the G query heads of one KV head are the rows of one ``tl.dot``
  (padded to 16 rows), so each K and V block is loaded once for all of
  them; D is padded to a power of two with a mask (D = 120 -> 128);
* INT8 caches are dequantized on the load by the reference's 1/64.
"""

import triton
import triton.language as tl


# Triton compiles a variant per integer argument that equals 1 or is a
# multiple of 16; the position, the cache length and the split sizes
# change from call to call, so none of them specializes: one compile
# per head geometry and cache dtype serves every position.
@triton.jit(do_not_specialize=["pos", "window", "S", "chunk", "s_end"])
def gqa_decode_split_kernel(q_ptr, k_ptr, v_ptr, m_ptr, l_ptr, acc_ptr,
                            pos, window, S, chunk, s_end, scale,
                            KV: tl.constexpr, G: tl.constexpr,
                            D: tl.constexpr, GP: tl.constexpr,
                            BLOCK_D: tl.constexpr, BLOCK_S: tl.constexpr,
                            INT8: tl.constexpr, HAS_WINDOW: tl.constexpr,
                            IEEE: tl.constexpr):
    bk = tl.program_id(0)              # b * KV + kv
    sp = tl.program_id(1)
    nsp = tl.num_programs(1)
    b = bk // KV
    kv = bk % KV
    g = tl.arange(0, GP)
    d = tl.arange(0, BLOCK_D)
    gmask = g < G
    dmask = d < D
    q = tl.load(q_ptr + (bk * G + g)[:, None] * D + d[None, :],
                mask=gmask[:, None] & dmask[None, :], other=0.0)
    cdt = q.dtype
    slot = pos % S
    wraps = (pos // S) * S
    s_lo = sp * chunk
    s_hi = tl.minimum(s_lo + chunk, s_end)
    m_i = tl.full([GP], -1e30, tl.float32)
    l_i = tl.zeros([GP], tl.float32)
    acc = tl.zeros([GP, BLOCK_D], tl.float32)
    for s0 in range(s_lo, s_hi, BLOCK_S):
        s = s0 + tl.arange(0, BLOCK_S)
        smask = s < s_hi
        row = ((b * S + s) * KV + kv).to(tl.int64) * D
        lmask = smask[:, None] & dmask[None, :]
        k = tl.load(k_ptr + row[:, None] + d[None, :], mask=lmask, other=0)
        v = tl.load(v_ptr + row[:, None] + d[None, :], mask=lmask, other=0)
        if INT8:
            k = k.to(tl.float32) * 0.015625
            v = v.to(tl.float32) * 0.015625
        k = k.to(cdt)
        v = v.to(cdt)
        if IEEE:
            sc = tl.dot(q, tl.trans(k), input_precision="ieee")
        else:
            sc = tl.dot(q, tl.trans(k))
        abs_pos = tl.where(s <= slot, wraps + s, wraps - S + s)
        valid = smask & (abs_pos >= 0) & (abs_pos <= pos)
        if HAS_WINDOW:
            valid = valid & (abs_pos > pos - window)
        sc = tl.where(valid[None, :], sc * scale, -1e30)
        m_new = tl.maximum(m_i, tl.max(sc, 1))
        p = tl.where(valid[None, :], tl.exp(sc - m_new[:, None]), 0.0)
        alpha = tl.exp(m_i - m_new)
        l_i = l_i * alpha + tl.sum(p, 1)
        if IEEE:
            pv = tl.dot(p.to(cdt), v, input_precision="ieee")
        else:
            pv = tl.dot(p.to(cdt), v)
        acc = acc * alpha[:, None] + pv
        m_i = m_new
    part = bk * nsp + sp
    tl.store(m_ptr + part * GP + g, m_i)
    tl.store(l_ptr + part * GP + g, l_i)
    tl.store(acc_ptr + (part * GP + g)[:, None] * BLOCK_D + d[None, :], acc)


@triton.jit(do_not_specialize=["nsp"])
def gqa_decode_combine_kernel(m_ptr, l_ptr, acc_ptr, out_ptr, nsp,
                              G: tl.constexpr, D: tl.constexpr,
                              GP: tl.constexpr, BLOCK_D: tl.constexpr):
    bk = tl.program_id(0)
    g = tl.arange(0, GP)
    d = tl.arange(0, BLOCK_D)
    big = tl.full([GP], -1e30, tl.float32)
    for sp in range(0, nsp):
        big = tl.maximum(big, tl.load(m_ptr + (bk * nsp + sp) * GP + g))
    den = tl.zeros([GP], tl.float32)
    num = tl.zeros([GP, BLOCK_D], tl.float32)
    for sp in range(0, nsp):
        part = bk * nsp + sp
        w = tl.exp(tl.load(m_ptr + part * GP + g) - big)
        den += w * tl.load(l_ptr + part * GP + g)
        num += w[:, None] * tl.load(
            acc_ptr + (part * GP + g)[:, None] * BLOCK_D + d[None, :])
    out = num / den[:, None]
    tl.store(out_ptr + (bk * G + g)[:, None] * D + d[None, :],
             out.to(out_ptr.dtype.element_ty),
             mask=(g < G)[:, None] & (d < D)[None, :])
