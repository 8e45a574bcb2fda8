"""Next-token cross-entropy, forward and backward, in Triton for NVIDIA
Hopper.

Replaces the XLA-lowered ``xent`` of the LM loss
(src/repro/models/transformer.py:272-276) and its gradient:

    loss_r = logsumexp_v(logits[r, v]) - logits[r, label_r]
    dlogits[r, v] = (softmax(logits[r])[v] - [v == label_r]) * g / N

with the logits (N rows of V, in the compute dtype) read in fp32.

Bound on this card: the logits' bytes.  The forward reads each logit
once, the backward reads it and writes its gradient (6 bytes a bf16
logit in all), against a handful of fp32 operations and one exp a logit
a pass: the pair is bound by its bytes at 3.35 TB/s.  At phi4-mini's
vocabulary (200,064, no power of two) a row is 400 KB of bf16.  Design:
one program a row walks it in ``BLOCK_V`` columns (masked at the end),
keeping a running maximum and a rescaled running sum in fp32 (one exp a
logit; the first block starts both), so no (N, V) fp32 copy and no
second pass exist; it also picks up the gold logit and writes the row's
loss and log-normalizer.  The backward recomputes each probability
from the saved log-normalizer and writes the gradient in the logits'
dtype, in place over the logits when the caller passes them as ``out``.
"""

import triton
import triton.language as tl


@triton.jit
def xent_fwd_kernel(logits_ptr, labels_ptr, loss_ptr, lse_ptr, V,
                    BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    base = logits_ptr + row * V
    cols = tl.arange(0, BLOCK_V)
    x = tl.load(base + cols, mask=cols < V,
                other=float("-inf")).to(tl.float32)
    m = tl.max(x, 0)
    s = tl.sum(tl.exp(x - m), 0)
    for start in range(BLOCK_V, V, BLOCK_V):
        c = start + cols
        x = tl.load(base + c, mask=c < V,
                    other=float("-inf")).to(tl.float32)
        m_new = tl.maximum(m, tl.max(x, 0))
        s = s * tl.exp(m - m_new) + tl.sum(tl.exp(x - m_new), 0)
        m = m_new
    lse = m + tl.log(s)
    gold = tl.load(base + tl.load(labels_ptr + row)).to(tl.float32)
    tl.store(loss_ptr + row, lse - gold)
    tl.store(lse_ptr + row, lse)


@triton.jit
def xent_bwd_kernel(logits_ptr, labels_ptr, lse_ptr, grad_ptr, out_ptr, V,
                    n_rows, BLOCK_V: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    base = logits_ptr + row * V
    obase = out_ptr + row * V
    cols = tl.arange(0, BLOCK_V)
    lse = tl.load(lse_ptr + row)
    label = tl.load(labels_ptr + row)
    # the mean's gradient: g / N, rounded as the reference divides
    coef = tl.div_rn(tl.load(grad_ptr), n_rows)
    for start in range(0, V, BLOCK_V):
        c = start + cols
        mask = c < V
        x = tl.load(base + c, mask=mask, other=0.0).to(tl.float32)
        p = tl.exp(x - lse)
        d = (p - tl.where(c == label, 1.0, 0.0)) * coef
        tl.store(obase + c, d.to(out_ptr.dtype.element_ty), mask=mask)
