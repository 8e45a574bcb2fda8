"""The AdamW step with global-norm clipping, in Triton for NVIDIA
Hopper: two kernels.

Replaces the XLA-lowered ``global_norm`` and per-leaf ``upd`` of
src/repro/optim/adamw.py:34-63.

* ``sumsq_kernel`` sums the squares of every gradient leaf into one
  fp64 device scalar in one launch.  The leaves are fp32 tensors
  anywhere in device memory: the kernel takes the lowest of them as its
  base pointer and each leaf as an element offset from it, and a table
  of ``CHUNK``-element chunks (leaf, start) as its grid; a program adds
  its chunk's squares in fp32 lanes, reduces them and adds the sum to
  the scalar by one fp64 atomic (about 22,000 atomics for phi4-mini's
  1.42e9 parameters at 8 layers; fp64 keeps the order they land in out
  of the norm's first seven digits).
* ``adamw_kernel`` updates one leaf in place: ``p``, ``m``, ``v`` (the
  moments in their storage dtype, fp32 or bf16), reading ``scale =
  min(1, clip / (norm + 1e-9))``, ``lr`` and the bias corrections
  ``1 - b^t`` from a 4-element device vector, so no value crosses to the
  host.  It runs the reference's operations in its order (adamw.py:49-58)
  in fp32 with round-to-nearest division and square root
  (``tl.div_rn``, ``tl.sqrt_rn``) and is launched without floating-point
  contraction (``enable_fp_fusion=False``), so that, given the same
  vector, it is bit-exact to the plain version, whose every operation is
  one correctly rounded PyTorch kernel.

Bound on this card: bytes.  A step with fp32 moments reads p, g, m, v
and writes p, m, v (28 bytes a parameter), and the norm reads g once
more: 32 bytes a parameter at 3.35 TB/s, against about 15 fp32
operations.
"""

import triton
import triton.language as tl


@triton.jit
def sumsq_kernel(base_ptr, offs_ptr, sizes_ptr, chunk_leaf_ptr,
                 chunk_start_ptr, acc_ptr, BLOCK: tl.constexpr,
                 ITERS: tl.constexpr):
    c = tl.program_id(0)
    leaf = tl.load(chunk_leaf_ptr + c)
    start = tl.multiple_of(tl.load(chunk_start_ptr + c), BLOCK * ITERS)
    n = tl.load(sizes_ptr + leaf)
    # every leaf starts on a 16-byte boundary (the wrapper checks)
    ptr = base_ptr + tl.multiple_of(tl.load(offs_ptr + leaf), 4)
    lanes = tl.arange(0, BLOCK)
    acc = tl.zeros([BLOCK], dtype=tl.float32)
    for i in range(ITERS):
        o = start + i * BLOCK + lanes
        x = tl.load(ptr + o, mask=o < n, other=0.0)
        acc += x * x
    tl.atomic_add(acc_ptr, tl.sum(acc, 0).to(tl.float64))


@triton.jit
def adamw_kernel(p_ptr, g_ptr, m_ptr, v_ptr, scal_ptr, n, b1, omb1, b2,
                 omb2, eps, wd, BLOCK: tl.constexpr):
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    scale = tl.load(scal_ptr)
    lr = tl.load(scal_ptr + 1)
    c1 = tl.load(scal_ptr + 2)
    c2 = tl.load(scal_ptr + 3)
    p = tl.load(p_ptr + offs, mask=mask, other=0.0).to(tl.float32)
    g = tl.load(g_ptr + offs, mask=mask, other=0.0).to(tl.float32) * scale
    m = tl.load(m_ptr + offs, mask=mask, other=0.0).to(tl.float32) * b1 \
        + omb1 * g
    v = tl.load(v_ptr + offs, mask=mask, other=0.0).to(tl.float32) * b2 \
        + omb2 * g * g
    mhat = tl.div_rn(m, c1)
    vhat = tl.div_rn(v, c2)
    delta = tl.div_rn(mhat, tl.sqrt_rn(vhat) + eps) + wd * p
    p = p - lr * delta
    tl.store(p_ptr + offs, p.to(p_ptr.dtype.element_ty), mask=mask)
    tl.store(m_ptr + offs, m.to(m_ptr.dtype.element_ty), mask=mask)
    tl.store(v_ptr + offs, v.to(v_ptr.dtype.element_ty), mask=mask)
