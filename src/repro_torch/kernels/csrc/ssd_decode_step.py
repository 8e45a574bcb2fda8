"""One token of the Mamba-2 (SSD) recurrence, in Triton for NVIDIA
Hopper.

Replaces the XLA-lowered state update and readout of ``ssm_decode``
(src/repro/models/ssm.py:183-188):

    h' = h * exp(dt * A) + dt * B (x) x        (d_state x head_dim)
    y  = C . h' + D * x

per (batch, head), with ``A = -exp(A_log)`` and B, C shared by the heads
of a group.  The state is stored in the compute dtype and updated in
fp32, as the reference does.

Bound on this card: the state's bytes.  A step reads the
``(B, H, N, P)`` state once and writes it once (4 bytes an element in
bf16), against about 5 operations an element: the kernel is bound by
its bytes at 3.35 TB/s.  Design: program ``(b * H + head, p-block)``
holds an ``N x BLOCK_P`` slice of the state (all of ``d_state``, so y's
reduction over ``N`` stays inside the program and no step crosses
programs), fuses the decay, the rank-1 update and the reduction into one
pass, and writes the new state over the old in place.  The wrapper cuts
``P`` into ``BLOCK_P`` columns only when ``B * H`` alone would leave SMs
idle (B 2: 96 programs on 132 SMs); each row of a slice stays
``BLOCK_P`` contiguous elements, 64 bytes or more in bf16 (cutting B 4's
192 programs into 768 of 32-byte rows, to spread the bytes evenly over
the SMs, measured slower on an H100).  B, C, dt, A and D are loaded once
per program.
"""

import triton
import triton.language as tl


@triton.jit
def ssd_decode_step_kernel(h_ptr, y_ptr, x_ptr, dt_ptr, alog_ptr, b_ptr,
                           c_ptr, d_ptr, NH: tl.constexpr, G: tl.constexpr,
                           N: tl.constexpr, P: tl.constexpr,
                           BLOCK_N: tl.constexpr, BLOCK_P: tl.constexpr):
    pid = tl.program_id(0)             # b * NH + head
    b = pid // NH
    hh = pid % NH
    grp = hh // (NH // G)
    n = tl.arange(0, BLOCK_N)
    p = tl.program_id(1) * BLOCK_P + tl.arange(0, BLOCK_P)
    nmask = n < N
    pmask = p < P
    hmask = nmask[:, None] & pmask[None, :]
    hoff = pid.to(tl.int64) * (N * P) + n[:, None] * P + p[None, :]
    h = tl.load(h_ptr + hoff, mask=hmask, other=0.0).to(tl.float32)
    dt = tl.load(dt_ptr + pid)
    a = -tl.exp(tl.load(alog_ptr + hh))
    da = tl.exp(dt * a)
    bv = tl.load(b_ptr + (b * G + grp) * N + n, mask=nmask,
                 other=0.0).to(tl.float32)
    cv = tl.load(c_ptr + (b * G + grp) * N + n, mask=nmask,
                 other=0.0).to(tl.float32)
    x = tl.load(x_ptr + pid * P + p, mask=pmask, other=0.0).to(tl.float32)
    h = h * da + (dt * bv)[:, None] * x[None, :]
    y = tl.sum(cv[:, None] * h, 0) + tl.load(d_ptr + hh) * x
    tl.store(h_ptr + hoff, h.to(h_ptr.dtype.element_ty), mask=hmask)
    tl.store(y_ptr + pid * P + p, y, mask=pmask)
