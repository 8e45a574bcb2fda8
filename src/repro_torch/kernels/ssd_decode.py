"""One token of the Mamba-2 SSD recurrence: the Triton kernel's wrapper
and its plain PyTorch version.

Counterpart of the state update and readout of
:func:`repro.models.ssm.ssm_decode` (ssm.py:178-188).
:func:`ssd_decode_step` dispatches on the tensors' device: CUDA tensors
launch the kernel (``csrc/ssd_decode_step.py``; a build or launch
failure raises); CPU tensors run :func:`ssd_decode_step_ref`, which
returns a new state.  On both devices the new state is written over the
caller's, as the attention caches are.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from . import triton_source

__all__ = ["ssd_decode_step", "ssd_decode_step_ref", "ssd_decode_step_cuda",
           "ssd_grid", "NUM_WARPS"]

# the least columns of a program's slice (64-byte rows in bf16: narrower
# rows measured slower), and the kernel's warps (fastest at every batch
# chip_smoke.py serves mamba2-780m at)
MIN_BLOCK_P = 32
NUM_WARPS = 2


def ssd_decode_step_ref(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                        a_log: torch.Tensor, b: torch.Tensor,
                        c: torch.Tensor, d: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version.  ``h`` (B, H, N, P) state in its storage dtype,
    ``x`` (B, H, P), ``b``/``c`` (B, G, N) in the compute dtype, ``dt``
    (B, H), ``a_log`` and ``d`` (H,) in fp32 -> ``(y (B, H, P) fp32,
    new state in h's dtype)``; the update runs in fp32."""
    hpg = h.shape[1] // b.shape[1]
    a = -torch.exp(a_log)
    da = torch.exp(dt * a)                                 # (B, H)
    bh = torch.repeat_interleave(b, hpg, dim=1)            # (B, H, N)
    ch = torch.repeat_interleave(c, hpg, dim=1)
    h32 = h.to(torch.float32)
    h32 = h32 * da[..., None, None] \
        + (dt[..., None, None] * bh[..., :, None]
           * x[..., None, :].to(torch.float32))
    y = torch.einsum("bhn,bhnp->bhp", ch.to(torch.float32), h32)
    y = y + d[..., None] * x.to(torch.float32)
    return y, h32.to(h.dtype)


def _check(h, x, dt, a_log, b, c, d):
    bsz, nh, n, p = h.shape
    g = b.shape[1]
    if (x.shape != (bsz, nh, p) or dt.shape != (bsz, nh)
            or b.shape != (bsz, g, n) or c.shape != b.shape
            or a_log.shape != (nh,) or d.shape != (nh,) or nh % g):
        raise ValueError(f"shapes h {tuple(h.shape)} x {tuple(x.shape)} dt "
                         f"{tuple(dt.shape)} B {tuple(b.shape)} C "
                         f"{tuple(c.shape)} A_log {tuple(a_log.shape)} D "
                         f"{tuple(d.shape)}")
    for t in (dt, a_log, d):
        if t.dtype != torch.float32:
            raise TypeError(f"dt, A_log and D must be float32, got {t.dtype}")


def ssd_grid(bh: int, p: int, sms: int) -> int:
    """``BLOCK_P``, the columns of a program's slice, for ``bh`` = B * H
    programs of head dimension ``p`` on ``sms`` SMs: all of P while
    that gives every SM a program, else P halved until it does or the
    slice is ``MIN_BLOCK_P`` columns."""
    bp = 1 << (p - 1).bit_length()
    while bp > MIN_BLOCK_P and bh * _cdiv(p, bp) < sms:
        bp //= 2
    return bp


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ssd_decode_step_cuda(h, x, dt, a_log, b, c, d):
    """Launch the kernel; ``h`` (contiguous) is updated in place.  The
    slice width comes from :func:`ssd_grid`."""
    _check(h, x, dt, a_log, b, c, d)
    ts = (h, x, dt, a_log, b, c, d)
    if not all(t.is_cuda and t.device == h.device for t in ts):
        raise ValueError("no SSD decode kernel for "
                         f"{sorted({str(t.device) for t in ts})}")
    if not h.is_contiguous():
        raise ValueError("the state must be contiguous (updated in place)")
    x, dt, b, c = (t.contiguous() for t in (x, dt, b, c))
    bsz, nh, n, p = h.shape
    bp = ssd_grid(bsz * nh, p, _sms(h.get_device()))
    mod = triton_source.load("ssd_decode_step")
    y = torch.empty((bsz, nh, p), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.get_device()):
        mod.ssd_decode_step_kernel[(bsz * nh, _cdiv(p, bp))](
            h, y, x, dt, a_log, b, c, d, NH=nh, G=b.shape[1], N=n, P=p,
            BLOCK_N=1 << (n - 1).bit_length(), BLOCK_P=bp,
            num_warps=NUM_WARPS)
    ssd_decode_step.launches += 1
    return y, h


def ssd_decode_step(h: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                    a_log: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                    d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, h)`` of one recurrence step (shapes and dtypes as
    :func:`ssd_decode_step_ref`): the new state is written over ``h`` on
    every device.  CUDA: the Triton kernel; CPU: the plain version."""
    if h.device.type == "cpu":
        _check(h, x, dt, a_log, b, c, d)
        y, new = ssd_decode_step_ref(h, x, dt, a_log, b, c, d)
        return y, h.copy_(new)
    return ssd_decode_step_cuda(h, x, dt, a_log, b, c, d)


# kernel launches since the last reset (CPU calls excluded)
ssd_decode_step.launches = 0
