"""Next-token cross-entropy of the LM loss: the Triton kernel's wrapper
and its plain PyTorch version.

Counterpart of ``xent`` inside :func:`repro.models.transformer.loss_fn`
(transformer.py:272-276) with the ``.mean()`` the reference takes of it:
``logsumexp(logits) - logits[label]`` per row, the logits read in fp32
as the reference's ``(h @ head).astype(float32)``, averaged over the
rows.  :func:`cross_entropy` dispatches on the logits' device: CUDA
tensors go through :class:`CrossEntropy` (the forward and backward
kernels of ``csrc/cross_entropy.py``; a build or launch failure
raises); CPU tensors run :func:`cross_entropy_ref` under autograd.

On CUDA the backward writes the gradient over the logits it saved (the
product ``h @ head`` before it needs ``h`` and ``head``, not its
output): the logits passed in must not be read after the backward.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import triton_source

__all__ = ["cross_entropy", "cross_entropy_ref", "cross_entropy_rows_ref",
           "cross_entropy_fwd_cuda", "cross_entropy_bwd_cuda",
           "CrossEntropy", "BLOCK_V", "NUM_WARPS"]

# columns a program reads at a time, and its warps: a 4096-wide bf16 block
# is 16 elements a thread at 8 warps
BLOCK_V = 4096
NUM_WARPS = 8


def cross_entropy_rows_ref(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Plain version, per row: ``logits`` (N, V) in any float dtype,
    ``labels`` (N,) integer -> (N,) fp32 ``logsumexp - gold``."""
    l32 = logits.to(torch.float32)
    logz = torch.logsumexp(l32, -1)
    gold = torch.gather(l32, -1, labels.long()[..., None])[..., 0]
    return logz - gold


def cross_entropy_ref(logits: torch.Tensor,
                      labels: torch.Tensor) -> torch.Tensor:
    """Plain version: the mean of :func:`cross_entropy_rows_ref` (fp32
    scalar), differentiable by autograd."""
    return cross_entropy_rows_ref(logits, labels).mean()


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"logits (N, V) and labels (N,), got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if not logits.is_floating_point():
        raise TypeError(f"logits must be floating, got {logits.dtype}")
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if not (logits.is_cuda and labels.device == logits.device):
        raise ValueError("no cross-entropy kernel for "
                         f"{logits.device} / {labels.device}")
    if not logits.is_contiguous():
        raise ValueError("the logits must be contiguous")


def cross_entropy_fwd_cuda(logits: torch.Tensor, labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(loss (N,), lse (N,))`` in fp32."""
    _check(logits, labels)
    n, v = logits.shape
    labels = labels.contiguous()
    loss = torch.empty(n, dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    mod = triton_source.load("cross_entropy")
    with torch.cuda.device(logits.get_device()):
        mod.xent_fwd_kernel[(n,)](logits, labels, loss, lse, v,
                                  BLOCK_V=BLOCK_V, num_warps=NUM_WARPS)
    cross_entropy.launches += 1
    return loss, lse


def cross_entropy_bwd_cuda(logits: torch.Tensor, labels: torch.Tensor,
                           lse: torch.Tensor, grad: torch.Tensor,
                           out: torch.Tensor) -> torch.Tensor:
    """The backward kernel: ``out = (softmax(logits) - onehot(labels)) *
    grad / N`` in ``out``'s dtype (``out`` may be ``logits`` itself);
    ``grad`` is the mean's fp32 gradient, read on the device."""
    _check(logits, labels)
    n, v = logits.shape
    if out.shape != logits.shape or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous {tuple(logits.shape)}")
    grad = grad.to(torch.float32).reshape(1)
    mod = triton_source.load("cross_entropy")
    with torch.cuda.device(logits.get_device()):
        mod.xent_bwd_kernel[(n,)](logits, labels.contiguous(), lse, grad,
                                  out, v, float(n), BLOCK_V=BLOCK_V,
                                  num_warps=NUM_WARPS)
    cross_entropy.launches += 1
    return out


class CrossEntropy(torch.autograd.Function):
    """Mean cross-entropy with the kernels: one forward and one backward
    launch; the backward's gradient is written over the saved logits."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = cross_entropy_fwd_cuda(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss.mean()

    @staticmethod
    def backward(ctx, grad):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_bwd_cuda(logits, labels, lse, grad,
                                      out=logits), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean cross-entropy of ``logits`` (N, V) against ``labels`` (N,),
    an fp32 scalar.  CUDA: the Triton kernels (:class:`CrossEntropy`);
    CPU: the plain version."""
    if logits.device.type == "cpu":
        return cross_entropy_ref(logits, labels)
    return CrossEntropy.apply(logits, labels)


# kernel launches (forward and backward) since the last reset; CPU calls
# excluded
cross_entropy.launches = 0
