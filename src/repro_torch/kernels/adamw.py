"""The AdamW step with global-norm clipping: the Triton kernels'
wrappers and their plain PyTorch versions.

Counterpart of :func:`repro.optim.adamw.global_norm` and the per-leaf
``upd`` of :func:`repro.optim.adamw.adamw_update` (adamw.py:34-63).
:func:`grad_norm` and :func:`adamw_step` dispatch on the tensors'
device: CUDA tensors launch the kernels of ``csrc/adamw_step.py`` (one
launch for the norm, one a leaf for the update; a build or launch
failure raises), CPU tensors run the plain versions.  On both devices
the parameters and moments are updated in place.

The scalars between the two kernels (the clip scale, the bias
corrections ``1 - b^t``, the learning rate) are computed by a few
PyTorch operations on the device, in the reference's operations and
order, into one 4-element fp32 vector that the update kernel and the
plain version both read: nothing is copied to the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch

from . import triton_source

__all__ = ["grad_norm", "grad_norm_ref", "adamw_step", "adamw_leaf_ref",
           "adamw_scalars", "dense", "SUMSQ_BLOCK", "SUMSQ_ITERS",
           "UPDATE_BLOCK"]

# the norm kernel's lanes and iterations (a 65,536-element chunk a
# program), the update kernel's elements a program
SUMSQ_BLOCK, SUMSQ_ITERS = 4096, 16
SUMSQ_WARPS = 8
UPDATE_BLOCK, UPDATE_WARPS = 1024, 4


def grad_norm_ref(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """Plain version: the reference's ``sqrt(sum(stack(sum(square(g)))))``
    in fp32 (an fp32 0-d tensor)."""
    sums = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _to_device(values: List[int], dev: torch.device) -> torch.Tensor:
    """An int64 vector on ``dev`` by an asynchronous copy from pinned
    memory (no wait on the device's queue)."""
    host = torch.tensor(values, dtype=torch.int64)
    return host.pin_memory().to(dev, non_blocking=True)


# chunk tables by the leaves' sizes, offset tables by their addresses
_CHUNKS: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
_OFFSETS: Dict[Tuple, torch.Tensor] = {}
_CACHE_MAX = 8


def _tables(leaves: Sequence[torch.Tensor]):
    dev = leaves[0].device
    sizes = tuple(g.numel() for g in leaves)
    key = (str(dev), sizes)
    chunks = _CHUNKS.get(key)
    if chunks is None:
        step = SUMSQ_BLOCK * SUMSQ_ITERS
        leaf_of, start_of = [], []
        for i, n in enumerate(sizes):
            for s in range(0, n, step):
                leaf_of.append(i)
                start_of.append(s)
        if len(_CHUNKS) >= _CACHE_MAX:
            _CHUNKS.clear()
        chunks = _CHUNKS[key] = (_to_device(list(sizes), dev),
                                 _to_device(leaf_of, dev),
                                 _to_device(start_of, dev))
    ptrs = [g.data_ptr() for g in leaves]
    base = min(range(len(leaves)), key=ptrs.__getitem__)
    okey = (str(dev), tuple(ptrs))
    offs = _OFFSETS.get(okey)
    if offs is None:
        if len(_OFFSETS) >= _CACHE_MAX:
            _OFFSETS.clear()
        offs = _OFFSETS[okey] = _to_device(
            [(p - ptrs[base]) // 4 for p in ptrs], dev)
    return leaves[base], offs, chunks


def dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and starts on a 16-byte boundary, else a
    contiguous copy (autograd may hand back a permuted or offset
    gradient, e.g. an einsum's over a 3-D expert weight)."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _grad_norm_cuda(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    dev = leaves[0].device
    for g in leaves:
        if not (g.is_cuda and g.device == dev):
            raise ValueError("no norm kernel across devices "
                             f"{sorted({str(t.device) for t in leaves})}")
        if g.dtype != torch.float32 or not g.is_contiguous():
            raise TypeError(f"the norm kernel takes contiguous float32 "
                            f"leaves, got {g.dtype} {tuple(g.stride())}")
        if g.data_ptr() % 16:
            raise ValueError("every leaf must start on a 16-byte boundary")
    base, offs, (sizes, leaf_of, start_of) = _tables(leaves)
    acc = torch.zeros(1, dtype=torch.float64, device=dev)
    mod = triton_source.load("adamw_step")
    with torch.cuda.device(dev):
        mod.sumsq_kernel[(leaf_of.numel(),)](
            base, offs, sizes, leaf_of, start_of, acc, BLOCK=SUMSQ_BLOCK,
            ITERS=SUMSQ_ITERS, num_warps=SUMSQ_WARPS)
    grad_norm.launches += 1
    return torch.sqrt(acc[0]).to(torch.float32)


def grad_norm(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of ``leaves`` (an fp32 0-d tensor on their
    device).  CUDA: one launch of the sum-of-squares kernel (fp32 leaves,
    contiguous from 16-byte boundaries: :func:`dense`), the square root
    of its fp64 sum; CPU: the plain version."""
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    if leaves[0].device.type == "cpu":
        return grad_norm_ref(leaves)
    return _grad_norm_cuda(leaves)


# kernel launches since the last reset (CPU calls excluded)
grad_norm.launches = 0


def adamw_scalars(gnorm: torch.Tensor, lr: Union[float, torch.Tensor],
                  step: torch.Tensor, *, b1: float, b2: float,
                  clip_norm: float) -> torch.Tensor:
    """``[scale, lr, 1 - b1^step, 1 - b2^step]`` as an fp32 vector on
    ``gnorm``'s device, ``step`` being the new (counted from 1) int32
    step: the reference's ``minimum(1, clip / (gnorm + 1e-9))`` and
    bias corrections, operation for operation."""
    dev = gnorm.device
    clip = torch.full((), clip_norm, dtype=torch.float32, device=dev)
    scale = torch.minimum(torch.ones_like(clip), clip / (gnorm + 1e-9))
    t = step.to(device=dev, dtype=torch.float32)
    c1 = 1.0 - b1 ** t
    c2 = 1.0 - b2 ** t
    if not isinstance(lr, torch.Tensor):
        lr = torch.full((), lr, dtype=torch.float32, device=dev)
    return torch.stack([scale, lr.to(device=dev, dtype=torch.float32)
                        .reshape(()), c1, c2])


def adamw_leaf_ref(p, g, m, v, scalars, *, b1: float, b2: float,
                   eps: float, weight_decay: float):
    """Plain version of one leaf's update: ``(p', m', v')`` in the
    dtypes of ``p``, ``m``, ``v``, computed in fp32 in the reference's
    order from ``scalars`` (:func:`adamw_scalars`)."""
    scale, lr, c1, c2 = scalars.unbind()
    g = g.to(torch.float32) * scale
    m32 = m.to(torch.float32) * b1 + (1 - b1) * g
    v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
    mhat = m32 / c1
    vhat = v32 / c2
    p32 = p.to(torch.float32)
    delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
    newp = (p32 - lr * delta).to(p.dtype)
    return newp, m32.to(m.dtype), v32.to(v.dtype)


def _adamw_leaf_cuda(p, g, m, v, scalars, *, b1, b2, eps, weight_decay):
    ts = (p, g, m, v, scalars)
    if not all(t.is_cuda and t.device == p.device for t in ts):
        raise ValueError("no AdamW kernel for "
                         f"{sorted({str(t.device) for t in ts})}")
    if not (g.shape == m.shape == v.shape == p.shape):
        raise ValueError(f"leaf shapes p {tuple(p.shape)} g "
                         f"{tuple(g.shape)} m {tuple(m.shape)} v "
                         f"{tuple(v.shape)}")
    if not all(t.is_contiguous() for t in (p, g, m, v)):
        raise ValueError("the AdamW kernel takes contiguous leaves")
    n = p.numel()
    mod = triton_source.load("adamw_step")
    with torch.cuda.device(p.get_device()):
        mod.adamw_kernel[(-(-n // UPDATE_BLOCK),)](
            p, g, m, v, scalars, n, b1, 1 - b1, b2, 1 - b2, eps,
            weight_decay, BLOCK=UPDATE_BLOCK, num_warps=UPDATE_WARPS,
            enable_fp_fusion=False)
    adamw_step.launches += 1


def adamw_step(params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
               lr: Union[float, torch.Tensor], step: torch.Tensor, *,
               b1: float, b2: float, eps: float, weight_decay: float,
               clip_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One AdamW step over the leaves, in place on ``params``, ``ms``
    and ``vs``; returns ``(grad_norm, step + 1)`` as device tensors.
    CUDA: the norm kernel, then one update launch a leaf; CPU: the plain
    versions."""
    if not (len(params) == len(grads) == len(ms) == len(vs)):
        raise ValueError("params, grads and moments differ in length")
    new_step = step + 1
    if params and params[0].device.type == "cuda":
        grads = [dense(g) for g in grads]
    gnorm = grad_norm(grads)
    if not params:
        return gnorm, new_step
    scalars = adamw_scalars(gnorm, lr, new_step, b1=b1, b2=b2,
                            clip_norm=clip_norm)
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    with torch.no_grad():
        for p, g, m, v in zip(params, grads, ms, vs):
            if p.device.type == "cpu":
                newp, newm, newv = adamw_leaf_ref(p, g, m, v, scalars,
                                                  **hyper)
                p.copy_(newp)
                m.copy_(newm)
                v.copy_(newv)
            else:
                _adamw_leaf_cuda(p, g, m, v, scalars, **hyper)
    return gnorm, new_step


# update-kernel launches (one a leaf) since the last reset (CPU calls
# excluded); the norm's are grad_norm.launches
adamw_step.launches = 0
