"""Arithmetic shared by the references.

:class:`Arith` does every matrix product of a reference: in float32
with TF32 off, or, as the control, on operands rounded to float8 e4m3
(one scale a tensor, its absolute maximum at 448), the precision below
the bfloat16 compute the configurations state.  The rounding passes
gradients straight through, so the control trains too.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

F8_MAX = 448.0


def fp32_exact() -> None:
    """float32 products in float32: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _RoundF8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        amax = t.abs().amax().clamp(min=1e-30)
        s = F8_MAX / amax
        return (t * s).to(torch.float8_e4m3fn).to(t.dtype) / s

    @staticmethod
    def backward(ctx, g):
        return g


class Arith:
    """``mm`` and ``einsum`` in float32, or on float8 operands
    (``fp8=True``: the control)."""

    def __init__(self, fp8: bool = False) -> None:
        self.fp8 = fp8

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _RoundF8.apply(t) if self.fp8 else t

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self.q(o) for o in ops])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * w


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of ``logits`` (..., V) fp32 at
    ``labels``."""
    lg = logits.reshape(-1, logits.shape[-1])
    return F.cross_entropy(lg, labels.reshape(-1).long(), reduction="sum")


# a parameter: (path, shape, init, std); init "normal" (times std),
# "ones", "zeros" or "a_log" (log of linspace(1, 16, n))
Spec = Tuple[Tuple, Tuple[int, ...], str, float]


def dense(path: Tuple, d_in: int, d_out: int) -> Spec:
    return (path, (d_in, d_out), "normal", 1.0 / math.sqrt(d_in))


def nest(flat: Dict[Tuple, torch.Tensor]) -> Dict:
    """``{path: tensor}`` as nested dicts, with ``("blocks", i, ...)``
    a list of per-block dicts."""
    out: Dict = {}
    for path, t in flat.items():
        node = out
        for i, k in enumerate(path[:-1]):
            nxt = path[i + 1]
            if isinstance(k, int):
                while len(node) <= k:
                    node.append({})
                node = node[k]
            else:
                node = node.setdefault(k, [] if isinstance(nxt, int) else {})
        node[path[-1]] = t
    return out


def remat(fn: Callable, *args):
    """``fn(*args)`` recomputed in the backward when gradients are on."""
    if torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def param_names(specs: List[Spec]) -> List[str]:
    return [".".join(str(k) for k in p) for p, *_ in specs]
