"""Weights made from the seed on the device.

Every normally distributed parameter is drawn in one ``randn`` call of
the dtype the cell hands the program (float32 masters for training, the
served bfloat16 for prefill), as views of one buffer scaled in place;
the constant ones (norm scales, biases, ``A_log``) are filled.  The same
seed gives the same weights, which the reference is handed too.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from ..reference.common import Spec, nest, param_names

_ALIGN = 64                         # elements between leaf starts
_MASK = (1 << 63) - 1


def weight_seed(seed: int) -> int:
    return int(seed) & _MASK


def kept_wide(path: Tuple, shape: Tuple[int, ...]) -> bool:
    """Whether a served tree keeps the leaf in the masters' dtype: the
    1-D parameters outside the blocks (the final norm's scale), as the
    port's one cast per model leaves them."""
    return path[0] != "blocks" and len(shape) < 2


def make(specs: List[Spec], seed: int, device, dtype: torch.dtype,
         wide: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` in ``specs``' order: ``dtype``, or ``wide`` for
    the leaves :func:`kept_wide` names when ``dtype`` is narrower."""
    names = param_names(specs)
    offs, total = [], 0
    for _, shape, init, _ in specs:
        offs.append(total)
        if init == "normal":
            total += -(-math.prod(shape) // _ALIGN) * _ALIGN
    gen = torch.Generator(device).manual_seed(weight_seed(seed))
    buf = torch.randn(total, generator=gen, dtype=dtype, device=device)
    out: Dict[str, torch.Tensor] = {}
    for name, off, (path, shape, init, std) in zip(names, offs, specs):
        leaf_dt = wide if (dtype != wide and kept_wide(path, shape)) \
            else dtype
        n = math.prod(shape)
        if init == "normal":
            t = buf[off:off + n].view(shape).mul_(std)
        elif init == "ones":
            t = torch.ones(shape, dtype=leaf_dt, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=leaf_dt, device=device)
        elif init == "dt_bias":
            # softplus^-1 of dt drawn log-uniform in [1e-3, 1e-1]
            u = torch.rand(shape, generator=gen, dtype=torch.float32,
                           device=device)
            dt = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                           + math.log(1e-3)).clamp(min=1e-4)
            t = (dt + torch.log(-torch.expm1(-dt))).to(leaf_dt)
        elif init == "a_log":
            t = torch.log(torch.linspace(1.0, 16.0, shape[0],
                                         dtype=torch.float32,
                                         device=device)).to(leaf_dt)
        else:
            raise ValueError(f"unknown init {init!r} of {name}")
        out[name] = t
    return out


def tree(flat: Dict[str, torch.Tensor]) -> Dict:
    """The nested layout (``blocks`` a list) of ``{name: tensor}``."""
    return nest({tuple(int(s) if s.isdigit() else s
                       for s in k.split(".")): v for k, v in flat.items()})
