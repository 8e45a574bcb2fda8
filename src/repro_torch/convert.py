"""Carry the JAX package's oracle state across to the port.

:func:`from_reference` takes what :func:`repro.core.ref.random_init` and
:func:`repro.core.ref.auto_quant` return — numpy dicts plus objects with
``.scale``/``.shift`` — and gives back the port's tensors and
:class:`~repro_torch.core.ref.QuantParams`.  It is duck-typed: nothing
of ``repro`` is imported.  Tensors pass through (moved to ``device``),
so the function is idempotent.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .core.ref import QuantParams
from .device import resolve_device

__all__ = ["from_reference", "to_tensor"]


def to_tensor(a: Any, device: Union[str, torch.device, None] = None
              ) -> torch.Tensor:
    """An array (numpy, tensor or nested sequence) as a tensor on
    ``device`` with its dtype kept."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def from_reference(weights: Mapping[int, Any], biases: Mapping[int, Any],
                   inputs: Any, quant: Optional[Mapping[int, Any]] = None,
                   device: Union[str, torch.device, None] = None
                   ) -> Tuple[Dict[int, torch.Tensor],
                              Dict[int, torch.Tensor], torch.Tensor,
                              Optional[Dict[int, QuantParams]]]:
    """``(weights, biases, inputs, quant)`` of the reference as the
    port's ``(tensors, tensors, tensor, QuantParams)`` on ``device``
    (default: CUDA).  ``quant=None`` stays ``None``."""
    dev = resolve_device(device)
    w = {int(k): to_tensor(v, dev) for k, v in weights.items()}
    b = {int(k): to_tensor(v, dev) for k, v in biases.items()}
    x = to_tensor(inputs, dev)
    q = None if quant is None else {
        int(k): QuantParams(scale=int(v.scale), shift=int(v.shift))
        for k, v in quant.items()}
    return w, b, x, q
