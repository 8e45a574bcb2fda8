"""Carry the JAX package's state across to the port.

:func:`from_reference` takes what :func:`repro.core.ref.random_init` and
:func:`repro.core.ref.auto_quant` return — numpy dicts plus objects with
``.scale``/``.shift`` — and gives back the port's tensors and
:class:`~repro_torch.core.ref.QuantParams`.  :func:`from_jax_params`
takes the LM's parameter pytree (:func:`repro.models.transformer.
init_params`) as numpy arrays and gives back the port's
:class:`~repro_torch.models.transformer.ParamTree`, its stacked blocks
unstacked; :func:`from_jax_opt_state` does the same for the AdamW
state (:func:`repro.optim.adamw_init`).  All are duck-typed: nothing of
``repro`` is imported.
Tensors pass through (moved to ``device``), so the functions are
idempotent.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from .core.ref import QuantParams
from .device import resolve_device

__all__ = ["from_reference", "from_jax_params", "from_jax_opt_state",
           "to_tensor"]

# pytree keys whose leaves carry a leading per-block axis
_STACKED = ("blocks", "enc_blocks")


def to_tensor(a: Any, device: Union[str, torch.device, None] = None
              ) -> torch.Tensor:
    """An array (numpy, tensor or nested sequence) as a tensor on
    ``device`` with its dtype kept."""
    dev = resolve_device(device)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":       # ml_dtypes: no numpy bridge
        return torch.from_numpy(arr.astype(np.float32)).to(
            dev, torch.bfloat16)
    if not arr.flags.writeable:            # e.g. a view of a JAX array
        arr = arr.copy()
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


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


def _tree_tensors(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, Mapping):
        return {k: _tree_tensors(v, dev) for k, v in tree.items()}
    return to_tensor(tree, dev)


def _unstack(tree: Any, i: int) -> Any:
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return tree[i]


def from_jax_params(cfg: Any, params: Mapping[str, Any],
                    device: Union[str, torch.device, None] = None):
    """The reference's LM parameters (nested mappings of arrays, with the
    leading ``n_blocks`` axis of ``params["blocks"]`` and
    ``encoder_layers`` axis of ``params["enc_blocks"]``) as the port's
    parameter module on ``device`` (default: CUDA), one tree per block.
    ``cfg`` gives the block counts."""
    from .models.transformer import ParamTree
    dev = resolve_device(device)
    counts = {"blocks": cfg.n_blocks, "enc_blocks": cfg.encoder_layers}
    tree: Dict[str, Any] = {}
    for key, val in params.items():
        if key in _STACKED:
            stacked = _tree_tensors(val, dev)
            tree[key] = [_unstack(stacked, i) for i in range(counts[key])]
        else:
            tree[key] = _tree_tensors(val, dev)
    return ParamTree(tree)


def from_jax_opt_state(cfg: Any, opt: Mapping[str, Any],
                       device: Union[str, torch.device, None] = None
                       ) -> Dict[str, Any]:
    """The reference's AdamW state (``m`` and ``v`` shaped as its
    parameters, stacked blocks included, and an int32 ``step``) as the
    port's: ``m`` and ``v`` as parameter modules (one tree per block,
    their dtype kept, bf16 included) and ``step`` an int32 0-d tensor, on
    ``device`` (default: CUDA)."""
    dev = resolve_device(device)
    return {"m": from_jax_params(cfg, opt["m"], dev),
            "v": from_jax_params(cfg, opt["v"], dev),
            "step": to_tensor(opt["step"], dev).to(torch.int32).reshape(())}
