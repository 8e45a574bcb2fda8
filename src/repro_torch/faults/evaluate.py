"""Fault-rate degradation curves on the INT8 oracle.

Host code copied from :mod:`repro.faults.evaluate` (the JAX package),
with the oracle on tensors: on the card every MVM of the clean and the
faulty forward passes runs on the bit-serial CUDA kernel
(:func:`repro_torch.kernels.ops.cim_mvm`), on the CPU on its plain
version.

One call = one workload swept across stuck-at fault rates: resolve a
:class:`~repro_torch.faults.model.FaultModel` per rate, corrupt the
weights, re-run the oracle and score bit-error rate / top-1 agreement
against the fault-free outputs.  Deterministic end to end (fixed seed),
so the resulting curve is golden-able: the rows equal the JAX package's
``BENCH_faults.json`` rows for its configuration.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from ..core import ref
from ..device import resolve_device
from ..kernels.ops import cim_mvm
from .metrics import bit_error_rate, top1_agreement
from .model import FaultModel, resolve_faults

__all__ = ["degradation_curve"]


def degradation_curve(cg: Any, chip: Any, rates: Sequence[float],
                      batch: int = 4, seed: int = 0,
                      base: Optional[FaultModel] = None,
                      device: Union[str, torch.device, None] = None
                      ) -> List[Dict[str, float]]:
    """BER / top-1 agreement of a condensed graph per stuck-at rate.

    ``base`` carries the non-``rate`` fault knobs (transient rate,
    seed); per sweep step only ``rate`` changes.  The oracle runs on
    ``device`` (CUDA unless named; raises without a card), with the
    quantization :func:`~repro_torch.core.ref.auto_quant` picks, as the
    ``func:torch`` backend does.  Returns one row per rate:
    ``{"rate", "n_stuck", "ber", "top1_agreement"}``.
    """
    dev = resolve_device(device)
    weights, biases, inputs = ref.random_init(cg, batch=batch, seed=seed,
                                              device=dev)
    quant = ref.auto_quant(cg, weights, biases, inputs)

    def forward(fs: Any) -> Dict[int, Any]:
        outs = ref.run_reference(cg, weights, biases, quant, inputs,
                                 matmul=cim_mvm, faults=fs)
        return {gid: t.cpu().numpy() for gid, t in outs.items()}

    clean = forward(None)
    final_gid = max(clean)
    rows: List[Dict[str, float]] = []
    fm0 = base if base is not None else FaultModel(seed=seed)
    for rate in rates:
        fm = replace(fm0, rate=float(rate))
        fs = resolve_faults(weights, chip, fm)
        faulty = forward(fs)
        rows.append({
            "rate": float(rate),
            "n_stuck": float(fs.n_stuck),
            "ber": bit_error_rate(clean, faulty),
            "top1_agreement": top1_agreement(clean[final_gid],
                                             faulty[final_gid]),
        })
    return rows
