"""Accuracy-degradation metrics over oracle outputs.

All metrics compare two ``{gid: int8 array}`` output dicts (or two raw
arrays) of identical shapes — typically the fault-free oracle run
against a faulty one — and reduce to plain floats, so degradation
curves serialize straight into benchmark goldens.  Copied from
:mod:`repro.faults.metrics` (the JAX package); outputs of the tensor
oracle come here as numpy arrays.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np

__all__ = ["bit_error_rate", "top1_agreement", "top1_delta"]

_Outputs = Union[np.ndarray, Dict[int, np.ndarray]]


def _pairs(ref: _Outputs, got: _Outputs):
    if isinstance(ref, dict) != isinstance(got, dict):
        raise TypeError("compare two output dicts or two arrays, "
                        "not a mix")
    if isinstance(ref, dict):
        if sorted(ref) != sorted(got):
            raise ValueError(f"output keys differ: {sorted(ref)} vs "
                             f"{sorted(got)}")
        for gid in sorted(ref):
            yield np.asarray(ref[gid]), np.asarray(got[gid])
    else:
        yield np.asarray(ref), np.asarray(got)


def bit_error_rate(ref: _Outputs, got: _Outputs) -> float:
    """Fraction of output *bits* that differ (0.0 = bit-identical)."""
    wrong = 0
    total = 0
    for a, b in _pairs(ref, got):
        if a.shape != b.shape:
            raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
        x = np.bitwise_xor(a.view(np.uint8), b.view(np.uint8))
        wrong += int(np.unpackbits(x.reshape(-1)).sum())
        total += x.size * 8
    return wrong / total if total else 0.0


def top1_agreement(ref: np.ndarray, got: np.ndarray) -> float:
    """Fraction of samples whose argmax class is unchanged.

    Takes the final ``(batch, ...)`` output maps; everything after the
    batch axis is flattened into one logit vector per sample.
    """
    a = np.asarray(ref).reshape(ref.shape[0], -1)
    b = np.asarray(got).reshape(got.shape[0], -1)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    return float(np.mean(a.argmax(axis=1) == b.argmax(axis=1)))


def top1_delta(ref: np.ndarray, got: np.ndarray) -> float:
    """Fraction of samples whose argmax class *changed* (1 - agreement)."""
    return 1.0 - top1_agreement(ref, got)
