"""Evaluation backends for :class:`repro_torch.flow.Artifact`.

Counterpart of :mod:`repro.flow.backends`.  A :class:`Backend` turns a
compiled artifact into an :class:`EvalReport`:

* :class:`AnalyticBackend` — the mapping cost model's stage latencies
  and energy-event ledger (no codegen).
* :class:`TorchFuncBackend` (``"func:torch"``) — the INT8 functional
  oracle with every MVM on the hand-written bit-serial CUDA kernel; the
  counterpart of the JAX package's ``"func:pallas"``.

Backends resolve by name through :data:`BACKENDS`.  The trace backend
and the ISS simulator backends (``"trace"``, ``"simulate"``/``"perf"``,
``"func"``) are not ported yet; naming one raises
:class:`NotImplementedError`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from ..convert import from_reference
from ..core import ref
from ..core.machine import machine_for
from ..device import resolve_device
from ..kernels.ops import cim_mvm

__all__ = ["EvalReport", "Backend", "AnalyticBackend", "TorchFuncBackend",
           "BACKENDS", "resolve_backend", "register_backend",
           "backend_for_fidelity"]


@dataclass
class EvalReport:
    """One artifact evaluation, identical shape across fidelities."""

    backend: str                   # resolved backend name
    cycles: float
    energy: Dict[str, float]       # nJ breakdown, incl. "total"
    throughput_sps: float          # samples/s at the chip clock
    batch: int
    wall_s: float = 0.0
    outputs: Optional[Dict[int, np.ndarray]] = None  # func oracles only

    @property
    def energy_total(self) -> float:
        return self.energy.get("total", 0.0)

    @property
    def edp(self) -> float:
        return self.cycles * self.energy_total

    def summary(self) -> str:
        return (f"[{self.backend}] {self.cycles:.0f} cycles, "
                f"{self.energy_total / 1e6:.3f} mJ, "
                f"{self.throughput_sps:.1f} samples/s "
                f"(batch={self.batch})")


def _throughput(chip: Any, cycles: float, batch: int) -> float:
    if cycles <= 0:
        return 0.0
    return batch / (cycles / (chip.clock_ghz * 1e9))


class Backend:
    """Evaluation backend protocol: ``evaluate(artifact) -> EvalReport``."""

    name: str = "backend"

    def evaluate(self, artifact: Any, **kw: Any) -> EvalReport:
        raise NotImplementedError


class AnalyticBackend(Backend):
    """The mapping cost model — no ISA, no simulator."""

    name = "analytic"

    def evaluate(self, artifact: Any, **kw: Any) -> EvalReport:
        if kw:
            raise TypeError(f"analytic backend takes no extra "
                            f"arguments, got {sorted(kw)}")
        t0 = time.perf_counter()
        res = artifact.partition
        batch = artifact.options.resolved_batch()
        calib = artifact.options.calibration
        cycles = float(res.latency_cycles(batch, calib))
        energy = dict(machine_for(artifact.chip).price_events(
            res.energy_events(batch, calib)))
        return EvalReport(
            backend=self.name, cycles=cycles, energy=energy,
            throughput_sps=_throughput(artifact.chip, cycles, batch),
            batch=batch, wall_s=time.perf_counter() - t0)


class TorchFuncBackend(Backend):
    """Functional oracle with the MVMs on the bit-serial CUDA kernel.

    Forward-passes the artifact's condensed graph through
    :func:`repro_torch.core.ref.run_reference` with every INT8 matmul on
    :func:`repro_torch.kernels.ops.cim_mvm`.  With ``check=True``
    (default) the same forward runs again with every MVM on the plain
    version and every group output is asserted equal.

    ``weights``/``biases``/``inputs`` (numpy arrays or tensors, all
    three or none) default to :func:`~repro_torch.core.ref.random_init`
    draws from ``seed``; ``quant`` to :func:`~repro_torch.core.ref.
    auto_quant`.  ``device`` defaults to CUDA (raises without a card).
    ``outputs`` come back as numpy int8, keyed by group.
    """

    name = "func:torch"

    def evaluate(self, artifact: Any, weights: Any = None,
                 biases: Any = None, inputs: Any = None,
                 quant: Any = None, check: bool = True, seed: int = 0,
                 faults: Any = None,
                 device: Union[str, torch.device, None] = None,
                 **kw: Any) -> EvalReport:
        if kw:
            raise TypeError(f"func:torch backend takes weights/biases/"
                            f"inputs/quant/check/seed/faults/device, "
                            f"got {sorted(kw)}")
        if faults is not None:
            raise NotImplementedError(
                "func:torch does not inject faults yet (the faults "
                "slice); pass faults=None")
        given = [a is not None for a in (weights, biases, inputs)]
        if any(given) and not all(given):
            raise TypeError("pass weights+biases+inputs together or none "
                            "of them")
        dev = resolve_device(device)
        t0 = time.perf_counter()
        cg = artifact.cg
        if weights is None:
            weights, biases, inputs = ref.random_init(
                cg, batch=artifact.options.resolved_batch(), seed=seed,
                device=dev)
        weights, biases, inputs, quant = from_reference(
            weights, biases, inputs, quant, dev)
        if quant is None:
            quant = ref.auto_quant(cg, weights, biases, inputs)
        outs = ref.run_reference(cg, weights, biases, quant, inputs,
                                 matmul=cim_mvm)
        if check:
            want = ref.run_reference(cg, weights, biases, quant, inputs)
            for gid, arr in want.items():
                got = outs[gid]
                if got.shape != arr.shape or not torch.equal(got, arr):
                    raise AssertionError(
                        f"func:torch mismatch on group {gid}: kernel "
                        f"oracle != plain oracle (shapes "
                        f"{tuple(got.shape)} vs {tuple(arr.shape)})")
        outputs = {gid: t.cpu().numpy() for gid, t in outs.items()}
        # a functional-validation pass carries no timing claim
        return EvalReport(backend=self.name, cycles=0.0,
                          energy={"total": 0.0}, throughput_sps=0.0,
                          batch=int(inputs.shape[0]),
                          wall_s=time.perf_counter() - t0, outputs=outputs)


BACKENDS: Dict[str, Backend] = {}

# backends of the JAX package that later slices of the port bring
_NOT_PORTED = {"trace": "the trace slice", "simulate": "the simulator slice",
               "perf": "the simulator slice", "func": "the simulator slice",
               "func:pallas": "'func:torch' is its counterpart"}


def register_backend(b: Backend, *aliases: str,
                     replace: bool = False) -> Backend:
    for key in (b.name,) + aliases:
        if key in BACKENDS and not replace:
            raise ValueError(f"backend {key!r} already registered")
        BACKENDS[key] = b
    return b


register_backend(AnalyticBackend())
register_backend(TorchFuncBackend())


def resolve_backend(backend: Union[str, Backend, None],
                    fidelity: str = "analytic") -> Backend:
    """Name | instance | None (-> the fidelity's default backend)."""
    if backend is None:
        backend = backend_for_fidelity(fidelity)
    if isinstance(backend, str):
        if backend in BACKENDS:
            return BACKENDS[backend]
        if backend in _NOT_PORTED:
            raise NotImplementedError(
                f"backend {backend!r} is not ported to repro_torch "
                f"({_NOT_PORTED[backend]}); registered: {sorted(BACKENDS)}")
        raise KeyError(f"unknown backend {backend!r}; registered: "
                       f"{sorted(BACKENDS)}")
    if isinstance(backend, Backend):
        return backend
    raise TypeError(f"backend must be a name or Backend instance, "
                    f"got {type(backend).__name__}")


def backend_for_fidelity(fidelity: str) -> str:
    """CompileOptions.fidelity -> default backend name."""
    return {"analytic": "analytic", "trace": "trace",
            "simulate": "simulate", "func": "func"}[fidelity]
