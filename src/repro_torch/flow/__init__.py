"""``repro_torch.flow`` — the pass-based compiler pipeline.

Counterpart of :mod:`repro.flow`::

    from repro_torch import flow
    from repro_torch.core.arch import default_chip

    art = flow.compile("resnet18", default_chip(),
                       flow.CompileOptions(strategy="dp", batch=4,
                                           workload_kw={"res": 224}))
    print(art.describe())                 # instrumented pass trace
    art.evaluate("analytic")              # cost model
    art.evaluate("simulate")              # ISS, decode on the card
    art.evaluate("func:torch")            # INT8 oracle on the CUDA kernel

* :class:`CompileOptions` — strategy / batch / quant / strict_lmem /
  fidelity in one frozen record.
* :class:`Pass` + :func:`register_pass` — partition strategies plug in
  as ``partition:<name>`` passes.
* :class:`Pipeline` — runs the pass chain behind an LRU output cache
  and, optionally, a disk tier shared across processes
  (:class:`PassDiskCache`).
* :class:`Backend` + :func:`register_backend` — the analytic cost
  model, the trace replay, the ISS simulator and the ``func:torch``
  oracle behind ``Artifact.evaluate``.
* :func:`calibrate` — per-unit correction factors for the analytic and
  trace fidelities from a few simulator runs, saved and loaded as named
  presets (:func:`save_calibration`, :func:`load_calibration`).
"""

from ..core.machine import Calibration, MachineModel, machine_for
from .backends import (BACKENDS, AnalyticBackend, Backend, EvalReport,
                       SimulatorBackend, TorchFuncBackend, TraceBackend,
                       backend_for_fidelity, register_backend,
                       resolve_backend)
from .calibrate import (CalibrationReport, CalibrationRow, calibrate,
                        calibration_dir, list_calibrations,
                        load_calibration, save_calibration)
from .diskcache import PassDiskCache
from .options import FIDELITIES, CompileOptions
from .passes import (PASS_REGISTRY, CodegenPass, CondensePass, Pass,
                     PartitionPass, PassRecord, PipelineContext, get_pass,
                     partition_pass_name, register_pass)
from .pipeline import (Artifact, Pipeline, compile, compile_many,
                       default_pipeline, workload_fingerprint)

__all__ = [
    "compile", "compile_many", "CompileOptions", "FIDELITIES",
    "Artifact", "Pipeline", "default_pipeline", "workload_fingerprint",
    "Pass", "PassRecord", "PipelineContext", "PASS_REGISTRY",
    "register_pass", "get_pass", "partition_pass_name",
    "CondensePass", "PartitionPass", "CodegenPass",
    "Backend", "EvalReport", "AnalyticBackend", "TraceBackend",
    "SimulatorBackend", "TorchFuncBackend",
    "BACKENDS", "register_backend", "resolve_backend",
    "backend_for_fidelity",
    "calibrate", "CalibrationReport", "CalibrationRow",
    "calibration_dir", "save_calibration", "load_calibration",
    "list_calibrations",
    "Calibration", "MachineModel", "machine_for", "PassDiskCache",
]
