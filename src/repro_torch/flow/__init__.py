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
* :class:`Pipeline` — runs the pass chain behind an LRU output cache.
* :class:`Backend` + :func:`register_backend` — the analytic cost
  model, the trace replay, the ISS simulator and the ``func:torch``
  oracle behind ``Artifact.evaluate``.
"""

from ..core.machine import Calibration, MachineModel, machine_for
from .backends import (BACKENDS, AnalyticBackend, Backend, EvalReport,
                       SimulatorBackend, TorchFuncBackend, TraceBackend,
                       backend_for_fidelity, register_backend,
                       resolve_backend)
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
    "Calibration", "MachineModel", "machine_for",
]
