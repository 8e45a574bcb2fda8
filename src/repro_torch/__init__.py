"""``repro_torch`` — CIMFlow on PyTorch and CUDA (NVIDIA Hopper).

The port of :mod:`repro` (JAX/TPU) to PyTorch, held bit-exact against
it.  The module layout mirrors ``repro`` so each counterpart is easy to
find:

* :mod:`repro_torch.core` — the host IR and compiler passes (graph,
  workloads, arch, machine, mapping, partition, oplevel, codegen), the
  simulators (the ISS, the numpy ``vectorsim`` engine, ``trace``), the
  integer vector semantics (:mod:`~repro_torch.core.vecsem`), the
  functional oracle on tensors (:mod:`~repro_torch.core.ref`) and the
  stage decode on tensors (:mod:`~repro_torch.core.torchsim`);
* :mod:`repro_torch.kernels` — the bit-serial CIM MVM as a hand-written
  CUDA kernel for ``sm_90a`` (:mod:`~repro_torch.kernels.bitserial_mvm`)
  beside its plain PyTorch version (:mod:`~repro_torch.kernels.ref`);
* :mod:`repro_torch.flow` — ``compile(workload, chip, options)`` ->
  ``Artifact.evaluate(backend)`` with the ``analytic``, ``trace``,
  ``simulate``/``perf``, ``func`` and ``func:torch`` backends, the pass
  disk cache and calibration presets;
* :mod:`repro_torch.explore` — design-space exploration: spaces, the
  cached pool engine, search, Pareto analysis, the CLI
  (``python -m repro_torch.explore``) and
  :class:`~repro_torch.explore.FleetEvaluator`, one compiled program
  under many chips' timing;
* :mod:`repro_torch.faults` — seeded fault models, their hooks in the
  oracle and the functional ISS, and degradation curves;
* :mod:`repro_torch.system` and :mod:`repro_torch.serve` — the mesh of
  chips and the serving replay;
* the LM stack: :mod:`repro_torch.configs` (the ten architectures),
  :mod:`repro_torch.data`, :mod:`repro_torch.quant`,
  :mod:`repro_torch.models` and :mod:`repro_torch.launch` (the serving
  entry point ``python -m repro_torch.launch.serve``), with the decode
  attention as a CUDA kernel and the SSD step as a Triton kernel;
* :mod:`repro_torch.convert` — carries the JAX package's numpy
  weights/inputs/quantization and LM parameters across as tensors.

The package imports ``torch`` and numpy only (``triton`` inside the
Triton kernel's launcher, at first use).  Entry points that touch
tensors run on CUDA unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
