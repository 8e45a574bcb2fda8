"""``repro_torch`` — CIMFlow on PyTorch and CUDA (NVIDIA Hopper).

The port of :mod:`repro` (JAX/TPU) to PyTorch, held bit-exact against
it.  The module layout mirrors ``repro`` so each counterpart is easy to
find:

* :mod:`repro_torch.core` — the host IR and compiler passes (graph,
  workloads, arch, machine, mapping, partition), the integer vector
  semantics (:mod:`~repro_torch.core.vecsem`) and the functional oracle
  on tensors (:mod:`~repro_torch.core.ref`);
* :mod:`repro_torch.kernels` — the bit-serial CIM MVM as a hand-written
  CUDA kernel for ``sm_90a`` (:mod:`~repro_torch.kernels.bitserial_mvm`)
  beside its plain PyTorch version (:mod:`~repro_torch.kernels.ref`);
* :mod:`repro_torch.flow` — ``compile(workload, chip, options)`` ->
  ``Artifact.evaluate(backend)`` with the ``analytic`` and
  ``func:torch`` backends;
* :mod:`repro_torch.convert` — carries the JAX package's numpy
  weights/inputs/quantization across as tensors.

The package imports ``torch`` and numpy only.  Entry points that touch
tensors run on CUDA unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
