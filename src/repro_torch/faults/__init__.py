"""Seeded fault injection and resilience evaluation (``repro_torch.faults``).

Counterpart of :mod:`repro.faults` (the JAX package), bit-exact with it:
the same seeds draw the same fault sets, and the faulty oracle outputs
and degradation rows are equal.  Mesh failover is
:meth:`repro_torch.system.SystemConfig.degrade`; serving degradation
(deadlines, shedding, retries) is :class:`repro_torch.serve.ServeSim`.

Reliability is a first-class design axis for digital CIM: the compute
arrays suffer stuck-at and transient bit faults, global memory takes
soft errors, and pod-scale meshes lose whole chips and links.  This
package makes all of that *measurable* with the same determinism
guarantees as the rest of the framework:

* :class:`FaultModel` — one frozen, seeded description of every fault
  process (CIM stuck-at rate, transient accumulator flips, gmem word
  flips, failed mesh chips/links).  Identical configs resolve to
  bit-identical fault sets on every run and every backend.
* :class:`FaultSet` — the resolved *logical* faults of one workload:
  per-MG-tile stuck-at masks over each group's ``(K, N)`` weight
  matrix plus deterministic per-``(group, sample)`` transient flips.
  Hooked into the tensor oracle (``ref.run_reference(faults=...)``),
  and so into the ``func:torch`` backend, and, through corrupted
  weights/gmem images, into the functional ISS.
* :class:`PhysicalCimFaults` — the *physical* view: stuck bits pinned
  to ``(core, macro group)`` array coordinates, applied by the
  functional ISS when ``CIM_LOAD`` latches weights into a faulty
  array (``Simulator(..., faults=...)``).
* :func:`bit_error_rate` / :func:`top1_delta` — accuracy-degradation
  metrics over oracle outputs.
* :func:`degradation_curve` — BER / top-1 agreement of a workload
  across a fault-rate sweep, the oracle on the card's CUDA kernel.
* :func:`residual_rate` — first-order effectiveness of the mitigation
  hardware (ECC / row sparing / TMR) priced by
  :class:`repro_torch.core.arch.ProtectionConfig`.
"""

from .metrics import bit_error_rate, top1_agreement, top1_delta
from .model import (FaultModel, FaultSet, PhysicalCimFaults, corrupt_gmem,
                    residual_rate, resolve_faults)
from .evaluate import degradation_curve

__all__ = [
    "FaultModel", "FaultSet", "PhysicalCimFaults",
    "resolve_faults", "corrupt_gmem", "residual_rate",
    "bit_error_rate", "top1_agreement", "top1_delta",
    "degradation_curve",
]
