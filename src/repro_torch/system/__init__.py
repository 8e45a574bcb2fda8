"""repro_torch.system — mesh-of-chips scale-out above the single-chip stack.

Host code copied from :mod:`repro.system` (the JAX package), with its
imports pointed at the port: the same plans, cache keys and reports.
What runs on the card is what each chip slice drives: a simulate
evaluation decodes every slice's stages on the ``torch`` engine, one
slice after another on the caller's ``device``.

One chip is the unit of everything below this package; here a
:class:`SystemConfig` arranges identical chips in a 2D mesh joined by
an inter-chip link tier (priced, like every other timing rule, by
:class:`repro_torch.core.machine.MachineModel`), and the system partitioners
split one workload across the mesh:

* ``pipeline`` — contiguous stage ranges per chip, cut-crossing
  activations as SEND/RECV link transfers (full fidelity ladder,
  including bit-exact func mode via :meth:`SystemArtifact.run_func`);
* ``tensor`` — per-group weight sharding with ring collectives
  (analytic + trace fidelities).

Entry point: ``repro_torch.flow.compile(workload, chip, system=cfg)`` — the
``system=`` keyword routes through the ``system:<mode>`` passes and
returns a :class:`SystemArtifact`.  Importing this package registers
those passes.
"""

from .artifact import FuncRunResult, SystemArtifact
from .config import PARALLEL_MODES, SystemConfig
from .evaluate import SystemReport, evaluate_plan
from .partition import (ChipSlice, Collective, SystemPlan,
                        SystemPlanError, Transfer, shard_tensor,
                        split_pipeline)
from . import passes as _passes            # noqa: F401  (registers passes)

__all__ = [
    "SystemConfig", "PARALLEL_MODES",
    "SystemPlan", "ChipSlice", "Transfer", "Collective",
    "SystemPlanError", "split_pipeline", "shard_tensor",
    "SystemArtifact", "FuncRunResult",
    "SystemReport", "evaluate_plan",
]
