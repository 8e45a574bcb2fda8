"""Functional optimizer (AdamW) + schedules on tensors.

Counterpart of :mod:`repro.optim`.  Optimizer state mirrors the
parameter tree (``m``, ``v`` in ``moment_dtype``, ``step`` an int32
tensor); ``moment_dtype`` lets huge models keep moments in bf16.  The
update runs in place through the AdamW kernels
(:mod:`repro_torch.kernels.adamw`) on CUDA and their plain versions on
the CPU.
"""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_warmup

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "cosine_warmup"]
