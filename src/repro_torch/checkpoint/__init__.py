"""Checkpointing: atomic, async, sharded, resumable.

Counterpart of :mod:`repro.checkpoint`, on trees of tensors."""

from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
