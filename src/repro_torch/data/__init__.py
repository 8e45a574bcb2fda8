"""Deterministic synthetic data pipeline.

Batches are a pure function of ``(seed, step, shard)`` — restart from a
checkpointed step index reproduces the exact stream (the fault-tolerance
story depends on this).  Host-side numpy generation, double-buffered
prefetch thread, per-modality extras (frames / patches) matching each
architecture's ``input_specs``.
"""

from .pipeline import SyntheticStream, make_batch

__all__ = ["SyntheticStream", "make_batch"]
