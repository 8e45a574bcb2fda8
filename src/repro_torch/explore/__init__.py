"""``repro_torch.explore`` — design-space exploration on the port.

So far the batched timing sweep only: :class:`FleetEvaluator` runs one
compiled program under many chips' timing constants, decoding each
stage once for the whole fleet on the card, and :func:`canonical_chip`
groups chips that share a compile.  The engine, search, cache and CLI
of :mod:`repro.explore` are not ported yet.
"""

from .fleet import FleetEvaluator, canonical_chip

__all__ = ["FleetEvaluator", "canonical_chip"]
