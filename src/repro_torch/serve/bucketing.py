"""Length-bucketed admission for the serving simulator.

Requests with similar sequence lengths are grouped into exponentially
spaced buckets (the ``data_reader`` batching idiom from tensor2tensor):
step costs are compiled once per *bucket* rather than once per length,
and admission/batching decisions quantise a request's KV length to its
bucket boundary.  The boundary is always an upper bound, so bucketed
costs are conservative.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

__all__ = [
    "bucket_boundaries",
    "bucket_for",
    "bucket_batch_sizes",
    "group_by_bucket",
]


def bucket_boundaries(max_length: int, min_length: int = 8,
                      step: float = 1.25) -> List[int]:
    """Exponentially spaced inclusive upper bounds covering
    ``[1, max_length]``.

    Consecutive boundaries grow by at least one and at most ``step``×;
    the final boundary is exactly ``max_length``.
    """
    if max_length < 1:
        raise ValueError("max_length must be >= 1")
    if step <= 1.0:
        raise ValueError("step must be > 1.0")
    x = max(1, min(min_length, max_length))
    out: List[int] = []
    while x < max_length:
        out.append(x)
        x = max(x + 1, int(x * step))
    out.append(max_length)
    return out


def bucket_for(length: int, boundaries: Sequence[int]) -> int:
    """Smallest boundary that admits ``length``.

    Raises ``ValueError`` when the length exceeds every boundary —
    the caller sized its buckets wrong, which should be loud.
    """
    if length < 0:
        raise ValueError("length must be >= 0")
    for b in boundaries:
        if length <= b:
            return b
    raise ValueError(
        f"length {length} exceeds largest bucket {boundaries[-1]}")


def bucket_batch_sizes(boundaries: Sequence[int], tokens_per_batch: int,
                       max_batch: int) -> Dict[int, int]:
    """Per-bucket batch-size caps under a token budget.

    Longer buckets admit fewer requests per batch so that
    ``batch × boundary`` stays within ``tokens_per_batch`` (at least one
    request per bucket, at most ``max_batch``).
    """
    if tokens_per_batch < 1 or max_batch < 1:
        raise ValueError("budgets must be >= 1")
    return {b: max(1, min(max_batch, tokens_per_batch // b))
            for b in boundaries}


def group_by_bucket(lengths: Sequence[int],
                    boundaries: Sequence[int]) -> Dict[int, List[int]]:
    """Indices of ``lengths`` grouped by their admitting bucket."""
    out: Dict[int, List[int]] = {}
    for i, n in enumerate(lengths):
        out.setdefault(bucket_for(n, boundaries), []).append(i)
    return out
