"""Batching policies and KV-cache admission control.

Two schedulers, mirroring the serving-systems literature:

* :class:`StaticBatcher` — request-level batching: a batch is formed
  only when the decode engine is idle and then runs until *every*
  member finishes (early finishers leave dead slots, new arrivals wait
  behind the whole batch — classic head-of-line blocking);
* :class:`ContinuousBatcher` — iteration-level (ORCA-style) batching:
  at every decode-iteration boundary, finished requests leave and
  queued requests join, so slots never idle while work is waiting.

Both admit under a KV-cache budget: a request reserves its *final*
footprint (prompt + all generated tokens) at admission, so a running
request can never be evicted mid-generation.  Admission is strict
FCFS — the scan stops at the first request that does not fit, which
trades a little utilisation for freedom from starvation.

Contract: :meth:`Batcher.admit` must be **pure** — it returns the
prefix of ``queue`` to admit without mutating ``active``, ``queue``,
or itself.  The array replay engine (:mod:`repro_torch.serve.engine`)
relies on this: during horizon planning it calls ``admit``
speculatively at simulated boundaries and discards the result when a
tail arrival invalidates the horizon.  A stateful policy would
double-count those probe calls.
"""
from __future__ import annotations

from typing import Callable, List, Protocol, Sequence

__all__ = ["Batcher", "StaticBatcher", "ContinuousBatcher",
           "make_policy", "POLICIES"]


class _HasFootprint(Protocol):
    kv_reserved: int


class Batcher:
    """Decides which queued requests join the decode batch."""

    name = "base"

    def __init__(self, max_batch: int = 8) -> None:
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.max_batch = max_batch

    def admit(self, active: Sequence[object],
              queue: Sequence[_HasFootprint],
              kv_free: int) -> List[_HasFootprint]:
        """Return the prefix of ``queue`` to admit.  Must be pure —
        the array engine probes boundaries speculatively and may
        discard the returned admission without applying it."""
        raise NotImplementedError

    def _take_fcfs(self, queue: Sequence[_HasFootprint], slots: int,
                   kv_free: int) -> List[_HasFootprint]:
        out: List[_HasFootprint] = []
        for r in queue:
            if len(out) >= slots:
                break
            if r.kv_reserved > kv_free:
                break  # strict FCFS: do not jump the queue
            out.append(r)
            kv_free -= r.kv_reserved
        return out


class StaticBatcher(Batcher):
    """Admit only into an idle engine; drain the batch to completion."""

    name = "static"

    def admit(self, active: Sequence[object],
              queue: Sequence[_HasFootprint],
              kv_free: int) -> List[_HasFootprint]:
        if active:
            return []
        return self._take_fcfs(queue, self.max_batch, kv_free)


class ContinuousBatcher(Batcher):
    """Top up the batch at every iteration boundary (iteration-level)."""

    name = "continuous"

    def admit(self, active: Sequence[object],
              queue: Sequence[_HasFootprint],
              kv_free: int) -> List[_HasFootprint]:
        slots = self.max_batch - len(active)
        if slots <= 0:
            return []
        return self._take_fcfs(queue, slots, kv_free)


POLICIES: dict[str, Callable[[int], Batcher]] = {
    "static": StaticBatcher,
    "continuous": ContinuousBatcher,
}


def make_policy(name: str, max_batch: int = 8) -> Batcher:
    try:
        return POLICIES[name](max_batch)
    except KeyError:
        raise ValueError(
            f"unknown policy {name!r}; choose from {sorted(POLICIES)}"
        ) from None
