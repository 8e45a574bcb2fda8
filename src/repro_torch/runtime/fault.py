"""Heartbeat-based failure detection.

Hosts publish monotonic heartbeats; the detector flags nodes whose last
beat is older than ``timeout``.  φ-accrual-lite: the timeout adapts to
the observed inter-beat distribution (mean + k·std), so slow-but-alive
networks do not trigger false evictions.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set

__all__ = ["HeartbeatRegistry", "FailureDetector"]


class HeartbeatRegistry:
    """Last-seen timestamps + inter-arrival history per node."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 history: int = 32) -> None:
        self._clock = clock
        self._last: Dict[str, float] = {}
        self._gaps: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=history))

    def beat(self, node: str) -> None:
        now = self._clock()
        if node in self._last:
            self._gaps[node].append(now - self._last[node])
        self._last[node] = now

    def nodes(self) -> List[str]:
        return sorted(self._last)

    def age(self, node: str) -> float:
        return self._clock() - self._last[node]

    def gap_stats(self, node: str):
        g = self._gaps[node]
        if not g:
            return None
        mean = sum(g) / len(g)
        var = sum((x - mean) ** 2 for x in g) / len(g)
        return mean, var ** 0.5


@dataclass
class FailureDetector:
    """Flags nodes as failed when heartbeat age exceeds the adaptive
    threshold ``max(min_timeout, mean + k * std)``."""

    registry: HeartbeatRegistry
    min_timeout: float = 10.0
    k: float = 6.0
    on_failure: Optional[Callable[[str], None]] = None
    _failed: Set[str] = field(default_factory=set)

    def check(self) -> List[str]:
        newly = []
        for node in self.registry.nodes():
            if node in self._failed:
                continue
            stats = self.registry.gap_stats(node)
            thresh = self.min_timeout
            if stats is not None:
                mean, std = stats
                thresh = max(self.min_timeout, mean + self.k * std)
            if self.registry.age(node) > thresh:
                self._failed.add(node)
                newly.append(node)
                if self.on_failure:
                    self.on_failure(node)
        return newly

    @property
    def failed(self) -> Set[str]:
        return set(self._failed)

    def alive(self) -> List[str]:
        return [n for n in self.registry.nodes()
                if n not in self._failed]

    def revive(self, node: str) -> None:
        """Node rejoined after elastic scale-up."""
        self._failed.discard(node)
