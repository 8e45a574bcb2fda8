"""Straggler detection over per-host step timings.

Robust z-score (median / MAD) across hosts within a step window: a host
whose step time persistently exceeds ``median + k * MAD`` is flagged.
Mitigation hooks: the launcher can demote the host (elastic re-mesh) or
enable gradient-skip for it (documented in launch/train.py).
"""

from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List

__all__ = ["StragglerDetector"]


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclass
class StragglerDetector:
    k: float = 4.0                 # MAD multiplier
    window: int = 16               # steps of history per host
    min_hits: int = 3              # consecutive flags before reporting
    _hist: Dict[str, deque] = field(
        default_factory=lambda: defaultdict(lambda: deque(maxlen=16)))
    _hits: Dict[str, int] = field(default_factory=lambda: defaultdict(int))

    def record_step(self, times: Dict[str, float]) -> List[str]:
        """Feed one step's per-host durations; returns flagged hosts."""
        med = _median(list(times.values()))
        mad = _median([abs(t - med) for t in times.values()]) or 1e-9
        flagged = []
        for host, t in times.items():
            self._hist[host].append(t)
            z = (t - med) / (1.4826 * mad)
            if z > self.k:
                self._hits[host] += 1
            else:
                self._hits[host] = 0
            if self._hits[host] >= self.min_hits:
                flagged.append(host)
        return flagged

    def chronic(self) -> List[str]:
        return [h for h, c in self._hits.items() if c >= self.min_hits]
