"""Latency/throughput metrics for the serving simulator.

Everything here is deterministic: percentiles use linear interpolation
on the sorted sample, and the JSON serialisation sorts keys and rounds
floats so the same simulation produces the same bytes on every run —
the property the determinism test and the CI golden gate rely on.

Two aggregation paths produce byte-identical output:

* :func:`summarize` over :class:`RequestRecord` lists (the event
  engine's native shape);
* :func:`summarize_soa` over preallocated numpy timeline arrays (the
  array engine's native shape) — means are chained ``cumsum`` (the
  same left-fold as Python ``sum``), percentiles interpolate on
  ``np.sort`` output, and every value is converted back to a Python
  float before rounding.

For ≥100k-request runs where holding and sorting full latency samples
is unwanted, :class:`StreamingPercentiles` estimates quantiles with
the P² algorithm (Jain & Chlamtac 1985) in O(1) memory per quantile;
pass ``percentile_mode="streaming"`` to either summarizer.  Exact
sorted-sample percentiles stay the default so existing goldens remain
byte-stable.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np

__all__ = ["RequestRecord", "percentile", "summarize", "summarize_soa",
           "StreamingPercentiles", "metrics_json"]

_ROUND = 9  # digits kept when serialising floats


@dataclass
class RequestRecord:
    """Per-request timeline collected by the simulator (seconds)."""
    rid: int
    t_arrive: float
    prompt_len: int
    gen_len: int
    t_prefill_start: float = 0.0
    t_first_token: float = 0.0
    t_complete: float = 0.0

    @property
    def ttft(self) -> float:
        return self.t_first_token - self.t_arrive

    @property
    def tpot(self) -> float:
        """Mean inter-token latency after the first token."""
        if self.gen_len <= 1:
            return 0.0
        return (self.t_complete - self.t_first_token) / (self.gen_len - 1)


def _percentile_sorted(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an already-sorted sample."""
    if not 0.0 <= q <= 100.0:
        raise ValueError("q must be in [0, 100]")
    n = len(xs)
    if n == 0:
        return 0.0
    if n == 1:
        return xs[0]
    pos = q / 100.0 * (n - 1)
    lo = int(pos)
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return xs[lo] * (1.0 - frac) + xs[hi] * frac


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of ``values`` (``q`` in [0,100])."""
    if not 0.0 <= q <= 100.0:
        raise ValueError("q must be in [0, 100]")
    return _percentile_sorted(sorted(values), q)


class StreamingPercentiles:
    """P² quantile estimation in O(1) memory per tracked quantile.

    Maintains five markers per quantile whose heights converge on the
    true quantile via piecewise-parabolic adjustment — no sample is
    retained.  Estimates are approximate (they converge as the stream
    grows), so goldens gated on exact percentiles must not use this
    mode; it exists for million-request runs where the exact sample
    would dominate memory.
    """

    def __init__(self, qs: Sequence[float] = (50.0, 95.0, 99.0)) -> None:
        self.qs = [float(q) for q in qs]
        for q in self.qs:
            if not 0.0 < q < 100.0:
                raise ValueError("streaming quantiles must be in (0,100)")
        self._init: List[float] = []
        # per-quantile: marker heights (5), positions (5), desired
        self._h: List[List[float]] = []
        self._pos: List[List[float]] = []
        self._count = 0

    def update(self, x: float) -> None:
        self._count += 1
        if self._count <= 5:
            self._init.append(x)
            if self._count == 5:
                self._init.sort()
                for _ in self.qs:
                    self._h.append(list(self._init))
                    self._pos.append([1.0, 2.0, 3.0, 4.0, 5.0])
            return
        for qi, q in enumerate(self.qs):
            p = q / 100.0
            h = self._h[qi]
            pos = self._pos[qi]
            if x < h[0]:
                h[0] = x
                k = 0
            elif x >= h[4]:
                h[4] = x
                k = 3
            else:
                k = 0
                while x >= h[k + 1]:
                    k += 1
            for j in range(k + 1, 5):
                pos[j] += 1.0
            n = float(self._count)
            desired = [1.0, 1.0 + (n - 1.0) * p / 2.0,
                       1.0 + (n - 1.0) * p,
                       1.0 + (n - 1.0) * (1.0 + p) / 2.0, n]
            for j in (1, 2, 3):
                d = desired[j] - pos[j]
                if (d >= 1.0 and pos[j + 1] - pos[j] > 1.0) or \
                        (d <= -1.0 and pos[j - 1] - pos[j] < -1.0):
                    sgn = 1.0 if d >= 1.0 else -1.0
                    # piecewise-parabolic marker move
                    hp = h[j] + sgn / (pos[j + 1] - pos[j - 1]) * (
                        (pos[j] - pos[j - 1] + sgn)
                        * (h[j + 1] - h[j]) / (pos[j + 1] - pos[j])
                        + (pos[j + 1] - pos[j] - sgn)
                        * (h[j] - h[j - 1]) / (pos[j] - pos[j - 1]))
                    if not h[j - 1] < hp < h[j + 1]:
                        # parabolic left the bracket: linear fallback
                        k2 = j + (1 if sgn > 0 else -1)
                        hp = h[j] + sgn * (h[k2] - h[j]) \
                            / (pos[k2] - pos[j])
                    h[j] = hp
                    pos[j] += sgn

    def extend(self, xs: Sequence[float]) -> None:
        for x in xs:
            self.update(float(x))

    def get(self, q: float) -> float:
        qi = self.qs.index(float(q))
        if self._count == 0:
            return 0.0
        if self._count <= 5 or not self._h:
            return _percentile_sorted(sorted(self._init), q)
        return self._h[qi][2]

    @property
    def count(self) -> int:
        return self._count


def _family_exact(values: Sequence[float]) -> Dict[str, float]:
    """p50/p95/p99/mean of a latency sample, sorting it exactly once.

    The mean folds in the *original* order — re-associating the sum
    over the sorted sample could change the last ulp.
    """
    mean = sum(values) / len(values) if values else 0.0
    xs = sorted(values)
    return {
        "p50": _percentile_sorted(xs, 50),
        "p95": _percentile_sorted(xs, 95),
        "p99": _percentile_sorted(xs, 99),
        "mean": mean,
    }


def _family_streaming(values: Sequence[float]) -> Dict[str, float]:
    sp = StreamingPercentiles()
    sp.extend(values)
    mean = sum(values) / len(values) if values else 0.0
    return {"p50": sp.get(50), "p95": sp.get(95), "p99": sp.get(99),
            "mean": mean}


def summarize(records: Sequence[RequestRecord],
              extra: Mapping[str, Any] | None = None,
              percentile_mode: str = "exact") -> Dict[str, Any]:
    """Aggregate request records into the canonical metrics dict."""
    if percentile_mode not in ("exact", "streaming"):
        raise ValueError("percentile_mode must be exact|streaming")
    family = _family_exact if percentile_mode == "exact" \
        else _family_streaming
    ttfts = [r.ttft for r in records]
    tpots = [r.tpot for r in records if r.gen_len > 1]
    e2es = [r.t_complete - r.t_arrive for r in records]
    toks = sum(r.gen_len for r in records)
    if records:
        t0 = min(r.t_arrive for r in records)
        t1 = max(r.t_complete for r in records)
        makespan = max(t1 - t0, 1e-12)
    else:
        makespan = 0.0
    out: Dict[str, Any] = {
        "requests": len(records),
        "tokens": toks,
        "makespan_s": makespan,
        "throughput_tok_s": toks / makespan if makespan else 0.0,
        "throughput_req_s": len(records) / makespan if makespan else 0.0,
        "ttft_s": family(ttfts),
        "tpot_s": family(tpots),
        "e2e_s": family(e2es),
    }
    if extra:
        out.update(extra)
    return out


def _np_mean(xs: np.ndarray) -> float:
    """Left-fold mean matching Python ``sum(list)/len`` bit-for-bit —
    ``np.sum`` is pairwise, ``np.cumsum`` is sequential."""
    if len(xs) == 0:
        return 0.0
    return float(np.cumsum(xs)[-1]) / len(xs)


def _family_soa(xs: np.ndarray, percentile_mode: str) -> Dict[str, float]:
    if percentile_mode == "streaming":
        return _family_streaming(xs.tolist())
    mean = _np_mean(xs)
    s = np.sort(xs)
    # float() everywhere: np.float64 would not JSON-serialise
    return {
        "p50": float(_percentile_sorted(s, 50)),
        "p95": float(_percentile_sorted(s, 95)),
        "p99": float(_percentile_sorted(s, 99)),
        "mean": mean,
    }


def summarize_soa(t_arrive: np.ndarray, gen_len: np.ndarray,
                  t_first_token: np.ndarray, t_complete: np.ndarray,
                  extra: Mapping[str, Any] | None = None,
                  percentile_mode: str = "exact") -> Dict[str, Any]:
    """:func:`summarize` over SoA timeline arrays — byte-identical
    output for the same per-request values, no record objects built.
    """
    if percentile_mode not in ("exact", "streaming"):
        raise ValueError("percentile_mode must be exact|streaming")
    n = len(t_arrive)
    ttfts = t_first_token - t_arrive
    multi = gen_len > 1
    tpots = (t_complete[multi] - t_first_token[multi]) \
        / (gen_len[multi] - 1)
    e2es = t_complete - t_arrive
    toks = int(np.sum(gen_len))
    if n:
        makespan = max(float(np.max(t_complete))
                       - float(np.min(t_arrive)), 1e-12)
    else:
        makespan = 0.0
    fam = _family_soa
    out: Dict[str, Any] = {
        "requests": n,
        "tokens": toks,
        "makespan_s": makespan,
        "throughput_tok_s": toks / makespan if makespan else 0.0,
        "throughput_req_s": n / makespan if makespan else 0.0,
        "ttft_s": fam(ttfts, percentile_mode),
        "tpot_s": fam(tpots, percentile_mode),
        "e2e_s": fam(e2es, percentile_mode),
    }
    if extra:
        out.update(extra)
    return out


def _rounded(obj: Any) -> Any:
    if isinstance(obj, float):
        return round(obj, _ROUND)
    if isinstance(obj, dict):
        return {k: _rounded(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_rounded(v) for v in obj]
    return obj


def metrics_json(metrics: Mapping[str, Any]) -> str:
    """Canonical (sorted, rounded) JSON — byte-stable across runs."""
    return json.dumps(_rounded(dict(metrics)), sort_keys=True, indent=2)
