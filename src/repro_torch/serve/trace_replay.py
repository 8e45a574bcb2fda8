"""Arrival traces and the discrete-event serving simulator.

A trace is a list of :class:`Request` (arrival time, prompt length,
generation length).  Traces come from a seeded Poisson process, a
bursty on/off-modulated Poisson process, or a JSON file — all three
are bit-for-bit reproducible from their seed.

:class:`ServeSim` replays a trace against a :class:`~repro_torch.serve.
workload.StepCostTable` with prefill/decode disaggregation:

* the **prefill engine** runs prompts back to back in arrival order;
  the first token of a request is produced when its prefill finishes
  (TTFT = prefill completion − arrival);
* the **decode engine** generates the remaining tokens.  At every
  iteration boundary the batching policy admits queued requests under
  the KV-cache budget, the iteration is priced in O(batch) from the
  step table, every member's KV grows by one, and finished members
  release their reservation.

The simulator touches no wall clock and no global RNG — identical
trace + table + policy produce identical metrics JSON.

Degraded operation is opt-in: pass ``deadline_s`` and/or ``max_queue``
to :class:`ServeSim` and the simulator adds request deadlines, load
shedding on queue pressure (with bounded retry-and-backoff), and
*goodput* — tokens from requests that met their deadline — to the
metrics.  With neither set, the simulation and its metrics JSON are
byte-identical to the fault-free simulator.
"""
from __future__ import annotations

import heapq
import json
import math
import random
import warnings
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .engine import run_array
from .metrics import RequestRecord, summarize
from .policy import Batcher
from .rng import VecMT, uniform_randbelow_batch
from .workload import StepCostTable

__all__ = ["Request", "poisson_trace", "poisson_trace_arrays",
           "bursty_trace", "load_trace", "save_trace", "ServeSim"]

_ENGINES = ("event", "array")
_PREFILL_POLICIES = ("fifo", "batched", "chunked")


@dataclass(frozen=True)
class Request:
    rid: int
    t_arrive: float
    prompt_len: int
    gen_len: int


def _poisson_trace_scalar(rate: float, n: int, seed: int = 0,
                          min_prompt: int = 4, max_prompt: int = 64,
                          min_new: int = 4,
                          max_new: int = 64) -> List[Request]:
    """Reference per-request loop (the committed traces' definition).

    :func:`poisson_trace` must match this bit-for-bit; the equivalence
    suite pins it.
    """
    if rate <= 0 or n < 1:
        raise ValueError("rate must be > 0 and n >= 1")
    rng = random.Random(seed)
    t = 0.0
    out: List[Request] = []
    for i in range(n):
        t += rng.expovariate(rate)
        out.append(Request(
            rid=i, t_arrive=t,
            prompt_len=rng.randint(min_prompt, max_prompt),
            gen_len=rng.randint(min_new, max_new)))
    return out


def poisson_trace_arrays(
        rate: float, n: int, seed: int = 0,
        min_prompt: int = 4, max_prompt: int = 64,
        min_new: int = 4,
        max_new: int = 64) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SoA form of :func:`poisson_trace`: ``(t_arrive, prompt_len,
    gen_len)`` numpy arrays, skipping :class:`Request` materialization
    (which dominates at million-request scale).  Values are
    bit-identical to the :class:`Request` list.
    """
    if rate <= 0 or n < 1:
        raise ValueError("rate must be > 0 and n >= 1")
    mt = VecMT(seed)
    u, (p, g) = uniform_randbelow_batch(
        mt, n, (max_prompt - min_prompt + 1, max_new - min_new + 1))
    gaps = [-math.log(1.0 - x) / rate for x in u.tolist()]
    t = np.cumsum(np.asarray(gaps))
    return t, p + min_prompt, g + min_new


def poisson_trace(rate: float, n: int, seed: int = 0,
                  min_prompt: int = 4, max_prompt: int = 64,
                  min_new: int = 4, max_new: int = 64) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s with uniform length draws.

    Bit-identical to :func:`_poisson_trace_scalar` (same seed, same
    bytes on disk) but draws the whole word stream through
    :class:`~repro_torch.serve.rng.VecMT` in numpy batches.  The only scalar
    stage left is the ``math.log`` map for the exponential gaps —
    numpy's SIMD ``log`` differs from libm by ~1 ulp on a fraction of
    inputs, which would change trace bytes.
    """
    t, p, g = poisson_trace_arrays(rate, n, seed, min_prompt,
                                   max_prompt, min_new, max_new)
    return [Request(rid=i, t_arrive=ti, prompt_len=pi, gen_len=gi)
            for i, (ti, pi, gi) in enumerate(zip(
                t.tolist(), p.tolist(), g.tolist()))]


def _bursty_trace_scalar(rate: float, n: int, seed: int = 0,
                         burst: float = 4.0, period_s: float = 2.0,
                         duty: float = 0.3, min_prompt: int = 4,
                         max_prompt: int = 64, min_new: int = 4,
                         max_new: int = 64) -> List[Request]:
    """Reference per-request loop for :func:`bursty_trace`."""
    if not 0.0 < duty < 1.0:
        raise ValueError("duty must be in (0, 1)")
    if burst * duty >= 1.0 + duty:
        # keep the off-phase rate positive
        raise ValueError("burst too high for this duty cycle")
    on_rate = rate * burst
    off_rate = rate * (1.0 - burst * duty) / (1.0 - duty)
    rng = random.Random(seed)
    t = 0.0
    out: List[Request] = []
    for i in range(n):
        while True:
            phase = (t / period_s) % 1.0
            r = on_rate if phase < duty else off_rate
            dt = rng.expovariate(r)
            # step at most to the next phase edge so the rate switch
            # lands where it should (thinning would also work; this
            # keeps the draw count deterministic per accepted arrival)
            edge = (duty if phase < duty else 1.0) * period_s \
                - (t % period_s)
            # t + edge == t: t sits within one ulp of the phase edge,
            # so stepping to the edge cannot advance the clock — accept
            # the draw at the boundary rate or the walk spins forever
            if dt <= edge or edge <= 0 or t + edge == t:
                t += dt
                break
            t += edge
        out.append(Request(
            rid=i, t_arrive=t,
            prompt_len=rng.randint(min_prompt, max_prompt),
            gen_len=rng.randint(min_new, max_new)))
    return out


def bursty_trace(rate: float, n: int, seed: int = 0,
                 burst: float = 4.0, period_s: float = 2.0,
                 duty: float = 0.3, min_prompt: int = 4,
                 max_prompt: int = 64, min_new: int = 4,
                 max_new: int = 64) -> List[Request]:
    """On/off-modulated Poisson arrivals with the same mean ``rate``.

    During the on-phase (fraction ``duty`` of each ``period_s`` cycle)
    arrivals run ``burst``× hotter; the off-phase rate is scaled down
    so the long-run average stays at ``rate``.

    Bit-identical to :func:`_bursty_trace_scalar`.  The phase walk is
    sequential by construction (each arrival's rate depends on the
    previous arrival time), so this draws the MT19937 word stream in
    numpy batches via :class:`~repro_torch.serve.rng.VecMT` and walks it
    with scalar pointer arithmetic instead of one ``random.Random``
    call per draw.
    """
    if not 0.0 < duty < 1.0:
        raise ValueError("duty must be in (0, 1)")
    if burst * duty >= 1.0 + duty:
        # keep the off-phase rate positive
        raise ValueError("burst too high for this duty cycle")
    on_rate = rate * burst
    off_rate = rate * (1.0 - burst * duty) / (1.0 - duty)
    span_p = max_prompt - min_prompt + 1
    span_g = max_new - min_new + 1
    sh_p = 32 - span_p.bit_length()
    sh_g = 32 - span_g.bit_length()
    mt = VecMT(seed)
    # walk the batch-generated stream as a plain int list — Python int
    # shifts beat numpy scalar indexing in a data-dependent loop
    words = mt.peek(8 * n + 4096).tolist()
    nw = len(words)
    inv53 = 1.0 / 9007199254740992.0
    log = math.log
    pos = 0
    t = 0.0
    out: List[Request] = []
    append = out.append
    for i in range(n):
        while True:
            phase = (t / period_s) % 1.0
            on = phase < duty
            if pos + 4 > nw:
                words = mt.peek(nw + max(4096, nw >> 1)).tolist()
                nw = len(words)
            u = ((words[pos] >> 5) * 67108864.0
                 + (words[pos + 1] >> 6)) * inv53
            dt = -log(1.0 - u) / (on_rate if on else off_rate)
            pos += 2
            edge = (duty if on else 1.0) * period_s - (t % period_s)
            # mirror the scalar loop's ulp guard: a degenerate edge
            # step (t + edge == t) cannot advance the clock
            if dt <= edge or edge <= 0 or t + edge == t:
                t += dt
                break
            t += edge
        while True:
            if pos >= nw:
                words = mt.peek(nw + max(4096, nw >> 1)).tolist()
                nw = len(words)
            v = words[pos] >> sh_p
            pos += 1
            if v < span_p:
                break
        p_len = min_prompt + v
        while True:
            if pos >= nw:
                words = mt.peek(nw + max(4096, nw >> 1)).tolist()
                nw = len(words)
            v = words[pos] >> sh_g
            pos += 1
            if v < span_g:
                break
        append(Request(rid=i, t_arrive=t, prompt_len=p_len,
                       gen_len=min_new + v))
    mt.consume(pos)
    return out


def save_trace(path: str, requests: Sequence[Request]) -> None:
    with open(path, "w") as f:
        json.dump([{"rid": r.rid, "t_arrive": r.t_arrive,
                    "prompt_len": r.prompt_len, "gen_len": r.gen_len}
                   for r in requests], f, indent=2)
        f.write("\n")


def load_trace(path: str) -> List[Request]:
    with open(path) as f:
        rows = json.load(f)
    return [Request(rid=int(r["rid"]), t_arrive=float(r["t_arrive"]),
                    prompt_len=int(r["prompt_len"]),
                    gen_len=int(r["gen_len"])) for r in rows]


# --------------------------------------------------------------------
# Simulator
# --------------------------------------------------------------------

class _Live:
    """A request in flight on the decode engine."""

    __slots__ = ("req", "rec", "t_ready", "kv_len", "emitted",
                 "kv_reserved")

    def __init__(self, req: Request, rec: RequestRecord,
                 t_ready: float, kv_reserved: int) -> None:
        self.req = req
        self.rec = rec
        self.t_ready = t_ready
        self.kv_len = req.prompt_len + 1  # prefill emitted token 1
        self.emitted = 1
        self.kv_reserved = kv_reserved


class ServeSim:
    """Replay an arrival trace against a compiled step-cost table.

    Two replay engines produce byte-identical metrics JSON (modulo the
    self-describing ``engine`` key):

    * ``engine="array"`` (default) — the array-batched engine in
      :mod:`repro_torch.serve.engine`: per-request timelines in preallocated
      numpy arrays, decode priced horizon-at-a-time with slice adds
      and ``cumsum`` clock chains.  Orders of magnitude faster on long
      traces; required for ``prefill_policy="batched"``/``"chunked"``.
    * ``engine="event"`` — the reference discrete-event loop below,
      one Python pass per decode iteration.  Kept as the semantic
      oracle the equivalence suite diffs the array engine against.

    ``prefill_policy`` picks how prompts reach the decode engine:
    ``fifo`` (batch-1 back-to-back, both engines), ``batched`` (FCFS
    batches up to ``prefill_max_batch``, priced with the table's
    prefill affine fit), or ``chunked`` (Sarathi-style chunked prefill
    co-scheduled into decode iterations under a ``chunk_tokens``
    budget).

    ``deadline_s``/``max_queue`` switch on degraded-mode machinery:

    * ``max_queue`` — admission control at the prefill engine.  A
      request arriving while ``max_queue`` requests already wait is
      *shed*; while it has retries left it re-arrives after an
      exponential backoff (``retry_backoff_s * 2**attempt``), keeping
      its original arrival time for latency accounting, otherwise it
      is dropped and counted in ``shed_requests``.
    * ``deadline_s`` — per-request SLO from the *original* arrival.  A
      request finishing late still completes (no mid-flight cancel —
      the engine already spent the cycles) but counts as a timeout and
      contributes nothing to goodput.

    With both unset (the default) every code path, record and metrics
    key is identical to the pre-degradation simulator.
    """

    def __init__(self, table: StepCostTable, policy: Batcher,
                 kv_capacity_bytes: Optional[int] = None,
                 kv_frac: float = 0.5,
                 deadline_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 max_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 engine: str = "array",
                 prefill_policy: str = "fifo",
                 prefill_max_batch: int = 8,
                 chunk_tokens: int = 32,
                 percentile_mode: str = "exact") -> None:
        self.table = table
        self.policy = policy
        if engine not in _ENGINES:
            raise ValueError(f"engine must be one of {_ENGINES}")
        if prefill_policy not in _PREFILL_POLICIES:
            raise ValueError(
                f"prefill_policy must be one of {_PREFILL_POLICIES}")
        if engine == "event" and prefill_policy != "fifo":
            raise ValueError(
                "the event engine only supports prefill_policy='fifo' "
                "— batched/chunked prefill need engine='array'")
        if max_queue is not None and prefill_policy != "fifo":
            raise ValueError(
                "max_queue admission control models the FIFO prefill "
                "queue; it composes with prefill_policy='fifo' only")
        if prefill_max_batch < 1:
            raise ValueError("prefill_max_batch must be >= 1")
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        if percentile_mode not in ("exact", "streaming"):
            raise ValueError("percentile_mode must be exact|streaming")
        self.engine = engine
        self.prefill_policy = prefill_policy
        self.prefill_max_batch = prefill_max_batch
        self.chunk_tokens = chunk_tokens
        self.percentile_mode = percentile_mode
        if kv_capacity_bytes is None:
            kv_capacity_bytes = int(
                table.chip.global_mem_bytes * kv_frac)
        one = table.cfg.kv_bytes(table.cfg.max_seq)
        if kv_capacity_bytes < one:
            raise ValueError(
                f"KV budget {kv_capacity_bytes}B cannot hold one "
                f"max-length request ({one}B)")
        self.kv_capacity_bytes = kv_capacity_bytes
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if max_queue is not None and max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if max_retries < 0 or retry_backoff_s < 0:
            raise ValueError("max_retries and retry_backoff_s must "
                             "be non-negative")
        self.deadline_s = deadline_s
        self.max_queue = max_queue
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s

    @property
    def degraded(self) -> bool:
        """True when any degradation feature is switched on."""
        return self.deadline_s is not None or self.max_queue is not None

    # -- prefill engine ----------------------------------------------

    def _run_prefill(self, requests: Sequence[Request]
                     ) -> List[Tuple[float, Request, RequestRecord]]:
        """FIFO prefill; returns (decode-ready time, req, record)."""
        free = 0.0
        out: List[Tuple[float, Request, RequestRecord]] = []
        for req in sorted(requests, key=lambda r: (r.t_arrive, r.rid)):
            start = max(free, req.t_arrive)
            end = start + self.table.prefill_s(req.prompt_len)
            free = end
            rec = RequestRecord(
                rid=req.rid, t_arrive=req.t_arrive,
                prompt_len=req.prompt_len, gen_len=req.gen_len,
                t_prefill_start=start, t_first_token=end,
                t_complete=end)
            out.append((end, req, rec))
        return out

    def _run_prefill_shedding(self, requests: Sequence[Request]
                              ) -> Tuple[
                                  List[Tuple[float, Request,
                                             RequestRecord]],
                                  int, int]:
        """FIFO prefill with queue-pressure admission control.

        Returns ``(ready, shed, retries)``.  A request whose (re-)
        arrival finds ``max_queue`` requests already waiting for the
        prefill engine is bounced: retried after backoff while
        attempts remain, shed for good otherwise.  Records keep the
        *original* arrival time, so retry delay shows up in TTFT/e2e
        exactly as a client would measure it.
        """
        cap = self.max_queue if self.max_queue is not None else None
        # (effective arrival, rid, attempt, request)
        pend = [(r.t_arrive, r.rid, 0, r) for r in requests]
        heapq.heapify(pend)
        free = 0.0
        starts: List[float] = []   # admitted-but-not-started, FIFO
        out: List[Tuple[float, Request, RequestRecord]] = []
        shed = 0
        retries = 0
        while pend:
            ta, _, attempt, req = heapq.heappop(pend)
            # drain the wait queue of everything that started by ta
            while starts and starts[0] <= ta:
                starts.pop(0)
            if cap is not None and len(starts) >= cap:
                if attempt < self.max_retries:
                    retries += 1
                    t_retry = ta + self.retry_backoff_s * (2 ** attempt)
                    heapq.heappush(
                        pend, (t_retry, req.rid, attempt + 1, req))
                else:
                    shed += 1
                continue
            start = max(free, ta)
            end = start + self.table.prefill_s(req.prompt_len)
            free = end
            if start > ta:
                starts.append(start)
            rec = RequestRecord(
                rid=req.rid, t_arrive=req.t_arrive,
                prompt_len=req.prompt_len, gen_len=req.gen_len,
                t_prefill_start=start, t_first_token=end,
                t_complete=end)
            out.append((end, req, rec))
        return out, shed, retries

    # -- decode engine -----------------------------------------------

    def run(self, requests: Sequence[Request],
            max_sim_s: Optional[float] = None) -> Dict[str, Any]:
        if self.engine == "array":
            return run_array(self, requests, max_sim_s)
        return self._run_event(requests, max_sim_s)

    def _run_event(self, requests: Sequence[Request],
                   max_sim_s: Optional[float] = None) -> Dict[str, Any]:
        if self.max_queue is not None:
            ready, shed, retries = self._run_prefill_shedding(requests)
        else:
            ready = self._run_prefill(requests)
            shed, retries = 0, 0
        records: List[RequestRecord] = [rec for _, _, rec in ready]
        if max_sim_s is not None and ready and \
                max(end for end, _, _ in ready) > max_sim_s:
            raise RuntimeError(self._overload_diag(ready, max_sim_s))

        # single-token requests never enter the decode engine
        heap: List[Tuple[float, int, Request, RequestRecord]] = []
        for end, req, rec in ready:
            if req.gen_len > 1:
                heapq.heappush(heap, (end, req.rid, req, rec))

        active: List[_Live] = []
        queue: List[_Live] = []
        kv_used = 0
        peak_kv = 0
        peak_batch = 0
        iterations = 0
        decode_busy = 0.0
        t = 0.0
        while heap or queue or active:
            # surface everything that has finished prefill by now
            while heap and heap[0][0] <= t:
                end, _, req, rec = heapq.heappop(heap)
                queue.append(_Live(
                    req, rec, end,
                    self.table.kv_bytes(req.prompt_len + req.gen_len)))
            if not active and not queue and heap:
                t = heap[0][0]
                continue

            admitted = self.policy.admit(
                active, queue, self.kv_capacity_bytes - kv_used)
            for live in admitted:
                queue.remove(live)
                kv_used += live.kv_reserved
                active.append(live)
            if not active:
                # queue blocked on KV/slots: wait for in-flight work,
                # or (static policy with empty engine) nothing can
                # block, so this only happens via the heap above
                if heap:
                    t = max(t, heap[0][0])
                    continue
                raise RuntimeError("deadlock: queued work cannot admit")

            dt = self.table.iteration_s([l.kv_len for l in active])
            t += dt
            decode_busy += dt
            iterations += 1
            if max_sim_s is not None and t > max_sim_s:
                raise RuntimeError(self._overload_diag(ready, max_sim_s,
                                                       t=t))
            peak_batch = max(peak_batch, len(active))
            peak_kv = max(peak_kv, kv_used)
            done: List[_Live] = []
            for live in active:
                live.kv_len += 1
                live.emitted += 1
                live.rec.t_complete = t
                if live.emitted >= live.req.gen_len:
                    done.append(live)
            for live in done:
                active.remove(live)
                kv_used -= live.kv_reserved

        extra = {
            "policy": self.policy.name,
            "max_batch": self.policy.max_batch,
            "fidelity": self.table.fidelity,
            "kv_capacity_bytes": self.kv_capacity_bytes,
            "kv_peak_bytes": peak_kv,
            "decode_iterations": iterations,
            "peak_decode_batch": peak_batch,
            "engine": "event",
            "prefill_policy": self.prefill_policy,
        }
        self._warn_if_saturated(records, decode_busy, t)
        if self.degraded:
            extra.update(self._degradation_extra(records, shed,
                                                 retries))
        return summarize(records, extra,
                         percentile_mode=self.percentile_mode)

    # -- degraded-mode accounting ------------------------------------

    def _degradation_extra(self, records: Sequence[RequestRecord],
                           shed: int, retries: int) -> Dict[str, Any]:
        """shed/timeout/retry counters and goodput (gated keys)."""
        timeouts = 0
        good_toks = 0
        for rec in records:
            late = (self.deadline_s is not None and
                    rec.t_complete - rec.t_arrive > self.deadline_s)
            if late:
                timeouts += 1
            else:
                good_toks += rec.gen_len
        if records:
            t0 = min(r.t_arrive for r in records)
            t1 = max(r.t_complete for r in records)
            makespan = max(t1 - t0, 1e-12)
        else:
            makespan = 0.0
        return {
            "shed_requests": shed,
            "retries": retries,
            "timeout_requests": timeouts,
            # tokens that arrived in time, per second — under overload
            # this drops below throughput_tok_s even as the engine
            # stays busy, which is the whole point of measuring it
            "goodput_tok_s": good_toks / makespan if makespan else 0.0,
        }

    # -- overload diagnostics ----------------------------------------

    def _utilization(self, records: Sequence[RequestRecord],
                     decode_busy: float,
                     t_end: float) -> Tuple[float, float]:
        """(prefill, decode) busy fractions over their active spans."""
        if not records:
            return 0.0, 0.0
        t0 = min(r.t_arrive for r in records)
        prefill_busy = sum(r.t_first_token - r.t_prefill_start
                           for r in records)
        prefill_span = max(r.t_first_token for r in records) - t0
        decode_span = t_end - t0
        u_pre = prefill_busy / prefill_span if prefill_span > 0 else 0.0
        u_dec = decode_busy / decode_span if decode_span > 0 else 0.0
        return u_pre, u_dec

    def _warn_if_saturated(self, records: Sequence[RequestRecord],
                           decode_busy: float, t_end: float) -> None:
        u_pre, u_dec = self._utilization(records, decode_busy, t_end)
        self._emit_saturation_warning(u_pre, u_dec)

    def _emit_saturation_warning(self, u_pre: float, u_dec: float,
                                 threshold: float = 0.95) -> None:
        """Shared by both engines so the warning text stays identical."""
        if max(u_pre, u_dec) < threshold:
            return
        stage = "prefill" if u_pre >= u_dec else "decode"
        warnings.warn(
            f"serving replay saturated: {stage} engine utilization "
            f"{max(u_pre, u_dec):.3f} (prefill {u_pre:.3f}, decode "
            f"{u_dec:.3f}) — offered load is at or beyond capacity, "
            f"so queueing delay grows with trace length and latency "
            f"percentiles reflect the trace, not the system; lower "
            f"the arrival rate or enable load shedding (max_queue=)",
            RuntimeWarning, stacklevel=4)

    def _overload_msg(self, t0: float, max_sim_s: float,
                      t: Optional[float] = None,
                      prefill_end: Optional[float] = None) -> str:
        """Shared by both engines so the diagnostic stays identical."""
        where = (f"decode clock reached {t:.3f}s" if t is not None
                 else f"prefill backlog extends past "
                      f"{prefill_end:.3f}s")
        return (f"serving replay exceeded max_sim_s={max_sim_s:g}s: "
                f"{where} for a trace starting at {t0:.3f}s — the "
                f"offered load exceeds sustainable capacity and the "
                f"replay would run (almost) unboundedly long; lower "
                f"the arrival rate, shrink the trace, enable load "
                f"shedding (max_queue=), or raise max_sim_s")

    def _overload_diag(self, ready: Sequence[Tuple[float, Request,
                                                   RequestRecord]],
                       max_sim_s: float,
                       t: Optional[float] = None) -> str:
        recs = [rec for _, _, rec in ready]
        t0 = min(r.t_arrive for r in recs) if recs else 0.0
        prefill_end = (max(e for e, _, _ in ready)
                       if t is None else None)
        return self._overload_msg(t0, max_sim_s, t=t,
                                  prefill_end=prefill_end)
