"""Array-batched serving replay engine.

The reference simulator (``ServeSim._run_event``) advances one decode
iteration per Python loop pass — ~4 µs of interpreter work per
iteration, which caps replay at a few hundred thousand iterations per
second and makes million-request traces impractical.  This module
replays the *same* simulation as masked/sliced numpy array operations,
byte-identical metrics JSON included, by exploiting two structural
facts about the event loop:

* **Backlog horizons (regime A).**  While the decode queue is
  non-empty, admission is strict FCFS from the queue *head*, so
  arrivals joining the tail cannot change any scheduling decision
  until the current queue would drain.  Everything that happens over
  such a horizon — admissions, completions, KV occupancy — is a pure
  integer event structure (a member admitted with ``kv0`` at iteration
  ``a`` runs ``gen_len - 1`` iterations, its KV growing by one each),
  simulated in Python with *no float work*, then priced in one shot:
  per-member ``per_seq`` slice-adds into a horizon cost array (in
  admission order — replaying ``sum()``'s left fold bit-for-bit),
  per-segment ``base`` slice assignments (the batch-max KV grows by
  exactly one per iteration between admission/completion events), and
  a seeded ``np.cumsum`` for the clock chain (``cumsum`` *is* the
  sequential left fold, unlike pairwise ``np.sum``).

* **Arrival-coupled runs (regime B).**  With an empty queue the active
  batch is fixed until the next completion or until a new arrival
  becomes visible.  The next completion is an integer; the arrival cut
  is found by ``searchsorted``-ing the arrival time into the priced
  boundary-clock array.  A cut is only needed when the policy could
  actually admit (continuous batching with free slots) — otherwise a
  mid-segment pop is unobservable and the segment runs to the next
  completion.

Request timelines land in preallocated SoA arrays (no
:class:`RequestRecord` objects, no per-token timestamp lists) and are
aggregated by :func:`repro_torch.serve.metrics.summarize_soa`.

Prefill policies on top of the array engine:

* ``fifo`` — batch-1 back-to-back prompts, byte-identical to the
  event engine (the ``max(free, arrive) + cost`` recurrence is a
  sequential float chain, so it stays a scalar loop over vectorized
  gathered costs);
* ``batched`` — work-conserving FCFS batches of up to
  ``prefill_max_batch`` prompts arrived by batch-formation time,
  priced with the table's prefill affine fit
  (``base + per_seq × batch``);
* ``chunked`` — Sarathi-style chunked prefill: no separate prefill
  engine at all; prompt chunks are co-scheduled into decode iterations
  under a ``chunk_tokens`` token budget (decode members cost one token
  each, the remainder goes to prompt chunks FCFS head-first), with the
  KV footprint and a decode slot reserved at first-chunk admission.
  Chunk pricing amortises the bucketed batch-1 prefill cost per
  *actual* token (``prefill_s(bucket)/bucket``), so mid-bucket prompts
  do not pay the bucket padding the batch-1 path pays.
"""
from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bucketing import bucket_for
from .metrics import summarize_soa
from .policy import StaticBatcher

__all__ = ["run_array"]


class _AMem:
    """Decode-batch member in the array engine (integer state only)."""

    __slots__ = ("idx", "kv_len", "rem", "kv_reserved", "a", "c", "off")

    def __init__(self, idx: int, kv_len: int, rem: int,
                 kv_reserved: int) -> None:
        self.idx = idx                # row in the SoA timeline arrays
        self.kv_len = kv_len          # KV tokens at next iteration
        self.rem = rem                # decode iterations left
        self.kv_reserved = kv_reserved
        self.a = 0                    # horizon-local admission boundary
        self.c = 0                    # horizon-local completion boundary
        self.off = 0                  # kv_len - a (kv at iter j = off+j)


class _SoA:
    """Per-request timeline arrays, in record (prefill) order."""

    __slots__ = ("rid", "t_arrive", "prompt_len", "gen_len",
                 "t_prefill_start", "t_first", "t_complete")

    def __init__(self, n: int) -> None:
        self.rid = np.zeros(n, dtype=np.int64)
        self.t_arrive = np.zeros(n, dtype=np.float64)
        self.prompt_len = np.zeros(n, dtype=np.int64)
        self.gen_len = np.zeros(n, dtype=np.int64)
        self.t_prefill_start = np.zeros(n, dtype=np.float64)
        self.t_first = np.zeros(n, dtype=np.float64)
        self.t_complete = np.zeros(n, dtype=np.float64)


def _sorted_trace(requests: Sequence[Any]
                  ) -> Tuple[List[int], List[float], List[int], List[int]]:
    reqs = sorted(requests, key=lambda r: (r.t_arrive, r.rid))
    return ([r.rid for r in reqs], [r.t_arrive for r in reqs],
            [r.prompt_len for r in reqs], [r.gen_len for r in reqs])


# --------------------------------------------------------------------
# Prefill drivers
# --------------------------------------------------------------------

def _prefill_fifo(sim, rid, ta, plen, glen) -> _SoA:
    """Batch-1 FIFO prefill — the ``max(free, arrive) + cost`` chain is
    sequential in float, so it stays a scalar loop; the cost lookups
    are one vectorized gather."""
    n = len(rid)
    soa = _SoA(n)
    soa.rid[:] = rid
    soa.t_arrive[:] = ta
    soa.prompt_len[:] = plen
    soa.gen_len[:] = glen
    c1, _, _ = sim.table.dense_prefill()
    costs = c1[np.asarray(plen, dtype=np.int64)].tolist()
    starts = soa.t_prefill_start
    ends = soa.t_first
    free = 0.0
    for i in range(n):
        start = free if free > ta[i] else ta[i]
        end = start + costs[i]
        starts[i] = start
        ends[i] = end
        free = end
    soa.t_complete[:] = soa.t_first
    return soa


def _prefill_batched(sim, rid, ta, plen, glen) -> _SoA:
    """Work-conserving FCFS batched prefill: a batch forms at
    ``start = max(free, head arrival)`` from up to ``prefill_max_batch``
    requests already arrived by ``start``, priced with the affine
    prefill fit."""
    n = len(rid)
    soa = _SoA(n)
    soa.rid[:] = rid
    soa.t_arrive[:] = ta
    soa.prompt_len[:] = plen
    soa.gen_len[:] = glen
    _, base_d, per_d = sim.table.dense_prefill()
    bases = base_d[np.asarray(plen, dtype=np.int64)].tolist()
    pers = per_d[np.asarray(plen, dtype=np.int64)].tolist()
    cap = sim.prefill_max_batch
    starts = soa.t_prefill_start
    ends = soa.t_first
    free = 0.0
    i = 0
    while i < n:
        start = max(free, ta[i])
        j = i + 1
        while j < n and j - i < cap and ta[j] <= start:
            j += 1
        # base of the largest prompt bucket + per-seq of every member
        mx = i
        s = 0.0
        for k in range(i, j):
            if plen[k] > plen[mx]:
                mx = k
            s += pers[k]
        end = start + (bases[mx] + s)
        for k in range(i, j):
            starts[k] = start
            ends[k] = end
        free = end
        i = j
    soa.t_complete[:] = soa.t_first
    return soa


def _prefill_shedding(sim, rid, ta, plen, glen
                      ) -> Tuple[_SoA, int, int]:
    """FIFO prefill with queue-pressure admission control — mirrors
    ``ServeSim._run_prefill_shedding`` float-op for float-op, writing
    SoA rows in admission order."""
    cap = sim.max_queue
    c1, _, _ = sim.table.dense_prefill()
    costs = c1[np.asarray(plen, dtype=np.int64)].tolist()
    pend = [(ta[i], rid[i], 0, i) for i in range(len(rid))]
    heapq.heapify(pend)
    free = 0.0
    starts_q: List[float] = []
    rows: List[Tuple[int, float, float]] = []  # (trace idx, start, end)
    shed = 0
    retries = 0
    while pend:
        eff_ta, _, attempt, i = heapq.heappop(pend)
        while starts_q and starts_q[0] <= eff_ta:
            starts_q.pop(0)
        if cap is not None and len(starts_q) >= cap:
            if attempt < sim.max_retries:
                retries += 1
                t_retry = eff_ta + sim.retry_backoff_s * (2 ** attempt)
                heapq.heappush(pend, (t_retry, rid[i], attempt + 1, i))
            else:
                shed += 1
            continue
        start = max(free, eff_ta)
        end = start + costs[i]
        free = end
        if start > eff_ta:
            starts_q.append(start)
        rows.append((i, start, end))
    soa = _SoA(len(rows))
    for r, (i, start, end) in enumerate(rows):
        soa.rid[r] = rid[i]
        soa.t_arrive[r] = ta[i]
        soa.prompt_len[r] = plen[i]
        soa.gen_len[r] = glen[i]
        soa.t_prefill_start[r] = start
        soa.t_first[r] = end
        soa.t_complete[r] = end
    return soa, shed, retries


# --------------------------------------------------------------------
# Array decode engine
# --------------------------------------------------------------------

class _Decode:
    """Array decode replay over a prefill-ready SoA timeline."""

    def __init__(self, sim, soa: _SoA,
                 max_sim_s: Optional[float]) -> None:
        self.sim = sim
        self.soa = soa
        self.max_sim_s = max_sim_s
        self.base_d, self.per_d = sim.table.dense_decode()
        # decode candidates: gen_len > 1, ordered like the event heap
        # pops — (prefill end, rid) lexicographic
        gl = soa.gen_len
        cand = np.flatnonzero(gl > 1)
        order = np.lexsort((soa.rid[cand], soa.t_first[cand]))
        self.cand = cand[order]
        self.ends = soa.t_first[self.cand].tolist()
        self.ptr = 0
        self.queue: List[_AMem] = []
        self.active: List[_AMem] = []
        self.kv_used = 0
        self.t = 0.0
        self.busy = 0.0
        self.iterations = 0
        self.peak_kv = 0
        self.peak_batch = 0
        self._static = isinstance(sim.policy, StaticBatcher)

    # -- shared helpers -----------------------------------------------

    def _mem(self, ci: int) -> _AMem:
        i = int(self.cand[ci])
        p = int(self.soa.prompt_len[i])
        g = int(self.soa.gen_len[i])
        return _AMem(i, p + 1, g - 1,
                     self.sim.table.kv_bytes(p + g))

    def _pops(self) -> None:
        while self.ptr < len(self.ends) and \
                self.ends[self.ptr] <= self.t:
            self.queue.append(self._mem(self.ptr))
            self.ptr += 1

    def _raise_overload(self, t_cross: float) -> None:
        raise RuntimeError(self.sim._overload_msg(
            float(np.min(self.soa.t_arrive)) if len(self.soa.rid)
            else 0.0, self.max_sim_s, t=t_cross))

    def _chain(self, dts: np.ndarray, j: int) -> np.ndarray:
        """Boundary clock: seeded cumsum == the event loop's chained
        ``t += dt`` fold.  Returns boundaries [0..len(dts)]; also
        advances ``t``/``busy``/``iterations`` through boundary j."""
        t_bound = np.cumsum(np.concatenate(([self.t], dts)))
        busy_bound = np.cumsum(np.concatenate(([self.busy], dts)))
        self.t = float(t_bound[j])
        self.busy = float(busy_bound[j])
        self.iterations += j
        if self.max_sim_s is not None and self.t > self.max_sim_s:
            cross = int(np.argmax(t_bound[:j + 1] > self.max_sim_s))
            self._raise_overload(float(t_bound[cross]))
        return t_bound

    # -- regime A: backlog horizon ------------------------------------

    def _horizon(self) -> None:
        """Queue non-empty: simulate the integer event structure until
        the initial queue would drain, then price in one shot."""
        sim = self.sim
        adds: List[_AMem] = []
        for m in self.active:              # already-running members
            m.a = 0
            m.c = m.rem
            m.off = m.kv_len
            adds.append(m)
        segs: List[Tuple[int, int, int, int, int]] = []
        compl: List[Tuple[int, _AMem]] = []
        i = 0
        while True:
            done = [m for m in self.active if m.c == i]
            for m in done:
                self.active.remove(m)
                self.kv_used -= m.kv_reserved
                compl.append((i, m))
            if not self.queue:
                break
            admitted = sim.policy.admit(
                self.active, self.queue,
                sim.kv_capacity_bytes - self.kv_used)
            if i > 0 and len(admitted) == len(self.queue):
                # the take ran off the end of the *known* queue — at a
                # future boundary, tail arrivals could extend it, so
                # roll back and reprocess with full information
                break
            for m in admitted:
                self.queue.remove(m)
                self.kv_used += m.kv_reserved
                m.a = i
                m.c = i + m.rem
                m.off = m.kv_len - i
                self.active.append(m)
                adds.append(m)
            if not self.queue:
                break
            if not self.active:
                raise RuntimeError(
                    "deadlock: queued work cannot admit")
            e = min(m.c for m in self.active)
            segs.append((i, e, max(m.off for m in self.active),
                         len(self.active), self.kv_used))
            i = e
        L = i
        if L == 0:
            return                         # regime B prices this boundary
        # price the horizon
        S = np.zeros(L, dtype=np.float64)
        for m in adds:                     # admission order == fold order
            hi = m.c if m.c < L else L
            kv0 = m.off + m.a
            S[m.a:hi] += self.per_d[kv0:kv0 + (hi - m.a)]
        B = np.empty(L, dtype=np.float64)
        for s, e, M, nb, kv in segs:
            B[s:e] = self.base_d[M + s:M + e]
            if nb > self.peak_batch:
                self.peak_batch = nb
            if kv > self.peak_kv:
                self.peak_kv = kv
        t_bound = self._chain(B + S, L)
        if compl:
            idxs = np.array([m.idx for _, m in compl], dtype=np.int64)
            bidx = np.array([b for b, _ in compl], dtype=np.int64)
            self.soa.t_complete[idxs] = t_bound[bidx]
        for m in self.active:              # survivors carry into next
            m.kv_len = m.off + L
            m.rem = m.c - L

    # -- regime B: arrival-coupled run --------------------------------

    def _segment(self) -> None:
        """Queue empty, batch active: run to the next completion, or
        cut at the first boundary where a new arrival becomes visible
        (only when the policy could actually admit it)."""
        sim = self.sim
        e = min(m.rem for m in self.active)
        S = np.zeros(e, dtype=np.float64)
        for m in self.active:
            S[0:e] += self.per_d[m.kv_len:m.kv_len + e]
        M = max(m.kv_len for m in self.active)
        dts = self.base_d[M:M + e] + S
        t_bound = np.cumsum(np.concatenate(([self.t], dts)))
        j = e
        cut = (not self._static
               and len(self.active) < sim.policy.max_batch)
        if cut and self.ptr < len(self.ends):
            nxt = self.ends[self.ptr]
            j = int(np.searchsorted(t_bound, nxt, side="left"))
            if j > e:
                j = e
        busy_bound = np.cumsum(np.concatenate(([self.busy], dts)))
        self.t = float(t_bound[j])
        self.busy = float(busy_bound[j])
        self.iterations += j
        if self.max_sim_s is not None and self.t > self.max_sim_s:
            cross = int(np.argmax(t_bound[:j + 1] > self.max_sim_s))
            self._raise_overload(float(t_bound[cross]))
        if len(self.active) > self.peak_batch:
            self.peak_batch = len(self.active)
        if self.kv_used > self.peak_kv:
            self.peak_kv = self.kv_used
        for m in self.active:
            m.kv_len += j
            m.rem -= j
        if j == e:
            done = [m for m in self.active if m.rem == 0]
            for m in done:
                self.active.remove(m)
                self.kv_used -= m.kv_reserved
                self.soa.t_complete[m.idx] = self.t

    # -- main loop ----------------------------------------------------

    def run(self) -> None:
        if self.max_sim_s is not None and len(self.soa.rid) and \
                float(np.max(self.soa.t_first)) > self.max_sim_s:
            # prefill backlog alone exceeds the cap — match the event
            # engine's early diagnostic
            raise RuntimeError(self.sim._overload_msg(
                float(np.min(self.soa.t_arrive)), self.max_sim_s,
                prefill_end=float(np.max(self.soa.t_first))))
        while self.ptr < len(self.ends) or self.queue or self.active:
            self._pops()
            if not self.active and not self.queue:
                self.t = self.ends[self.ptr]
                continue
            if self.queue:
                self._horizon()
            else:
                self._segment()


def _chunked_decode(sim, rid, ta, plen, glen,
                    max_sim_s: Optional[float]
                    ) -> Tuple[_SoA, Dict[str, int], float, float]:
    """Chunked-prefill interleaving on the decode engine.

    Scalar by necessity (the per-iteration token-budget split is data
    dependent); chunked mode trades replay speed for modeled latency,
    not the other way round.
    """
    n = len(rid)
    soa = _SoA(n)
    soa.rid[:] = rid
    soa.t_arrive[:] = ta
    soa.prompt_len[:] = plen
    soa.gen_len[:] = glen
    table = sim.table
    base_d, per_d = table.dense_decode()
    base_l = base_d.tolist()
    per_l = per_d.tolist()
    c1, _, _ = table.dense_prefill()
    pb = table.prefill_buckets
    # per-token prefill rate: bucketed batch-1 cost amortised over the
    # *bucket* — chunked kernels run exact token counts, so a chunk of
    # k tokens costs k × s(bucket)/bucket (no bucket padding)
    rate = [c1[p] / bucket_for(p, pb) if p > 0 else 0.0
            for p in range(len(c1))]
    budget = sim.chunk_tokens
    max_batch = sim.policy.max_batch
    kv_cap = sim.kv_capacity_bytes

    # prefill queue entries: [trace idx, tokens left, started flag]
    pq: List[List[int]] = []
    active: List[_AMem] = []
    started = 0
    ptr = 0
    kv_used = 0
    t = 0.0
    busy = 0.0
    iterations = 0
    peak_kv = 0
    peak_batch = 0
    while ptr < n or pq or active:
        while ptr < n and ta[ptr] <= t:
            pq.append([ptr, plen[ptr], 0])
            ptr += 1
        if not pq and not active:
            t = ta[ptr]
            continue
        # split the token budget: decode members first, remainder to
        # prompt chunks FCFS head-first
        left = budget - len(active)
        chunks: List[Tuple[List[int], int]] = []
        for entry in pq:
            if left <= 0:
                break
            if not entry[2]:
                i = entry[0]
                reserve = table.kv_bytes(plen[i] + glen[i])
                if len(active) + started >= max_batch or \
                        kv_used + reserve > kv_cap:
                    break              # strict FCFS: no queue jumping
                entry[2] = 1
                started += 1
                kv_used += reserve
                if kv_used > peak_kv:
                    peak_kv = kv_used
                soa.t_prefill_start[i] = t
            k = entry[1] if entry[1] < left else left
            left -= k
            chunks.append((entry, k))
        if not chunks and not active:
            raise RuntimeError("deadlock: queued work cannot admit")
        dt = 0.0
        if active:
            mx = 0
            s = 0.0
            for m in active:
                if m.kv_len > mx:
                    mx = m.kv_len
                s += per_l[m.kv_len]
            dt = base_l[mx] + s
        for entry, k in chunks:
            dt += k * rate[plen[entry[0]]]
        t += dt
        busy += dt
        iterations += 1
        if max_sim_s is not None and t > max_sim_s:
            raise RuntimeError(sim._overload_msg(
                float(np.min(soa.t_arrive)) if n else 0.0,
                max_sim_s, t=t))
        if len(active) > peak_batch:
            peak_batch = len(active)
        if kv_used > peak_kv:
            peak_kv = kv_used
        done = []
        for m in active:
            m.kv_len += 1
            m.rem -= 1
            if m.rem == 0:
                done.append(m)
        for m in done:
            active.remove(m)
            kv_used -= m.kv_reserved
            soa.t_complete[m.idx] = t
        for entry, k in chunks:
            entry[1] -= k
            if entry[1] == 0:
                i = entry[0]
                pq.remove(entry)
                started -= 1
                soa.t_first[i] = t     # last chunk emits first token
                soa.t_complete[i] = t
                if glen[i] > 1:
                    m = _AMem(i, plen[i] + 1, glen[i] - 1,
                              table.kv_bytes(plen[i] + glen[i]))
                    active.append(m)   # decodes from next iteration
                else:
                    kv_used -= table.kv_bytes(plen[i] + glen[i])
    stats = {"kv_peak_bytes": peak_kv, "decode_iterations": iterations,
             "peak_decode_batch": peak_batch}
    return soa, stats, busy, t


# --------------------------------------------------------------------
# Entry point
# --------------------------------------------------------------------

def run_array(sim, requests: Sequence[Any],
              max_sim_s: Optional[float] = None) -> Dict[str, Any]:
    """Replay ``requests`` on the array engine; returns the same
    metrics dict as the event engine (byte-identical JSON for
    ``prefill_policy="fifo"``)."""
    rid, ta, plen, glen = _sorted_trace(requests)
    shed = 0
    retries = 0
    if sim.max_queue is not None:
        soa, shed, retries = _prefill_shedding(sim, rid, ta, plen, glen)
    elif sim.prefill_policy == "batched":
        soa = _prefill_batched(sim, rid, ta, plen, glen)
    elif sim.prefill_policy == "chunked":
        soa, stats, busy, t_end = _chunked_decode(
            sim, rid, ta, plen, glen, max_sim_s)
        return _finish(sim, soa, stats, busy, t_end, shed, retries)
    else:
        soa = _prefill_fifo(sim, rid, ta, plen, glen)
    dec = _Decode(sim, soa, max_sim_s)
    dec.run()
    stats = {"kv_peak_bytes": dec.peak_kv,
             "decode_iterations": dec.iterations,
             "peak_decode_batch": dec.peak_batch}
    return _finish(sim, soa, stats, dec.busy, dec.t, shed, retries)


def _finish(sim, soa: _SoA, stats: Dict[str, int], busy: float,
            t_end: float, shed: int, retries: int) -> Dict[str, Any]:
    extra = {
        "policy": sim.policy.name,
        "max_batch": sim.policy.max_batch,
        "fidelity": sim.table.fidelity,
        "kv_capacity_bytes": sim.kv_capacity_bytes,
        "kv_peak_bytes": stats["kv_peak_bytes"],
        "decode_iterations": stats["decode_iterations"],
        "peak_decode_batch": stats["peak_decode_batch"],
        "engine": "array",
        "prefill_policy": sim.prefill_policy,
    }
    _warn_if_saturated_soa(sim, soa, busy, t_end)
    if sim.degraded:
        extra.update(_degradation_extra_soa(sim, soa, shed, retries))
    return summarize_soa(soa.t_arrive, soa.gen_len, soa.t_first,
                         soa.t_complete, extra,
                         percentile_mode=sim.percentile_mode)


def _warn_if_saturated_soa(sim, soa: _SoA, decode_busy: float,
                           t_end: float) -> None:
    """``t_end`` is the final *decode clock* (0.0 when nothing ever
    decoded) — the event engine's utilization span, not
    ``max(t_complete)``."""
    n = len(soa.rid)
    if n == 0:
        return
    t0 = float(np.min(soa.t_arrive))
    # left-fold sum (cumsum) to match the event path bit-for-bit
    prefill_busy = float(
        np.cumsum(soa.t_first - soa.t_prefill_start)[-1])
    prefill_span = float(np.max(soa.t_first)) - t0
    decode_span = t_end - t0
    u_pre = prefill_busy / prefill_span if prefill_span > 0 else 0.0
    u_dec = decode_busy / decode_span if decode_span > 0 else 0.0
    sim._emit_saturation_warning(u_pre, u_dec)


def _degradation_extra_soa(sim, soa: _SoA, shed: int,
                           retries: int) -> Dict[str, Any]:
    n = len(soa.rid)
    e2e = soa.t_complete - soa.t_arrive
    if sim.deadline_s is not None:
        late = e2e > sim.deadline_s
        timeouts = int(np.sum(late))
        good_toks = int(np.sum(soa.gen_len[~late]))
    else:
        timeouts = 0
        good_toks = int(np.sum(soa.gen_len))
    if n:
        makespan = max(float(np.max(soa.t_complete))
                       - float(np.min(soa.t_arrive)), 1e-12)
    else:
        makespan = 0.0
    return {
        "shed_requests": shed,
        "retries": retries,
        "timeout_requests": timeouts,
        "goodput_tok_s": good_toks / makespan if makespan else 0.0,
    }
