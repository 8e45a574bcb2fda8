"""The traced window: ``torch.profiler`` over the window, reduced to the
numbers the per-layer readers take.

The reduction reads the profiler's raw events once: the device's
kernel, copy and set intervals (their union is the busy time), each
linked to the innermost host op open at its launch, and that op placed
inside a named op (the port's autograd Functions) by containment on its
thread.  The
window is the harness's own ``perfbench.window`` annotation.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "perfbench.window"
STEP = "perfbench.step"
WAIT = "perfbench.wait"

# host ops that the readers attribute device time to (the port's
# autograd Functions, forward and backward)
NAMED_OPS = ("SSDChunkScan", "SSDChunkScanBackward", "RaggedDot",
             "RaggedDotBackward", "FlashAttention", "FlashAttentionBackward",
             "CausalConvSilu", "CausalConvSiluBackward", "GatedNorm",
             "GatedNormBackward", "CrossEntropy", "CrossEntropyBackward")
TOP = 10
NAME_CHARS = 96


@dataclass
class Reduced:
    """What the readers take from a traced window."""

    window_s: float = 0.0
    busy_s: float = 0.0
    device_events: int = 0
    op_device_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def start():
    """A started profiler of host and device activity (no shapes, no
    stacks)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False,
                   with_stack=False, profile_memory=False)
    prof.start()
    return prof


def stop(prof) -> Reduced:
    prof.stop()
    return reduce(prof.profiler.kineto_results.events())


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _short(name: str) -> str:
    name = " ".join(name.split())
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def reduce(events: Sequence) -> Reduced:
    """The window's busy time, device time under each named op, the
    device ops that took most time and the longest idle gaps, each gap
    named by the innermost host op of the main thread that spans it."""
    win: Optional[Tuple[int, int]] = None
    dev: List[Tuple[int, int, str, int]] = []
    op_at: Dict[int, Tuple[int, int]] = {}           # op id -> (tid, ts)
    named: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    host: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
    for e in events:
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if _is_device(e):
            # the device side of the harness's own annotations is no work
            if name.startswith("perfbench.") or "annotation" in str(
                    getattr(e, "activity_type", lambda: "")()):
                continue
            # linked to the innermost host op open at its launch
            dev.append((s, end, name, e.linked_correlation_id()))
            continue
        if e.linked_correlation_id() != 0:
            continue                     # a runtime call, not a host op
        tid = e.start_thread_id()
        if name == WINDOW:
            win = (s, end)
        op_at[e.correlation_id()] = (tid, s)
        host[tid].append((s, end, name))
        if name in NAMED_OPS:
            named[tid].append((s, end, name))
    out = Reduced()
    if win is None:
        return out
    w0, w1 = win
    out.window_s = (w1 - w0) * 1e-9
    clipped = [(max(s, w0), min(e, w1), n, c) for s, e, n, c in dev
               if e > w0 and s < w1]
    out.device_events = len(clipped)
    busy = _union([(s, e) for s, e, _, _ in clipped])
    out.busy_s = sum(e - s for s, e in busy) * 1e-9
    # device time by kernel name
    by_name: Dict[str, float] = defaultdict(float)
    for s, e, n, _ in clipped:
        by_name[_short(n)] += (e - s) * 1e-9
    out.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    # device time under each named op: the innermost one open on the
    # launching thread at the launch
    queries: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
    for s, e, _, corr in clipped:
        hit = op_at.get(corr)
        if hit is not None:
            queries[hit[0]].append((hit[1], e - s))
    op_s: Dict[str, float] = defaultdict(float)
    for tid, qs in queries.items():
        qs.sort()
        names = innermost(_nested(named.get(tid, [])), [t for t, _ in qs])
        for name, (_, d) in zip(names, qs):
            if name is not None:
                op_s[name] += d * 1e-9
    out.op_device_s = dict(op_s)
    out.idle_gaps = _gaps(busy, w0, w1, host)
    return out


def _nested(ops: List[Tuple[int, int, str]]) -> List[Tuple[int, int, str]]:
    """``ops`` by start, an op before the ops it holds."""
    return sorted(ops, key=lambda o: (o[0], -o[1]))


def innermost(ops: List[Tuple[int, int, str]], queries: List[int]
              ) -> List[Optional[str]]:
    """For each time of ``queries`` (sorted), the name of the innermost
    op of ``ops`` (nested intervals of one thread, sorted by start) open
    at that time, or ``None``."""
    out: List[Optional[str]] = []
    stack: List[Tuple[int, int, str]] = []
    i = 0
    for q in queries:
        while i < len(ops) and ops[i][0] <= q:
            while stack and stack[-1][1] < ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def _gaps(busy, w0: int, w1: int, host) -> List[Tuple[str, float]]:
    """The window's idle stretches, summed by the host op (innermost, on
    the thread that holds the window annotation) running at each one's
    start."""
    gaps = []
    t = w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    main = next((tid for tid, v in host.items()
                 if any(n == WINDOW for _, _, n in v)), None)
    names = innermost(_nested(host.get(main, [])), [s for s, _ in gaps])
    by: Dict[str, float] = defaultdict(float)
    for name, (s, e) in zip(names, gaps):
        by[_short(name or "idle")] += (e - s) * 1e-9
    return sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
