"""The timed windows and their checks, one driver a traffic kind.

A driver builds the program's step and its inputs from the seed
(set-up), warms the shapes of its mix, runs the window for the given
seconds, and then, with the program's state freed, holds what the
window produced against the plain reference.  ``fault`` plants one of
:data:`FAULTS` in the program's step, for the tests and the limits'
upper readings.
"""

from __future__ import annotations

import gc
import math
import random
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

from .. import reference
from ..reference import train as ref_train
from ..reference.common import Arith, fp32_exact, param_names
from . import program, trace, traffic, weights
from .spec import Cell

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

FAULTS = {
    "train": ("stale_state", "half_batch", "doubled_update"),
    "prefill": ("half_batch", "altered_token", "altered_row"),
}


@dataclass
class Outcome:
    """What a run measured and what its check read."""

    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    tokens: int = 0
    calls: List[Tuple[int, int]] = field(default_factory=list)
    latencies_s: List[float] = field(default_factory=list)
    enqueue_s: List[float] = field(default_factory=list)
    memory_peak: int = 0
    reduced: Optional[trace.Reduced] = None
    readings: Dict[str, float] = field(default_factory=dict)
    per_request: Dict[str, List[float]] = field(default_factory=dict)
    notes: Dict[str, Any] = field(default_factory=dict)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


class _Window:
    """The measured window: the annotation the trace reads, the
    profiler when tracing, and its host-clock bounds."""

    def __init__(self, tracing: bool, device) -> None:
        self.tracing, self.device = tracing, device
        self.prof = None
        self.reduced: Optional[trace.Reduced] = None

    def __enter__(self):
        _sync(self.device)
        _peak_reset(self.device)
        if self.tracing:
            self.prof = trace.start()
        self.mark = record_function(trace.WINDOW)
        self.mark.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync(self.device)
        self.t1 = time.perf_counter()
        self.mark.__exit__(*exc)
        if self.prof is not None:
            self.reduced = trace.stop(self.prof)
        return False


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _plant_train(step: Callable, fault: Optional[str], params_of) -> Callable:
    if fault is None:
        return step
    if fault not in FAULTS["train"]:
        raise ValueError(f"no training fault {fault!r}")

    def planted(params, opt, batch, i):
        tok = batch["tokens"]
        if fault == "half_batch":
            return step(params, opt, {"tokens": tok[:tok.shape[0] // 2]}, i)
        # stale_state: every leaf put back; doubled_update: the first
        # leaf's update written twice
        leaves = params_of(params)
        kept = [t.detach().clone() for t in
                (leaves if fault == "stale_state" else leaves[:1])]
        params, opt, met = step(params, opt, batch, i)
        with torch.no_grad():
            for t, k in zip(params_of(params), kept):
                if fault == "stale_state":
                    t.copy_(k)
                else:
                    t.add_(t - k)
        return params, opt, met

    return planted


def train(cell: Cell, seed: int, seconds: float, tracing: bool, device,
          t0: float, fault: Optional[str] = None,
          control: bool = False) -> Outcome:
    mix, cfg = cell.traffic, cell.config
    m = cfg["model"]
    ref = reference.module(cfg["reference"])
    opt_cfg = mix["optimizer"]
    b, s = traffic.shapes(mix)[0]
    k = int(mix["check_steps"])
    out = Outcome()

    a = program.arch(cfg)
    specs = ref.param_specs(m)
    names = param_names(specs)
    dtype = _DTYPES[cfg["dtypes"]["train"]["params"]]
    flat = weights.make(specs, seed, device, dtype)
    params = program.train_tree(weights.tree(flat))
    step, init_opt = program.train_step(a, device, b, s, opt_cfg)
    opt = init_opt(params)
    step = _plant_train(step, fault, program.leaves)
    pool = traffic.token_pool(mix, seed, m["vocab"], device)

    def batch(i: int) -> Dict[str, torch.Tensor]:
        return {"tokens": pool[i % pool.shape[0]].view(b, s)}

    # set-up: the first k steps through the window's own call, read for
    # the check (the first clipped gradient from the first moment, the
    # change over the k steps before step k + 1 moves it)
    where = {p.data_ptr(): i for i, p in enumerate(program.leaves(params))}
    at = [where[flat[n].data_ptr()] for n in names]
    start = {n: flat[n].detach().clone() for n in names}
    losses = []
    grad1 = None
    for i in range(k):
        params, opt, met = step(params, opt, batch(i), i)
        losses.append(met["loss"])
        if i == 0:
            mom = program.leaves(opt["m"])
            grad1 = torch.stack([torch.linalg.vector_norm(
                mom[j].to(torch.float32)) for j in at]) / (1 - opt_cfg["b1"])
    change = torch.stack([torch.linalg.vector_norm(
        flat[n].to(torch.float32) - start[n].to(torch.float32))
        for n in names])
    del start
    prog = {"loss": [float(x) for x in losses],
            "grad1": dict(zip(names, grad1.tolist())),
            "change": dict(zip(names, change.tolist()))}
    _sync(device)
    out.setup_s = time.perf_counter() - t0

    losses_w = []
    i = k
    with _Window(tracing, device) as w:
        deadline = w.t0 + seconds
        while True:
            with record_function(trace.STEP):
                params, opt, met = step(params, opt, batch(i), i)
            losses_w.append(met["loss"])
            i += 1
            if time.perf_counter() >= deadline:
                break
    out.window_s = w.t1 - w.t0
    out.reduced = w.reduced
    out.memory_peak = _peak(device)
    out.attempted = len(losses_w)
    out.failed = int(sum(not math.isfinite(float(x)) for x in losses_w))
    out.calls = [(b, s)] * out.attempted
    out.tokens = out.attempted * b * s
    out.notes["routes"] = program.counters()

    # the check: the program's state freed, the reference from the seed
    batches = [batch(j)["tokens"].clone() for j in range(k)]
    del params, opt, met, step, losses_w, flat, pool
    _free()
    fp32_exact()
    W = weights.make(specs, seed, device, torch.float32)
    got = ref_train.steps(ref, m, W, batches, opt_cfg, Arith(fp8=control),
                          rows=int(mix["reference_rows"]))
    if control:
        # the control in the program's place, held to the reference
        prog = got
        got = ref_train.steps(ref, m, W, batches, opt_cfg, Arith(),
                              rows=int(mix["reference_rows"]))
    out.readings = train_readings(prog, got)
    out.notes["worst_leaves"] = worst_leaves(prog, got)
    return out


def worst_leaves(prog: Dict, ref: Dict, n: int = 3) -> Dict[str, list]:
    """The leaves with the largest gaps of the two norms, with both."""
    out = {}
    for key in ("grad1", "change"):
        med = statistics.median(ref[key].values())
        rows = sorted(((abs(prog[key][k] - v) / max(v, med), k,
                        prog[key][k], v) for k, v in ref[key].items()),
                      reverse=True)[:n]
        out[key] = [[k, a, r] for _, k, a, r in rows]
    return out


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``loss_gap``: the largest gap of a step's loss against the
    reference's, as a share of it; ``grad1_gap`` and ``change_gap``: the
    worst leaf's gap between the norms of the first clipped gradient, and
    of the parameters' change over the checked steps, as a share of the
    reference's norm of that leaf or of the median leaf, the larger.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of the change (round-off moves them under
    Adam)."""
    loss = max(abs(a - r) / abs(r) for a, r in zip(prog["loss"],
                                                   ref["loss"]))
    g_ref = ref["grad1"]
    g_med = statistics.median(g_ref.values())
    c_med = statistics.median(ref["change"].values())
    grad = max(abs(prog["grad1"][n] - g) / max(g, g_med)
               for n, g in g_ref.items())
    change = max(abs(prog["change"][n] - c) / max(c, c_med)
                 for n, c in ref["change"].items()
                 if g_ref[n] >= 1e-3 * g_med)
    return {"loss_gap": loss, "grad1_gap": grad, "change_gap": change}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _plant_prefill(step: Callable, fault: Optional[str],
                   vocab: int) -> Callable:
    if fault is None:
        return step
    if fault not in FAULTS["prefill"]:
        raise ValueError(f"no prefill fault {fault!r}")

    def planted(params, batch):
        tok = batch["tokens"]
        if fault in ("altered_token", "altered_row"):
            # every row's last token altered, or the first row's alone
            rows = tok.shape[0] if fault == "altered_token" else 1
            alt = tok.clone()
            alt[:rows, -1] = (alt[:rows, -1] + 1) % vocab
            return step(params, {"tokens": alt})
        half = step(params, {"tokens": tok[:tok.shape[0] // 2]})
        return torch.cat([half, half])[:tok.shape[0]]

    return planted


def _sample(done: List[traffic.Call], seed: int, n: int
            ) -> List[Tuple[int, int]]:
    """``n`` requests ``(call, row)`` of the finished calls, drawn from
    the seed, with one of the longest among them."""
    reqs = [(ci, r) for ci, c in enumerate(done) for r in range(c.batch)]
    rng = random.Random(traffic.data_seed(seed) ^ 0xC4EC)
    pick = rng.sample(reqs, min(n, len(reqs)))
    longest = max(c.seq for c in done)
    if not any(done[ci].seq == longest for ci, _ in pick):
        pick[0] = rng.choice([q for q in reqs if done[q[0]].seq == longest])
    return pick


def prefill(cell: Cell, seed: int, seconds: float, tracing: bool, device,
            t0: float, fault: Optional[str] = None,
            control: bool = False) -> Outcome:
    mix, cfg = cell.traffic, cell.config
    m = cfg["model"]
    ref = reference.module(cfg["reference"])
    out = Outcome()

    a = program.arch(cfg)
    specs = ref.param_specs(m)
    dtype = _DTYPES[cfg["dtypes"]["prefill"]["weights"]]
    flat = weights.make(specs, seed, device, dtype)
    shapes = traffic.shapes(mix)
    pool = traffic.token_pool(mix, seed, m["vocab"], device)
    calls = traffic.calls(mix, seed, int(mix["max_calls"]))
    done: List[traffic.Call] = []
    logits: List[torch.Tensor] = []
    with program.mesh_context():
        tree = program.served_tree(a, weights.tree(flat))
        step = _plant_prefill(program.prefill_step(a, device, *shapes[0]),
                              fault, m["vocab"])
        # warm every shape of the mix, and no other
        for bs, ss in shapes:
            tok = pool[0, :bs * ss].view(bs, ss)
            for _ in range(int(mix["warm_calls"])):
                step(tree, {"tokens": tok}).cpu()
        _sync(device)
        out.setup_s = time.perf_counter() - t0

        with _Window(tracing, device) as w:
            deadline = w.t0 + seconds
            for call in calls:
                ts = time.perf_counter()
                with record_function(trace.STEP):
                    y = step(tree, {"tokens": traffic.call_tokens(pool, call)})
                te = time.perf_counter()
                with record_function(trace.WAIT):
                    host = y.cpu()
                tw = time.perf_counter()
                out.enqueue_s.append(te - ts)
                out.latencies_s += [tw - ts] * call.batch
                done.append(call)
                logits.append(host)
                if tw >= deadline:
                    break
            else:
                raise RuntimeError(f"the window outlasted {len(calls)} "
                                   f"calls (max_calls)")
    out.window_s = w.t1 - w.t0
    out.reduced = w.reduced
    out.memory_peak = _peak(device)
    out.attempted = sum(c.batch for c in done)
    out.failed = int(sum(int((~torch.isfinite(x)).any(-1).sum())
                         for x in logits))
    out.calls = [(c.batch, c.seq) for c in done]
    out.tokens = sum(c.tokens for c in done)
    out.notes["routes"] = program.counters()

    # the check: a sample of the finished requests against the reference
    del step, tree, y
    _free()
    fp32_exact()
    pick = _sample(done, seed, int(mix["check_requests"]))
    W = weights.tree(flat)
    by_seq: Dict[int, List[Tuple[int, int]]] = {}
    for ci, r in pick:
        by_seq.setdefault(done[ci].seq, []).append((ci, r))
    got, want = [], []
    budget = int(mix["reference_tokens"])
    for seq, reqs in sorted(by_seq.items()):
        rows = max(1, budget // seq)
        for i in range(0, len(reqs), rows):
            part = reqs[i:i + rows]
            tok = torch.stack([traffic.call_tokens(pool, done[ci])[r]
                               for ci, r in part])
            with torch.no_grad():
                want.append(ref.last_logits(m, W, tok, Arith()).cpu())
                if control:
                    got.append(ref.last_logits(m, W, tok,
                                               Arith(fp8=True)).cpu())
            if not control:
                got.append(torch.stack([logits[ci][r] for ci, r in part]))
    over = cell.limits.get("far_share", {}).get("over")
    out.readings, out.per_request = prefill_readings(
        torch.cat(got), torch.cat(want), over)
    out.notes["checked_requests"] = len(pick)
    return out


def prefill_readings(got: torch.Tensor, want: torch.Tensor,
                     over: Optional[float] = None
                     ) -> Tuple[Dict[str, float], Dict[str, List[float]]]:
    """The readings of the checked requests, and each request's own.

    ``top_gap``: the widest gap by which the reference's logit of a
    served (greedy) token lies below the reference's best; ``logit_err``:
    the largest absolute logit error; ``logit_rms``: the median over the
    requests of the root-mean-square logit error (steady where a few
    requests' experts flip at a near-tie); each as a share of that
    request's reference logits' standard deviation.  With ``over``,
    ``far_share``: the share of the requests whose root-mean-square
    error is above ``over``, which a fault in a minority of the requests
    moves and the median does not."""
    got, want = got.to(torch.float64), want.to(torch.float64)
    sd = want.std(-1)
    served = got.argmax(-1)
    gap = (want.max(-1).values
           - want.gather(-1, served[:, None])[:, 0]) / sd
    err = (got - want).abs().max(-1).values / sd
    rms = (got - want).square().mean(-1).sqrt() / sd
    bad = ~torch.isfinite(got).all(-1)
    for t in (gap, err, rms):
        t[bad] = float("inf")
    out = {"top_gap": float(gap.max()), "logit_err": float(err.max()),
           "logit_rms": float(torch.quantile(rms, 0.5))}
    if over is not None:
        out["far_share"] = float((rms > over).double().mean())
    return out, {"rms": rms.tolist(), "gap": gap.tolist()}


DRIVERS = {"train": train, "prefill": prefill}
