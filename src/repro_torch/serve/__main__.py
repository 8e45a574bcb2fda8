"""CLI for the serving simulator (``python -m repro_torch.serve``).

Counterpart of ``python -m repro.serve`` (the JAX package), with the same
flags and the same printed report, plus ``--device``: at ``--fidelity
simulate`` every bucket's stages decode on the card unless ``--device``
names another device.

Examples::

    python -m repro_torch.serve --trace poisson --rate 8 --requests 200 \\
        --fidelity trace
    python -m repro_torch.serve --trace bursty --rate 6 --requests 100 \\
        --policy static
    python -m repro_torch.serve --trace file --trace-file t.json \\
        --policy both --json out.json
    python -m repro_torch.serve --fidelity simulate --chips 2 \\
        --policy both
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List

from ..core.machine import LINK_TIERS
from .metrics import metrics_json
from .policy import POLICIES, make_policy
from .trace_replay import (Request, ServeSim, bursty_trace, load_trace,
                           poisson_trace)
from .workload import ServeModelCfg, StepCostTable


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serve",
        description="Request-level CIM LM serving simulator")
    p.add_argument("--trace", choices=("poisson", "bursty", "file"),
                   default="poisson")
    p.add_argument("--trace-file", help="JSON trace for --trace file")
    p.add_argument("--rate", type=float, default=8.0,
                   help="mean arrival rate, req/s")
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--burst", type=float, default=3.0,
                   help="bursty: on-phase rate multiplier")
    p.add_argument("--fidelity",
                   choices=("analytic", "trace", "simulate"),
                   default="trace")
    p.add_argument("--policy",
                   choices=tuple(sorted(POLICIES)) + ("both",),
                   default="continuous")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--engine", choices=("event", "array"),
                   default="array",
                   help="replay engine: the array-batched engine "
                        "(default; orders of magnitude faster) or the "
                        "reference discrete-event loop — both produce "
                        "byte-identical metrics JSON")
    p.add_argument("--prefill-policy",
                   choices=("fifo", "batched", "chunked"),
                   default="fifo",
                   help="fifo: batch-1 prompts back to back; batched: "
                        "FCFS prefill batches up to --prefill-max-batch; "
                        "chunked: prompt chunks co-scheduled into decode "
                        "iterations under a --chunk-tokens budget "
                        "(batched/chunked need --engine array)")
    p.add_argument("--prefill-max-batch", type=int, default=8,
                   help="batch cap for --prefill-policy batched")
    p.add_argument("--chunk-tokens", type=int, default=32,
                   help="per-iteration token budget for "
                        "--prefill-policy chunked")
    p.add_argument("--streaming-percentiles", action="store_true",
                   help="estimate latency percentiles with the P2 "
                        "streaming algorithm (O(1) memory; approximate) "
                        "instead of the exact sorted sample")
    p.add_argument("--kv-frac", type=float, default=0.5,
                   help="fraction of global memory reserved for KV")
    p.add_argument("--deadline-s", type=float, default=None,
                   help="per-request SLO (s) from arrival; late "
                        "completions count as timeouts and drop out "
                        "of goodput")
    p.add_argument("--max-queue", type=int, default=None,
                   help="prefill admission cap: arrivals that find "
                        "this many requests waiting are shed (with "
                        "--max-retries retry attempts)")
    p.add_argument("--max-retries", type=int, default=0,
                   help="retry attempts for shed requests "
                        "(exponential backoff)")
    p.add_argument("--retry-backoff-s", type=float, default=0.05,
                   help="base backoff before a shed request retries")
    p.add_argument("--max-sim-s", type=float, default=None,
                   help="abort the replay with a diagnostic if "
                        "simulated time passes this cap (guards "
                        "against over-capacity traces running "
                        "unboundedly long)")
    p.add_argument("--n-layers", type=int, default=2)
    p.add_argument("--d-model", type=int, default=128)
    p.add_argument("--n-heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--max-prompt", type=int, default=64)
    p.add_argument("--max-new", type=int, default=64)
    p.add_argument("--no-incremental", action="store_true",
                   help="price decode with full KV re-staging")
    p.add_argument("--chips", default="1",
                   help="chip mesh, e.g. '2x2', '1x4' or a count "
                        "('4' picks the squarest mesh); '1' = classic "
                        "single-chip serving")
    p.add_argument("--link", default="pcb",
                   choices=tuple(sorted(LINK_TIERS)),
                   help="inter-chip link tier for --chips > 1")
    p.add_argument("--flow-cache",
                   help="flow pass/table disk cache directory "
                        "(also honors $REPRO_TORCH_FLOW_CACHE); a second "
                        "run with the same knobs skips compilation")
    p.add_argument("--calibration",
                   help="saved calibration preset name (see "
                        "flow.calibrate(..., save=...))")
    p.add_argument("--device", default=None,
                   help="device of the simulate-fidelity decodes "
                        "(default: the CUDA device; e.g. cpu)")
    p.add_argument("--json", help="write metrics JSON here")
    return p


def _system(args: argparse.Namespace):
    """``--chips``/``--link`` -> SystemConfig (None for one chip)."""
    from ..system import SystemConfig
    t = str(args.chips).lower().replace("×", "x")
    try:
        if "x" in t:
            cx, cy = (int(v) for v in t.split("x", 1))
            sysc = SystemConfig(chips_x=cx, chips_y=cy, link=args.link)
        else:
            sysc = SystemConfig.mesh(int(t), link=args.link)
    except ValueError as e:
        raise SystemExit(f"bad --chips {args.chips!r}: {e}") from None
    return sysc if sysc.n_chips > 1 else None


def _trace(args: argparse.Namespace) -> List[Request]:
    if args.trace == "file":
        if not args.trace_file:
            raise SystemExit("--trace file requires --trace-file")
        return load_trace(args.trace_file)
    kw = dict(rate=args.rate, n=args.requests, seed=args.seed,
              max_prompt=args.max_prompt, max_new=args.max_new)
    if args.trace == "bursty":
        return bursty_trace(burst=args.burst, **kw)
    return poisson_trace(**kw)


def _report(m: Dict[str, Any]) -> str:
    t, p = m["ttft_s"], m["tpot_s"]
    s = (
        f"policy={m['policy']:<11s} engine={m['engine']}/"
        f"{m['prefill_policy']} req={m['requests']} "
        f"tok/s={m['throughput_tok_s']:8.1f} "
        f"ttft p50={t['p50'] * 1e3:7.2f}ms p95={t['p95'] * 1e3:7.2f}ms "
        f"p99={t['p99'] * 1e3:7.2f}ms  "
        f"tpot p50={p['p50'] * 1e6:6.1f}us p99={p['p99'] * 1e6:6.1f}us")
    if "goodput_tok_s" in m:
        s += (f"  goodput={m['goodput_tok_s']:8.1f} "
              f"shed={m['shed_requests']} "
              f"timeout={m['timeout_requests']} "
              f"retries={m['retries']}")
    return s


def main(argv: List[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = ServeModelCfg(
        n_layers=args.n_layers, d_model=args.d_model,
        n_heads=args.n_heads, vocab=args.vocab,
        max_prompt=args.max_prompt, max_new=args.max_new)
    system = _system(args)
    mesh = (f", mesh {system.chips_x}x{system.chips_y} "
            f"'{system.link.name}'" if system is not None else "")
    print(f"compiling step costs (fidelity={args.fidelity}{mesh}) ...",
          flush=True)
    table = StepCostTable(cfg, fidelity=args.fidelity,
                          incremental=not args.no_incremental,
                          system=system,
                          calibration=args.calibration,
                          flow_cache=args.flow_cache,
                          device=args.device)
    if table.cache_hit:
        print("step-cost table loaded from flow cache "
              "(compilation skipped)")
    requests = _trace(args)
    policies = sorted(POLICIES) if args.policy == "both" \
        else [args.policy]
    results: Dict[str, Any] = {}
    for name in policies:
        try:
            sim = ServeSim(table, make_policy(name, args.max_batch),
                           kv_frac=args.kv_frac,
                           deadline_s=args.deadline_s,
                           max_queue=args.max_queue,
                           max_retries=args.max_retries,
                           retry_backoff_s=args.retry_backoff_s,
                           engine=args.engine,
                           prefill_policy=args.prefill_policy,
                           prefill_max_batch=args.prefill_max_batch,
                           chunk_tokens=args.chunk_tokens,
                           percentile_mode=(
                               "streaming" if args.streaming_percentiles
                               else "exact"))
        except ValueError as e:
            raise SystemExit(f"error: {e}") from None
        try:
            m = sim.run(requests, max_sim_s=args.max_sim_s)
        except RuntimeError as e:
            raise SystemExit(f"error: {e}") from None
        results[name] = m
        print(_report(m))
    if args.json:
        payload = results if len(results) > 1 \
            else results[policies[0]]
        with open(args.json, "w") as f:
            f.write(metrics_json(payload))
            f.write("\n")
        print(f"wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
