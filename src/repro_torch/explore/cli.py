"""``python -m repro_torch.explore`` — sweeps without writing a script.

Counterpart of ``python -m repro.explore`` (the JAX package), with the
same subcommands and output.  Simulate-fidelity points run on the card
(``--device`` names another device, e.g. ``cpu``); ``--engine torch``
batches a timing sweep through the fleet evaluator.

Subcommands:

* ``sweep MODEL`` — evaluate a design space over the cached pool
  engine and print the result table (optionally append to a JSONL
  store / promote the top-K to the simulator).
* ``pareto STORE.jsonl`` — Pareto frontier of previously recorded
  evaluations.
* ``cache prune|stats|clear`` — manage the on-disk result cache.

Examples::

    python -m repro_torch.explore sweep tiny_cnn --res 8 --mg 4,8 --flit 8
    python -m repro_torch.explore sweep resnet18 --res 112 --pool 8 \
        --store results/resnet18.jsonl --top-k 3
    python -m repro_torch.explore sweep resnet18 --res 224 \
        --space timing --fidelity simulate --engine torch
    python -m repro_torch.explore pareto results/resnet18.jsonl \
        --axes cycles,energy
    python -m repro_torch.explore cache prune --max-age-days 30 \
        --max-entries 10000
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

from ..core.mapping import CostParams
from ..core.partition import STRATEGIES
from .cache import ResultCache, default_cache_dir
from .engine import ExplorationEngine
from .pareto import frontier_report
from .records import EvalRecord, RecordStore
from .search import by_edp, successive_halving
from .space import (DesignSpace, default_space, mg_flit_space,
                    protection_space, timing_space)

__all__ = ["main"]


def _ints(csv: str) -> List[int]:
    return [int(v) for v in csv.split(",") if v]


def _row_table(recs: Sequence[EvalRecord]) -> str:
    out = ["model            strategy  MG n_mg cores flit lmem  "
           "cycles        EDP         error"]
    for r in recs:
        p = r.point
        err = (r.error or "")[:40]
        out.append(
            f"{r.model:16s} {p.strategy:9s} {p.macros_per_group:2d} "
            f"{p.n_macro_groups:4d} {p.n_cores:5d} {p.flit_bytes:4d} "
            f"{p.local_mem_kb:4d}  {r.cycles:<12.5g}  "
            f"{r.edp:<10.4g}  {err}")
    return "\n".join(out)


def _build_space(args: argparse.Namespace) -> DesignSpace:
    strategies = tuple(args.strategies.split(","))
    for s in strategies:
        if s not in STRATEGIES:
            raise SystemExit(f"unknown strategy {s!r}; "
                             f"have {list(STRATEGIES)}")
    if args.space in ("default", "timing", "protection"):
        if args.mg is not None or args.flit is not None:
            raise SystemExit("--mg/--flit restrict the mg-flit grid "
                             "only; they cannot be combined with "
                             f"--space {args.space}")
        if args.space == "timing":
            return timing_space(strategies=strategies)
        if args.space == "protection":
            return protection_space(strategies=strategies)
        return default_space(strategies=strategies)
    return mg_flit_space(_ints(args.mg or "4,8,16"),
                         _ints(args.flit or "8,16"),
                         strategies=strategies)


def _cmd_sweep(args: argparse.Namespace) -> int:
    if args.top_k and args.fidelity == "simulate":
        raise SystemExit(
            "--top-k implies the two-fidelity successive-halving flow "
            "(cheap screen, simulator promotion); it cannot be "
            "combined with --fidelity simulate")
    space = _build_space(args)
    kw = {}
    if args.res is not None:
        kw["res"] = args.res
    eng = ExplorationEngine(
        args.model, params=CostParams(batch=args.batch),
        pool=args.pool,
        cache=None if args.no_cache else (args.cache_root
                                          or default_cache_dir()),
        store=args.store, flow_cache=args.flow_cache,
        calibration=getattr(args, "calibration", None),
        engine=args.engine, device=args.device, **kw)
    print(f"sweeping {args.model}: {space.describe()}")
    if args.top_k:
        result, screened = successive_halving(
            eng, space, top_k=args.top_k, objective=by_edp,
            screen_fidelity=args.fidelity, calibrate=args.calibrate)
        if eng.calibration is not None:
            print(eng.calibration.describe())
        print(_row_table(screened))
        print(f"\ntop-{args.top_k} promoted to the simulator:")
        print(_row_table(result.history))
    else:
        if args.resume and not args.store:
            raise SystemExit("--resume needs --store (the JSONL record "
                             "store is what the sweep resumes from)")
        recs = eng.sweep(space, fidelity=args.fidelity,
                         resume=args.resume)
        print(_row_table(recs))
    print(f"\ncache: {eng.cache_stats()}")
    if args.store:
        print(f"records appended to {args.store}")
    return 0


def _cmd_pareto(args: argparse.Namespace) -> int:
    recs = RecordStore(args.store).load()
    if args.model:
        recs = [r for r in recs if r.model == args.model]
    if not recs:
        raise SystemExit(f"no records in {args.store}"
                         + (f" for model {args.model!r}"
                            if args.model else ""))
    axes = tuple(args.axes.split(","))
    print(f"{len(recs)} records; Pareto frontier on {axes}:")
    print(frontier_report(recs, axes=axes))
    return 0


def _cmd_cache(args: argparse.Namespace) -> int:
    cache = ResultCache(args.cache_root or default_cache_dir())
    if args.cache_cmd == "stats":
        print(f"{cache.root}: {len(cache)} entries")
        return 0
    if args.cache_cmd == "clear":
        print(f"removed {cache.clear()} entries from {cache.root}")
        return 0
    # prune
    if args.max_age_days is None and args.max_entries is None:
        raise SystemExit("cache prune needs --max-age-days and/or "
                         "--max-entries")
    n = cache.prune(max_age_days=args.max_age_days,
                    max_entries=args.max_entries)
    print(f"pruned {n} entries from {cache.root} "
          f"({len(cache)} remain)")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.explore",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sw = sub.add_parser("sweep", help="evaluate a design space")
    sw.add_argument("model", help="workload name (e.g. resnet18)")
    sw.add_argument("--res", type=int, default=None,
                    help="input resolution for CNN workloads")
    sw.add_argument("--batch", type=int, default=4)
    sw.add_argument("--space", choices=("mg-flit", "default", "timing",
                                        "protection"),
                    default="mg-flit",
                    help="mg-flit: Fig.6 grid; default: full 5-dim "
                         "space; timing: 64-point unit-latency grid "
                         "sharing one compiled program (pairs with "
                         "--engine torch)")
    sw.add_argument("--mg", default=None,
                    help="[mg-flit only] comma-separated MG sizes "
                         "(default 4,8,16)")
    sw.add_argument("--flit", default=None,
                    help="[mg-flit only] comma-separated flit widths "
                         "(default 8,16)")
    sw.add_argument("--strategies", default=",".join(STRATEGIES))
    sw.add_argument("--fidelity",
                    choices=("analytic", "trace", "simulate"),
                    default="analytic",
                    help="sweep fidelity; with --top-k this is the "
                         "screening rung (simulate is then invalid)")
    sw.add_argument("--top-k", type=int, default=0,
                    help="successive halving: cheap screen, then "
                         "promote the top-K to the simulator "
                         "(exclusive with --fidelity simulate)")
    sw.add_argument("--calibrate", type=int, default=0,
                    help="[with --top-k] fit per-unit correction "
                         "factors from N simulator runs before the "
                         "deciding screen")
    sw.add_argument("--calibration", default=None,
                    help="named calibration preset to start from "
                         "(results/calibrations/<name>.json, written "
                         "by flow.calibrate(..., save=name))")
    sw.add_argument("--flow-cache", default=None,
                    help="directory for the persistent flow "
                         "pass-output cache (shared by pool workers)")
    sw.add_argument("--pool", type=int, default=0,
                    help="worker processes (0 = serial)")
    sw.add_argument("--engine",
                    choices=("auto", "scalar", "vector", "torch"),
                    default="auto",
                    help="perf-simulator engine for simulate-fidelity "
                         "points: auto runs each point with its stage "
                         "decode on the device; torch batches "
                         "same-structure chips through one decode per "
                         "stage (the fleet); scalar/vector are the "
                         "numpy host engines")
    sw.add_argument("--device", default=None,
                    help="device of the simulate-fidelity decodes "
                         "(default: the CUDA device; e.g. cpu)")
    sw.add_argument("--resume", action="store_true",
                    help="skip points already successfully recorded "
                         "in --store (restart a killed sweep where "
                         "it left off)")
    sw.add_argument("--store", default=None,
                    help="append records to this JSONL file")
    sw.add_argument("--cache-root", default=None)
    sw.add_argument("--no-cache", action="store_true")
    sw.set_defaults(fn=_cmd_sweep)

    pa = sub.add_parser("pareto", help="frontier of recorded results")
    pa.add_argument("store", help="JSONL record store path")
    pa.add_argument("--axes", default="cycles,energy",
                    help="comma-separated minimized axes")
    pa.add_argument("--model", default=None,
                    help="filter records to one workload")
    pa.set_defaults(fn=_cmd_pareto)

    ca = sub.add_parser("cache", help="manage the result cache")
    ca.add_argument("cache_cmd", choices=("prune", "stats", "clear"))
    ca.add_argument("--cache-root", default=None)
    ca.add_argument("--max-age-days", type=float, default=None)
    ca.add_argument("--max-entries", type=int, default=None)
    ca.set_defaults(fn=_cmd_cache)

    args = ap.parse_args(argv)
    return args.fn(args)
