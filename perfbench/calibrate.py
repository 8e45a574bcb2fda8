"""Readings for the limits of a cell's check, on the card, in one process.

    python perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control 3] [--faults half_batch,stale_state] [--fault-seeds 3] \\
        [--no-sound] [--seconds 2] --out chiprun_out/cal.jsonl

For each seed, a sound run of the program with a short window (the
lower readings); for the first ``--control`` seeds, the control (the
reference on float8 operands in the program's place); for the first
``--fault-seeds`` seeds, each named fault planted in the timed path
(upper readings).  One JSON line a run: the compared numbers, the
end-to-end metrics and the seconds it took on standard output; in the
file also each checked request's own readings, from which a per-request
threshold such as ``far_share``'s ``over`` is chosen.  The benchmark's
own runs never run this.
"""

import time

T0 = time.perf_counter()

import argparse                                               # noqa: E402
import json                                                   # noqa: E402
import os                                                     # noqa: E402
import sys                                                    # noqa: E402
from pathlib import Path                                      # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--no-sound", action="store_true",
                    help="only the control and the faults")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench.bench import runner, spec
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    jobs = [] if args.no_sound else [(s, None, False) for s in seeds]
    jobs += [(s, None, True) for s in seeds[:args.control]]
    jobs += [(s, f, False) for f in faults for s in seeds[:args.fault_seeds]]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda", 0)
    with open(args.out, "a") as f:
        for seed, fault, control in jobs:
            t = time.perf_counter()
            r = runner.run(cell, seed, args.seconds, False, dev, t0=t,
                           fault=fault, control=control,
                           detail=True)
            line = {"workload": args.workload, "seed": seed, "fault": fault,
                    "control": control,
                    "readings": r["notes"]["readings"],
                    "metrics": {k: v["value"] for k, v in
                                r["metrics"].items()},
                    "attempted": r["attempted"], "failed": r["failed"],
                    "peak": r["device"]["memory_peak_bytes"],
                    "seconds": time.perf_counter() - t}
            print(json.dumps(line), flush=True)
            line["per_request"] = r["notes"].get("per_request", {})
            f.write(json.dumps(line) + "\n")
            f.flush()
    leaked = runner.forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}",
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
