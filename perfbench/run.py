"""Run one cell of ``BENCHMARK.json`` once, on the machine's CUDA card.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Set-up (imports, the kernels' builds or
cache loads, the weights drawn on the card from ``--seed``, the cell's
first steps or its shapes warmed) is timed from process start; then the
window runs for ``--seconds``; then, with the program's state freed, the
check holds what the window produced against the plain reference.  The
last line of standard output is one JSON object; the compared numbers
beside their limits are the last lines of standard error.  ``--trace 1``
profiles the window and reports the per-layer metrics instead of the
end-to-end ones.

Exits non-zero with no result without a CUDA card (or fewer than the
cell's chips), and when JAX or the JAX package is loaded once the
window has closed.  Kernel builds and caches stay under ``build/`` in
the checkout.
"""

import time

T0 = time.perf_counter()

import argparse                                               # noqa: E402
import os                                                     # noqa: E402
import sys                                                    # noqa: E402
from pathlib import Path                                      # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the Triton cache inside the checkout, at a fixed path (the CUDA
# sources' libraries build into build/repro_torch/ by the program)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "perfbench" / "triton")
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="perfbench/run.py",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from perfbench.bench import runner, spec
    cell = spec.cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), t0=T0)
    leaked = runner.forbidden_modules()
    if leaked:
        print(f"modules of JAX or the JAX package were loaded: {leaked}",
              file=sys.stderr)
        return 3
    print(runner.dumps(result), flush=True)
    for line in runner.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
