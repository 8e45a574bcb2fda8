#!/usr/bin/env python3
"""Probe of Mamba-2's decode mixer kernel alone on one GPU.

    python3 scripts/ssm_decode_probe.py [--out results.json] [--reps N]
    python3 scripts/ssm_decode_probe.py --serve PARENT [--out results.json]

Builds ``csrc/ssm_decode_sm90.cu`` and prints ptxas's registers and spills
for each instantiation, holds the kernel to its plain version at
``chip_smoke.MIXER_CASES`` (``chip_smoke.mixer_phase``: limits, planted
faults, a graph replay, the ``unfused`` route in turns), then times
variants of the source at mamba2-780m B 2 / 4 / 128 and jamba's geometry
at B 4, by CUDA-graph replay, each variant built from a string
replacement of the source and swapped in through the wrapper's library:

* ``base``: the source as it is;
* ``empty``: the kernel returns at once (the launch alone);
* ``notail``: no block rescales a row (the last block's tail removed);
* ``noticket``: no ticket drawn either;
* ``nostate``: the state slice neither loaded nor stored;
* ``nostore``: the state slice loaded, not stored;
* ``lb4``: four blocks an SM (64 registers) in place of five;
* ``pre4``: the tail loads four vectors a thread at once, not two.

The variants other than ``base`` compute wrong outputs: they are
timings of parts of the kernel, not kernels.  Each variant is timed in
turns (the list, then the list reversed), the least of ``--reps`` graph
timings a pass.

``--serve PARENT`` runs, in place of all that, phase 10c's mamba2-780m
run (``chip_smoke.lm_serve_phase`` with ``profile``: the serving CLI at
full depth, batch 4, 32 + 32 tokens, then 8 traced decode steps) from
the checkout at ``PARENT`` (an earlier commit of this repo) and from this
one in turns: parent, this, this, parent.  It reports each run's decode
tok/s, device-busy share and device events a decode step.

Each step runs in a process of its own with a time limit (a kernel that
hangs ends its process, not the probe).  The exit code is 1 if any step
failed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STEP_TIMEOUT_S = 300
CASES = ("mamba2 B 2", "mamba2 B 4", "mamba2 B 128", "jamba B 4")
VARIANTS = {
    "base": [],
    "empty": [("  constexpr int kEV = Vec<T>::kN;\n  extern __shared__",
               "  if (p.B > 0) return;\n  constexpr int kEV = Vec<T>::kN;\n"
               "  extern __shared__")],
    "notail": [("  if (!*last) return;", "  if (true) return;")],
    "noticket": [("    const int ticket = atomicAdd(p.counters + b, 1);",
                  "    const int ticket = 0;"),
                 ("  if (!*last) return;", "  if (true) return;")],
    "nostate": [("    mbar_expect_tx(bar, slice_bytes);\n"
                 "    bulk_load(hs, hg, slice_bytes, bar);", ""),
                ("  mbar_wait(bar, 0);", ""),
                ("    bulk_store(hg, hs, slice_bytes);", "")],
    "nostore": [("    bulk_store(hg, hs, slice_bytes);", "")],
    "lb4": [("__launch_bounds__(kThreads, 5)",
             "__launch_bounds__(kThreads, 4)")],
    "pre4": [("  constexpr int kPre = 2;", "  constexpr int kPre = 4;")],
}

_STEP = r'''
import json, sys
from pathlib import Path
root, what, out, var = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[5]
reps = int(sys.argv[4])
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)
import torch
import chip_smoke as C
if what == "serve":
    # every device event of the traced steps, counted the same way in
    # either checkout (an earlier chip_smoke keeps only the top five)
    events, profile_once = [], C.device_profile

    def counted(fn, top=5, cpu=True):
        wall, busy, rows = profile_once(fn, top=None, cpu=cpu)
        events.append(sum(r[1] for r in rows))
        return wall, busy, rows[:top]

    C.device_profile = counted
    runs = [r for r in C.LM_SERVE_RUNS if r[0].startswith("mamba2")]
    res = C.lm_serve_phase(runs=runs, profile=True)["runs"][0]
    res.pop("lines")
    # decode_profile traces 8 decode steps in either checkout
    res["device_events_per_step"] = events[-1] / 8
    Path(out).write_text(json.dumps(res, indent=1, default=str))
    sys.exit(0)
from repro_torch.kernels import nvcc, ssm_decode as M
if what == "check":
    M.build_library()
    ptxas = [l.strip() for l in nvcc.BUILD_LOGS.get("ssm_decode_sm90", "")
             .splitlines() if "registers" in l or "spill" in l]
    for l in ptxas:
        print("ptxas", l, flush=True)
    res = C.mixer_phase("cuda", 0)
    res["ptxas"] = ptxas
else:
    variants = json.loads(Path(var).read_text())
    src = M.SOURCE.read_text()
    build = Path(root) / "build" / "ssm_decode_probe"
    build.mkdir(parents=True, exist_ok=True)
    cases = [c for c in C.MIXER_CASES if c[0] in json.loads(what)]
    res = {"ms": {}}
    names = list(variants)
    for name in names + names[::-1]:
        text = src
        for a, b in variants[name]:
            assert text.count(a) == 1, (name, a)
            text = text.replace(a, b)
        path = build / f"ssm_decode_{name}.cu"
        path.write_text(text)
        M.SOURCE, M._LIB = path, None
        M._library()
        for case in cases:
            gen = torch.Generator("cuda").manual_seed(0)
            zx, window, h, params, g = C.mixer_inputs(case, gen, "cuda")
            ms = min(C.dev_ms(lambda: C.mixer_call(
                M.ssm_decode_mixer, zx, window, h, params, g), "cuda")
                for _ in range(reps))
            res["ms"].setdefault(name, {}).setdefault(case[0], []).append(ms)
            print(f"{name:9s} {case[0]:13s} {ms:.4f} ms", flush=True)
Path(out).write_text(json.dumps(res, indent=1, default=str))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--serve", default=None, metavar="PARENT",
                    help="10c's mamba2 run, PARENT's checkout and this "
                         "one in turns, in place of the kernel's probe")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    out = Path(args.out or ROOT / "build" / "ssm_decode_probe.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    scratch = ROOT / "build" / "ssm_decode_probe"
    scratch.mkdir(parents=True, exist_ok=True)
    var, part = scratch / "variants.json", scratch / "step.json"
    var.write_text(json.dumps(VARIANTS))
    report, rc = {"card": card}, 0
    if args.serve:
        parent = Path(args.serve).resolve()
        steps = [("parent", parent, "serve"), ("this", ROOT, "serve"),
                 ("this", ROOT, "serve"), ("parent", parent, "serve")]
        report["serve"] = []
    else:
        steps = [("check", ROOT, "check"),
                 ("variants", ROOT, json.dumps(CASES))]
    for key, root, what in steps:
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _STEP, str(root), what, str(part),
                 str(args.reps), str(var)], cwd=root,
                timeout=STEP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            print(f"{key}: no end within {STEP_TIMEOUT_S} s", flush=True)
            rc = 1
            break
        if proc.returncode:
            rc = 1
            break
        res = json.loads(part.read_text())
        if what == "serve":
            res["checkout"] = key
            report["serve"].append(res)
            print(f"serve {key}: {res['tok_s']} tok/s, device busy "
                  f"{res['device_busy_ms']} of {res['profiled_wall_ms']} ms, "
                  f"{res['device_events_per_step']} device events a step",
                  flush=True)
        else:
            report[key] = res
    out.write_text(json.dumps(report, indent=1, default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main())
