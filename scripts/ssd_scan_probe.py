#!/usr/bin/env python3
"""Probe of the SSD chunk-scan kernel alone on one GPU.

    python3 scripts/ssd_scan_probe.py [--out results.json] [--quick]
        [--route sm90|mma|both] [--case LABEL ...] [--no-isolate]

Builds both routes' sources (``csrc/ssd_chunk_scan_sm90.cu``, the
``sm90`` route; ``csrc/ssd_chunk_scan.cu``, the ``mma`` route) and prints
ptxas's registers, shared memory and spills for every kernel
instantiation, then at each case and route runs the forward and the
backward on the card and prints the rms share each output needs against
the plain versions (``ssd_chunk_scan_ref`` on fp32 upcasts and autograd
of it; ``ssd_chunk_scan_bwd_ref``), the planted faults' shares, whether
a repeat is bit-equal, the forward and forward + backward device ms by
CUDA-graph replay, and each launch's device ms alone (the entry point
restricted to that launch, ``ssd_sm90_only`` / ``ssd_chunk_scan_only``;
CUDA events around graph-replayed single launches).  bf16 cases run on
each route asked for, fp32 ones on ``mma`` only.  Each (case, route) runs
in a process of its own with a time limit (a kernel that hangs ends its
process, not the probe), unless ``--no-isolate``.  A case that fails
prints its error and the next one runs; the exit code is 1 if any did.
``--quick`` keeps the small cases.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (label, b, S, nh, hp, g, N, Q, dtype)
CASES = [
    ("tiny fp32", 2, 64, 4, 16, 1, 16, 16, "float32"),
    ("tiny bf16 g2", 2, 128, 4, 16, 2, 32, 32, "bfloat16"),
    ("small bf16 Q64", 2, 256, 4, 64, 1, 64, 64, "bfloat16"),
    ("small bf16 g2 Q128", 1, 512, 8, 128, 2, 128, 128, "bfloat16"),
    ("mamba2 B4 S2048", 4, 2048, 48, 64, 1, 128, 256, "bfloat16"),
    ("jamba B1 S4096", 1, 4096, 128, 128, 8, 128, 256, "bfloat16"),
    ("mamba2 B1 S32768", 1, 32768, 48, 64, 1, 128, 256, "bfloat16"),
    ("mamba2 B4 S64", 4, 64, 48, 64, 1, 128, 64, "bfloat16"),
    ("mamba2 B2 S=Q 256", 2, 256, 48, 64, 1, 128, 256, "bfloat16"),
]
QUICK = 4
# each route's launches, in the order its entry points make them
LAUNCH_NAMES = {
    "sm90": (("cb", "state", "pass", "scan"),
             ("cb", "dstate", "pass", "dx_db", "dc", "dt", "reduce")),
    "mma": (("state", "pass", "scan"),
            ("dstate", "pass", "dx_db", "dc", "dt", "reduce")),
}
CASE_TIMEOUT_S = 300


def share(got, want) -> float:
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    return float((g - w).abs().max()) / rms if rms else float("nan")


def inputs(case, gen, dev):
    import torch
    _, b, S, nh, hp, g, n, _, dt_name = case
    dtype = getattr(torch, dt_name)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    # x, B and C as views of one wider row, as the layer's split gives them
    xbc = draw(b, S, nh * hp + 2 * g * n)
    x = xbc[..., :nh * hp].reshape(b, S, nh, hp)
    B = xbc[..., nh * hp:nh * hp + g * n].reshape(b, S, g, n)
    C = xbc[..., nh * hp + g * n:].reshape(b, S, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, nh), generator=gen, device=dev) - 2.0)
    A = -torch.linspace(1.0, 16.0, nh, device=dev)
    dy = draw(b, S, nh, hp)
    return x, dt, A, B, C, dy


def graph_ms(fn, reps: int = 3) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / (3 * reps)


def _only(K, rt):
    """The route's launch mask setter."""
    lib = K._sm90_library() if rt == "sm90" else K._library()
    fn = lib.ssd_sm90_only if rt == "sm90" else lib.ssd_chunk_scan_only
    fn.argtypes = [ctypes.c_int]
    fn.restype = None
    return fn


def run_case(case, rt, gen, dev) -> dict:
    import torch
    from repro_torch.kernels import ssd_scan as K
    label, b, S, nh, hp, g, n, Q, dt_name = case
    x, dt, A, B, C, dy = inputs(case, gen, dev)
    row = {"case": label, "route": rt}
    if rt == "sm90":
        row["band"] = K.band_heads(b, S // Q, nh, g, Q)

    def fwd(plant=0):
        return K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q, plant=plant,
                                         route=rt)

    def bwd(cum_, st_):
        return K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cum_, st_, Q,
                                         route=rt)

    t0 = time.perf_counter()
    y, cum, state = fwd()
    grads = bwd(cum, state)
    torch.cuda.synchronize()
    row["first_s"] = time.perf_counter() - t0
    cum_r, state_r = K.ssd_chunk_states_ref(x, dt, A, B, C, Q)
    row["cum"] = share(cum, cum_r)
    row["state"] = share(state, state_r)
    leaves = [t.detach().float().clone().requires_grad_()
              for t in (x, dt, A, B, C)]
    y32 = K.ssd_chunk_scan_ref(*leaves, Q)
    y32.backward(dy.float())
    row["y"] = share(y, y32)
    row["y_ref_dtypes"] = share(y, K.ssd_chunk_scan_ref(x, dt, A, B, C, Q))
    plain = K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, Q)
    for name, got, want, want_p in zip(("dx", "ddt", "dA", "dB", "dC"),
                                       grads, [t.grad for t in leaves],
                                       plain):
        row[name] = share(got, want)
        row[name + "_plain"] = share(got, want_p)
    del y32, leaves, plain
    if S // Q > 1:
        for pname, bit in (("state dropped", K.PLANT_STATE),
                           ("diagonal dropped", K.PLANT_DIAG)):
            bad, _, _ = fwd(bit)
            row["fault " + pname] = share(bad, y)
    # determinism: a second run bit-equal
    y2, c2, s2 = fwd()
    g2 = bwd(c2, s2)
    row["repeat_equal"] = bool(torch.equal(y2, y) and all(
        torch.equal(a_, b_) for a_, b_ in zip(g2, grads)))
    row["fwd_ms"] = graph_ms(fwd)

    def fwd_bwd():
        yy, cc, ss = fwd()
        bwd(cc, ss)

    row["ms"] = graph_ms(fwd_bwd)
    # each launch alone, on the inputs the full call left in place
    only = _only(K, rt)
    names_f, names_b = LAUNCH_NAMES[rt]
    launch = {}
    try:
        for k, name in enumerate(names_f):
            only(1 << k)
            launch["fwd." + name] = graph_ms(fwd)
        for k, name in enumerate(names_b):
            only(1 << k)
            launch["bwd." + name] = graph_ms(lambda: bwd(cum, state))
    finally:
        only(-1)
    row["launch_ms"] = launch
    return row


def ptxas_lines(stem: str):
    """ptxas's report of the last build of ``stem``, a line a kernel
    instantiation: its (demangled enough) name, registers, shared memory
    and spill stores / loads."""
    import re
    from repro_torch.kernels import nvcc
    out, name, spill = [], None, ""
    for line in nvcc.BUILD_LOGS.get(stem, "").splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          m.group(1))
            name = re.sub(r"EEEv.*|ENS_.*", "", name)
            continue
        if "spill" in line:
            spill = ", ".join(x.strip() for x in line.split(",")[1:3])
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line) \
            or re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = m.group(2) if m.lastindex == 2 else "0"
            out.append(f"{name}: {m.group(1)} registers, {smem} bytes "
                       f"static smem, {spill}")
            name = None
    return out


def one(idx: int, rt: str) -> int:
    """A (case, route) in this process: its row as a JSON line."""
    import torch
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(idx)
    row = run_case(CASES[idx], rt, gen, dev)
    print("ROW " + json.dumps(row), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--route", choices=("sm90", "mma", "both"),
                    default="both")
    ap.add_argument("--case", action="append", default=None,
                    help="run only the cases of these labels")
    ap.add_argument("--no-isolate", action="store_true")
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--one-route", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.one is not None:
        return one(args.one, args.one_route)
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import ssd_scan as K
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        built = [pool.submit(K.build_library, K.SOURCE_SM90),
                 pool.submit(K.build_library, K.SOURCE)]
        for f in built:
            f.result()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    ptx = {stem: ptxas_lines(stem)
           for stem in ("ssd_chunk_scan_sm90", "ssd_chunk_scan")}
    for stem, lines in ptx.items():
        for line in lines:
            print(f"  ptxas {stem}: {line}", flush=True)
    cases = CASES[:QUICK] if args.quick else CASES
    if args.case:
        cases = [c for c in CASES if c[0] in args.case]
    routes = ("sm90", "mma") if args.route == "both" else (args.route,)
    rows, bad = [], 0
    for case in cases:
        for rt in routes:
            if rt == "sm90" and K.route(getattr(torch, case[8]), case[7],
                                        case[6], case[4]) != "sm90":
                continue
            idx = CASES.index(case)
            try:
                if args.no_isolate:
                    dev = torch.device("cuda", 0)
                    row = run_case(case, rt,
                                   torch.Generator(dev).manual_seed(idx), dev)
                    torch.cuda.empty_cache()
                else:
                    proc = subprocess.run(
                        [sys.executable, __file__, "--one", str(idx),
                         "--one-route", rt], capture_output=True, text=True,
                        timeout=CASE_TIMEOUT_S)
                    got = [ln[4:] for ln in proc.stdout.splitlines()
                           if ln.startswith("ROW ")]
                    if proc.returncode or not got:
                        raise RuntimeError(f"exit {proc.returncode}:\n"
                                           f"{proc.stderr[-3000:]}")
                    row = json.loads(got[-1])
            except Exception:            # a probe: report and go on
                bad += 1
                traceback.print_exc()
                row = {"case": case[0], "route": rt,
                       "error": traceback.format_exc()[-3000:]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"ptxas": ptx, "rows": rows},
                                             indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
