#!/usr/bin/env python3
"""Probe of Mamba-2's gated output norm alone on one GPU, both routes.

    python3 scripts/gated_norm_probe.py [--out results.json] [--quick]
        [--time] [--case LABEL ...] [--no-isolate]

Builds the ``sm90`` route's source (``csrc/gated_norm_sm90.cu``) and
prints ptxas's registers, shared memory and spills for every kernel
instantiation, then at each case runs the forward (with and without the D
skip) and the backward on both routes (``sm90``; ``triton``,
``csrc/gated_norm.py``) and prints the rms share each output needs
against the plain versions (``gated_norm_ref`` in the reference's dtypes
and on fp32 upcasts; ``gated_norm_bwd_ref``), the largest gap between the
two routes, the planted faults' shares (the D skip dropped; eps dropped
on inputs scaled by 2^-6), whether a repeat is bit-equal, the ``sm90``
plan, and with ``--time`` the forward, backward and forward + backward
device ms of each route by
CUDA-graph replay, the routes in turns, beside the byte bound (3.35e12
B/s).  y, x and z are views as the layer hands them: z of one ``in_proj``
row, x of one conv row.  Each case runs in a process of its own with a
time limit (a kernel that hangs ends its process, not the probe), unless
``--no-isolate``.  The exit code is 1 if any case failed.  ``--quick``
keeps the small cases.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (label, B, S, nh, hp, g, N): mamba2-780m's and jamba-1.5's widths
CASES = [
    ("mamba2 B2 S3", 2, 3, 48, 64, 1, 128),
    ("mamba2 B4 S1", 4, 1, 48, 64, 1, 128),
    ("small 8x64 B2 S256", 2, 256, 8, 64, 1, 16),
    ("jamba B1 S64", 1, 64, 128, 128, 8, 128),
    ("mamba2 B4 S2048", 4, 2048, 48, 64, 1, 128),
    ("mamba2 B1 S32768", 1, 32768, 48, 64, 1, 128),
    ("jamba B1 S4096", 1, 4096, 128, 128, 8, 128),
]
QUICK = 4
CASE_TIMEOUT_S = 240
PEAK_BYTES = 3.35e12
GRAPH_REPS = 10
EPS_SCALE = 2.0 ** -6


def share(got, want) -> float:
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    return float((g - w).abs().max()) / rms if rms else float("nan")


def inputs(case, gen, dev):
    import torch
    _, b, S, nh, hp, g, n = case
    d, c = nh * hp, nh * hp + 2 * g * n

    def draw(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=gen,
                                            device=dev)).to(torch.bfloat16)

    row = draw(b, S, 2 * d + 2 * g * n + nh)
    return {"y": draw(b, S, d), "z": row[..., :d],
            "x": draw(b, S, c)[..., :d], "heads": nh,
            "D": draw(nh, scale=0.3, shift=1.0).float(),
            "w": draw(d, scale=0.2, shift=1.0), "dout": draw(b, S, d)}


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Mean device ms of ``fn()``: ``reps`` calls in one CUDA graph,
    replayed 3 times between CUDA events."""
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
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(3):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (3 * reps)


def run_case(case, timing: bool) -> dict:
    import torch
    from repro_torch.kernels import gated_norm as GN, gated_norm_sm90 as GS
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    a = inputs(case, gen, dev)
    y, z, w, nh, x, D, dout = (a[k] for k in ("y", "z", "w", "heads", "x",
                                              "D", "dout"))
    b, S, d = y.shape
    row = {"case": case[0], "B": b, "S": S, "d": d, "heads": nh,
           "plan_fwd": GS.plan_on(0, b * S, d, nh, True, False),
           "plan_bwd": GS.plan_on(0, b * S, d, nh, True, True)}
    args = (y, z, w, nh, x, D)
    with torch.no_grad():
        ref = GN.gated_norm_ref(*args)
        ref32 = GN.gated_norm_ref(*(t.float() if isinstance(t, torch.Tensor)
                                    else t for t in args))
    algo = GN.gated_norm_bwd_ref(dout, *args)
    outs = {}
    for rt in GN.ROUTES:
        t0 = time.perf_counter()
        out = GN.gated_norm_fwd_cuda(*args, route=rt)
        grads = GN.gated_norm_bwd_cuda(dout, *args, route=rt)
        nos = GN.gated_norm_fwd_cuda(y, z, w, nh, route=rt)
        torch.cuda.synchronize()
        outs[rt] = (out, grads, nos)
        r = {"first_call_s": time.perf_counter() - t0,
             "out_share_ref": share(out, ref),
             "out_share_f32": share(out, ref32),
             "no_skip_share_ref": share(nos, GN.gated_norm_ref(y, z, w, nh)),
             "grad_share_plain": {
                 k: share(g, p) for k, g, p in zip(
                     ("dy", "dz", "dw", "dx", "dD"), grads, algo)}}
        again = GN.gated_norm_fwd_cuda(*args, route=rt)
        again_g = GN.gated_norm_bwd_cuda(dout, *args, route=rt)
        r["repeat_bit_equal"] = bool(torch.equal(again, out)) and all(
            torch.equal(p, q) for p, q in zip(again_g, grads))
        r["fault_skip_share_f32"] = share(
            GN.gated_norm_fwd_cuda(*args, plant=GN.PLANT_SKIP, route=rt),
            ref32)
        small = (y * EPS_SCALE, z * EPS_SCALE, w, nh, x * EPS_SCALE, D)
        with torch.no_grad():
            s32 = GN.gated_norm_ref(*(t.float() if isinstance(
                t, torch.Tensor) else t for t in small))
        r["scaled_share_f32"] = share(GN.gated_norm_fwd_cuda(
            *small, route=rt), s32)
        r["fault_eps_share_f32"] = share(GN.gated_norm_fwd_cuda(
            *small, plant=GN.PLANT_EPS, route=rt), s32)
        row[rt] = r
    row["route_gap"] = {
        "out": float((outs["sm90"][0].float()
                      - outs["triton"][0].float()).abs().max()),
        **{k: float((p.float() - q.float()).abs().max())
           for k, p, q in zip(("dy", "dz", "dw", "dx", "dD"),
                              outs["sm90"][1], outs["triton"][1])}}
    del outs
    n = b * S * d
    row["fwd_bound_ms"] = 1e3 * (8 * n + 2 * 2 * d) / PEAK_BYTES
    row["bound_ms"] = 1e3 * (22 * n + 4 * 2 * d) / PEAK_BYTES
    if timing:
        def fwd(rt):
            return lambda: GN.gated_norm_fwd_cuda(*args, route=rt)

        def both(rt):
            def step():
                GN.gated_norm_fwd_cuda(*args, route=rt)
                GN.gated_norm_bwd_cuda(dout, *args, route=rt)
            return step

        def bwd(rt):
            return lambda: GN.gated_norm_bwd_cuda(dout, *args, route=rt)

        runs = {k: [] for k in ("sm90_fwd", "triton_fwd", "sm90", "triton",
                                "sm90_bwd", "triton_bwd")}
        for order in (("sm90", "triton"), ("triton", "sm90")):
            for rt in order:
                runs[f"{rt}_fwd"].append(graph_ms(fwd(rt)))
                runs[rt].append(graph_ms(both(rt)))
                runs[f"{rt}_bwd"].append(graph_ms(bwd(rt)))
        row["ms_runs"] = runs
        for k, v in runs.items():
            row[f"{k}_ms"] = sum(v) / len(v)
        for rt in GN.ROUTES:
            row[f"{rt}_share_of_bound"] = row["bound_ms"] / row[f"{rt}_ms"]
            row[f"{rt}_fwd_share_of_bound"] = (row["fwd_bound_ms"]
                                               / row[f"{rt}_fwd_ms"])
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--case", action="append")
    ap.add_argument("--no-isolate", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    if args.one:
        case = next(c for c in CASES if c[0] == args.one)
        print(json.dumps(run_case(case, args.time)))
        return 0
    from repro_torch.kernels import gated_norm_sm90 as GS, nvcc
    t0 = time.perf_counter()
    GS.build_library()
    print(f"built {GS.SOURCE.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in nvcc.BUILD_LOGS.get(GS.SOURCE.stem, "").splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    cases = CASES[:QUICK] if args.quick else CASES
    if args.case:
        cases = [c for c in CASES if c[0] in args.case]
    rows, failed = [], 0
    for case in cases:
        try:
            if args.no_isolate:
                row = run_case(case, args.time)
            else:
                cmd = [sys.executable, __file__, "--one", case[0]] + (
                    ["--time"] if args.time else [])
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=CASE_TIMEOUT_S)
                if proc.returncode:
                    raise RuntimeError(proc.stderr[-3000:])
                row = json.loads(proc.stdout.strip().splitlines()[-1])
        except Exception:
            failed += 1
            print(f"{case[0]}: FAILED\n{traceback.format_exc()}", flush=True)
            continue
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
