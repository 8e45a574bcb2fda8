#!/usr/bin/env python3
"""Probe of the SSD chunk-scan kernel alone on one GPU.

    python3 scripts/ssd_scan_probe.py [--out results.json] [--quick]

Builds ``csrc/ssd_chunk_scan.cu`` (prints ptxas's registers, shared
memory and spills a kernel), then at each case runs the forward and the
backward on the card and prints the rms share each output needs against
the plain versions (``ssd_chunk_scan_ref`` on fp32 upcasts and autograd
of it; ``ssd_chunk_scan_bwd_ref``), the planted faults' shares, and the
forward and forward + backward device ms by CUDA-graph replay.  A case
that fails prints its error and the next one runs; the exit code is 1 if
any did.  ``--quick`` keeps the small cases.
"""

from __future__ import annotations

import argparse
import json
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
    ("Q48 bf16", 1, 96, 4, 32, 1, 32, 48, "bfloat16"),
    ("mamba2 B4 S2048", 4, 2048, 48, 64, 1, 128, 256, "bfloat16"),
    ("jamba B1 S4096", 1, 4096, 128, 128, 8, 128, 256, "bfloat16"),
    ("mamba2 B1 S32768", 1, 32768, 48, 64, 1, 128, 256, "bfloat16"),
]
QUICK = 3


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


def run_case(case, gen, dev) -> dict:
    import torch
    from repro_torch.kernels import ssd_scan as K
    label, b, S, nh, hp, g, n, Q, dt_name = case
    x, dt, A, B, C, dy = inputs(case, gen, dev)
    row = {"case": label}
    t0 = time.perf_counter()
    y, cum, state = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q)
    grads = K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cum, state, Q)
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
            bad, _, _ = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q,
                                                  plant=bit)
            row["fault " + pname] = share(bad, y)
    # determinism: a second run bit-equal
    y2, c2, s2 = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q)
    g2 = K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, c2, s2, Q)
    row["repeat_equal"] = bool(torch.equal(y2, y) and all(
        torch.equal(a_, b_) for a_, b_ in zip(g2, grads)))
    row["fwd_ms"] = graph_ms(lambda: K.ssd_chunk_scan_fwd_cuda(
        x, dt, A, B, C, Q))

    def fwd_bwd():
        yy, cc, ss = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, Q)
        K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cc, ss, Q)

    row["ms"] = graph_ms(fwd_bwd)
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import nvcc, ssd_scan as K
    t0 = time.perf_counter()
    K.build_library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in nvcc.BUILD_LOGS.get("ssd_chunk_scan", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(0)
    rows, bad = [], 0
    for case in CASES[:QUICK] if args.quick else CASES:
        try:
            row = run_case(case, gen, dev)
        except Exception:            # a probe: report and go on
            bad += 1
            traceback.print_exc()
            row = {"case": case[0], "error": traceback.format_exc()}
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
