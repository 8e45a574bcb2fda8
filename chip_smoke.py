#!/usr/bin/env python3
"""Smoke run of the ``repro_torch`` port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile]

Phases (none catches its own failure; any mismatch raises and the
script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); build the
   bit-serial CUDA kernel from ``src/repro_torch/kernels/csrc`` (timed
   as set-up);
2. hold the kernel (``cim_mvm`` on CUDA tensors) against its plain
   PyTorch version ``bitserial_mvm_ref``, bit-exact (tolerance 0): the
   CPU tests' shapes (K not a multiple of 16 among them) under
   ``act_bits`` 4/6/8 and ``signed`` both ways, with the blocks the
   chooser picks, every tile forced with one K slice and with the most
   slices, and the explicit ``BLOCKS``; a tile the kernel lacks must
   raise.  Then the int32 wrap-around case (K = 2^17 + 1 products of
   (-128)·(-128)) with one K slice and split K: the MMA accumulation
   and the split combine both wrap modulo 2^32;
3. drive the main path through the user entry points —
   ``flow.compile(...).evaluate("func:torch", check=True)`` — for
   resnet18@224 (batch 4) and the default transformer (batch 1), with
   the kernel's launch count set to 0 just before and read just after;
   it must equal one launch per static group plus one per sample per
   dynamic group.  A path with dynamic-weight groups is driven once
   more at one sample more (its own state passed in), so that the
   per-sample launches are counted with more than one sample;
4. hold the kernel against its plain version on exactly the operands
   each path's MVMs receive (recorded from a plain-oracle pass);
5. time each path (``check=False``, after a warm-up, CUDA events) and
   each of its MVMs: the kernel, the plain version, the bound
   ``max(2·M·K·N / 1979e12, (M·K + K·N + 4·M·N) / 3.35e12)``
   (H100 SXM int8 tensor-core peak and HBM rate; the function is one
   int8 GEMM — the ``act_bits`` plane products are the kernel's design,
   not work the function needs) and the yardstick ``torch._int_mm``
   (timed here only; the port never calls it).  Each MVM is timed as
   device time (calls replayed from a CUDA graph, :func:`graph_ms`) and
   as issued from Python (:func:`cuda_ms`, the host's launch cost
   included); the ``kernels`` line reports device times.  Each row
   names the tile and K split the chooser picked, and beside it the
   fastest of every tile and K split on the same operands (each held
   equal to the chooser's result).
   ``--profile`` adds one ``torch.profiler`` trace of each path: the
   device's busy share and its top kernels.

The second-to-last line is the ``{"kernels": [...]}`` JSON record and
the last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when no CUDA device is present or when the
port's sources are not beside this script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PEAK_INT8_OPS = 1979e12       # H100 SXM dense int8 tensor-core peak
PEAK_BYTES = 3.35e12          # H100 SXM HBM3 rate
REPS = 10                     # timed runs per MVM and per path
CPU_TEST_SHAPES = [(128, 128, 128), (256, 128, 384), (128, 512, 128),
                   (1, 1, 1), (37, 100, 59), (128, 129, 130),
                   (200, 64, 1000), (5, 4096, 8), (511, 27, 64),
                   (300, 147, 64)]
BLOCKS = [(128, 128, 128), (64, 64, 256)]
PATHS = [("resnet18@224", "resnet18", {"res": 224}, 4),
         ("transformer", "transformer", {}, 1)]


def log(*a):
    print(*a, flush=True)


def bound(shapes) -> tuple:
    """``(ms, "operations" | "bytes")``: the least time the card takes
    for the ``(M, K, N)`` int8 GEMMs in ``shapes``, one after another.
    Each GEMM takes the larger of its bytes (operands read once, the
    int32 output written once) at the HBM rate and its ``2·M·K·N``
    operations at the int8 tensor-core peak; the label names the larger
    of the two sums."""
    t_ops = [2.0 * m * k * n / PEAK_INT8_OPS for m, k, n in shapes]
    t_bytes = [(m * k + k * n + 4.0 * m * n) / PEAK_BYTES
               for m, k, n in shapes]
    return (1e3 * sum(map(max, t_ops, t_bytes)),
            "operations" if sum(t_ops) >= sum(t_bytes) else "bytes")


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn()`` over ``reps`` runs issued from Python, after
    one warm-up, by CUDA events: the device's time, or the host's when
    the host issues slower than the device runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()``: ``reps`` calls captured in one CUDA
    graph (after a warm-up on a side stream), the graph replayed 3 times
    between CUDA events.  The host's launch cost is out of the window;
    each call's device work runs in order, as issued."""
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
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def device_profile(fn, top: int = 5):
    """One ``torch.profiler`` traced run of ``fn``: its host wall ms,
    the device's busy ms (sum of the device events' own time) and the
    ``top`` device events by time as ``(ms, count, name)``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return wall_ms, sum(r[0] for r in rows), rows[:top]


def int_mm_operands(a, w):
    """Zero-pad to ``torch._int_mm``'s CUDA rules (M > 16, K and N
    multiples of 8)."""
    from repro_torch.kernels.ops import pad_to
    ap = pad_to(a, (8, 8))
    if ap.shape[0] <= 16:
        ap = pad_to(ap, (32, 1))
    return ap, pad_to(w, (8, 8))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the measurements as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one run of each path with "
                         "torch.profiler (device busy share, top kernels)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch sources are not under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import flow
    from repro_torch.core import ref
    from repro_torch.core.arch import default_chip
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels.ops import cim_mvm
    from repro_torch.kernels.ref import bitserial_mvm_ref

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    report = {"card": card, "paths": {}, "shapes": []}

    # 1. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    lib = bsm.build_library()
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {lib.name} in {report['build_s']:.2f} s")
    for line in bsm.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")

    # 2. kernel vs plain version on the CPU tests' shapes ---------------------
    rng = torch.Generator().manual_seed(args.seed)
    max_err = 0
    n_cmp = 0

    def compare(a, w, **kw):
        nonlocal max_err, n_cmp
        got = cim_mvm(a, w, **kw)
        want = bitserial_mvm_ref(
            a, w, act_bits=kw.get("act_bits", 8),
            signed=kw.get("signed", True))
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        max_err = max(max_err, err)
        n_cmp += 1
        if got.shape != want.shape or err != 0:
            raise AssertionError(
                f"kernel != plain on {tuple(a.shape)}x{tuple(w.shape)} "
                f"{kw}: max |err| {err}")

    for m, k, n in CPU_TEST_SHAPES:
        a = torch.randint(-128, 128, (m, k), generator=rng,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-128, 128, (k, n), generator=rng,
                          dtype=torch.int8).to(dev)
        full_k = -(-k // bsm.BK) * bsm.BK
        forced = [(None, None, None)] + BLOCKS + [
            (bm, bn, bk) for bm, bn in bsm.TILES for bk in (bsm.BK, full_k)]
        for act_bits in (4, 6, 8):
            for signed in (True, False):
                for bm, bn, bk in forced:
                    compare(a, w, act_bits=act_bits, signed=signed,
                            block_m=bm, block_n=bn, block_k=bk)
    log(f"kernel == plain on {n_cmp} CPU-test cases (act_bits 4/6/8, "
        f"signed both ways; chooser, tiles {list(bsm.TILES)} with one "
        f"and the most K slices, blocks {BLOCKS})")
    try:
        bsm.bitserial_mvm(a[:64, :64].contiguous(), w[:64, :32].contiguous(),
                          block_m=64, block_n=32, block_k=64)
    except ValueError as e:
        log(f"tile (64,32) refused: {e}")
    else:
        raise AssertionError("a tile the kernel lacks was not refused")

    # int32 wrap-around: K*16384 = 2^31 + 16384 wraps to -2^31 + 16384
    k = (1 << 17) + 1
    a = torch.full((2, k), -128, dtype=torch.int8, device=dev)
    w = torch.full((k, 3), -128, dtype=torch.int8, device=dev)
    wrapped = (k * 16384 + 2**31) % 2**32 - 2**31
    for blocks in ((None, None, None), (16, 64, -(-k // bsm.BK) * bsm.BK)):
        kw = dict(zip(("block_m", "block_n", "block_k"), blocks))
        compare(a, w, **kw)
        got = cim_mvm(a, w, **kw)
        if not bool((got == wrapped).all()):
            raise AssertionError(f"wrap-around {blocks}: {got.tolist()}")
    log(f"int32 wrap-around (K = {k}) exact with split K "
        f"{bsm.choose_blocks(2, 3, k)} and one K slice")

    # 3. the main path, counted -----------------------------------------------
    chip = default_chip()
    launches_total = 0
    recorded = []                  # (path, a, w) of every MVM of a path
    for label, model, kw, batch in PATHS:
        t0 = time.perf_counter()
        art = flow.compile(model, chip, flow.CompileOptions(
            strategy="dp", batch=batch, workload_kw=kw))
        compile_s = time.perf_counter() - t0
        cg = art.cg
        n_dyn = sum(1 for g in cg if g.dynamic_weights)
        expected = len(cg) - n_dyn + batch * n_dyn
        bsm.bitserial_mvm.launches = 0
        t0 = time.perf_counter()
        rep = art.evaluate("func:torch", check=True, seed=args.seed)
        check_s = time.perf_counter() - t0
        launched = bsm.bitserial_mvm.launches
        log(f"{label}: {len(cg)} groups ({n_dyn} dynamic), compile "
            f"{compile_s:.2f} s, func:torch check=True {check_s:.2f} s, "
            f"{launched} launches (expected {expected})")
        if launched != expected:
            raise AssertionError(f"{label}: {launched} kernel launches, "
                                 f"expected {expected}")
        launches_total += launched
        outs = rep.outputs
        if sorted(outs) != [g.idx for g in cg]:
            raise AssertionError(f"{label}: outputs for {sorted(outs)}")
        last = outs[len(cg) - 1]
        if last.dtype.name != "int8" or last.shape[0] != batch:
            raise AssertionError(f"{label}: final output {last.dtype} "
                                 f"{last.shape}")
        if not any(o.any() for o in outs.values()):
            raise AssertionError(f"{label}: every output is zero")
        if n_dyn:
            # per-sample launches of the dynamic groups, counted at B > 1
            b2 = batch + 1
            w2, bb2, x2 = ref.random_init(cg, batch=b2, seed=args.seed,
                                          device=dev)
            expected2 = len(cg) - n_dyn + b2 * n_dyn
            bsm.bitserial_mvm.launches = 0
            rep2 = art.evaluate("func:torch", weights=w2, biases=bb2,
                                inputs=x2, check=True)
            launched2 = bsm.bitserial_mvm.launches
            log(f"{label} at batch {b2}: func:torch check=True, "
                f"{launched2} launches (expected {expected2})")
            if launched2 != expected2:
                raise AssertionError(f"{label} at batch {b2}: {launched2} "
                                     f"kernel launches, expected "
                                     f"{expected2}")
            last2 = rep2.outputs[len(cg) - 1]
            if last2.shape[0] != b2:
                raise AssertionError(f"{label} at batch {b2}: final "
                                     f"output {last2.shape}")
            report["paths"][f"{label} b{b2}"] = {"launches": launched2}

        # the same state for the timed runs and the operand recording
        w, b, x = ref.random_init(cg, batch=batch, seed=args.seed,
                                  device=dev)
        q = ref.auto_quant(cg, w, b, x)
        ops = []

        def record(a, m):
            ops.append((a.contiguous(), m.contiguous()))
            return ref.mvm_ref(a, m)

        want = ref.run_reference(cg, w, b, q, x, matmul=record)
        if len(ops) != expected:
            raise AssertionError(f"{label}: {len(ops)} MVMs recorded")
        recorded += [(label, a, m) for a, m in ops]

        # 5a. the path's time: evaluate with check=False, CUDA events
        def run_path():
            art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                         quant=q, check=False)

        def run_plain():
            ref.run_reference(cg, w, b, q, x)

        got = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                           quant=q, check=False).outputs
        for gid, arr in want.items():
            if not (got[gid] == arr.cpu().numpy()).all():
                raise AssertionError(f"{label}: group {gid} differs")
        t0 = time.perf_counter()
        path_ms = cuda_ms(run_path, REPS)
        host_ms = (time.perf_counter() - t0) * 1e3 / (REPS + 1)
        plain_ms = cuda_ms(run_plain, REPS)
        report["paths"][label] = {
            "groups": len(cg), "dynamic_groups": n_dyn, "batch": batch,
            "launches": launched, "compile_s": compile_s,
            "check_s": check_s, "evaluate_ms": path_ms,
            "evaluate_host_ms": host_ms, "plain_oracle_ms": plain_ms}
        log(f"{label}: evaluate(check=False) {path_ms:.3f} ms "
            f"(host clock {host_ms:.3f} ms), plain oracle forward "
            f"{plain_ms:.3f} ms")
        if args.profile:
            wall, busy, top = device_profile(run_path)
            report["paths"][label].update(
                profiled_wall_ms=wall, device_busy_ms=busy,
                top_device_events=top)
            log(f"{label}: traced run {wall:.3f} ms, device busy "
                f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
            for ms, count, name in top:
                log(f"  {ms:9.3f} ms  x{count:<4d} {name[:90]}")

    # 4. kernel vs plain version on the main path's own operands -------------
    for _, a, m in recorded:
        compare(a, m)
    log(f"kernel == plain on all {len(recorded)} main-path MVMs "
        f"(max |err| {max_err})")

    # 5b. per-MVM times ------------------------------------------------------
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    by_shape = {}
    for label, a, m in recorded:
        key = (label, a.shape[0], a.shape[1], m.shape[1])
        by_shape.setdefault(key, [a, m, 0])[2] += 1
    # Device time (graph_ms) is each call's own; issued time (cuda_ms,
    # "_issued") adds what the host spends launching it.
    tot = dict.fromkeys(("ms", "plain_ms", "library_ms", "ms_issued",
                         "plain_ms_issued", "library_ms_issued"), 0.0)
    tot["best_ms"] = 0.0

    def sweep_blocks(a, m):
        """``(block_m, block_n, split, ms)`` of the fastest tile and K
        split for these operands, over every tile and every distinct
        split; each configuration's result must equal the chooser's."""
        k = a.shape[1]
        want = cim_mvm(a, m)
        steps = -(-k // bsm.BK)
        pers = sorted({-(-steps // s) for s in range(1, steps + 1)})
        best = None
        for tbm, tbn in bsm.TILES:
            for per in pers:
                kw = dict(block_m=tbm, block_n=tbn, block_k=per * bsm.BK)
                if not torch.equal(cim_mvm(a, m, **kw), want):
                    raise AssertionError(f"{tuple(a.shape)}x{tuple(m.shape)}"
                                         f" {kw} differs from the chooser's")
                t = graph_ms(lambda: cim_mvm(a, m, **kw), REPS)
                if best is None or t < best[3]:
                    best = (tbm, tbn, -(-steps // per), t)
        return best
    log("path  M  K  N  count  tile  split  kernel_ms  plain_ms  bound_ms  "
        "bound_by  int_mm_ms  kernel/bound  |  issued: kernel_ms  "
        "int_mm_ms  |  best of all: tile split kernel_ms")
    for (label, mm, kk, nn), (a, m, count) in by_shape.items():
        ia, iw = int_mm_operands(a, m)
        fns = {"ms": lambda: cim_mvm(a, m),
               "plain_ms": lambda: bitserial_mvm_ref(a, m),
               "library_ms": lambda: torch._int_mm(ia, iw)}
        b_ms, b_by = bound([(mm, kk, nn)])
        bm, bn, bk = bsm.choose_blocks(mm, nn, kk, sms)
        split = -(-kk // bk)
        row = {"path": label, "M": mm, "K": kk, "N": nn, "count": count,
               "tile": [bm, bn], "block_k": bk, "split": split,
               "bound_ms": b_ms, "bound_by": b_by}
        for key, fn in fns.items():
            row[key] = graph_ms(fn, REPS)
            row[key + "_issued"] = cuda_ms(fn, REPS)
        best = sweep_blocks(a, m)
        row["best"] = {"tile": list(best[:2]), "split": best[2],
                       "ms": best[3]}
        report["shapes"].append(row)
        for key in fns:
            tot[key] += count * row[key]
            tot[key + "_issued"] += count * row[key + "_issued"]
        tot["best_ms"] += count * best[3]
        log(f"{label} {mm} {kk} {nn} {count} {bm}x{bn} {split} "
            f"{row['ms']:.4f} {row['plain_ms']:.4f} {b_ms:.6f} {b_by} "
            f"{row['library_ms']:.4f} {row['ms'] / b_ms:.0f}  |  "
            f"{row['ms_issued']:.4f} {row['library_ms_issued']:.4f}  |  "
            f"{best[0]}x{best[1]} {best[2]} {best[3]:.4f}")
    tot["bound_ms"], bound_all_by = bound(
        [(a.shape[0], a.shape[1], m.shape[1]) for _, a, m in recorded])
    report["totals"] = tot
    log(f"sum over the main path's {len(recorded)} MVMs, device time: "
        f"kernel {tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound "
        f"{tot['bound_ms']:.4f} ms, torch._int_mm {tot['library_ms']:.3f} "
        f"ms; issued from Python: kernel {tot['ms_issued']:.3f} ms, plain "
        f"{tot['plain_ms_issued']:.3f} ms, torch._int_mm "
        f"{tot['library_ms_issued']:.3f} ms; the best tile and split of "
        f"each shape: kernel {tot['best_ms']:.3f} ms [{card}]")

    kernels = [{
        "name": "bitserial_mvm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/bitserial_mvm.cu",
        "replaces": "src/repro/kernels/bitserial_mvm.py:45",
        "launches": launches_total,
        "max_abs_err": max_err,
        "ms": tot["ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": bound_all_by,
        "library_ms": tot["library_ms"],
    }]
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log("kernels: bitserial_mvm (cuda, sm_90a)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
