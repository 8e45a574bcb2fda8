#!/usr/bin/env python3
"""Variants of the flash attention's Hopper source, timed on one GPU.

    python3 scripts/flash_attention_probe.py [--out probe.json]

Builds ``src/repro_torch/kernels/csrc/flash_attention_sm90.cu`` as it is
and as each of ``VARIANTS`` (a string replacement of the source: a design
choice its note names, set the other way), one ``nvcc`` each, all started
together; swaps each library in through the wrapper's ``_SM90_LIB`` and,
at the bf16 cases of ``chip_smoke.py`` phase 14 named in ``CASES``, checks
each against the fp32 plain masked softmax and its autograd
(``chip_smoke.fa_fp32_reference``, phase 14's limits) and times its
forward and forward + backward by CUDA-graph replay
(``chip_smoke.fa_ms``), one process, the variants in turns on the same
inputs, beside the ``mma`` route (``flash_attention.cu``) and SDPA's flash
backend; the kernel's and each variant's device time by kernel (forward,
delta, dK/dV, dQ) from one ``torch.profiler`` trace.  Then the kernel
alone at ``EDGES`` (one key tile, odd lengths, windows, ``q_pos0``,
D 16, 120 and 192 / 128) against the same reference.  Prints one JSON line a
measurement, the card's name and power limit first.  Needs a CUDA device
(exits 2 without one).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_TURNS = '''__device__ __forceinline__ void take_turn(int wg) {
  if (wg == 0)
    asm volatile("bar.sync 1, 256;\\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 256;\\n" ::: "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  if (wg == 0)
    asm volatile("bar.arrive 2, 256;\\n" ::: "memory");
  else
    asm volatile("bar.arrive 1, 256;\\n" ::: "memory");
}'''

# dK/dV's tile as one wait, then P^T and dS^T, then dV and dK issued
# together (the kernel) ...
_DKDV_SERIAL = """    gemm_ss<BQ, DP / 16>(st, ka, S::kKBox, qs, S::kQBox);
    gemm_ss<BQ, DVP / 16>(dpt, va, S::kKBox, os, S::kQBox);
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<0>();
    fence_regs<BQ / 2>(st);
    fence_regs<BQ / 2>(dpt);
"""
_DKDV_SERIAL_TAIL = """      const float pt = ok ? exp2f(fmaf(st[i], p.scale_log2, -lse2[c])) : 0.f;
      st[i] = pt;
      dpt[i] = pt * (dpt[i] - dl[c]);
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_frags<BQ / 16>(st, pa);
    to_frags<BQ / 16>(dpt, da);
    fence_regs<DVP / 2>(dv);
    fence_regs<DP / 2>(dk);
    take_turn(wg);
    wgmma_fence();
    gemm_rs<DVP, BQ / 16>(dv, pa, os, S::kQBox);
    gemm_rs<DP, BQ / 16>(dk, da, qs, S::kQBox);
    wgmma_commit();
"""
# ... or overlapped: P^T computed while dP^T is in flight, dV issued
# while dS^T is computed
_DKDV_OVERLAP = """    gemm_ss<BQ, DP / 16>(st, ka, S::kKBox, qs, S::kQBox);
    wgmma_commit();
    gemm_ss<BQ, DVP / 16>(dpt, va, S::kKBox, os, S::kQBox);
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<1>();
    fence_regs<BQ / 2>(st);
"""
_DKDV_OVERLAP_TAIL = """      st[i] = ok ? exp2f(fmaf(st[i], p.scale_log2, -lse2[c])) : 0.f;
    }
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
    to_frags<BQ / 16>(st, pa);
    wgmma_wait<0>();
    fence_regs<BQ / 2>(dpt);
    fence_regs<DVP / 2>(dv);
    take_turn(wg);
    wgmma_fence();
    gemm_rs<DVP, BQ / 16>(dv, pa, os, S::kQBox);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i)
      dpt[i] = st[i] * (dpt[i] - dl[8 * (i >> 2) + 2 * t + (i & 1)]);
    to_frags<BQ / 16>(dpt, da);
    fence_regs<DP / 2>(dk);
    wgmma_fence();
    gemm_rs<DP, BQ / 16>(dk, da, qs, S::kQBox);
    wgmma_commit();
"""


def _fwd_3_stages(src: str) -> str:
    """3 K and V tiles in flight in the forward up to D 128 (2 at 192)."""
    head, rest = src.split("template <int DP, int DVP>\nstruct FwdShape", 1)
    shape, rest = rest.split("// --- backward", 1)
    old = ("  static constexpr int kSmem =\n"
           "      kQBytes + kFwdStages * (kKBytes + kVBytes) + 1024;")
    if old not in shape:
        raise ValueError("fwd_3_stages: the forward's kSmem not found")
    shape = shape.replace(old, (
        "  static constexpr int kStages = DP > 128 ? 2 : 3;\n"
        "  static constexpr int kSmem =\n"
        "      kQBytes + kStages * (kKBytes + kVBytes) + 1024;"))
    shape = shape.replace("kFwdStages", "S::kStages")
    return (head + "template <int DP, int DVP>\nstruct FwdShape" + shape
            + "// --- backward" + rest)


VARIANTS = {
    # the consumer warpgroups issue their products whenever they are ready
    "no_pingpong": [(_TURNS, "__device__ __forceinline__ void take_turn(int) {}"
                             "\n__device__ __forceinline__ void pass_turn(int) {}")],
    # 3 K and V tiles in flight in the forward (2)
    "fwd_3_stages": _fwd_3_stages,
    # 2 Q / dO and K / V tiles in flight in the backward's kernels (3)
    "bwd_2_stages": [("constexpr int kBwdStages = 3;",
                      "constexpr int kBwdStages = 2;"),
                     ("constexpr int kDqStages = 3;",
                      "constexpr int kDqStages = 2;")],
    # dK/dV: P^T while dP^T is in flight, dV issued while dS^T is computed
    "dkdv_overlap": [(_DKDV_SERIAL, _DKDV_OVERLAP),
                     (_DKDV_SERIAL_TAIL, _DKDV_OVERLAP_TAIL)],
}
# phase 14 cases, and the variants timed at each
CASES = [("phi4-mini B4 S2048", tuple(VARIANTS)),
         ("phi4-mini B1 S32768", tuple(VARIANTS)),
         ("deepseek-v3 MLA S4096", ("no_pingpong", "fwd_3_stages",
                                    "bwd_2_stages")),
         ("danube S8192 w4096", ("no_pingpong",))]
# the kernel alone: (label, B, Sq, Sk, KV, G, D, Dv, causal, window,
# q_pos0, dtype), phase 14's layout
EDGES = [
    ("one key tile D64", 1, 128, 128, 1, 1, 64, 64, True, None, 0),
    ("S300 KV2 G2 D128 w100", 1, 300, 300, 2, 2, 128, 128, True, 100, 0),
    ("q_pos0 256", 2, 200, 456, 2, 3, 128, 128, True, None, 256),
    ("cross D64", 2, 100, 333, 3, 1, 64, 64, False, None, 0),
    ("D120 w200", 1, 500, 500, 2, 2, 120, 120, True, 200, 0),
    ("MLA S300", 1, 300, 300, 4, 1, 192, 128, True, None, 0),
    ("D16", 1, 130, 130, 1, 1, 16, 16, True, None, 0),
]


def build(name: str):
    """The library of the source with ``name``'s replacements."""
    from repro_torch.kernels import flash_attention as FA, nvcc
    src = FA.SOURCE_SM90.read_text()
    change = VARIANTS.get(name, [])
    if callable(change):
        src = change(src)
    for old, new in [] if callable(change) else change:
        if old not in src:
            raise ValueError(f"{name}: {old[:60]!r} not in the source")
        src = src.replace(old, new)
    path = nvcc.BUILD_DIR / "probe" / f"flash_attention_sm90_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return FA.load_sm90(FA.build_library(path))


def kernel_ms(fn, reps: int = 3) -> dict:
    """Device ms a call by kernel, from one ``torch.profiler`` trace of
    ``reps`` calls after a warm-up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        name = next((k for k in ("fwd_kernel", "delta_kernel", "dkdv_kernel",
                                 "dq_kernel") if k in e.key), None)
        if t and name:
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("flash_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as FA

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    names = ["kernel"] + list(VARIANTS)
    with ThreadPoolExecutor(len(names) + 1) as pool:
        mma = pool.submit(FA.build_library)
        libs = dict(zip(names, pool.map(build, names)))
        mma.result()
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    from repro_torch.kernels import nvcc
    for name in names:     # ptxas: registers, spills, serialised wgmma
        for line in nvcc.BUILD_LOGS.get(f"flash_attention_sm90_{name}",
                                        "").splitlines():
            if "Potential" in line or ("spill" in line
                                       and not line.strip().startswith("0")):
                print(json.dumps({"variant": name, "ptxas": line.strip()}),
                      flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(dev).manual_seed(args.seed)
    rows = []

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    def check(case, q, k, v, do, want):
        causal, window, q_pos0, dt = case[8:12]
        o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal, window, q_pos0)
        grads = FA.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal,
                                            window, q_pos0)
        out = {"O": cs.needed_share(o, want[0], cs.FA_TOL_F32[dt][1])}
        for name, got, w in zip(("dq", "dk", "dv"), grads, want[2:]):
            out[name] = cs.needed_share(got, w, cs.FA_TOL_GRAD[dt][1])
        ok = cs.scaled_within(o, want[0], *cs.FA_TOL_F32[dt])[2] and all(
            cs.scaled_within(g, w, *cs.FA_TOL_GRAD[dt])[2]
            for g, w in zip(grads, want[2:]))
        return out, ok

    cases = {c[0]: c for c in cs.FA_CASES}
    for label, variants in CASES:
        case = cases[label]
        causal, window, q_pos0 = case[8:11]
        q, k, v, do = cs.fa_inputs(case, gen, dev)
        want = cs.fa_fp32_reference(q, k, v, do, causal, window, q_pos0)
        bounds = cs.fa_bound(case)
        for name in ("kernel",) + variants:
            FA._SM90_LIB = libs[name]
            shares, ok = check(case, q, k, v, do, want)
            emit({"case": label, "variant": name, "correct": ok,
                  "share_needed": shares})
        lib = cs.fa_sdpa(q, k, v, do, causal) if window is None \
            and q_pos0 == 0 and case[6] == case[7] else None
        turns = ["mma", "kernel", *variants, *reversed(variants), "kernel",
                 "mma"]
        for name in turns:
            rt = "mma" if name == "mma" else "sm90"
            if rt == "sm90":
                FA._SM90_LIB = libs[name]
            fwd = lambda: FA.flash_attention_fwd_cuda(  # noqa: E731
                q, k, v, causal, window, q_pos0, route=rt)
            fwd_bwd = lambda: FA.flash_attention_bwd_cuda(  # noqa: E731
                q, k, v, *fwd(), do, causal, window, q_pos0, route=rt)
            row = {"case": label, "variant": name, "route": rt,
                   "fwd_ms": cs.fa_ms(fwd, dev), "ms": cs.fa_ms(fwd_bwd, dev),
                   "fwd_bound_ms": bounds["fwd"][0],
                   "bound_ms": bounds["fwd_bwd"][0]}
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
            row["fwd_share_of_bound"] = row["fwd_bound_ms"] / row["fwd_ms"]
            if rt == "sm90" and name not in [r["variant"] for r in rows
                                             if r["case"] == label
                                             and "by_kernel_ms" in r]:
                row["by_kernel_ms"] = kernel_ms(fwd_bwd)
            emit(row)
        if lib is not None:
            emit({"case": label, "variant": "sdpa",
                  "fwd_ms": cs.cuda_ms(lib[0], cs.FA_REPS),
                  "ms": cs.cuda_ms(lib[1], cs.FA_REPS)})
        del q, k, v, do, want, lib
        torch.cuda.empty_cache()
    FA._SM90_LIB = libs["kernel"]
    for edge in EDGES:
        case = edge + ("bfloat16",)
        causal, window, q_pos0 = case[8:11]
        q, k, v, do = cs.fa_inputs(case, gen, dev)
        want = cs.fa_fp32_reference(q, k, v, do, causal, window, q_pos0)
        shares, ok = check(case, q, k, v, do, want)
        emit({"case": edge[0], "variant": "kernel", "correct": ok,
              "share_needed": shares})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
