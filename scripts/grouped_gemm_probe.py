#!/usr/bin/env python3
"""Variants of the grouped GEMM's Hopper source, timed on one GPU.

    python3 scripts/grouped_gemm_probe.py [--out probe.json]

Builds ``src/repro_torch/kernels/csrc/grouped_gemm_sm90.cu`` as it is and
as each of ``VARIANTS`` (a string replacement of the source: the design
choices its note names, set the other way, and ablations that drop one
part of the work), one ``nvcc`` each, all started together; swaps each
library in through the wrapper's ``_SM90_LIB`` and times it by CUDA-graph
replay (``chip_smoke.graph_ms``) at ``chip_smoke.py`` phase 12's shapes,
one process, one variant after another on the same operands, each checked
against the plain version within ``GG_TOL`` (an ablation's wrong output is
reported, not raised).  Then the stream route against the wgmma route for
the forward over buffers of 40 to 640 rows at olmoe-1b-7b's and
deepseek-v3's widths (the threshold ``STREAM_MAX_M``).  Prints one JSON
line a measurement, the card's name and power limit first.  Needs a CUDA
device (exits 2 without one).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# the kernel's first epilogue: bf16 pairs stored from registers (8 rows
# of 16 bytes a warp instruction), no staging, 4 stages
_REGISTER_EPILOGUE = '''      bf16* C = static_cast<bf16*>(p.c);
      int r_hi, ldc;
      if (MODE == kDw) {
        C += static_cast<long long>(it.g) * p.K * p.N;
        r_hi = p.K;
        ldc = p.N;
      } else {
        r_hi = min(it.r0 + kBM, it.r_end);
        ldc = ncols;
      }
      const int rrow0 = it.r0 + 64 * wg + 16 * wl + (lane >> 2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rrow0 + 8 * h;
        if (row < r_hi) {
          bf16* out = C + static_cast<long long>(row) * ldc;
#pragma unroll
          for (int j = 0; j < kBN / 8; ++j) {
            const int col = it.c0 + 2 * (lane & 3) + 8 * j;
            if (col < ldc)
              *reinterpret_cast<__nv_bfloat162*>(out + col) =
                  __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                        acc[4 * j + 2 * h + 1]);
          }
        }
      }
      continue;
'''

VARIANTS = {
    # the design choices, set the other way
    "register_epilogue": [
        ("      const int wt = threadIdx.x & 127;   // thread in its warpgroup\n",
         _REGISTER_EPILOGUE
         + "      const int wt = threadIdx.x & 127;   // thread in its warpgroup\n"),
        ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
        ("constexpr int kWgSmem = kStages * kStageBytes + 2 * kOutBytes + 1024;",
         "constexpr int kWgSmem = kStages * kStageBytes + 1024;")],
    "tile_128x128": [("constexpr int kBN = 256;", "constexpr int kBN = 128;"),
                     ("constexpr int kStages = 3;", "constexpr int kStages = 5;")],
    "row_major": [("""  it.c0 = (local / nt) * bn;
  it.r0 = s_off[lo] + (local % nt) * kTile;""", """  it.c0 = (i - slot * nct) * bn;
  it.r0 = s_off[lo] + (slot - s_tile[lo]) * kTile;""")],
    "strips_32": [("constexpr int kSWide = 6;", "constexpr int kSWide = 1 << 20;")],
    "strips_64": [("constexpr int kSWide = 6;", "constexpr int kSWide = 0;")],
    # ablations: the same walk with one part of the work left out
    "no_epilogue": [("      if (wt == 0) bulk_wait_read();",
                     "      if (p.M >= 0) continue;\n"
                     "      if (wt == 0) bulk_wait_read();")],
    "no_mma": [("        for (int kk = 0; kk < kBK / 16; ++kk) {",
                "        for (int kk = 0; kk < kBK / 16 && p.M < 0; ++kk) {")],
    "no_loads": [("          mbar_expect_tx(bar, kStageBytes);",
                  "          mbar_arrive(bar);\n"
                  "          if (p.M >= 0) {\n"
                  "            if (++stage == kStages) {\n"
                  "              stage = 0;\n"
                  "              phase ^= 1;\n"
                  "            }\n"
                  "            continue;\n"
                  "          }")],
}
# (phase 12 case, projection, products, variants)
TRAIN = ("olmoe train B 4 x S 2048", ("up", "down"), ("fwd", "dx", "dw"),
         ("register_epilogue", "tile_128x128", "row_major", "no_epilogue",
          "no_mma", "no_loads"))
PLAN = [TRAIN,
        ("deepseek-v3 T 4096", ("up",), ("fwd", "dx"),
         ("register_epilogue", "row_major")),
        ("olmoe decode B 4", ("up", "down"), ("fwd",),
         ("strips_32", "strips_64")),
        ("deepseek-v3 T 4", ("up",), ("fwd", "dw"),
         ("strips_32", "strips_64", "register_epilogue")),
        ("jamba-1.5 T 4", ("up",), ("fwd", "dw"),
         ("strips_32", "strips_64", "register_epilogue"))]
# the threshold: (groups, d_model, expert d_ff, top-k), tokens at B x 1
SWEEP = [((64, 2048, 1024, 8), (4, 8, 16, 24, 32, 64)),
         ((256, 7168, 2048, 8), (4, 8, 16, 24, 32, 64))]


def build(name: str) -> ctypes.CDLL:
    """The library of the source with ``name``'s replacements."""
    from repro_torch.kernels import grouped_gemm as GG, nvcc
    src = GG.SM90_SOURCE.read_text()
    for old, new in VARIANTS.get(name, []):
        if old not in src:
            raise ValueError(f"{name}: {old[:60]!r} not in the source")
        src = src.replace(old, new)
    path = nvcc.BUILD_DIR / "probe" / f"grouped_gemm_sm90_{name}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    lib = ctypes.CDLL(str(nvcc.build_library(path)))
    c_int, c_ptr = ctypes.c_int, ctypes.c_void_p
    lib.grouped_gemm_sm90_launch.argtypes = (
        [c_int, c_int] + [c_ptr] * 4 + [c_int] * 4 + [c_ptr])
    lib.grouped_gemm_sm90_launch.restype = c_int
    lib.grouped_gemm_sm90_error_string.argtypes = [c_int]
    lib.grouped_gemm_sm90_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("grouped_gemm_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import grouped_gemm as GG

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    names = ["kernel"] + list(VARIANTS)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(args.seed)
    dgen = torch.Generator(dev).manual_seed(args.seed)
    tol = cs.GG_TOL["bfloat16"]
    rows = []

    def operands(groups, d, f, tokens, top_k, part):
        sizes, hits, cap = cs.gg_group_sizes(groups, tokens, top_k, gen, dev)
        k, n = (d, f) if part == "up" else (f, d)
        x = torch.randn((cap, k), generator=dgen, device=dev,
                        dtype=torch.bfloat16)
        w = torch.randn((groups, k, n), generator=dgen, device=dev,
                        dtype=torch.bfloat16) * k ** -0.5
        dy = torch.randn((cap, n), generator=dgen, device=dev,
                         dtype=torch.bfloat16)
        return sizes, hits, cap, k, n, x, w, dy

    def timed(label, variant, mode, a, b, sizes, route, want, bound):
        GG._SM90_LIB = libs[variant]
        fn = lambda: GG.ragged_dot_cuda(mode, a, b, sizes,  # noqa: E731
                                        route=route)
        got = fn()
        torch.cuda.synchronize()
        _, rel, ok = cs.gg_check(label, got, want, sizes, mode, tol,
                                 fault=True)
        out_bytes = got.numel() * got.element_size()
        del got
        ms = cs.gg_timing_ms(fn, out_bytes, dev)
        row = {"case": label, "product": ["fwd", "dx", "dw"][mode],
               "variant": variant, "route": route, "ms": ms,
               "bound_ms": bound, "share_of_bound": bound / ms,
               "correct": ok, "err_over_rms": rel, "card": card}
        rows.append(row)
        print(json.dumps(row), flush=True)

    cases = {c[0]: c for c in cs.GG_CASES}
    for label, parts, products, variants in PLAN:
        _, groups, d, f, tokens, top_k, _ = cases[label]
        for part in parts:
            sizes, hits, cap, k, n, x, w, dy = operands(groups, d, f, tokens,
                                                        top_k, part)
            nonempty = int((sizes > 0).sum())
            for name in products:
                mode = ["fwd", "dx", "dw"].index(name)
                a, b, ref = [(x, w, GG.ragged_dot_ref),
                             (dy, w, GG.ragged_dot_dx_ref),
                             (x, dy, GG.ragged_dot_dw_ref)][mode]
                want = ref(a, b, sizes)
                bound = cs.gg_bound(mode, hits, cap, k, n, groups, nonempty,
                                    2, cs.PEAK_BF16_OPS)[0]
                route = GG.route(mode, torch.bfloat16, cap, k, n, True)
                runs = ["kernel"] + [v for v in variants
                                     if route == "stream"
                                     or not v.startswith("strips")]
                for v in runs + ["kernel"]:
                    timed(f"{label} {part}", v, mode, a, b, sizes, route,
                          want, bound)
                del want
            del x, w, dy
            torch.cuda.empty_cache()
    for (groups, d, f, top_k), token_counts in SWEEP:
        for tokens in token_counts:
            sizes, hits, cap, k, n, x, w, _ = operands(groups, d, f, tokens,
                                                       top_k, "up")
            want = GG.ragged_dot_ref(x, w, sizes)
            bound = cs.gg_bound(GG.FWD, hits, cap, k, n, groups,
                                int((sizes > 0).sum()), 2,
                                cs.PEAK_BF16_OPS)[0]
            for route in ("stream", "wgmma", "stream"):
                timed(f"G {groups} K {k} N {n}, M {cap}", "kernel", GG.FWD,
                      x, w, sizes, route, want, bound)
            del x, w, want
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
