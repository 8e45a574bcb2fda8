#!/usr/bin/env python3
"""Smoke run of the ``repro_torch`` port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile]

Phases (none catches its own failure; any mismatch raises and the
script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, each in its own thread, all started together) while Triton
   compiles the SSD step's variants phase 10 launches
   (:func:`build_triton_kernels`), timed as set-up;
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
   device's busy share and its top kernels;
6. the simulate fidelity, on the paper's benchmark (resnet18@224,
   batch 4, ``default_chip()``, ``strategy="dp"``) and the transformer
   (batch 1): compile at ``fidelity="simulate"`` (codegen timed), run
   the ISS with ``engine="vector"`` (numpy) and with its default
   engine, ``"torch"`` (the stage decode as tensor code on the card),
   and require identical cycles, stage_cycles, events, unit_busy and
   instrs, and every stage of every torch run decoded by one pass on
   the card (none left to the scalar interpreter); split the vector
   engine's time into decode and replay and the torch engine's into
   the stage passes' device ms (CUDA events), the host<->device copy
   ms and the host finish s; record peak device memory.  On resnet18,
   evaluate 16 chips that differ only in timing constants with
   ``FleetEvaluator`` (one batched decode per stage, each on the card)
   and require each payload to equal that chip's own
   ``engine="vector"`` run, timed against that loop; evaluate the
   trace backend once;
7. design-space exploration and faults, on resnet18@224 (batch 4):
   (a) ``python -m repro_torch.explore``'s ``main`` sweeps the 64-point
   timing space (``--strategies dp``) at simulate fidelity on the fleet
   (``--engine torch``, no result cache): every record equals that
   chip's own ``engine="vector"`` run of the pinned program, none
   carries an error, and each stage is decoded by one pass on the card
   (s per point; the fleet's device, copy and host times); (b) its
   successive halving (mg-flit space, top 3, calibrated from 2
   simulator runs, no cache): 5 simulator runs on the card's ``torch``
   engine, every stage decoded there, no error record, each promoted
   record equal to an ``engine="vector"`` run of its point; (c)
   ``faults.degradation_curve`` on the configuration
   ``benchmarks/bench_faults.py`` pins (tiny_cnn, res 8, c 8, batch 2,
   seed 0) on the card reproduces ``BENCH_faults.json``'s degradation
   rows and clean-output hash exactly; (d) ``evaluate("func:torch",
   check=True, faults=...)`` for ``FAULT_MODELS`` (stuck-at 1e-3, and
   1e-2 with transient flips) with the kernel's launches counted per run
   (21), the ms of each faulty run against a clean one, then
   ``degradation_curve`` over ``FAULT_RATES`` (BER, top-1 agreement);
8. the mesh of chips (:func:`mesh_phase`), on the transformer
   ``BENCH_system.json`` pins: (a) trace fidelity on 1 chip and 2/4/8-chip
   pipeline and tensor meshes (link ``pcb``) equal to its rows at 9
   decimals (at its batch of 32); (b) ``SystemArtifact.evaluate(
   "simulate")`` on 2- and 4-chip pipeline meshes at batch 1, every chip
   slice decoded on the card, equal to ``engine="vector"`` chip by chip
   (best of 3 each, the decode split); (c) a 4-mesh with slot 2, then
   slot 1 failed: the re-plan conserves the work and avoids the slot,
   trace and simulate (batch 1) report the degradation, torch == vector;
   (d) ``SystemArtifact.run_func`` (``tiny_cnn`` on 2 and 4 chips, the
   degraded 4-mesh, a one-layer d128 transformer on 2; batch 2) equal,
   element for element, to ``run_reference`` with the kernel (its
   launches counted) and to the plain oracle; (e) the explore engine's
   6-point mesh sweep at trace fidelity, each record equal to a direct
   evaluation, scale-out helping, then all from its cache;
9. serving (:func:`serve_phase`): (a) ``BENCH_serving.json`` rebuilt
   with the port (policies, engine equivalence, prefill policies, the
   large trace's digest and decode iterations); (b) ``python -m
   repro_torch.serve --fidelity simulate --chips 2 --policy both
   --requests 200``: each bucket's costs equal the same artifacts on the
   vector engine, the event and array engines' metrics JSON equal (the
   second run from the table cache); (c) deadlines, shedding and retries
   on that table, two runs byte-identical.

10. LM serving (``python -m repro_torch.launch.serve``) and its kernels:
   (a) each new kernel against its plain version on the card —
   ``gqa_decode_attention`` (CUDA, one launch a call) at phi4-mini's
   heads (KV 8, G 3, D 128) for (B, S_cache) = (2, 8), (4, 64), (32, 4096), (8, 32768) and
   h2o-danube's (D 120, window 4096, 4096- and 5120-slot rings) before
   and after one and two wraps, bf16 and INT8 caches (and float32 at
   (2, 8)), within ``ATTN_TOL_F32`` of the plain version on fp32 inputs
   and ``ATTN_TOL_REF`` of it in the reference's dtypes, both scaled to
   each case's rms, with a planted fault that must fail at 4096 slots and
   up, timed beside its bytes bound and
   ``scaled_dot_product_attention`` (GQA) on the bf16 cache, each case's
   splits and launches per call (1) recorded; two multi-split calls of
   the (8, 32768) bf16 case captured in one CUDA graph and replayed 3
   times, equal to eager calls (the split combine's ticket counters put
   themselves back), the last replay after an eager multi-split call of
   a larger B * KV (the counters stay where the graph saw them);
   ``ssd_decode_step`` (Triton) at mamba2-780m's 48 heads, d_state 128,
   head_dim 64 for B = 2, 4 and 128 (bf16 state), within ``SSD_TOL_*``;
   ``int8_matmul`` (``ops.int8_matmul``, routed by its planner) bit-exact
   to ``cim_mvm`` on the 55 MVMs of phase 3 (summed beside the tile route,
   the bit-serial source's one-pass tiles, and ``torch._int_mm``); the
   stream kernel (CUDA, ``csrc/int8_matmul.cu``) at ``QL_SHAPES``, each
   plan asserted as ``STREAM_PLANS``, bit-exact to ``cim_mvm`` and to its
   plain split algorithm, timed one by one hot (graph replay of the same
   operands) and cold (the weight read from HBM) beside the tile route in
   the same call (which it must beat), ``torch._int_mm`` and its bound;
   the edge cases ``I8_EDGES`` and the int32 wrap-around on the stream
   route, the wrap-around on the tiles with one K slice and split K, a
   CUDA-graph replay of the four shapes equal to eager calls, and the
   floor of a graph-replayed stream launch; (b)
   phi4-mini-3.8b and mamba2-780m at published widths and vocabularies,
   cut to 2 layers: 8 teacher-forced decode steps with the kernels on
   the card and the plain versions on the CPU, logits within
   ``LOGIT_TOL`` of their range, argmax agreement reported; (c)
   ``repro_torch.launch.serve.main`` at full depth, batch 4, 32 + 32
   tokens: phi4-mini greedy with a bf16 and an INT8 KV cache
   (``tuning.tuned(int8_kv_cache=True)``) and the default mamba2-780m,
   each with the decode kernels' launches counted (one per attention or
   SSD layer per token), its prefill s, decode s and tok/s, peak device
   memory and the device-busy share of 8 steady decode steps (one
   ``torch.profiler`` trace); (d) ``quantized_linear`` driven at
   phi4-mini's decode projections, both routes equal to each other and to
   ``quantized_linear_ref`` (tolerance 0) and the backward, with
   ``int8_matmul``'s launches counted by route (all 4 on the stream
   route) and the bit-serial kernel's.

The ``launches`` of the ``kernels`` record count the main paths: the
bit-serial kernel's those of phases 3, 7, 8 and 10d, ``int8_matmul``'s
10d's, the decode kernels' 10c's.  Each record's times are device times
(CUDA-graph replay): the bit-serial kernel summed over the 55 MVMs of
phase 3; ``int8_matmul`` summed over ``QL_SHAPES`` with the weight read
cold from HBM, as a decode step reads it (``previous_ms``: the tile
route; ``ms_l2_resident``: the same operands replayed, the weight in
L2; ``ms_55``: over the 55 MVMs of phase 3, the entry's definition
before the stream kernel); the decode attention at 10c's shape (B 4,
64 slots, bf16, the last position); the SSD step at B 4.  The
second-to-last line is the ``{"kernels": [...]}`` JSON record and the
last line ``{"ok": true, "device": {...}}``.  Exits non-zero
without printing a result when no CUDA device is present or when the
port's sources are not beside this script.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
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
N_FLEET = 16                  # timing variants in the fleet phase
REPS_SIM = 3                  # timed runs of each simulate engine
# phase 7: the DSE sweeps, and the faults at full width (7d)
EXPLORE_PATH = ("resnet18@224", "resnet18", {"res": 224}, 4)
FAULT_MODELS = [{"rate": 1e-3}, {"rate": 1e-2, "transient_rate": 1e-5}]
FAULT_RATES = (0.0, 1e-3, 1e-2)
# 7c: the configuration benchmarks/bench_faults.py pins (BENCH_faults.json)
GOLDEN_FAULTS = ("tiny_cnn", {"res": 8, "c": 8}, 2, 0)
# phase 8: the mesh, on the transformer BENCH_system.json pins (4 layers,
# d_model 512, 8 heads, seq 128, vocab 32000; link "pcb"; its rows are
# at CostParams' default batch of 32)
MESH_LINK = "pcb"
MESH_SIM = (2, 4)             # 8b: pipeline meshes at simulate fidelity
# 8b/8c simulate at batch 1, as phase 6 does: at batch 32 codegen takes
# about 2 min a mesh and one vector-engine run about 1 min
MESH_SIM_BATCH = 1
# 8c: the failed slot of a 2x2 mesh; at full width the pipeline keeps
# slots 0 and 1, so slot 2 fails beside the plan and slot 1 inside it
MESH_FAILED = (2, 1)
# 8d: multi-chip func runs at the sizes the functional ISS can hold (the
# transformer of tests/test_system.py: 1 layer, d_model 128, seq 16);
# (label, workload, workload_kw, chips, failed chips), batch 2
SMALL_TF = {"n_layers": 1, "d_model": 128, "n_heads": 4, "seq": 16,
            "vocab": 64}
MESH_FUNC = [("tiny_cnn x2", "tiny_cnn", {}, 2, ()),
             ("tiny_cnn x4", "tiny_cnn", {}, 4, ()),
             ("tiny_cnn x4, slot 2 failed", "tiny_cnn", {}, 4, (2,)),
             ("transformer 1L d128 x2", "transformer", SMALL_TF, 2, ())]
# phase 9a: the constants of benchmarks/bench_serve.py (BENCH_serving.json)
SERVE_MODEL = {"n_layers": 2, "d_model": 128, "n_heads": 4, "vocab": 256,
               "max_prompt": 64, "max_new": 64}
SERVE_MAX_BATCH = 8
SERVE_FAULT = {"rate": 300000.0, "n": 200, "seed": 1}
SERVE_FAULT_KW = {"deadline_s": 0.002, "max_queue": 4, "max_retries": 2,
                  "retry_backoff_s": 0.0005}
SERVE_PREFILL = {"rate": 9000.0, "n": 3000, "seed": 11, "min_prompt": 33,
                 "max_prompt": 64, "min_new": 2, "max_new": 8}
SERVE_PREFILL_RUN = {"max_batch": 16, "chunk_tokens": 64}
SERVE_LARGE = {"rate": 5000.0, "n": 120_000, "seed": 9, "min_prompt": 4,
               "max_prompt": 64, "min_new": 16, "max_new": 1024}
SERVE_GATED = ("tokens", "throughput_tok_s", "throughput_req_s",
               "decode_iterations", "peak_decode_batch", "kv_peak_bytes")
# 9b: the serving CLI at simulate fidelity on a 2-chip pipeline mesh
SERVE_CLI = ["--fidelity", "simulate", "--chips", "2", "--policy", "both",
             "--requests", "200"]
# phase 10: LM serving (python -m repro_torch.launch.serve) and its kernels
PEAK_BF16_OPS = 989e12        # H100 SXM dense bf16 tensor-core peak
PEAK_F32_OPS = 67e12          # H100 SXM fp32 outside the tensor cores
# 10a decode attention: (arch, KV heads, G = H / KV, head_dim, window) and
# (B, S_cache, positions); phi4-mini's (4, 64) is 10c's serving shape,
# (2, 8) 10b's
ATTN_PHI4 = ("phi4-mini", 8, 3, 128, None)
ATTN_DANUBE = ("h2o-danube", 8, 4, 120, 4096)
ATTN_PHI4_CASES = [(2, 8, (7, 3)), (4, 64, (63, 37)),
                   (32, 4096, (4095, 2053)), (8, 32768, (32767,))]
# danube's 4096-slot ring (window 4096): before the wrap, after one, two;
# and a 5120-slot ring under the same window, whose valid stretch crosses
# the ring's edge after a wrap (1024 slots masked)
ATTN_DANUBE_CASES = [(4, 4096, (4095, 4096 + 1000, 2 * 4096 + 17)),
                     (4, 5120, (5119, 5120 + 1000, 2 * 5120 + 17))]
# kernel vs plain, each limit scaled to the case's own output:
# |err| <= tol[0] * rms(plain) + tol[1] * |plain|, by compute dtype.
# ATTN_TOL_F32 holds the kernel to the plain version on fp32 inputs (fp32
# scores, as the kernel keeps them; bf16 leaves the kernel's rounding of
# the probabilities before P.V and of its output, about one ulp);
# ATTN_TOL_REF to the plain version in the reference's dtypes, which
# also rounds the scores to bf16.  The rms shares are 2.5-4x the largest
# measured (PERF.md section 6: 0.0193, 0.0853 and 1.03e-6); a planted
# fault (one 64-slot block dropped at the end of the stretch, or the
# window's edge one block short; 0.25 of the rms or more) must fail
# ATTN_TOL_F32 at every case of 4096 slots and up.
ATTN_TOL_F32 = {"bfloat16": (0.05, 2.0 ** -7), "float32": (4e-6, 4e-6)}
ATTN_TOL_REF = {"bfloat16": (0.25, 2.0 ** -6), "float32": (4e-6, 4e-6)}
ATTN_FAULT_MIN_S = 4096
ATTN_FAULT_SLOTS = 64         # the planted fault's missing slots
# the CUDA-graph check: a phi4-mini (B, S_cache) case and two positions
# captured in one graph (both must take more than one split: the planner
# gives (32, 4096) one), and the (B, S_cache) of an eager call of a larger
# B * KV, also split, made between two replays
ATTN_GRAPH = (8, 32768, (32767, 16383))
ATTN_GRAPH_LARGER = (12, 8192)
# 10a SSD step: mamba2-780m's (heads, groups, d_state, head_dim), batches
# (10b's 2, 10c's 4, and 128)
SSD_MAMBA2 = (48, 1, 128, 64)
SSD_BATCHES = (2, 4, 128)
SSD_TOL_Y = (1e-3, 1e-4)      # fp32 output: the same ops, another order
SSD_TOL_H = (1e-6, 2.0 ** -7)  # bf16 state: one ulp of a rounding flip
# 10a/10d quantized_linear at phi4-mini's projections for one decode
# batch of 4 tokens: q, k/v, MLP in/gate, MLP out
# the stream kernel's plan at each of QL_SHAPES on an H100 (132 SMs):
# (route, K rows a slice, K slices, blocks)
STREAM_PLANS = [("stream", 768, 4, 96), ("stream", 384, 8, 64),
                ("stream", 1536, 2, 128), ("stream", 2048, 4, 96)]
# 10a: int8_matmul's edge cases on the stream route, (M, K, N)
I8_EDGES = [(m, k, n) for m in (1, 3, 16) for n in (16, 1008)
            for k in (64, 3000)]
# ... and the cluster's combine at its edges, with the split each must
# take, (K rows a slice, slices): every slice one stage; the largest
# (non-portable) cluster, where x's limit raises the split to 16
I8_CLUSTER_EDGES = {(4, 256, 1024): (128, 2), (16, 65536, 16): (4096, 16)}
QL_SHAPES = [(4, 3072, 3072), (4, 3072, 1024), (4, 3072, 8192),
             (4, 8192, 3072)]
# 10b: full widths and vocab, cut to 2 layers, 8 teacher-forced steps
LM_MODEL_ARCHS = ("phi4-mini-3.8b", "mamba2-780m")
LM_MODEL_LAYERS, LM_MODEL_STEPS, LM_MODEL_BATCH = 2, 8, 2
# kernels (card) vs plain versions (CPU), bf16 logits:
# max |card - cpu| <= LOGIT_TOL * max |cpu|
LOGIT_TOL = 0.03
# 10c: the serving CLI at full depth, (label, argv, int8 KV cache)
LM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "32", "--gen", "32"]
LM_SERVE_RUNS = [
    ("phi4-mini-3.8b, bf16 KV", ["--arch", "phi4-mini-3.8b",
                                 "--temperature", "0"], False),
    ("phi4-mini-3.8b, INT8 KV", ["--arch", "phi4-mini-3.8b",
                                 "--temperature", "0"], True),
    ("mamba2-780m (default arch)", [], False)]


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
    between CUDA events (:func:`graph_seq_ms`).  The host's launch cost
    is out of the window; each call's device work runs in order, as
    issued."""
    return graph_seq_ms([fn] * reps)


def graph_seq_ms(fns) -> float:
    """Mean device ms of the calls ``fns``, captured in order in one CUDA
    graph (after a warm-up on a side stream) and replayed 3 times."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
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
    return start.elapsed_time(end) / (3 * len(fns))


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


def timing_chips(base, n: int) -> list:
    """``n`` chips with ``base``'s structure and different timing
    constants (scalar/vector/CIM latencies, weight-load rate, router
    latency, clock): one compiled program serves them all."""
    import dataclasses as dc
    return [dc.replace(
        base,
        core=dc.replace(
            base.core,
            scalar=dc.replace(base.core.scalar, alu_latency=1 + i % 3,
                              ldst_latency=2 + i % 2),
            vector=dc.replace(base.core.vector, alu_latency=1 + i % 4,
                              mul_latency=2 + i % 3),
            cim=dc.replace(base.core.cim,
                           weight_load_rows_per_cycle=1 + i % 4)),
        noc=dc.replace(base.noc, router_latency=1 + i % 3),
        clock_ghz=1.0 + 0.2 * i, name=f"t{i}") for i in range(n)]


def best_of(fn, reps: int = REPS_SIM, keep=None):
    """``(s, result)``: the least host wall time of ``reps`` runs of
    ``fn()`` and the last result (also appended to ``keep``)."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    if keep is not None:
        keep.append(out)
    return best, out


def same_report(a, b) -> bool:
    return (a.cycles == b.cycles and a.stage_cycles == b.stage_cycles
            and a.events == b.events and a.unit_busy == b.unit_busy
            and a.instrs == b.instrs)


def simulate_phase(paths, n_fleet: int, device=None) -> dict:
    """Phase 6: the simulate fidelity, torch engine against the numpy
    vector engine on each path, the fleet against a loop of single
    runs and the trace backend on the first path.  ``device`` is where
    the torch engine runs (the card unless named).  Raises on any
    mismatch; returns the measurements."""
    import torch
    from repro_torch import flow
    from repro_torch.core import torchsim, vectorsim
    from repro_torch.core.arch import default_chip
    from repro_torch.core.mapping import CostParams
    from repro_torch.core.simulator import Simulator
    from repro_torch.explore import FleetEvaluator

    cuda = device is None or torch.device(device).type == "cuda"
    chip = default_chip()
    out = {}
    for i, (label, model, kw, batch) in enumerate(paths):
        opts = flow.CompileOptions(strategy="dp", workload_kw=kw or None,
                                   params=CostParams(batch=batch),
                                   fidelity="simulate")
        t0 = time.perf_counter()
        art = flow.compile(model, chip, opts)
        row = {"compile_s": time.perf_counter() - t0,
               "codegen_s": art.pass_record("codegen").wall_s}
        cm = art.model
        row["stage_instrs"] = [s.total_instrs for s in cm.stages]
        log(f"simulate {label}: compile {row['compile_s']:.2f} s (codegen "
            f"{row['codegen_s']:.2f} s), {cm.total_instrs} instructions "
            f"in {len(cm.stages)} stages {row['stage_instrs']}")

        # the numpy vector engine: the entry point, then its two halves
        vsim = Simulator(chip, cm.isa, engine="vector")
        row["vector_s"], vrep = best_of(lambda: vsim.run_model(cm))
        dec = vectorsim.StageDecoder(cm.isa, vsim.m)
        decoded = []
        row["vector_decode_s"] = sum(best_of(
            lambda sp=sp: dec.decode_stage(sp.programs), keep=decoded)[0]
            for sp in cm.stages)
        row["vector_replay_s"] = sum(best_of(
            lambda sp=sp, ds=ds: vectorsim.replay_stage(vsim, sp, ds))[0]
            for sp, ds in zip(cm.stages, decoded))

        # the torch engine on the card: a first run, then timed ones,
        # each with its decode split into device / copy / host time
        tsim = Simulator(chip, cm.isa, device=device)   # engine "torch"
        t0 = time.perf_counter()
        first = tsim.run_model(cm)
        row["torch_first_s"] = time.perf_counter() - t0
        tdec = torchsim.decoder_for(tsim)
        if tsim.engine != "torch" or tdec.fallbacks:
            raise AssertionError(f"simulate {label}: engine {tsim.engine},"
                                 f" {tdec.fallbacks} stages not decoded "
                                 f"on the device")
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(REPS_SIM):
            tdec.timing, tdec.fallbacks = torchsim.StageTiming(), 0
            t0 = time.perf_counter()
            trep = tsim.run_model(cm)
            runs.append((time.perf_counter() - t0, tdec.timing.as_dict(),
                         trep))
            # every stage went through one pass on the device
            if tdec.fallbacks or tdec.timing.calls != len(cm.stages):
                raise AssertionError(
                    f"simulate {label}: {tdec.timing.calls} stage passes "
                    f"for {len(cm.stages)} stages, {tdec.fallbacks} to "
                    f"the scalar interpreter")
        row["torch_s"], row["torch_decode"], trep = min(
            runs, key=lambda r: r[0])
        row["fallback_stages"] = tdec.fallbacks
        row["peak_bytes"] = (torch.cuda.max_memory_allocated()
                             if cuda else None)
        for name, rep in [("first torch run", first)] + [
                ("torch", r[2]) for r in runs]:
            if not same_report(rep, vrep):
                raise AssertionError(
                    f"simulate {label}: {name} != vector: cycles "
                    f"{rep.cycles} vs {vrep.cycles}, instrs {rep.instrs} "
                    f"vs {vrep.instrs}")
        ev = art.evaluate("simulate", device=device)
        jv = art.evaluate("simulate", engine="vector")
        if (ev.cycles, ev.energy) != (jv.cycles, jv.energy):
            raise AssertionError(f"simulate {label}: backend torch != "
                                 f"vector")
        if not (0 < trep.cycles < float("inf") and trep.instrs > 0):
            raise AssertionError(f"simulate {label}: {trep.cycles} "
                                 f"cycles, {trep.instrs} instrs")
        td = row["torch_decode"]
        row["torch_decode_s"] = (td["prep_s"] + td["finish_s"]
                                 + (td["h2d_ms"] + td["pass_ms"]
                                    + td["d2h_ms"]) / 1e3)
        log(f"simulate {label}: torch == vector ({trep.cycles:.0f} cycles, "
            f"{trep.instrs} instrs, {ev.energy_total / 1e6:.3f} mJ); "
            f"best of {REPS_SIM}: vector {row['vector_s']:.3f} s (decode "
            f"{row['vector_decode_s']:.3f} s, replay "
            f"{row['vector_replay_s']:.3f} s); torch {row['torch_s']:.3f} s "
            f"(first run {row['torch_first_s']:.3f} s), its decode "
            f"{row['torch_decode_s']:.3f} s: host prep "
            f"{td['prep_s']:.3f} s, stage passes "
            f"{td['pass_ms']:.3f} ms device, copies h2d {td['h2d_ms']:.3f} "
            f"+ d2h {td['d2h_ms']:.3f} ms, host finish "
            f"{td['finish_s']:.3f} s; {row['fallback_stages']} stages to "
            f"the scalar interpreter; peak device memory "
            f"{row['peak_bytes']} B")

        if i == 0:
            # the fleet: one batched decode per stage for n_fleet chips,
            # through the entry point (its own codegen included) and on
            # the model compiled above, against a loop of single runs
            chips = timing_chips(chip, n_fleet)
            fe = FleetEvaluator(art.cg, params=CostParams(batch=batch),
                                device=device)
            t0 = time.perf_counter()
            payloads = fe.evaluate([(c, "dp") for c in chips])
            row["fleet_entry_s"] = time.perf_counter() - t0
            # the fleet's decode and replay alone: its per-model half on
            # the model compiled above, twice
            fleet_timing = torchsim.StageTiming()
            fe = FleetEvaluator(art.cg, params=CostParams(batch=batch),
                                device=device, timing=fleet_timing)
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            row["fleet_s"], again = best_of(lambda: fe._eval_model(
                cm, chips, time.perf_counter()), reps=2)
            row["fleet_decode"] = fleet_timing.as_dict()
            if fleet_timing.calls != 2 * len(cm.stages):
                raise AssertionError(
                    f"fleet: {fleet_timing.calls} stage passes for 2 runs "
                    f"of {len(cm.stages)} stages")
            row["fleet_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                       if cuda else None)
            row["loop_s"] = 0.0
            for c, pl, pl2 in zip(chips, payloads, again):
                dt, rep = best_of(lambda c=c: Simulator(
                    c, cm.isa, engine="vector").run_model(cm), reps=2)
                row["loop_s"] += dt
                sps = cm.batch / (rep.cycles / (c.clock_ghz * 1e9))
                for got in (pl, pl2):
                    if (got.get("error") or got["cycles"] != rep.cycles
                            or got["energy"] != dict(rep.energy())
                            or got["throughput_sps"] != sps):
                        raise AssertionError(
                            f"fleet != single run on {c.name}: {got} vs "
                            f"{rep.cycles}")
            fd = row["fleet_decode"]
            log(f"fleet of {n_fleet} == {n_fleet} single vector runs; "
                f"FleetEvaluator.evaluate {row['fleet_entry_s'] / n_fleet:.3f}"
                f" s per chip (its codegen included); on the compiled model "
                f"(best of 2) {row['fleet_s'] / n_fleet:.3f} s per chip "
                f"(prep {fd['prep_s'] / 2:.3f} s, stage passes "
                f"{fd['pass_ms'] / 2:.3f} ms device, copies "
                f"{(fd['h2d_ms'] + fd['d2h_ms']) / 2:.3f} ms, finish "
                f"{fd['finish_s'] / 2:.3f} s a run), loop of vector runs "
                f"{row['loop_s'] / n_fleet:.3f} s per chip; peak device "
                f"memory {row['fleet_peak_bytes']} B; cycles "
                f"{min(p['cycles'] for p in payloads):.0f}.."
                f"{max(p['cycles'] for p in payloads):.0f}")

            t0 = time.perf_counter()
            tr = flow.compile(model, chip, opts.replace(
                fidelity="trace")).evaluate()
            row["trace_s"] = time.perf_counter() - t0
            row["trace_cycles"] = tr.cycles
            if not (tr.backend == "trace" and 0 < tr.cycles < float("inf")
                    and tr.energy_total > 0):
                raise AssertionError(f"trace {label}: {tr.summary()}")
            log(f"trace {label}: {tr.summary()} in {row['trace_s']:.3f} s "
                f"(simulate: {trep.cycles:.0f} cycles)")
        out[label] = row
    return out


@contextlib.contextmanager
def decodes_counted():
    """Within the block, every torch-engine stage decode (a single
    simulator's or a fleet's) adds to one ``StageTiming``; yields it,
    the torch decoders made inside (their ``fallbacks`` count stages
    left to the scalar interpreter) and the stage counts of each
    torch-engine ``Simulator.run_model``."""
    from repro_torch.core import torchsim
    from repro_torch.core.simulator import Simulator
    from repro_torch.explore import fleet
    timing = torchsim.StageTiming()
    decoders, runs = [], []
    saved = (torchsim.TorchStageDecoder.__init__,
             fleet.FleetEvaluator.__init__, Simulator.run_model)

    def dec_init(self, *a, **kw):
        saved[0](self, *a, **kw)
        self.timing = timing
        decoders.append(self)

    def fleet_init(self, *a, **kw):
        saved[1](self, *a, **kw)
        self.timing = timing

    def run_model(self, model, *a, **kw):
        if self.engine == "torch":
            runs.append(len(model.stages))
        return saved[2](self, model, *a, **kw)

    torchsim.TorchStageDecoder.__init__ = dec_init
    fleet.FleetEvaluator.__init__ = fleet_init
    Simulator.run_model = run_model
    try:
        yield timing, decoders, runs
    finally:
        (torchsim.TorchStageDecoder.__init__,
         fleet.FleetEvaluator.__init__, Simulator.run_model) = saved


def run_cli(argv) -> tuple:
    """``(s, stdout)`` of ``repro_torch.explore.cli.main(argv)``, which
    must return 0."""
    from repro_torch.explore import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"explore {argv}: exit {rc}")
    return wall, buf.getvalue()


def same_payload(rec, rep, chip, batch) -> bool:
    """A record's cycles, energy and throughput equal a simulator
    report's, bit for bit."""
    sps = (0.0 if rep.cycles <= 0
           else batch / (rep.cycles / (chip.clock_ghz * 1e9)))
    return (rec.cycles == rep.cycles and rec.energy == dict(rep.energy())
            and rec.throughput_sps == sps)


def explore_phase(path, device=None) -> dict:
    """Phase 7 (a) and (b): ``python -m repro_torch.explore``'s ``main``
    on ``path``.  (a) the 64-point timing sweep (``--strategies dp``:
    one compile) at simulate fidelity on the fleet (``--engine torch``),
    each record against that chip's own
    ``engine="vector"`` run of the pinned program; (b) successive
    halving on the mg-flit space, top 3 after a 2-run calibration, each
    promoted record against an ``engine="vector"`` run of its point.
    No result cache; every stage of every torch-engine run must be
    decoded by one pass on ``device`` (the card unless named).  Raises
    on any mismatch; returns the measurements."""
    import torch
    from repro_torch import flow
    from repro_torch.core import workloads
    from repro_torch.core.mapping import CostParams
    from repro_torch.core.simulator import Simulator
    from repro_torch.explore import RecordStore, canonical_chip

    label, model, kw, batch = path
    cuda = device is None or torch.device(device).type == "cuda"
    dev_arg = [] if device is None else ["--device", str(device)]
    res_arg = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
    params = CostParams(batch=batch)
    cg = workloads.build(model, **kw).condense()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the timing sweep on the fleet
        store = str(Path(tmp) / "timing.jsonl")
        with decodes_counted() as (timing, decoders, runs):
            wall, text = run_cli(
                ["sweep", model, *res_arg, "--batch", str(batch),
                 "--space", "timing", "--strategies", "dp",
                 "--fidelity", "simulate", "--engine", "torch",
                 "--no-cache", "--store", store]
                + dev_arg)
        recs = RecordStore(store).load()
        canon = {canonical_chip(r.point.chip()) for r in recs}
        if len(recs) != 64 or len(canon) != 1:
            raise AssertionError(f"timing sweep: {len(recs)} records, "
                                 f"{len(canon)} canonical chips")
        cm = flow.compile(cg, canon.pop(), flow.CompileOptions(
            strategy="dp", params=params,
            fidelity="simulate")).ensure_model()
        if (timing.calls != len(cm.stages) or runs
                or any(r.error or r.engine != "torch" for r in recs)):
            raise AssertionError(
                f"timing sweep: {timing.calls} stage passes for "
                f"{len(cm.stages)} stages, {len(runs)} per-point torch "
                f"runs, errors {[r.error for r in recs if r.error]}")
        t0 = time.perf_counter()
        for r in recs:
            chip = r.point.chip()
            rep = Simulator(chip, cm.isa, engine="vector").run_model(cm)
            if not same_payload(r, rep, chip, cm.batch):
                raise AssertionError(f"timing sweep: {r.point} "
                                     f"{r.cycles} != vector {rep.cycles}")
        vector_s = time.perf_counter() - t0
        td = timing.as_dict()
        out["timing_sweep"] = {
            "points": len(recs), "wall_s": wall,
            "s_per_point": wall / len(recs),
            "fleet_wall_s_per_point": recs[0].wall_s,
            "decode": td, "vector_loop_s_per_point": vector_s / len(recs),
            "cycles": [min(r.cycles for r in recs),
                       max(r.cycles for r in recs)]}
        log(f"explore timing sweep {label}: {len(recs)} points == their "
            f"vector runs on the pinned program; cli.main {wall:.3f} s "
            f"({wall / len(recs):.4f} s per point, codegen included; fleet "
            f"{recs[0].wall_s:.4f} s per point), {timing.calls} stage "
            f"passes on {'the card' if cuda else device}: device "
            f"{td['pass_ms']:.3f} ms, copies "
            f"{td['h2d_ms'] + td['d2h_ms']:.3f} ms, host prep "
            f"{td['prep_s']:.3f} s + finish {td['finish_s']:.3f} s; the "
            f"vector loop {vector_s / len(recs):.4f} s per point; cycles "
            f"{out['timing_sweep']['cycles']}")
        for line in text.splitlines()[:3]:
            log(f"  {line}")

        # (b) successive halving with calibration
        store = str(Path(tmp) / "halving.jsonl")
        with decodes_counted() as (timing, decoders, runs):
            wall, text = run_cli(
                ["sweep", model, *res_arg, "--batch", str(batch),
                 "--space", "mg-flit", "--top-k", "3", "--calibrate", "2",
                 "--no-cache", "--store", store] + dev_arg)
        recs = RecordStore(store).load()
        promoted = [r for r in recs if r.fidelity == "simulate"]
        fallbacks = sum(d.fallbacks for d in decoders)
        if (any(r.error for r in recs) or len(promoted) != 3
                or len(runs) != 5 or fallbacks
                or timing.calls != sum(runs)):
            raise AssertionError(
                f"successive halving: {len(recs)} records "
                f"({[r.error for r in recs if r.error]} errors), "
                f"{len(promoted)} promoted, {len(runs)} simulator runs, "
                f"{timing.calls} stage passes for {sum(runs)} stages, "
                f"{fallbacks} to the scalar interpreter")
        for r in promoted:
            chip = r.point.chip()
            rep = flow.compile(cg, chip, flow.CompileOptions(
                strategy=r.point.strategy, params=params,
                fidelity="simulate")).evaluate("simulate", engine="vector")
            if (r.cycles, r.energy, r.throughput_sps) != (
                    rep.cycles, rep.energy, rep.throughput_sps):
                raise AssertionError(f"successive halving: {r.point} "
                                     f"{r.cycles} != vector {rep.cycles}")
        td = timing.as_dict()
        out["successive_halving"] = {
            "records": len(recs), "promoted": len(promoted),
            "simulator_runs": len(runs), "wall_s": wall,
            "promoted_wall_s": [r.wall_s for r in promoted],
            "screen_wall_s": sum(r.wall_s for r in recs
                                 if r.fidelity != "simulate"),
            "decode": td}
        log(f"explore successive halving {label}: {len(recs) - 3} screened "
            f"records, 2 calibration + 3 promoted simulator runs on "
            f"{'the card' if cuda else device} ({timing.calls} stage "
            f"passes, 0 to the scalar interpreter), promoted == vector; "
            f"cli.main {wall:.3f} s; promoted points "
            f"{[round(r.wall_s, 3) for r in promoted]} s each; stage "
            f"passes {td['pass_ms']:.3f} ms device")
        for line in text.splitlines()[-5:-2]:
            log(f"  {line}")
    return out


def faults_phase(golden, path, device=None) -> dict:
    """Phase 7 (c) and (d): ``degradation_curve`` on the configuration
    ``BENCH_faults.json`` pins against its rows and clean-output hash;
    then faulty ``func:torch`` (``check=True``) on ``path`` for each of
    ``FAULT_MODELS``, and ``degradation_curve`` over ``FAULT_RATES`` on
    it, with the kernel's launches counted.  The oracle runs on
    ``device`` (the card unless named).  Raises on any mismatch;
    returns the measurements and the launches counted."""
    import numpy as np
    import torch
    from repro_torch import flow
    from repro_torch.core import ref, workloads
    from repro_torch.core.arch import default_chip
    from repro_torch.faults import (FaultModel, degradation_curve,
                                    resolve_faults)
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels.ops import cim_mvm

    cuda = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    chip = default_chip()
    out = {"launches": 0}

    def counted(expected, fn):
        bsm.bitserial_mvm.launches = 0
        t0 = time.perf_counter()
        got = fn()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = bsm.bitserial_mvm.launches
        if cuda and n != expected:
            raise AssertionError(f"{n} kernel launches, expected "
                                 f"{expected}")
        out["launches"] += n
        return wall, n, got

    # (c) the golden degradation curve
    model, kw, batch, seed = golden
    want = json.loads((ROOT / "BENCH_faults.json").read_text())
    rates = [r["rate"] for r in want["degradation"]]
    cg = workloads.build(model, **kw).condense()
    wall, n, rows = counted((1 + len(rates)) * len(cg), lambda:
                            degradation_curve(cg, chip, rates, batch=batch,
                                              seed=seed, device=device))
    if rows != want["degradation"]:
        raise AssertionError(f"degradation {rows} != BENCH_faults.json "
                             f"{want['degradation']}")
    w, b, x = ref.random_init(cg, batch=batch, seed=seed, device=dev)
    clean = ref.run_reference(cg, w, b, ref.auto_quant(cg, w, b, x), x,
                              matmul=cim_mvm)
    h = hashlib.sha256()
    for gid in sorted(clean):
        h.update(np.ascontiguousarray(clean[gid].cpu().numpy()).tobytes())
    if h.hexdigest() != want["clean_identity"]["output_sha256"]:
        raise AssertionError("clean outputs differ from BENCH_faults.json")
    out["golden"] = {"rows": rows, "launches": n, "wall_s": wall}
    log(f"faults golden ({model} {kw}, batch {batch}): degradation rows "
        f"and clean-output sha256 == BENCH_faults.json; {n} launches, "
        f"{wall:.3f} s")

    # (d) faulty func:torch and a degradation curve at full width
    label, model, kw, batch = path
    art = flow.compile(model, chip, flow.CompileOptions(
        strategy="dp", batch=batch, workload_kw=kw))
    cg = art.cg
    n_dyn = sum(1 for g in cg if g.dynamic_weights)
    per_run = len(cg) - n_dyn + batch * n_dyn
    w, b, x = ref.random_init(cg, batch=batch, seed=0, device=dev)
    q = ref.auto_quant(cg, w, b, x)
    clean = art.evaluate("func:torch", weights=w, biases=b, inputs=x,
                         quant=q, check=False, device=device).outputs
    runs = []
    for fm in [{"rate": 0.0}] + FAULT_MODELS:
        t0 = time.perf_counter()
        fs = resolve_faults(w, chip, FaultModel(seed=0, **fm))
        resolve_s = time.perf_counter() - t0

        def run(check):
            return art.evaluate("func:torch", weights=w, biases=b,
                                inputs=x, quant=q, check=check, faults=fs,
                                device=device)

        check_s, n, rep = counted(per_run, lambda: run(True))
        ms = min(counted(per_run, lambda: run(False))[0]
                 for _ in range(3)) * 1e3
        final = len(cg) - 1
        agree = float(np.mean(
            rep.outputs[final].reshape(batch, -1).argmax(1)
            == clean[final].reshape(batch, -1).argmax(1)))
        changed = sum(int((rep.outputs[g] != clean[g]).sum())
                      for g in clean)
        if (fm["rate"] == 0.0) != (changed == 0):
            raise AssertionError(f"func:torch {fm}: {changed} output "
                                 f"bytes differ from the clean run")
        runs.append({"fault_model": fm, "n_stuck": fs.n_stuck,
                     "resolve_s": resolve_s, "check_s": check_s,
                     "launches": n, "evaluate_ms": ms,
                     "changed_bytes": changed, "top1_agreement": agree})
        log(f"func:torch {label} faults {fm}: check=True passes with "
            f"{n} launches ({check_s:.3f} s); {fs.n_stuck} stuck bits "
            f"resolved in {resolve_s:.3f} s; evaluate(check=False) "
            f"{ms:.3f} ms (best of 3); {changed} output bytes changed, "
            f"top-1 agreement {agree}")
    out["func_torch"] = runs
    wall, n, rows = counted((1 + len(FAULT_RATES)) * per_run, lambda:
                            degradation_curve(cg, chip, FAULT_RATES,
                                              batch=batch, seed=0,
                                              device=device))
    if rows[0]["ber"] != 0.0 or not all(r["ber"] > 0 for r in rows[1:]):
        raise AssertionError(f"degradation {label}: {rows}")
    out["degradation"] = {"rows": rows, "launches": n, "wall_s": wall}
    log(f"degradation_curve {label} rates {FAULT_RATES}: {n} launches, "
        f"{wall:.3f} s; " + "; ".join(
            f"rate {r['rate']}: {r['n_stuck']:.0f} stuck, BER "
            f"{r['ber']:.6f}, top-1 {r['top1_agreement']}" for r in rows))
    return out


def decode_s(td) -> float:
    """Seconds of a ``StageTiming`` dict: host prep and finish, and the
    copies and stage passes on the device's clock."""
    return (td["prep_s"] + td["finish_s"]
            + (td["h2d_ms"] + td["pass_ms"] + td["d2h_ms"]) / 1e3)


def same_system_report(a, b) -> bool:
    """Two ``SystemReport``s agree on every stitched number and, chip
    by chip, on the simulator's (or trace's) report."""
    if (a.cycles, a.comm_cycles, a.bottleneck_cycles, a.energy,
            a.throughput_sps, a.mode, a.n_chips, a.n_failed_chips,
            a.n_failed_links) != (
            b.cycles, b.comm_cycles, b.bottleneck_cycles, b.energy,
            b.throughput_sps, b.mode, b.n_chips, b.n_failed_chips,
            b.n_failed_links) or len(a.per_chip) != len(b.per_chip):
        return False
    for ra, rb in zip(a.per_chip, b.per_chip):
        if (ra.cycles, ra.energy, ra.throughput_sps) != (
                rb.cycles, rb.energy, rb.throughput_sps):
            return False
        if ra.sim is not None and not (
                rb.sim is not None and same_report(ra.sim, rb.sim)):
            return False
    return True


def mesh_simulate(art, label, device=None) -> dict:
    """``SystemArtifact.evaluate("simulate")`` on the ``torch`` engine
    (every chip slice's stages decoded on ``device``, the card unless
    named) against ``engine="vector"``, best of ``REPS_SIM`` each, the
    torch decode split into host prep, copies, device passes and host
    finish.  Raises on any difference; returns the measurements and the
    fastest torch run's report."""
    stages = sum(len(a.model.stages) for a in art.chips)
    row = {"chips": art.n_chips, "stages": stages,
           "codegen_s": sum(a.pass_record("codegen").wall_s
                            for a in art.chips)}
    row["vector_s"], vrep = best_of(
        lambda: art.evaluate("simulate", engine="vector"))
    runs = []
    with decodes_counted() as (timing, decoders, sims):
        for _ in range(REPS_SIM):
            before = timing.as_dict()
            t0 = time.perf_counter()
            rep = art.evaluate("simulate", device=device)
            runs.append((time.perf_counter() - t0,
                         {k: v - before[k]
                          for k, v in timing.as_dict().items()}, rep))
        fallbacks = sum(d.fallbacks for d in decoders)
    if (fallbacks or len(sims) != REPS_SIM * art.n_chips
            or timing.calls != REPS_SIM * stages):
        raise AssertionError(
            f"mesh simulate {label}: {len(sims)} torch runs for "
            f"{REPS_SIM} x {art.n_chips} chips, {timing.calls} stage "
            f"passes for {REPS_SIM} x {stages} stages, {fallbacks} to the "
            f"scalar interpreter")
    for _, _, rep in runs:
        if not same_system_report(rep, vrep):
            raise AssertionError(f"mesh simulate {label}: torch != vector: "
                                 f"{rep.summary()} vs {vrep.summary()}")
    row["torch_s"], td, rep = min(runs, key=lambda r: r[0])
    row["torch_decode"] = td
    row["torch_decode_s"] = decode_s(td)
    row["report"] = {"cycles": rep.cycles, "comm_cycles": rep.comm_cycles,
                     "throughput_sps": rep.throughput_sps,
                     "energy_nj": rep.energy["total"],
                     "instrs": [r.sim.instrs for r in rep.per_chip]}
    log(f"mesh simulate {label}: {art.n_chips} chips, {stages} stages "
        f"(codegen {row['codegen_s']:.2f} s), torch == vector "
        f"({rep.cycles:.0f} cycles, {rep.comm_cycles:.0f} inter-chip, "
        f"{rep.throughput_sps:.3f} samples/s); best of {REPS_SIM}: vector "
        f"{row['vector_s']:.3f} s, torch {row['torch_s']:.3f} s, its decode "
        f"{row['torch_decode_s']:.3f} s: host prep {td['prep_s']:.3f} s, "
        f"copies h2d {td['h2d_ms']:.3f} + d2h {td['d2h_ms']:.3f} ms, stage "
        f"passes {td['pass_ms']:.3f} ms device, host finish "
        f"{td['finish_s']:.3f} s")
    return row, rep


def mesh_phase(tf_kw=None, golden=True, func_cases=MESH_FUNC,
               device=None) -> dict:
    """Phase 8: the mesh of chips on the transformer (``tf_kw``: its
    workload arguments, the full-width default unless given).  (a) trace
    fidelity on 1 chip and on 2/4/8-chip pipeline and tensor meshes,
    against ``BENCH_system.json`` at 9 decimals when ``golden``; (b)
    simulate fidelity on ``MESH_SIM`` pipeline meshes at batch
    ``MESH_SIM_BATCH``, torch == vector; (c) a 4-mesh with each slot of
    ``MESH_FAILED`` failed: the plan, and degraded trace and simulate
    reports (batch ``MESH_SIM_BATCH``); (d) ``SystemArtifact.run_func`` on ``func_cases``
    against ``run_reference`` with the kernel (launches counted) and
    the plain oracle, bit-exact; (e) the explore engine's mesh sweep at
    trace fidelity, each record against a direct evaluation, then all
    from its cache.  Raises on any mismatch; returns the measurements
    and the kernel launches of (d)."""
    import numpy as np
    import torch
    from repro_torch import flow
    from repro_torch.core import ref, workloads
    from repro_torch.core.arch import default_chip
    from repro_torch.explore import ExplorationEngine, mesh_space
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels.ops import cim_mvm
    from repro_torch.system import SystemConfig, split_pipeline

    cuda = device is None or torch.device(device).type == "cuda"
    dev = torch.device("cuda", 0) if device is None else \
        torch.device(device)
    chip = default_chip()
    tf_kw = dict(tf_kw or {})
    seq = tf_kw.get("seq", 128)
    opts = flow.CompileOptions(workload_kw=tf_kw or None)
    out = {"launches": 0}

    # (a) trace fidelity, against BENCH_system.json -----------------------
    meshes = {}
    for n in (1, 2, 4, 8):
        entry = {}
        for mode in (("single",) if n == 1 else ("pipeline", "tensor")):
            system = None if mode == "single" else SystemConfig.mesh(
                n, link=MESH_LINK, parallel=mode)
            t0 = time.perf_counter()
            art = flow.compile("transformer", chip, opts.replace(
                fidelity="trace", system=system))
            compile_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            rep = art.evaluate()
            entry[mode] = {
                "cycles": rep.cycles,
                "comm_cycles": getattr(rep, "comm_cycles", 0),
                "throughput_sps": rep.throughput_sps,
                "tok_s": rep.throughput_sps * seq,
                "chips_used": getattr(rep, "n_chips", 1),
                "compile_s": compile_s,
                "evaluate_s": time.perf_counter() - t0}
            log(f"mesh trace {n} {mode}: {rep.summary()}; compile "
                f"{compile_s:.2f} s, evaluate {entry[mode]['evaluate_s']:.3f}"
                f" s")
        meshes[str(n)] = entry
    if golden:
        want = json.loads((ROOT / "BENCH_system.json").read_text())
        drift = [f"{n}.{mode}.{k}: {want['meshes'][n][mode][k]} -> {m[k]}"
                 for n, entry in meshes.items()
                 for mode, m in entry.items()
                 for k in ("cycles", "comm_cycles", "throughput_sps",
                           "tok_s")
                 if round(float(m[k]), 9)
                 != round(float(want["meshes"][n][mode][k]), 9)]
        if sorted(meshes) != sorted(want["meshes"]) or any(
                sorted(meshes[n]) != sorted(want["meshes"][n])
                for n in meshes) or drift:
            raise AssertionError(f"mesh trace != BENCH_system.json: {drift}")
        log("mesh trace: 7 configurations == BENCH_system.json (cycles, "
            "comm_cycles, throughput_sps, tok_s at 9 decimals)")
    if meshes["4"]["tensor"]["comm_cycles"] <= \
            meshes["2"]["tensor"]["comm_cycles"]:
        raise AssertionError("tensor comm no longer grows with chip count")
    out["trace"] = meshes

    # (b) simulate fidelity, pipeline meshes, torch == vector -------------
    out["simulate"] = {}
    sim_opts = opts.replace(batch=MESH_SIM_BATCH)
    for n in MESH_SIM:
        t0 = time.perf_counter()
        art = flow.compile("transformer", chip, sim_opts.replace(
            fidelity="simulate", system=SystemConfig.mesh(n, link=MESH_LINK)))
        compile_s = time.perf_counter() - t0
        row, _ = mesh_simulate(art, f"pipeline x{n}", device)
        row["compile_s"] = compile_s
        out["simulate"][str(n)] = row

    # (c) the degraded mesh ------------------------------------------------
    cg = workloads.build("transformer", **tf_kw).condense()
    out["degraded"] = {}
    for slot in MESH_FAILED:
        sysc = SystemConfig.mesh(4, link=MESH_LINK).degrade(
            failed_chips=(slot,))
        plan = split_pipeline(cg, chip, sysc)
        covered = [g for s in plan.slices for g in s.gids]
        if (plan.total_macs() != cg.total_macs
                or covered != list(range(len(cg)))
                or any(s.mesh_slot == slot for s in plan.slices)):
            raise AssertionError(f"degraded plan: {plan.describe()}")
        trep = flow.compile("transformer", chip, sim_opts.replace(
            fidelity="trace", system=sysc)).evaluate()
        art = flow.compile("transformer", chip, sim_opts.replace(
            fidelity="simulate", system=sysc))
        row, srep = mesh_simulate(art, f"pipeline x4, slot {slot} failed",
                                  device)
        for rep in (trep, srep):
            if not (rep.degraded and rep.n_failed_chips == 1
                    and rep.throughput_sps > 0):
                raise AssertionError(f"degraded report: {rep.summary()}")
        row["slots"] = [s.mesh_slot for s in plan.slices]
        row["hops"] = [t.hops for t in plan.transfers]
        row["trace_cycles"] = trep.cycles
        out["degraded"][str(slot)] = row
        log(f"degraded mesh, slot {slot} failed: plan on slots "
            f"{row['slots']} (transfer hops {row['hops']}) conserves "
            f"{cg.total_macs} MACs over {len(cg)} groups; trace "
            f"{trep.summary()}; simulate {srep.summary()}")

    # (d) multi-chip func mode against the single-chip oracle --------------
    out["func"] = []
    for label, model, kw, n, failed in func_cases:
        system = SystemConfig.mesh(n).degrade(failed_chips=failed)
        batch = 2
        art = flow.compile(model, chip, flow.CompileOptions(
            fidelity="func", batch=batch, workload_kw=kw or None,
            system=system))
        cg = art.cg
        w, b, x = ref.random_init(cg, batch=batch, seed=0, device=dev)
        q = ref.auto_quant(cg, w, b, x)
        t0 = time.perf_counter()
        got = art.run_func(w, b, x, quant=q)
        func_s = time.perf_counter() - t0
        n_dyn = sum(1 for g in cg if g.dynamic_weights)
        expected = len(cg) - n_dyn + batch * n_dyn
        bsm.bitserial_mvm.launches = 0
        kernel = ref.run_reference(cg, w, b, q, x, matmul=cim_mvm)
        n_launched = bsm.bitserial_mvm.launches
        plain = ref.run_reference(cg, w, b, q, x)
        last = len(cg) - 1
        bad = {}
        for name, oracle in (("kernel", kernel), ("plain", plain)):
            want = oracle[last].reshape(batch, -1).cpu().numpy()
            bad[name] = (int(np.sum(got.final != want))
                         if got.final.shape == want.shape else -1)
        if (cuda and n_launched != expected) or any(bad.values()) \
                or art.n_chips < 2 or not art.plan.transfers:
            raise AssertionError(
                f"mesh func {label}: {bad} mismatching elements, "
                f"{n_launched} launches (expected {expected}), "
                f"{art.n_chips} chips")
        out["launches"] += n_launched
        out["func"].append({"case": label, "chips": art.n_chips,
                            "transfers": len(art.plan.transfers),
                            "final_elements": int(got.final.size),
                            "mismatches": bad, "launches": n_launched,
                            "run_func_s": func_s,
                            "instrs": [r.instrs for r in got.reports]})
        log(f"mesh func {label}: run_func on {art.n_chips} chips "
            f"({len(art.plan.transfers)} cut transfers, "
            f"{func_s:.3f} s) == run_reference with the kernel "
            f"({n_launched} launches) == the plain oracle: 0 of "
            f"{got.final.size} elements differ")

    # (e) the mesh design space, through the explore engine ----------------
    with tempfile.TemporaryDirectory() as tmp:
        eng = ExplorationEngine("transformer", cache=tmp, device=device,
                                **tf_kw)
        pts = mesh_space(chips=(1, 2, 4),
                         links=("interposer", "pcb")).points()
        t0 = time.perf_counter()
        recs = eng.evaluate(pts, fidelity="trace")
        sweep_s = time.perf_counter() - t0
        if len(recs) != 6 or any(r.error for r in recs):
            raise AssertionError(f"mesh sweep: {len(recs)} records, errors "
                                 f"{[r.error for r in recs if r.error]}")
        for r in recs:
            pt = r.point
            rep = flow.compile("transformer", pt.chip(), opts.replace(
                strategy=pt.strategy, params=eng.params, fidelity="trace",
                system=pt.system())).evaluate()
            if (r.cycles, r.energy, r.throughput_sps) != (
                    rep.cycles, rep.energy, rep.throughput_sps):
                raise AssertionError(f"mesh sweep {pt.chips} {pt.link}: "
                                     f"{r.cycles} != direct {rep.cycles}")
        by = {(r.point.chips, r.point.link): r for r in recs}
        if not (by[(2, "interposer")].throughput_sps
                > by[(1, "interposer")].throughput_sps
                and by[(2, "interposer")].cycles <= by[(2, "pcb")].cycles):
            raise AssertionError("mesh sweep: scale-out no longer helps")
        t0 = time.perf_counter()
        again = eng.evaluate(pts, fidelity="trace")
        cached_s = time.perf_counter() - t0
        if not all(r.cache_hit for r in again) or \
                [r.cycles for r in again] != [r.cycles for r in recs]:
            raise AssertionError("mesh sweep: second pass not all cached")
    out["sweep"] = {"points": len(recs), "wall_s": sweep_s,
                    "cached_wall_s": cached_s,
                    "records": {f"{k[0]} {k[1]}": [r.cycles,
                                                   r.throughput_sps]
                                for k, r in by.items()}}
    log(f"mesh sweep: 6 trace records == direct evaluations in "
        f"{sweep_s:.3f} s; again from the cache in {cached_s:.3f} s; "
        + "; ".join(f"{k[0]} chips {k[1]}: {r.throughput_sps:.3f} "
                    f"samples/s" for k, r in by.items()))
    return out


@contextlib.contextmanager
def serve_captured():
    """Within the block, every ``StepCostTable`` built, the artifacts
    its buckets compiled (``(table, workload, kw, artifact)``) and the
    wall time of each ``ServeSim.run`` are recorded."""
    from repro_torch.serve import trace_replay, workload
    tables, arts, replays = [], [], []
    saved = (workload.StepCostTable.__init__,
             workload.StepCostTable._compile, trace_replay.ServeSim.run)

    def init(self, *a, **kw):
        tables.append(self)
        saved[0](self, *a, **kw)

    def compile_(self, wl, kw):
        art = saved[1](self, wl, kw)
        arts.append((self, wl, dict(kw), art))
        return art

    def run(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return saved[2](self, *a, **kw)
        finally:
            replays.append(time.perf_counter() - t0)

    workload.StepCostTable.__init__ = init
    workload.StepCostTable._compile = compile_
    trace_replay.ServeSim.run = run
    try:
        yield tables, arts, replays
    finally:
        (workload.StepCostTable.__init__, workload.StepCostTable._compile,
         trace_replay.ServeSim.run) = saved


def run_serve_cli(argv) -> tuple:
    """``(s, stdout)`` of ``repro_torch.serve.__main__.main(argv)``,
    which must return 0."""
    from repro_torch.serve.__main__ import main as serve_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"serve {argv}: exit {rc}")
    return wall, buf.getvalue()


def serving_golden() -> dict:
    """Phase 9a: ``BENCH_serving.json`` rebuilt with the port (trace
    fidelity, the committed trace, synthetic tables for the prefill and
    large sections), compared at the keys and rounding its gate uses.
    Raises on any drift; returns the measurements."""
    import warnings
    from repro_torch.serve import (ServeModelCfg, ServeSim, StepCostTable,
                                   load_trace, make_policy, metrics_json,
                                   poisson_trace)

    want = json.loads((ROOT / "BENCH_serving.json").read_text())

    def table_from_costs(max_new, decode_base, decode_step, decode_per,
                         per_step):
        cfg = ServeModelCfg(max_prompt=64, max_new=max_new)
        pb = [1, 2, 4, 8, 16, 32, 64]
        db, b = [], 1
        while b < cfg.max_seq:
            db.append(b)
            b *= 2
        db.append(cfg.max_seq)
        return StepCostTable.from_costs(
            cfg, prefill_s={b: 2e-6 * b for b in pb},
            decode_base_s={b: decode_base + decode_step * b for b in db},
            decode_per_seq_s={b: decode_per + per_step * b for b in db},
            prefill_base_s={b: 1.5e-6 * b for b in pb},
            prefill_per_seq_s={b: 0.5e-6 * b for b in pb})

    def run(table, trace, policy="continuous", max_batch=SERVE_MAX_BATCH,
            **kw):
        sim = ServeSim(table, make_policy(policy, max_batch), **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return sim.run(trace)

    def equiv(table, trace, policy="continuous", **kw):
        got = []
        for eng in ("event", "array"):
            m = dict(run(table, trace, policy, engine=eng, **kw))
            m.pop("engine")
            got.append(metrics_json(m))
        return got[0] == got[1]

    out = {}
    t0 = time.perf_counter()
    table = StepCostTable(ServeModelCfg(**SERVE_MODEL), fidelity="trace")
    out["table_s"] = time.perf_counter() - t0
    trace = load_trace(str(ROOT / "benchmarks" / "serving_trace.json"))
    t0 = time.perf_counter()
    policies = {p: run(table, trace, p) for p in ("static", "continuous")}
    fault_trace = poisson_trace(**SERVE_FAULT)
    equivalence = {
        "static": equiv(table, trace, "static"),
        "continuous": equiv(table, trace, "continuous"),
        "degraded": equiv(table, fault_trace, "continuous",
                          **SERVE_FAULT_KW)}
    ptable = table_from_costs(SERVE_PREFILL["max_new"], 10e-6, 0.0, 1e-6,
                              0.0)
    ptrace = poisson_trace(**SERVE_PREFILL)
    prefill = {p: run(ptable, ptrace, prefill_policy=p,
                      **SERVE_PREFILL_RUN)
               for p in ("fifo", "batched", "chunked")}
    out["replay_s"] = time.perf_counter() - t0
    large = poisson_trace(**SERVE_LARGE)
    sha = hashlib.sha256(json.dumps(
        [[r.rid, r.t_arrive, r.prompt_len, r.gen_len]
         for r in large]).encode()).hexdigest()
    t0 = time.perf_counter()
    iters = run(table_from_costs(SERVE_LARGE["max_new"], 30e-6, 0.01e-6,
                                 2e-6, 0.002e-6), large)["decode_iterations"]
    out["large_replay_s"] = time.perf_counter() - t0

    def r9(x):
        return round(float(x), 9)

    drift = []
    for name, m in policies.items():
        g = want["policies"][name]
        drift += [f"{name}.{k}" for k in SERVE_GATED if r9(m[k]) != r9(g[k])]
        drift += [f"{name}.{fam}.{q}"
                  for fam in ("ttft_s", "tpot_s", "e2e_s")
                  for q in ("p50", "p95", "p99", "mean")
                  if r9(m[fam][q]) != r9(g[fam][q])]
    drift += [f"equivalence.{k}" for k, ok in equivalence.items() if not ok]
    drift += [f"prefill.{p}.ttft.{q}" for p, m in prefill.items()
              for q in ("p50", "p99")
              if r9(m["ttft_s"][q])
              != r9(want["prefill"]["policies"][p]["ttft_s"][q])]
    if sha != want["large"]["trace_sha256"]:
        drift.append("large.trace_sha256")
    if iters != want["large"]["decode_iterations"]:
        drift.append(f"large.decode_iterations {iters}")
    if sorted(policies) != sorted(want["policies"]) or drift:
        raise AssertionError(f"serving != BENCH_serving.json: {drift}")
    out["policies"] = {p: {k: m[k] for k in ("throughput_tok_s", "ttft_s",
                                             "tpot_s")}
                       for p, m in policies.items()}
    log(f"serving golden: policies, equivalence, prefill and the large "
        f"trace ({SERVE_LARGE['n']} requests, {iters} decode iterations, "
        f"sha256 {sha[:12]}) == BENCH_serving.json; trace table "
        f"{out['table_s']:.2f} s, replays {out['replay_s']:.3f} s, large "
        f"replay {out['large_replay_s']:.3f} s")
    return out


def serve_phase(cli_extra=(), golden=True, device=None) -> dict:
    """Phase 9: (a) :func:`serving_golden` when ``golden``; (b) the
    serving CLI at simulate fidelity on a 2-chip pipeline mesh
    (``SERVE_CLI`` plus ``cli_extra``; the table's decodes on ``device``,
    the card unless named): every bucket's costs equal the same
    artifacts evaluated with ``engine="vector"``, and the metrics JSON
    of ``--engine event`` equals ``--engine array``'s (a second run,
    its table from the flow cache); (c) serving degradation on that
    table: deadlines, shedding and retries, two runs byte-identical.
    Raises on any mismatch; returns the measurements."""
    import warnings
    from repro_torch.flow import default_pipeline, diskcache
    from repro_torch.serve import (ServeSim, make_policy, metrics_json,
                                   poisson_trace)

    out = {}
    if golden:
        out["golden"] = serving_golden()
    dev_arg = [] if device is None else ["--device", str(device)]
    pipe = default_pipeline()
    saved = (os.environ.get(diskcache.ENV_VAR), pipe.disk)
    with tempfile.TemporaryDirectory() as tmp:
        argv = SERVE_CLI + list(cli_extra) + dev_arg + [
            "--flow-cache", str(Path(tmp) / "flow")]
        try:
            with serve_captured() as (tables, arts, replays), \
                    decodes_counted() as (timing, decoders, sims):
                wall, text = run_serve_cli(
                    argv + ["--json", str(Path(tmp) / "array.json")])
            table = tables[0]
            fallbacks = sum(d.fallbacks for d in decoders)
            td = timing.as_dict()
            if (table.cache_hit or table.system is None
                    or table.fidelity != "simulate" or fallbacks
                    or not sims or timing.calls != sum(sims)):
                raise AssertionError(
                    f"serve CLI: cache hit {table.cache_hit}, system "
                    f"{table.system}, {len(sims)} torch runs, "
                    f"{timing.calls} stage passes, {fallbacks} to the "
                    f"scalar interpreter")
            with serve_captured() as (tables2, _, replays2):
                wall2, text2 = run_serve_cli(
                    argv + ["--engine", "event",
                            "--json", str(Path(tmp) / "event.json")])
        finally:
            if saved[0] is None:
                os.environ.pop(diskcache.ENV_VAR, None)
            else:
                os.environ[diskcache.ENV_VAR] = saved[0]
            pipe.disk = saved[1]
        if not tables2[0].cache_hit:
            raise AssertionError("serve CLI: second run missed the table "
                                 "cache")
        docs = {}
        for eng in ("array", "event"):
            doc = json.loads((Path(tmp) / f"{eng}.json").read_text())
            for m in doc.values():
                if m.pop("engine") != eng:
                    raise AssertionError(f"serve CLI: engine key {eng}")
            docs[eng] = metrics_json(doc)
        if docs["array"] != docs["event"]:
            raise AssertionError("serve CLI: --engine event != array")

    # every bucket's costs against the same artifacts on the vector engine
    k = table.fit_batch
    hz = table.chip.clock_ghz * 1e9
    want = {n: {} for n in ("prefill_s", "prefill_base_s",
                            "prefill_per_seq_s", "decode_base_s",
                            "decode_per_seq_s")}
    t0 = time.perf_counter()
    for _, wl, kw, art in arts:
        c1 = float(art.evaluate(engine="vector").cycles)
        ck = float(art.replace_options(batch=k).evaluate(
            engine="vector").cycles)
        per = max((ck - c1) / (k - 1), 0.0)
        if wl == "transformer":
            b = kw["seq"]
            want["prefill_s"][b] = c1 / hz
            want["prefill_per_seq_s"][b] = per / hz
            want["prefill_base_s"][b] = max(c1 - per, 0.0) / hz
        else:
            b = kw["kv_len"]
            want["decode_per_seq_s"][b] = per / hz
            want["decode_base_s"][b] = max(c1 - per, 0.0) / hz
    vector_s = time.perf_counter() - t0
    for name, costs in want.items():
        if getattr(table, "_" + name) != costs:
            raise AssertionError(f"serve table {name}: torch "
                                 f"{getattr(table, '_' + name)} != vector "
                                 f"{costs}")
    buckets = len(table.prefill_buckets) + len(table.decode_buckets)
    replay_s = sum(replays)
    build_s = wall - replay_s
    out["cli"] = {"wall_s": wall, "table_build_s": build_s,
                  "table_decode": td, "table_decode_s": decode_s(td),
                  "torch_runs": len(sims), "stage_passes": timing.calls,
                  "replay_s": replay_s, "replays": len(replays),
                  "cached_wall_s": wall2, "cached_replay_s": sum(replays2),
                  "buckets": buckets, "vector_check_s": vector_s,
                  "table": table.to_dict()}
    log(f"serve CLI (simulate, 2-chip pipeline mesh): {buckets} buckets "
        f"x 2 batches on the torch engine == the same artifacts on the "
        f"vector engine ({vector_s:.2f} s); event == array metrics JSON; "
        f"wall {wall:.2f} s: table build {build_s:.2f} s ({len(sims)} "
        f"simulator runs, {timing.calls} stage passes; decode "
        f"{decode_s(td):.3f} s: host prep {td['prep_s']:.3f} s, copies "
        f"{td['h2d_ms'] + td['d2h_ms']:.3f} ms, passes {td['pass_ms']:.3f} "
        f"ms device, host finish {td['finish_s']:.3f} s), replay "
        f"{replay_s:.3f} s for {len(replays)} policies; second run from "
        f"the table cache {wall2:.2f} s")
    for line in text.splitlines():
        if line.startswith("policy="):
            log(f"  {line}")

    # (c) serving degradation on that table
    hot = poisson_trace(**SERVE_FAULT)
    got = []
    for _ in range(2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got.append(ServeSim(table, make_policy("continuous",
                                                   SERVE_MAX_BATCH),
                                **SERVE_FAULT_KW).run(hot))
    m = got[0]
    if not (m["shed_requests"] > 0 and m["timeout_requests"] > 0
            and m["retries"] > 0
            and m["requests"] + m["shed_requests"] == len(hot)
            and metrics_json(got[0]) == metrics_json(got[1])):
        raise AssertionError(f"serving degradation: {m}")
    out["degradation"] = {k: m[k] for k in (
        "requests", "shed_requests", "timeout_requests", "retries",
        "goodput_tok_s", "throughput_tok_s")}
    log(f"serving degradation ({SERVE_FAULT}, {SERVE_FAULT_KW}): "
        f"{out['degradation']}; two runs byte-identical")
    return out


def build_triton_kernels(device) -> float:
    """Compile the SSD step's Triton variants phase 10 launches (the
    wrapper's pick at each of ``SSD_BATCHES`` at mamba2-780m's widths) by
    a launch on zero inputs: the seconds taken.  The compiles then happen
    at set-up, beside ``nvcc``, and not inside the timed phases."""
    import torch
    from repro_torch.kernels import ssd_decode as SD
    t0 = time.perf_counter()
    nh, ng, n, p = SSD_MAMBA2
    for b in SSD_BATCHES:
        SD.ssd_decode_step(
            torch.zeros((b, nh, n, p), dtype=torch.bfloat16, device=device),
            torch.zeros((b, nh, p), dtype=torch.bfloat16, device=device),
            torch.zeros((b, nh), device=device),
            torch.zeros(nh, device=device),
            torch.zeros((b, ng, n), dtype=torch.bfloat16, device=device),
            torch.zeros((b, ng, n), dtype=torch.bfloat16, device=device),
            torch.zeros(nh, device=device))
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def dev_ms(fn, device) -> float:
    """Device ms of ``fn()`` on CUDA (:func:`graph_ms`); on the CPU (a
    rehearsal only) the host's mean ms over ``REPS`` runs."""
    if str(device).startswith("cuda"):
        return graph_ms(fn, REPS)
    fn()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) * 1e3 / REPS


def within(got, want, atol: float, rtol: float) -> tuple:
    """``(max |got - want|, ok)``: elementwise
    ``|got - want| <= atol + rtol * |want|`` in fp32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool((diff <= atol + rtol * w.abs()).all()) and g.shape == w.shape
    return float(diff.max()) if diff.numel() else 0.0, ok


def scaled_within(got, want, scale: float, rtol: float) -> tuple:
    """``(max |got - want|, that over rms(want), ok)``: elementwise
    ``|got - want| <= scale * rms(want) + rtol * |want|`` in fp32."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    rms = float(w.square().mean().sqrt()) if w.numel() else 0.0
    ok = bool((diff <= scale * rms + rtol * w.abs()).all()) \
        and g.shape == w.shape
    err = float(diff.max()) if diff.numel() else 0.0
    return err, err / rms if rms else (float("inf") if err else 0.0), ok


def attention_graph_check(q, kc, vc, positions, window, failures) -> dict:
    """Two calls of the decode attention (one per position) captured in
    one CUDA graph, replayed 3 times: each replay's outputs must equal
    eager calls' bit for bit.  With several splits this shows that the
    kernel's ticket counters are back at 0 after every launch.  Before
    the last replay an eager call of a larger B * KV (``ATTN_GRAPH_LARGER``,
    also split) draws tickets too: the counters must not move, and the
    replay must still equal the eager calls."""
    import torch
    from repro_torch.kernels import decode_attention as DA
    b, s_cache, kvh, d = kc.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    boxes = DA.row_boxes(kvh, d, kc.element_size())
    big_b, big_s = ATTN_GRAPH_LARGER

    def splits_of(bb, s_end):
        return DA.attention_splits(bb * kvh, s_end, boxes, sms)[0]

    splits = [splits_of(b, min(s_cache, pos + 1)) for pos in positions]
    big_splits = splits_of(big_b, big_s)
    if min(splits) < 2 or big_splits < 2 or big_b <= b:
        failures.append(f"graph check: splits {splits} and {big_splits} at "
                        f"B {big_b}, not several / not larger")
    eager = [DA.gqa_decode_attention(q, kc, vc, pos, window)
             for pos in positions]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for pos in positions:
            DA.gqa_decode_attention(q, kc, vc, pos, window)
    torch.cuda.current_stream().wait_stream(side)
    tickets = DA._COUNTERS[q.device.index].data_ptr()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [DA.gqa_decode_attention(q, kc, vc, pos, window)
                for pos in positions]
    same = []
    for r in range(3):
        if r == 2:
            gen = torch.Generator(q.device).manual_seed(1)
            bq = torch.randn((big_b, kvh, q.shape[2], d), generator=gen,
                             device=q.device, dtype=q.dtype)
            bk, bv = (torch.randn((big_b, big_s, kvh, d), generator=gen,
                                  device=q.device, dtype=kc.dtype)
                      for _ in range(2))
            big = DA.gqa_decode_attention(bq, bk, bv, big_s - 1, window)
            big_ok = torch.equal(
                big, DA.gqa_decode_attention(bq, bk, bv, big_s - 1, window))
            moved = DA._COUNTERS[q.device.index].data_ptr() != tickets
            if moved or not big_ok:
                failures.append(f"graph check: the B {big_b} call moved the "
                                f"counters ({moved}) or differed between "
                                f"two calls ({not big_ok})")
            del bq, bk, bv, big
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(o, e) for o, e in zip(outs, eager)))
    del graph
    if not all(same):
        failures.append(f"graph check: replays equal to eager {same}")
    log(f"  attention B{b} S{s_cache} bf16, positions {list(positions)} "
        f"({splits} splits) captured in one CUDA graph: 3 replays equal "
        f"to eager calls, the last after a B{big_b} S{big_s} call "
        f"({big_splits} splits): {same}")
    return {"B": b, "S_cache": s_cache, "positions": list(positions),
            "splits": splits, "larger": [big_b, big_s, big_splits],
            "replays_equal": same}


def lm_kernels_phase(recorded, device, seed: int = 0) -> dict:
    """Phase 10a: each new kernel against its plain version on the card,
    on the shapes phase 10's runs launch and the cases of the port's
    plan, with its device time, bound and library yardstick.  Launches
    made here compare; they are not counted.  Raises on a mismatch."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ssd_decode as SD
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels import int8_matmul as I8
    from repro_torch.kernels.ops import cim_mvm, int8_matmul
    from repro_torch.kernels.ref import mvm_ref

    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    out = {"attention": [], "ssd": [], "int8_matmul": {}, "wall_s": {}}
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if dev.type == "cuda" else 132)
    t0 = time.perf_counter()

    # -- gqa_decode_attention ------------------------------------------------
    cases = [(ATTN_PHI4, c) for c in ATTN_PHI4_CASES] \
        + [(ATTN_DANUBE, c) for c in ATTN_DANUBE_CASES]
    failures = []
    for (arch, kvh, g, d, window), (b, s_cache, positions) in cases:
        q = torch.randn((b, kvh, g, d), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        shape = (b, s_cache, kvh, d)
        caches = {
            "bf16": [torch.randn(shape, generator=gen, device=dev,
                                 dtype=torch.bfloat16) for _ in range(2)],
            "int8": [torch.randint(-127, 128, shape, generator=gen,
                                   device=dev, dtype=torch.int8)
                     for _ in range(2)]}
        if (arch, b, s_cache) == (ATTN_PHI4[0],) + ATTN_PHI4_CASES[0][:2]:
            # float32, a reduced config's compute dtype: the kernel's
            # full-precision dot
            caches["f32"] = [c.float() for c in caches["bf16"]]
        for kind, (kc, vc) in caches.items():
            qk = q.float() if kind == "f32" else q
            # the plain version on fp32 inputs: fp32 scores, as the kernel
            q32, k32, v32 = (qk.float(), DA.kv_load(kc, torch.float32),
                             DA.kv_load(vc, torch.float32))
            cdt = str(qk.dtype).removeprefix("torch.")
            tol32, tol_ref = ATTN_TOL_F32[cdt], ATTN_TOL_REF[cdt]
            for pos in positions:
                case = f"{arch} B{b} S{s_cache} {kind} pos {pos}"
                before = DA.gqa_decode_attention.launches
                t_first = time.perf_counter()
                got = DA.gqa_decode_attention(qk, kc, vc, pos, window)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                t_first = time.perf_counter() - t_first
                per_call = DA.gqa_decode_attention.launches - before
                if dev.type == "cuda" and per_call != 1:
                    failures.append(f"{case}: {per_call} launches a call")
                want = DA.gqa_decode_attention_ref(qk, kc, vc, pos, window)
                want32 = DA.gqa_decode_attention_ref(q32, k32, v32, pos,
                                                     window)
                err, rel, ok = scaled_within(got, want, *tol_ref)
                err32, rel32, ok32 = scaled_within(got, want32, *tol32)
                # on the CPU (a rehearsal) the wrapper runs the plain
                # version itself, which rounds the scores to bf16
                ok32 = ok32 or dev.type != "cuda"
                if not (ok and ok32):
                    failures.append(f"{case}: |err| / rms {rel:.3g} (plain)"
                                    f", {rel32:.3g} (fp32 plain)")
                fault_rel = None
                if s_cache >= ATTN_FAULT_MIN_S and kind != "f32":
                    # planted fault: the last block of the stretch
                    # dropped, or the window one block short
                    f_pos, f_win = ((pos - ATTN_FAULT_SLOTS, None)
                                    if window is None
                                    else (pos, window - ATTN_FAULT_SLOTS))
                    bad = DA.gqa_decode_attention(qk, kc, vc, f_pos, f_win)
                    _, fault_rel, caught = scaled_within(bad, want32, *tol32)
                    caught = not caught
                    if not caught:
                        failures.append(f"{case}: planted fault (pos "
                                        f"{f_pos}, window {f_win}) passes, "
                                        f"|err| / rms {fault_rel:.3g}")
                s_end = min(s_cache, pos + 1)
                elt = {"int8": 1, "bf16": 2, "f32": 4}[kind]
                splits = DA.attention_splits(
                    b * kvh, s_end, DA.row_boxes(kvh, d, elt), sms)[0]
                n_bytes = 2 * b * s_end * kvh * d * elt \
                    + 2 * b * kvh * g * d * qk.element_size()
                n_ops = 4.0 * b * kvh * g * s_end * d
                t_b = n_bytes / PEAK_BYTES
                t_o = n_ops / (PEAK_F32_OPS if kind == "f32"
                               else PEAK_BF16_OPS)
                row = {"arch": arch, "B": b, "S_cache": s_cache, "KV": kvh,
                       "G": g, "D": d, "window": window, "kv": kind,
                       "pos": pos, "slots_read": s_end, "max_abs_err": err,
                       "err_over_rms": rel, "max_abs_err_f32": err32,
                       "err_f32_over_rms": rel32,
                       "rms": float(want32.float().square().mean().sqrt()),
                       "fault_err_over_rms": fault_rel,
                       "first_call_s": t_first, "splits": splits,
                       "launches_per_call": per_call,
                       "ms": dev_ms(lambda: DA.gqa_decode_attention(
                           qk, kc, vc, pos, window), dev),
                       "plain_ms": dev_ms(lambda: DA.gqa_decode_attention_ref(
                           qk, kc, vc, pos, window), dev),
                       "bound_ms": 1e3 * max(t_b, t_o),
                       "bound_by": "bytes" if t_b >= t_o else "operations",
                       "library_ms": None}
                valid = DA.ring_valid(pos, s_cache, window, dev)
                if kind == "bf16" and bool(valid[:s_end].all()) \
                        and not bool(valid[s_end:].any()) \
                        and dev.type == "cuda":
                    # the same function for one PyTorch call: SDPA (GQA)
                    # over the valid slots of the bf16 cache
                    qh = q.reshape(b, kvh * g, 1, d)
                    kh = kc[:, :s_end].permute(0, 2, 1, 3)
                    vh = vc[:, :s_end].permute(0, 2, 1, 3)
                    lib = F.scaled_dot_product_attention(qh, kh, vh,
                                                         enable_gqa=True)
                    _, rel_l, ok_l = scaled_within(
                        lib.reshape(b, kvh, g, d), want, *tol_ref)
                    if not ok_l:
                        failures.append(f"{case}: SDPA disagrees with the "
                                        f"plain version, {rel_l:.3g}")
                    row["library_ms"] = dev_ms(
                        lambda: F.scaled_dot_product_attention(
                            qh, kh, vh, enable_gqa=True), dev)
                out["attention"].append(row)
                lib_s = ("-" if row["library_ms"] is None
                         else f"{row['library_ms']:.4f}")
                fault_s = ("" if fault_rel is None
                           else f", planted fault {fault_rel:.3g}")
                log(f"  attention {case}: {splits} split(s), {per_call} "
                    f"launch(es) a call, first call {t_first:.3f} s, "
                    f"|err| / rms {rel:.3g} (plain), {rel32:.3g} (fp32 "
                    f"plain){fault_s}; kernel {row['ms']:.4f} ms, plain "
                    f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f}"
                    f" ms ({row['bound_by']}), SDPA {lib_s} ms")
        if (b, s_cache) == ATTN_GRAPH[:2] and dev.type == "cuda":
            out["attention_graph"] = attention_graph_check(
                q, *caches["bf16"], ATTN_GRAPH[2], window, failures)
        del caches, k32, v32
    if failures:
        raise AssertionError("gqa_decode_attention: " + "; ".join(failures))

    out["wall_s"]["attention"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- ssd_decode_step -------------------------------------------------------
    nh, ng, n, p = SSD_MAMBA2
    for b in SSD_BATCHES:
        h = torch.randn((b, nh, n, p), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        x = torch.randn((b, nh, p), generator=gen, device=dev,
                        dtype=torch.bfloat16)
        dt = F.softplus(torch.randn((b, nh), generator=gen, device=dev))
        a_log = torch.log(torch.linspace(1.0, 16.0, nh, device=dev))
        bb = torch.randn((b, ng, n), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        cc = torch.randn((b, ng, n), generator=gen, device=dev,
                         dtype=torch.bfloat16)
        dd = torch.randn((nh,), generator=gen, device=dev)
        want_y, want_h = SD.ssd_decode_step_ref(h, x, dt, a_log, bb, cc, dd)
        hk = h.clone()
        got_y, got_h = SD.ssd_decode_step(hk, x, dt, a_log, bb, cc, dd)
        err_y, ok_y = within(got_y, want_y, *SSD_TOL_Y)
        err_h, ok_h = within(got_h, want_h, *SSD_TOL_H)
        if not (ok_y and ok_h):
            raise AssertionError(f"ssd_decode_step B{b}: |err| y {err_y}, "
                                 f"h {err_h}")
        hw = h.clone()
        n_el = b * nh * n * p
        n_bytes = 2 * n_el * 2 + b * nh * p * (2 + 4) + b * nh * 4 \
            + 2 * b * ng * n * 2
        t_b, t_o = n_bytes / PEAK_BYTES, 6.0 * n_el / PEAK_F32_OPS
        row = {"B": b, "heads": nh, "d_state": n, "head_dim": p,
               "max_abs_err": max(err_y, err_h), "err_y": err_y,
               "err_h": err_h,
               "ms": dev_ms(lambda: SD.ssd_decode_step(
                   hw, x, dt, a_log, bb, cc, dd), dev),
               "plain_ms": dev_ms(lambda: SD.ssd_decode_step_ref(
                   h, x, dt, a_log, bb, cc, dd), dev),
               "bound_ms": 1e3 * max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations",
               "library_ms": None}
        row["block_p"] = SD.ssd_grid(b * nh, p, sms)
        out["ssd"].append(row)
        log(f"  ssd_decode_step B{b}: err y {err_y:.2e} h {err_h:.2e}, "
            f"kernel {row['ms']:.4f} ms (BLOCK_P {row['block_p']}), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']})")

    out["wall_s"]["ssd"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # -- int8_matmul: bit-exact to the bit-serial kernel ---------------------
    # the 55 MVMs of phase 3 through ops.int8_matmul (the planner's route
    # for each; large M takes the bit-serial source's tiles) beside the tile
    # route for all of them (bsm.int8_matmul_cuda)
    tot = dict.fromkeys(("ms", "previous_ms", "plain_ms", "library_ms"), 0.0)
    n_cmp = 0
    for _, a, m in recorded:
        got = int8_matmul(a, m)
        if not torch.equal(got, cim_mvm(a, m)):
            raise AssertionError(f"int8_matmul != cim_mvm on "
                                 f"{tuple(a.shape)}x{tuple(m.shape)}")
        n_cmp += 1
    by_shape = {}
    for _, a, m in recorded:
        by_shape.setdefault((a.shape[0], a.shape[1], m.shape[1]),
                            [a, m, 0])[2] += 1
    tot["routes"] = {}
    for (mm, kk, nn), (a, m, count) in by_shape.items():
        route = I8.plan(mm, nn, kk, sms).route
        tot["routes"][route] = tot["routes"].get(route, 0) + count
        fns = {"ms": lambda: int8_matmul(a, m),
               "previous_ms": lambda: bsm.int8_matmul_cuda(a, m),
               "plain_ms": lambda: mvm_ref(a, m)}
        if dev.type == "cuda":
            ia, iw = int_mm_operands(a, m)
            fns["library_ms"] = lambda: torch._int_mm(ia, iw)
        else:
            fns.pop("previous_ms")
        for key, fn in fns.items():
            tot[key] += count * dev_ms(fn, dev)
    tot["bound_ms"], tot["bound_by"] = bound(
        [(a.shape[0], a.shape[1], m.shape[1]) for _, a, m in recorded])
    out["int8_matmul_55"] = tot
    log(f"  int8_matmul == cim_mvm on all {n_cmp} main-path MVMs (routes "
        f"{tot['routes']}); summed: kernel {tot['ms']:.4f} ms, the tile route "
        f"{tot['previous_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms, torch._int_mm {tot['library_ms']} ms")
    out["int8_matmul"] = int8_matmul_checks(dev, gen, sms)
    out["wall_s"]["int8_matmul"] = time.perf_counter() - t0
    log("  10a wall s: " + ", ".join(f"{k} {v:.1f}"
                                    for k, v in out["wall_s"].items()))
    return out


def cold_ms(fn, x, w, device) -> float:
    """Device ms of ``fn(x, w_i)`` with the weight read cold: calls over
    enough copies of ``w`` to pass 150 MB (three times the H100's 50 MB L2),
    each once, captured in one CUDA graph and replayed (:func:`graph_ms`
    replays the same operands, which then stay in L2).  On the CPU (a
    rehearsal only) :func:`dev_ms` of one call."""
    import torch
    if not str(device).startswith("cuda"):
        return dev_ms(lambda: fn(x, w), device)
    n = max(REPS, -(-150_000_000 // w.numel()))
    copies = [w] + [w.clone() for _ in range(n - 1)]
    calls = [lambda c=c: fn(x, c) for c in copies]
    t = graph_seq_ms(calls)
    del copies, calls
    return t


def plan_row(p) -> dict:
    """A stream or tile plan as JSON: route, strip width, K slices, blocks,
    stages of the ring (0 for the tiles), K rows a slice."""
    from repro_torch.kernels import int8_matmul as I8
    stream = p.route == "stream"
    return {"route": p.route, "strip_n": I8.BOX if stream else p.tile[1],
            "slices": p.slices, "blocks": p.blocks,
            "stages": I8.STAGES if stream else 0,
            "k_per_slice": p.k_per_slice}


def int8_matmul_checks(device, gen, sms: int) -> dict:
    """Phase 10a's ``int8_matmul`` at 10d's shapes: the stream kernel
    (``csrc/int8_matmul.cu``) through ``ops.int8_matmul``, each shape's plan
    asserted as planned (``STREAM_PLANS``), bit-exact to ``cim_mvm`` and to
    its plain split algorithm (``int8_matmul_splits_ref``), timed beside
    the tile route (``bsm.int8_matmul_cuda``, the bit-serial source's one-pass
    tiles) in the same call, the plain version, ``torch._int_mm`` and the
    bound, hot (graph replay of the same operands) and cold (the weight
    read from HBM, :func:`cold_ms`); the edge cases ``I8_EDGES`` and the
    int32 wrap-around through the stream route; the tile route's
    wrap-around with one K slice and with split K; a CUDA-graph replay of
    the four shapes equal to eager calls, with an eager call of another
    shape between replays; the floor of a graph-replayed stream launch
    (1x64x16).  Raises on a mismatch."""
    import torch
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels import int8_matmul as I8
    from repro_torch.kernels.ops import cim_mvm, int8_matmul
    from repro_torch.kernels.ref import mvm_ref

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def rnd(*shape):
        return torch.randint(-128, 128, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    def exact(a, m, label):
        p = I8.plan(a.shape[0], m.shape[1], a.shape[1], sms)
        got = int8_matmul(a, m)
        if not (torch.equal(got, cim_mvm(a, m))
                and torch.equal(got, I8.int8_matmul_splits_ref(a, m, p))):
            raise AssertionError(f"int8_matmul {label} {tuple(a.shape)}x"
                                 f"{tuple(m.shape)} differs from cim_mvm or "
                                 f"its split algorithm")
        return p, got

    res = {"ql_shapes": []}
    keys = ("ms", "previous_ms", "plain_ms", "library_ms", "bound_ms",
            "ms_cold", "previous_ms_cold", "plain_ms_cold", "library_ms_cold")
    tot = dict.fromkeys(keys, 0.0)
    ops_ql = []
    for (mm, kk, nn), want in zip(QL_SHAPES, STREAM_PLANS):
        a, m = rnd(mm, kk), rnd(kk, nn)
        p, _ = exact(a, m, "QL")
        got_plan = (p.route, p.k_per_slice, p.slices, p.blocks)
        if got_plan != want:
            raise AssertionError(f"{mm}x{kk}x{nn}: plan {got_plan}, "
                                 f"planned {want}")
        b_ms, b_by = bound([(mm, kk, nn)])
        r = {"M": mm, "K": kk, "N": nn, "plan": plan_row(p),
             "bound_ms": b_ms, "bound_by": b_by,
             "ms": dev_ms(lambda: int8_matmul(a, m), dev),
             "plain_ms": dev_ms(lambda: mvm_ref(a, m), dev),
             "previous_ms": None, "library_ms": None, "ms_cold": None,
             "previous_ms_cold": None, "plain_ms_cold": None,
             "library_ms_cold": None}
        if cuda:
            ia, iw = int_mm_operands(a, m)
            r["previous_ms"] = dev_ms(lambda: bsm.int8_matmul_cuda(a, m), dev)
            r["library_ms"] = dev_ms(lambda: torch._int_mm(ia, iw), dev)
            r["ms_cold"] = cold_ms(int8_matmul, a, m, dev)
            r["previous_ms_cold"] = cold_ms(bsm.int8_matmul_cuda, a, m, dev)
            r["plain_ms_cold"] = cold_ms(mvm_ref, a, m, dev)
            r["library_ms_cold"] = cold_ms(torch._int_mm, ia, iw, dev)
            if r["ms"] >= r["previous_ms"]:
                raise AssertionError(
                    f"int8_matmul {mm}x{kk}x{nn}: the stream kernel "
                    f"{r['ms']:.4f} ms is not faster than the tile route "
                    f"{r['previous_ms']:.4f} ms")
        r["pct_bound"] = 100 * b_ms / r["ms"]
        if r["ms_cold"] is not None:
            r["pct_bound_cold"] = 100 * b_ms / r["ms_cold"]
        for key in keys:
            if r[key] is not None:
                tot[key] += r[key]
        res["ql_shapes"].append(r)
        ops_ql.append((a, m))
        log(f"  int8_matmul {mm}x{kk}x{nn} ({p.route}: strips of "
            f"{I8.BOX}, {p.slices} K slices, {p.blocks} blocks, "
            f"{I8.STAGES} stages): kernel {r['ms']:.4f} ms "
            f"({r['pct_bound']:.0f}% of bound {b_ms:.4f} ms, {b_by}), the "
            f"tile route {r['previous_ms']} ms, plain {r['plain_ms']:.4f} ms, "
            f"torch._int_mm {r['library_ms']} ms; cold: kernel "
            f"{r['ms_cold']} ms ({r.get('pct_bound_cold', 0):.0f}% of bound), "
            f"the tile route {r['previous_ms_cold']} ms, plain "
            f"{r['plain_ms_cold']} ms, torch._int_mm {r['library_ms_cold']} "
            f"ms")
    res.update(tot)
    res["bound_by"] = bound(QL_SHAPES)[1]
    res["pct_bound"] = 100 * tot["bound_ms"] / tot["ms"]
    res["pct_bound_cold"] = (100 * tot["bound_ms"] / tot["ms_cold"]
                             if cuda else 0.0)
    log(f"  int8_matmul over the {len(QL_SHAPES)} shapes: kernel "
        f"{tot['ms']:.4f} ms, the tile route {tot['previous_ms']:.4f} ms, "
        f"bound {tot['bound_ms']:.4f} ms ({res['pct_bound']:.0f}%), plain "
        f"{tot['plain_ms']:.4f} ms, torch._int_mm {tot['library_ms']:.4f} ms;"
        f" cold: kernel {tot['ms_cold']:.4f} ms ({res['pct_bound_cold']:.0f}%"
        f"), the tile route {tot['previous_ms_cold']:.4f} ms, plain "
        f"{tot['plain_ms_cold']:.4f} ms, torch._int_mm "
        f"{tot['library_ms_cold']:.4f} ms")

    # edge cases through the stream route
    for mm, kk, nn in I8_EDGES + list(I8_CLUSTER_EDGES):
        p, _ = exact(rnd(mm, kk), rnd(kk, nn), "edge")
        split = I8_CLUSTER_EDGES.get((mm, kk, nn), (p.k_per_slice, p.slices))
        if p.route != "stream" or (p.k_per_slice, p.slices) != split:
            raise AssertionError(f"edge {mm}x{kk}x{nn}: plan {plan_row(p)}")
    # the int32 wrap-around through ops.int8_matmul on the stream route:
    # N = 16 (K in 8 slices) and N = 64 per SM (more blocks than SMs); and
    # on the tile route (the bit-serial source's tiles, which larger M
    # takes): N = 3 (split K) and N = 64 per SM (one K slice)
    k = (1 << 17) + 1
    xw = torch.full((2, k), -128, dtype=torch.int8, device=dev)
    wrapped = (k * 16384 + 2**31) % 2**32 - 2**31
    wrap_cases = [(16, I8.SLICES), (64 * sms, None)] if cuda else [(16, 8)]
    for n, slices in wrap_cases:
        p = I8.plan(2, n, k, sms)
        if p.route != "stream" or p.slices < 2 \
                or (slices is not None and p.slices != slices):
            raise AssertionError(f"wrap-around N {n}: plan {plan_row(p)}")
        ww = torch.full((k, n), -128, dtype=torch.int8, device=dev)
        _, got = exact(xw, ww, "wrap-around")
        if not bool((got == wrapped).all()):
            raise AssertionError(f"int8_matmul wrap-around N {n}: "
                                 f"{got.unique().tolist()}")
        del ww
    for n, one_slice in ((3, False), (64 * sms, True)) if cuda else ():
        if (bsm.choose_blocks(2, n, k, sms)[2] >= k) != one_slice:
            raise AssertionError(f"wrap-around N {n}: the tiles' K split "
                                 f"is not as planned")
        ww = torch.full((k, n), -128, dtype=torch.int8, device=dev)
        got = bsm.int8_matmul_cuda(xw, ww)
        if not bool((got == wrapped).all()) \
                or not torch.equal(got, cim_mvm(xw, ww)):
            raise AssertionError(f"the tile route wrap-around N {n}: "
                                 f"{got.unique().tolist()}")
        del ww
    if cuda:
        # the four shapes' calls in one CUDA graph: replays equal eager
        # calls, also after an eager call of another shape between them
        other = (rnd(16, 3000), rnd(3000, 1008))
        eager = [int8_matmul(a, m) for a, m in ops_ql]
        outs = []
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for a, m in ops_ql:
                int8_matmul(a, m)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            outs = [int8_matmul(a, m) for a, m in ops_ql]
        for rep in range(3):
            for o in outs:
                o.fill_(0)
            graph.replay()
            torch.cuda.synchronize()
            if not all(torch.equal(o, e) for o, e in zip(outs, eager)):
                raise AssertionError(f"int8_matmul graph replay {rep} "
                                     f"differs from eager calls")
            exact(*other, "between replays")
        del graph
        fx, fw = rnd(1, 64), rnd(64, 16)
        res["floor_ms"] = dev_ms(lambda: int8_matmul(fx, fw), dev)
        res["floor_empty_ms"] = dev_ms(lambda: fx.add_(0), dev)
        log(f"  int8_matmul: {len(I8_EDGES) + len(I8_CLUSTER_EDGES)} edge "
            f"cases (one-stage slices and a 16-block cluster among them) and "
            f"the wrap-around "
            f"exact on the stream route; CUDA-graph replay (x3) of the "
            f"{len(ops_ql)} shapes == eager calls; floor of a graph-replayed "
            f"stream launch (1x64x16) {res['floor_ms']:.4f} ms (an int8 add_ "
            f"of 64 bytes {res['floor_empty_ms']:.4f} ms)")
    res.update(compared=len(QL_SHAPES) + len(I8_EDGES)
               + len(I8_CLUSTER_EDGES) + len(wrap_cases),
               max_abs_err=0)
    return res


def ql_drive(device, seed: int = 0) -> dict:
    """Phase 10d: ``quantized_linear``, the INT8 linear of the LM stack
    (``repro_torch.kernels.ops``), driven as a user calls it at
    phi4-mini's decode projections: forward on both routes (equal to
    each other and to ``quantized_linear_ref``, tolerance 0), then the
    straight-through backward of the default route.  Returns the
    launches of ``int8_matmul`` by route and of the bit-serial kernel;
    on CUDA all of ``int8_matmul``'s must take the stream route."""
    import torch
    from repro_torch.kernels import bitserial_mvm as bsm
    from repro_torch.kernels import int8_matmul as I8
    from repro_torch.kernels.ops import quantized_linear
    from repro_torch.kernels.ref import quantized_linear_ref

    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    ops = [(torch.randn((mm, kk), generator=gen, device=dev),
            torch.randint(-128, 128, (kk, nn), generator=gen, device=dev,
                          dtype=torch.int8)) for mm, kk, nn in QL_SHAPES]
    for route in I8.launches_by_route:
        I8.launches_by_route[route] = 0
    bsm.int8_matmul_cuda.launches = 0
    bsm.bitserial_mvm.launches = 0
    t0 = time.perf_counter()
    for x, w in ops:
        x = x.requires_grad_(True)
        scales = (float(x.detach().abs().max()) / 127.0, 0.01)
        y = quantized_linear(x, w, scales)
        y_cim = quantized_linear(x.detach(), w, scales, use_pallas=True)
        y.sum().backward()
        y_ref = quantized_linear_ref(x.detach(), w, scales[1], scales[0])
        if not (torch.equal(y.detach(), y_cim)
                and torch.equal(y_cim, y_ref)
                and bool(torch.isfinite(x.grad).all())):
            raise AssertionError(f"quantized_linear {tuple(w.shape)}: the "
                                 f"routes and the plain version differ")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = {"int8_matmul_launches": I8.launches_by_route["stream"],
           "int8_matmul_routes": dict(I8.launches_by_route),
           "tile_launches": bsm.int8_matmul_cuda.launches,
           "bitserial_launches": bsm.bitserial_mvm.launches, "wall_s": wall}
    if dev.type == "cuda" and (
            res["int8_matmul_launches"] != len(QL_SHAPES)
            or res["int8_matmul_routes"]["tile"] != 0
            or res["tile_launches"] != 0
            or res["bitserial_launches"] != len(QL_SHAPES)):
        raise AssertionError(f"quantized_linear drive launches {res}")
    return res


def lm_model_phase(name: str, device, layers: int = LM_MODEL_LAYERS,
                   steps: int = LM_MODEL_STEPS, batch: int = LM_MODEL_BATCH,
                   seed: int = 0) -> dict:
    """Phase 10b: ``name`` at its published widths and vocabulary, cut to
    ``layers`` layers, random weights from ``seed``: ``steps``
    teacher-forced decode steps on ``device`` (the kernels) and with the
    same bf16 parameters on the CPU (the plain versions).  The logits
    must agree within ``LOGIT_TOL`` of their range; returns the largest
    gap and how often the argmax agrees."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import make_batch
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    dev = torch.device(device)
    cfg = dataclasses.replace(ARCHS[name], n_layers=layers)
    cast = T.cast_params(cfg, T.init_params(
        cfg, torch.Generator(dev).manual_seed(seed), dev))
    cpu = cast.map(lambda t: t.to("cpu"))
    cpu.compute_dtype = cast.compute_dtype
    tokens = torch.from_numpy(make_batch(cfg, batch, steps, seed=seed,
                                         step=0)["tokens"])
    st_dev = T.init_decode_state(cfg, cast, batch, steps)
    st_cpu = T.init_decode_state(cfg, cpu, batch, steps)
    worst, agree, t_dev, t_cpu = 0.0, 0, 0.0, 0.0
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        t0 = time.perf_counter()
        got, st_dev = T.decode_step(cfg, cast, st_dev, tok.to(dev))
        got = got.cpu()
        t_dev += time.perf_counter() - t0
        t0 = time.perf_counter()
        want, st_cpu = T.decode_step(cfg, cpu, st_cpu, tok)
        t_cpu += time.perf_counter() - t0
        gap = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not (bool(torch.isfinite(got).all()) and gap <= LOGIT_TOL * scale):
            raise AssertionError(f"{name} step {t}: max |card - cpu| {gap} "
                                 f"over max |logit| {scale}")
        worst = max(worst, gap / scale)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    return {"arch": name, "layers": layers, "steps": steps, "batch": batch,
            "wall_s": time.perf_counter() - t_start,
            "max_gap_over_range": worst,
            "argmax_agree": agree / (steps * batch),
            "device_s": t_dev, "cpu_s": t_cpu}


def run_lm_serve(argv) -> tuple:
    """``(s, stdout)`` of ``repro_torch.launch.serve.main(argv)``, which
    must return 0 (it asserts finite logits itself)."""
    from repro_torch.launch.serve import main as lm_main
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = lm_main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"launch.serve {argv}: exit {rc}")
    return wall, buf.getvalue()


def decode_profile(args, steps: int = 8) -> tuple:
    """One ``torch.profiler`` trace of ``steps`` steady-state decode steps
    of the served configuration (``args`` as the CLI parsed them: its
    caches, the prompt stepped through first, then ``steps`` more tokens
    traced), built through the same entry points: :func:`device_profile`'s
    ``(wall ms, device busy ms, top events)``."""
    import torch
    from repro_torch.configs import ARCHS, ShapeConfig, reduced
    from repro_torch.data import make_batch
    from repro_torch.launch import steps as lm_steps
    from repro_torch.models import transformer as T

    cfg = reduced(ARCHS[args.arch]) if args.reduced else ARCHS[args.arch]
    dev = torch.device("cuda", 0) if args.device is None \
        else torch.device(args.device)
    total = args.prompt_len + args.gen
    end = args.prompt_len + min(steps, args.gen)
    params = T.cast_params(cfg, T.init_params(
        cfg, torch.Generator(dev).manual_seed(args.seed), dev))
    fn, _ = lm_steps.make_decode_step(
        cfg, dev, ShapeConfig("profile", total, args.batch, "decode"))
    tokens = torch.from_numpy(make_batch(cfg, args.batch, end,
                                         seed=args.seed, step=0)["tokens"])
    tokens = tokens.to(dev)
    state = T.init_decode_state(cfg, params, args.batch, total)
    for t in range(args.prompt_len):
        _, state = fn(params, state, tokens[:, t:t + 1])

    def run():
        nonlocal state
        for t in range(args.prompt_len, end):
            _, state = fn(params, state, tokens[:, t:t + 1])

    return device_profile(run)


def lm_serve_phase(runs=LM_SERVE_RUNS, extra=(), device=None,
                   profile: bool = False) -> dict:
    """Phase 10c: ``python -m repro_torch.launch.serve`` through
    ``main(argv)`` for each of ``runs`` (``LM_SERVE_ARGS`` plus the run's
    and ``extra`` arguments; the INT8 KV cache by
    ``tuning.tuned(int8_kv_cache=True)``), the decode kernels' launch
    counts set to 0 just before each run and read just after: one
    attention launch per attention layer and token, one SSD launch per
    SSD layer and token.  Prints the CLI's lines; ``profile`` traces
    one more run of each for the device-busy share."""
    import re
    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ssd_decode as SD
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import tuning

    dev_arg = [] if device is None else ["--device", str(device)]
    on_card = device is None or str(device).startswith("cuda")
    out = []
    for label, run_argv, int8 in runs:
        argv = LM_SERVE_ARGS + list(run_argv) + list(extra) + dev_arg
        args = lm_serve.parser().parse_args(argv)
        cfg = ARCHS[args.arch]
        if args.reduced:
            cfg = reduced(cfg)
        tokens = args.prompt_len + args.gen
        n_attn = cfg.n_blocks * cfg.block_pattern.count("A")
        n_ssm = cfg.n_blocks * cfg.block_pattern.count("M")

        def knob():
            return (tuning.tuned(int8_kv_cache=True) if int8
                    else contextlib.nullcontext())

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        DA.gqa_decode_attention.launches = 0
        SD.ssd_decode_step.launches = 0
        with knob():
            wall, text = run_lm_serve(argv)
        launched = (DA.gqa_decode_attention.launches,
                    SD.ssd_decode_step.launches)
        lines = text.strip().splitlines()
        m = re.fullmatch(r"prefill: (\S+)s  decode: (\S+)s \((\S+) tok/s\)",
                         lines[1])
        if len(lines) != 3 or m is None or not lines[2].startswith(
                "sample token ids: "):
            raise AssertionError(f"{label}: output {lines}")
        row = {"label": label, "argv": argv, "int8_kv": int8,
               "wall_s": wall, "prefill_s": float(m.group(1)),
               "decode_s": float(m.group(2)), "tok_s": float(m.group(3)),
               "attention_launches": launched[0],
               "ssd_launches": launched[1], "lines": lines}
        if on_card:
            want = (tokens * n_attn, tokens * n_ssm)
            if launched != want:
                raise AssertionError(f"{label}: launches {launched}, "
                                     f"expected {want}")
            row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if profile and on_card:
            with knob():
                p_wall, busy, top = decode_profile(args)
            row.update(profiled_wall_ms=p_wall, device_busy_ms=busy,
                       top_device_events=top)
        out.append(row)
        for line in lines:
            log(f"  {line}")
        msg = (f"  {label}: {wall:.2f} s in all, launches attention "
               f"{launched[0]}, SSD {launched[1]}")
        if "peak_gb" in row:
            msg += f", peak device memory {row['peak_gb']:.2f} GB"
        if "device_busy_ms" in row:
            busy, p_wall = row["device_busy_ms"], row["profiled_wall_ms"]
            msg += (f"; 8 traced decode steps: device busy {busy:.1f} of "
                    f"{p_wall:.1f} ms ({100 * busy / p_wall:.1f}%)")
        log(msg)
    return {"runs": out}


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

    # 1. build: one nvcc per CUDA source, each in a thread, while Triton
    # compiles the SSD step ---------------------------------------------------
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import nvcc
    t0 = time.perf_counter()
    from repro_torch.kernels import int8_matmul as I8
    with ThreadPoolExecutor(3) as pool:
        built = [pool.submit(bsm.build_library), pool.submit(DA.build_library),
                 pool.submit(I8.build_library)]
        report["triton_build_s"] = build_triton_kernels(dev)
        libs = [f.result() for f in built]
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {', '.join(lib.name for lib in libs)} and the Triton SSD "
        f"step in {report['build_s']:.2f} s (Triton "
        f"{report['triton_build_s']:.2f} s of it)")
    for name, text in sorted(nvcc.BUILD_LOGS.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas ({name}): {line.strip()}")

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

    # 6. the simulate fidelity: torch engine, fleet, trace --------------------
    report["simulate"] = simulate_phase(PATHS, N_FLEET)
    log(f"simulate phase done [{card}]")

    # 7. design-space exploration and faults --------------------------------
    report["explore"] = explore_phase(EXPLORE_PATH)
    report["faults"] = faults_phase(GOLDEN_FAULTS, EXPLORE_PATH)
    launches_total += report["faults"]["launches"]
    log(f"explore and faults phase done; kernel launches: {launches_total}"
        f" on the main paths ({launches_total - report['faults']['launches']}"
        f" in phase 3, {report['faults']['launches']} in phase 7) [{card}]")

    # 8. the mesh of chips ---------------------------------------------------
    t0 = time.perf_counter()
    report["mesh"] = mesh_phase()
    launches_total += report["mesh"]["launches"]
    report["mesh"]["wall_s"] = time.perf_counter() - t0
    log(f"mesh phase done in {report['mesh']['wall_s']:.1f} s; "
        f"{report['mesh']['launches']} kernel launches in 8d [{card}]")

    # 9. serving ---------------------------------------------------------------
    t0 = time.perf_counter()
    report["serve"] = serve_phase()
    report["serve"]["wall_s"] = time.perf_counter() - t0
    log(f"serving phase done in {report['serve']['wall_s']:.1f} s; kernel "
        f"launches on the main paths: {launches_total} [{card}]")

    # 10. LM serving (python -m repro_torch.launch.serve) and its kernels -----
    t0 = time.perf_counter()
    log(f"phase 10a: the LM kernels against their plain versions (device "
        f"memory at the start: {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB reserved)")
    lmk = lm_kernels_phase(recorded, dev, args.seed)
    log("phase 10b: the model at full width, 2 layers: kernels (card) "
        "against the plain versions (CPU)")
    models = [lm_model_phase(name, dev, seed=args.seed)
              for name in LM_MODEL_ARCHS]
    for r in models:
        log(f"  {r['arch']} x{r['layers']} layers, {r['steps']} steps at "
            f"batch {r['batch']}: max |card - cpu| / max |logit| "
            f"{r['max_gap_over_range']:.4f} (tolerance {LOGIT_TOL}), argmax "
            f"agrees {100 * r['argmax_agree']:.1f}%; card {r['device_s']:.2f}"
            f" s, cpu {r['cpu_s']:.2f} s of {r['wall_s']:.1f} s")
    log("phase 10c: python -m repro_torch.launch.serve at full depth")
    lms = lm_serve_phase(profile=True)
    log("phase 10d: quantized_linear driven at phi4-mini's projections")
    ql = ql_drive(dev, args.seed)
    launches_total += ql["bitserial_launches"]
    report["lm"] = {"kernels": lmk, "models": models, "serve": lms,
                    "quantized_linear": ql,
                    "wall_s": time.perf_counter() - t0}
    log(f"LM phase done in {report['lm']['wall_s']:.1f} s; quantized_linear "
        f"launched int8_matmul {ql['int8_matmul_launches']} times on the "
        f"stream route (routes {ql['int8_matmul_routes']}) and the "
        f"bit-serial kernel {ql['bitserial_launches']} times [{card}]")

    def main_row(rows, **key):
        for r in rows:
            if all(r[k] == v for k, v in key.items()):
                return r
        raise AssertionError(f"no row {key}")

    runs = lms["runs"]
    attn = main_row(lmk["attention"], arch=ATTN_PHI4[0], B=4, S_cache=64,
                    kv="bf16", pos=63)
    ssd = main_row(lmk["ssd"], B=4)
    i8 = lmk["int8_matmul"]
    i8_55 = lmk["int8_matmul_55"]
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
    }, {
        "name": "int8_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/int8_matmul.cu",
        "replaces": "src/repro/kernels/ops.py:80",
        "launches": ql["int8_matmul_launches"],
        "max_abs_err": i8["max_abs_err"],
        # the times held against the HBM bound: cold, w read from HBM as a
        # decode step reads it, summed over QL_SHAPES
        "ms": i8["ms_cold"],
        "plain_ms": i8["plain_ms_cold"],
        "bound_ms": i8["bound_ms"],
        "bound_by": i8["bound_by"],
        "library_ms": i8["library_ms_cold"],
        "previous_ms": i8["previous_ms_cold"],
        # graph replay of the same operands: w resident in the 50 MB L2,
        # no share of the HBM bound
        "ms_l2_resident": i8["ms"],
        "previous_ms_l2_resident": i8["previous_ms"],
        # the entry's PR 16-17 definition: ops.int8_matmul summed over the
        # 55 MVMs of phase 3 (hot), beside the tile route and its bound
        "ms_55": i8_55["ms"],
        "previous_ms_55": i8_55["previous_ms"],
        "bound_ms_55": i8_55["bound_ms"],
    }, {
        "name": "gqa_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gqa_decode_attention.cu",
        "replaces": "src/repro/models/layers.py:319",
        "launches": sum(r["attention_launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in lmk["attention"]),
        "ms": attn["ms"],
        "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"],
        "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
    }, {
        "name": "ssd_decode_step",
        "route": "triton",
        "source": "src/repro_torch/kernels/csrc/ssd_decode_step.py",
        "replaces": "src/repro/models/ssm.py:183",
        "launches": sum(r["ssd_launches"] for r in runs),
        "max_abs_err": max(r["max_abs_err"] for r in lmk["ssd"]),
        "ms": ssd["ms"],
        "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"],
        "bound_by": ssd["bound_by"],
        "library_ms": ssd["library_ms"],
    }]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log("kernels: bitserial_mvm, int8_matmul and gqa_decode_attention "
        "(cuda, sm_90a), ssd_decode_step (triton)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
