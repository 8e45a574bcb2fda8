#!/usr/bin/env python3
"""Smoke run of the ``repro_torch`` port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--seed 0] [--out results.json] [--profile]

Phases (none catches its own failure; any mismatch raises and the
script exits non-zero):

1. print the card's name and power limit (``nvidia-smi``); build the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per
   source, eight of them, the grouped GEMM's two, the flash attention's
   two and the SSD chunk scan among them, each in its own thread, all
   started together) while
   Triton
   compiles the SSD step's variants phase 10 launches
   (:func:`build_triton_kernels`) and the training kernels' first
   variants (:func:`build_train_kernels`), timed as set-up;
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
   phi4-mini-3.8b, mamba2-780m and olmoe-1b-7b at published widths and
   vocabularies, cut to 2 layers, under the launchers' local mesh (olmoe
   through ``moe_ep`` and the grouped GEMM, 3 launches an MoE layer a
   step): 8 teacher-forced decode steps with the kernels on the card and
   the plain versions on the CPU, logits within ``LOGIT_TOL`` of their
   range (an MoE row up to its first routing flip between the devices),
   argmax agreement and routing flips reported; (c)
   ``repro_torch.launch.serve.main`` at full depth, batch 4, 32 + 32
   tokens: phi4-mini greedy with a bf16 and an INT8 KV cache
   (``tuning.tuned(int8_kv_cache=True)``), the default mamba2-780m and
   olmoe-1b-7b greedy (16 layers, 6.92e9 parameters, under the CLI's
   local mesh), each with the decode kernels' launches counted (one per
   attention or SSD layer per token, three grouped-GEMM launches per MoE
   layer per token), its prefill s, decode s and tok/s, peak device
   memory and the device-busy share of 8 steady decode steps (one
   ``torch.profiler`` trace); (d) ``quantized_linear`` driven at
   phi4-mini's decode projections, both routes equal to each other and to
   ``quantized_linear_ref`` (tolerance 0) and the backward, with
   ``int8_matmul``'s launches counted by route (all 4 on the stream
   route) and the bit-serial kernel's.

11. LM training (``python -m repro_torch.launch.train``) and its
   kernels: (a) each against its plain version on the card —
   ``cross_entropy`` (Triton, a forward and a backward launch) at
   phi4-mini's and mamba2-780m's vocabularies (200,064 and 50,280) for
   ``XENT_ROWS`` = 4 x 2047 rows of bf16 logits: the loss per row within
   ``XENT_LOSS_RTOL``, dlogits within one bf16 ulp, the autograd path
   (gradient written over the logits) equal to the direct launches, a
   planted wrong label refused; ``adamw_step`` (Triton: the norm in one
   launch, the update one launch a leaf) over phi4-mini's parameter tree
   at 8 layers with fp32 and bf16 moments: the norm within
   ``ADAMW_NORM_RTOL``, the update bit-exact to the plain version given
   the kernel's scale, planted faults refused; each timed (the kernel by
   CUDA-graph replay, the plain version and the library call, by CUDA
   events) beside its bytes bound and ``F.cross_entropy`` (fp32 logits)
   or ``clip_grad_norm_(foreach=True)`` + fused ``torch.optim.AdamW``;
   (b) phi4-mini-3.8b and mamba2-780m at published widths and
   vocabularies, cut to 2 layers (batch 2, seq 64): one
   ``steps.make_train_step`` step with the kernels on the card and one
   with the plain versions on the CPU from the same parameters, loss and
   gradient norm within ``TRAIN_TOL``, every updated parameter within one
   AdamW step's reach and at most ``TRAIN_FLIP_MAX`` of them over half an
   lr apart (olmoe-1b-7b too, under the local mesh), mamba2's SSD chunk
   scan on its kernel (2 forward calls and a backward an SSM layer); (c)
   ``repro_torch.launch.train.main`` on mamba2-780m at full width and
   depth, and phi4-mini-3.8b and olmoe-1b-7b at full width cut to 8 and
   4 layers (``depth_variant``) through ``steps.make_train_step`` in the
   same loop under the local mesh: 20 steps at batch 4, seq 2048, the
   loss finite at every step and lower at the last than at the first,
   the kernels' launches counted (2 cross-entropy launches, 1 norm launch
   and one update launch a leaf a step, 12 grouped-GEMM launches an MoE
   layer a step, 2 SSD chunk-scan forward calls and a backward an SSM
   layer a step), median ms/step, tokens/s, peak device memory and the
   device-busy share of 8 more steps (one ``torch.profiler`` trace);
   (d) ``train.main --reduced`` (olmoe-1b-7b, through ``moe_ep`` and the
   grouped GEMM's fp32 tile) saving at steps 3 and 6, step 6 removed
   and resumed: the new step 6 within ``RESUME_TOL`` of the first, the
   stream state equal.

12. the grouped expert GEMM (:func:`grouped_gemm_phase`), run before
   phase 10, whose paths launch it: forward, dx and dw of
   ``kernels/grouped_gemm.py`` against its plain version
   (``ragged_dot_ref`` and its two backward products) at ``GG_CASES``
   (olmoe's decode and training capacity buffers, up and down
   projections; deepseek-v3's 256 experts at d 7168 / f 2048 for T 4 and
   4096; jamba-1.5's 16 experts, top 2, d 8192 / f 24576) and
   ``GG_EDGES`` (one group, empty groups whose dw must be exactly 0, rows
   past the groups' sum exactly 0, K and N off the tile, unaligned rows,
   fp32, group edges off 128, a sum past M, buffers at and past the
   stream route's threshold), within ``GG_TOL`` of each case's rms, and
   on ``grouped_gemm_sm90.cu``'s routes (``wgmma``, ``stream``) of
   ``ragged_dot_tiles_ref`` too; a planted fault (one row moved into the
   next group) refused on both routes; each timed by graph replay beside
   the ``tile`` route (``grouped_gemm.cu``, in turns), its bound
   ``max(2·hits·K·N / 989e12, bytes / 3.35e12)`` (the groups' rows, the
   non-empty groups' weights and the output), the plain version and
   ``torch._grouped_mm`` (the yardstick; the port never calls it); a
   graph-replay check (replays equal eager calls, after another shape's
   call and new group sizes); the redesign's checks logged (``met`` or
   ``MISSED``); then ``moe_ep`` forward and backward at olmoe's widths
   under ``torch.cuda.set_sync_debug_mode("error")`` at B 4 x S 16 and
   B 4 x S 1 (no host sync, 9 launches, none on the tile route), held to
   the dense dispatch.  10b, 10c and 11c assert every bf16 grouped-GEMM
   launch on ``grouped_gemm_sm90.cu``.

13. the prefill step and the dry run (after phase 11): the dry-run CLI
   (``python -m repro_torch.launch.dryrun --arch phi4-mini-3.8b --shape
   prefill_32k --out build/dryrun.json`` on the fake (16, 16) mesh),
   ``cost_cell`` on the local (1, 1) mesh for 13a's shapes and ``python
   -m repro_torch.launch.serve --production-mesh`` start on the host in
   the background, away from the card; (a) phi4-mini-3.8b at full depth
   through ``steps.make_prefill_step`` at B 4 x S 2048 and B 1 x S 32768,
   the attention core on the flash-attention kernel (its launches counted
   over the timed calls: one an attention layer a call): finite
   last-token logits, the median host ms of the timed calls, prefill
   tokens/s, peak device memory (at S 32768 under the fp32 parameters,
   their bf16 cast and the 26.2 GB of (1, 32768, 200064) fp32 logits the
   last-token head avoids), one traced call's device-busy ms; (b)
   olmoe-1b-7b at full
   depth, B 4 x S 2048, under the local mesh: 48 grouped-GEMM launches,
   every one on the wgmma route; (b') mamba2-780m at full depth, B 4 x
   S 2048: the SSD chunk scan's forward on its kernel once an SSM layer a
   call (counted), median ms a call, peak memory, one traced call's
   device-busy ms; (c) phi4-mini, olmoe (fp32) and mamba2 (fp32) at 2
   layers, full width, B 4 x S 64: the prefill step's last-token logits
   on the card against the prompt stepped through the decode step on the
   card and against the prefill step on the CPU (``LOGIT_TOL``, MoE rows
   that route differently left out, ``MOE_CHECKED_MIN`` held; the card's
   prefill launches the flash-attention kernel once an attention layer
   and the SSD chunk scan once an SSM layer); mamba2 at bf16 against the
   CPU's prefill alone, its gap to decode logged beside the CPU's own
   (``PREFILL_AGREE_CPU_ONLY``);
   (d) each 13a call's device-busy time at least its cell's H100
   ``compute_s`` (where it is not: at least ``compute_s`` less the FLOPs
   of the masked attention blocks the dry run walks and the kernel
   skips), the CLI's cell ``ok`` with its roofline terms; (e)
   ``plan_parallelism`` on the H100 preset at train_4k for every arch,
   and ``--production-mesh`` refused with the 256-rank message.

14. the flash-attention kernel (:func:`flash_phase`), run before phase 10:
   its forward and backward (``kernels/flash_attention.py``; bf16 on the
   ``sm90`` route, ``csrc/flash_attention_sm90.cu``, fp32 on the ``mma``
   route, ``csrc/flash_attention.cu``) at ``FA_CASES`` (phi4-mini at B 4 x S
   2048 and B 1 x S 32768, h2o-danube's D 120 under its 4096 window at S
   8192, olmoe's G 1, whisper's encoder at S 1500 and its cross-attention
   at 448 x 1500, a deepseek-v3 MLA layer at H 128, D 192, Dv 128, S 4096
   with v a slice of wider rows, a sequence-parallel rank's rows at
   ``q_pos0`` 8192, olmoe in fp32): O within ``FA_TOL_F32`` of the plain
   masked softmax on fp32 upcasts and ``FA_TOL_REF`` of the card's path
   before the kernel in the reference's dtypes, lse within
   ``FA_TOL_LSE``, dq, dk and dv within ``FA_TOL_GRAD`` of autograd of
   the fp32 plain version; planted faults (each row's last 64 keys
   dropped; the window one 64-key block short) refused at every case of
   4096 rows and up; the forward and backward captured in one CUDA graph
   and replayed equal to eager calls; each case's forward and forward +
   backward timed by graph replay beside its bound ``max(FLOPs / 989e12,
   bytes / 3.35e12)`` over the valid pairs, the plain versions at the
   reference's 512 x 1024 blocks, the card's path before the kernel, and
   ``scaled_dot_product_attention``'s flash backend where it takes the
   case, every bf16 case on the ``sm90`` and ``mma`` routes in turns
   (``fa_redesign_checks`` logs the ``sm90`` route against SDPA and the
   ``mma`` route at ``FA_REDESIGN``).  11b, 11c, 13a and 13c count the
   kernel's launches on their paths and assert them, every one on the
   route planned for their compute dtype (``fa_routes_check``).

15. the SSD chunk-scan kernel (:func:`ssd_phase`), run before phase 10:
   its forward and backward (``kernels/ssd_scan.py``; bf16 on the ``sm90``
   route, ``csrc/ssd_chunk_scan_sm90.cu``, and on the ``mma`` route,
   ``csrc/ssd_chunk_scan.cu``, each held to the same limits; fp32 on
   ``mma``) at ``SSD_SCAN_CASES`` (mamba2-780m at B 4 x
   S 2048 and B 1 x S 32768, jamba-1.5's SSD geometry at B 1 x S 4096,
   S 64 at Q 64, S = Q = 256, the reduced geometry in fp32; x, B and C
   views of one conv row, as the layer splits them): y within
   ``SSD_TOL_F32`` of ``ssd_chunk_scan_ref`` on fp32 upcasts and
   ``SSD_TOL_REF`` of it in the reference's dtypes; dx, ddt, dA, dB and
   dC within ``SSD_TOL_GRAD`` of autograd of the fp32 plain version and
   ``SSD_TOL_GRAD_PLAIN`` of ``ssd_chunk_scan_bwd_ref``; two planted
   faults (chunk 1's carried state dropped; the mask's diagonal dropped)
   refused at every case of more than one chunk; forward and backward
   captured in one CUDA graph, replays equal to eager calls bit for bit;
   each case's forward and forward + backward timed by graph replay
   (a bf16 case on the two routes in turns) beside its bound
   ``max(FLOPs / 989e12, bytes / 3.35e12)`` (:func:`ssd_bound`) and the
   plain version (the card's path before the kernel); no PyTorch call
   computes the scan; ``ssd_redesign_checks`` logs the ``sm90`` route
   against the ``mma`` route (``SSD_REDESIGN_GAIN`` at
   ``SSD_SCAN_MAIN``).  11b, 11c, 13b' and 13c count the scan's calls on
   their paths and assert them, every launch on the route planned for
   their compute dtype (``ssd_routes_check``).  11c's mamba2-780m also
   traces one step with the host's ops and their input shapes
   (:func:`op_profile`).

The ``launches`` of the ``kernels`` record count the main paths: the
bit-serial kernel's those of phases 3, 7, 8 and 10d, ``int8_matmul``'s
10d's, the decode kernels' 10c's, the training kernels' 11c's, the
grouped GEMM's 10c's, 11c's and 13b's, the flash attention's 11c's,
13a's and 13c's (a forward one launch, a backward three), the SSD chunk
scan's 11c's, 13b''s and 13c's (on the sm90 route a forward four, a
backward seven; on mma three and six).  Each
record's times are device times
(CUDA-graph replay): the bit-serial kernel summed over the 55 MVMs of
phase 3; ``int8_matmul`` summed over ``QL_SHAPES`` with the weight read
cold from HBM, as a decode step reads it (``previous_ms``: the tile
route; ``ms_l2_resident``: the same operands replayed, the weight in
L2; ``ms_55``: over the 55 MVMs of phase 3, the entry's definition
before the stream kernel); the decode attention at 10c's shape (B 4,
64 slots, bf16, the last position); the SSD step at B 4; the
cross-entropy's forward and backward at phi4-mini's 11c shape; the
AdamW step (norm and every leaf's update) over phi4-mini's tree at 8
layers with fp32 moments; the grouped GEMM's forward, dx and dw summed
at olmoe's training buffer (up projection; ``previous_ms``: the same on
the tile route, ``grouped_gemm.cu``; ``decode_*``: the forward at its
decode buffer); the flash attention's forward and backward at phi4-mini's
11c shape (``fwd_*``: the forward alone); the SSD chunk scan's forward
and backward at mamba2-780m's 11c shape (``fwd_*``: the forward alone).
The
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
import math
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
LM_MODEL_ARCHS = ("phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b")
LM_MODEL_LAYERS, LM_MODEL_STEPS, LM_MODEL_BATCH = 2, 8, 2
# kernels (card) vs plain versions (CPU), bf16 logits:
# max |card - cpu| <= LOGIT_TOL * max |cpu|.  MoE: a router's top-k can
# flip between the two devices on one bf16 rounding (a near tie of the
# 8th and 9th expert), and a flip changes that token's residual stream
# and every later step of its sequence through the KV cache; so a row
# is held to LOGIT_TOL up to the step of its first routing flip (each
# MoE layer's top-k recomputed from its input on each device), and at
# least MOE_CHECKED_MIN of the (step, row) pairs must be held
LOGIT_TOL = 0.03
MOE_CHECKED_MIN = 0.25
# 10c: the serving CLI at full depth, (label, argv, int8 KV cache)
LM_SERVE_ARGS = ["--batch", "4", "--prompt-len", "32", "--gen", "32"]
LM_SERVE_RUNS = [
    ("phi4-mini-3.8b, bf16 KV", ["--arch", "phi4-mini-3.8b",
                                 "--temperature", "0"], False),
    ("phi4-mini-3.8b, INT8 KV", ["--arch", "phi4-mini-3.8b",
                                 "--temperature", "0"], True),
    ("mamba2-780m (default arch)", [], False),
    ("olmoe-1b-7b (moe_ep)", ["--arch", "olmoe-1b-7b", "--temperature",
                              "0"], False)]
# phase 11: LM training (python -m repro_torch.launch.train) and its kernels
# 11a cross_entropy: (arch, vocabulary) at 11c's rows, B 4 x (S - 1);
# the loss per row within XENT_LOSS_RTOL (relative) of the plain version,
# dlogits within one bf16 ulp of it (the kernel rounds the fp32 gradient
# once, as the plain version's cast does; exp and the two sums round
# apart in the last fp32 bits)
XENT_VOCABS = (("phi4-mini-3.8b", 200064), ("mamba2-780m", 50280))
XENT_ROWS = 4 * 2047
XENT_LOSS_RTOL = 1e-5
XENT_BYTES = 6                # a bf16 logit read forward, read and written back
# 11a adamw_step: phi4-mini's parameter tree at 8 layers, the update given
# the kernel's scale bit-exact to the plain version, the norm within
# ADAMW_NORM_RTOL (fp64 atomics against fp32 sums, another order)
ADAMW_ARCH, ADAMW_LAYERS = "phi4-mini-3.8b", 8
ADAMW_NORM_RTOL = 1e-6
ADAMW_LR, ADAMW_STEP = 3e-4, 4
# bytes a parameter: read p, g, m, v, write p, m, v, and the norm's read
# of g (fp32 moments: 32; bf16 moments: 24)
ADAMW_BYTES = {"float32": 32, "bfloat16": 24}
ADAMW_OPS = 16                # fp32 operations a parameter
# 11b: full widths and vocabularies cut to 2 layers, one train step on
# the card (kernels) and on the CPU (plain versions) from the same
# parameters; bf16 compute: loss and gradient norm within TRAIN_TOL
# (relative); each updated parameter within 2 lr (1 + wd |p|) of the CPU's
# (one AdamW step from equal parameters moves each by at most
# lr (1 + wd |p|)), and at most TRAIN_FLIP_MAX of the elements more than
# lr / 2 apart (updates of opposite sign: gradients near zero, where bf16
# rounding decides the sign)
TRAIN_MODEL_ARCHS = ("phi4-mini-3.8b", "mamba2-780m", "olmoe-1b-7b")
TRAIN_MODEL_LAYERS, TRAIN_MODEL_BATCH, TRAIN_MODEL_SEQ = 2, 2, 64
TRAIN_LR = 1e-3
TRAIN_TOL = 0.02
TRAIN_FLIP_MAX = 0.05
# 11c: mamba2-780m at full depth through launch.train.main, phi4-mini at
# 8 layers and olmoe-1b-7b at 4 (1.88e9 parameters) through
# steps.make_train_step in train.main's loop (under its local mesh)
TRAIN_FULL = [("mamba2-780m", None), ("phi4-mini-3.8b", 8),
              ("olmoe-1b-7b", 4)]
TRAIN_FULL_STEPS, TRAIN_FULL_BATCH, TRAIN_FULL_SEQ = 20, 4, 2048
TRAIN_TRACE_STEPS = 8
# 11c's mamba2-780m: one more step traced with the host's ops and their
# input shapes, which attributes each device kernel to the op that launched
# it; the OP_TOP (op, shapes) pairs by that device time are kept
OP_TRACE_STEPS, OP_TOP = 1, 12
# 11d: train.main --reduced (olmoe-1b-7b), saving at 3 and 6, step_6
# removed and resumed; every leaf of the new step_6 within RESUME_TOL
# (rtol, atol) of the first (the norm's fp64 atomics land in another order
# from run to run, and clipping carries its last bits into every update)
RESUME_ARGS = ["--reduced", "--steps", "6", "--ckpt-every", "3",
               "--log-every", "1"]
RESUME_TOL = (1e-5, 1e-8)
# phase 12: the grouped expert GEMM (kernels/grouped_gemm.py) against its
# plain version: (label, groups, K = d_model, N = expert d_ff, tokens,
# top-k, down): the capacity buffer of moe_ep at tp 1 (cap = 1.25 x hits
# rounded up to 8; hits from a random top-k routing, rows past them
# filled with noise that the kernel must zero) times the up projection
# (G, K, N), and where ``down`` the down projection (G, N, K); forward,
# dx and dw of each.  deepseek-v3 and jamba at their widths are kernel
# cases only (their models do not fit one card).
GG_CASES = [("olmoe decode B 4", 64, 2048, 1024, 4, 8, True),
            ("olmoe train B 4 x S 2048", 64, 2048, 1024, 8192, 8, True),
            ("deepseek-v3 T 4", 256, 7168, 2048, 4, 8, False),
            ("deepseek-v3 T 4096", 256, 7168, 2048, 4096, 8, False),
            ("jamba-1.5 T 4", 16, 8192, 24576, 4, 2, False)]
GG_CF = 1.25
# edge cases, (label, dtype, M, K, N, group sizes): every row in one group;
# empty groups (their dw exactly 0) and rows past the groups' sum (exactly
# 0); K and N not multiples of the tile; unaligned rows (element loads);
# fp32 operands (the FFMA tile); for grouped_gemm_sm90.cu: group edges off
# 128 and a 1-row group, K and N multiples of 8 below one box, a sum past M
# (cut at M), many small groups, and fwd buffers of GG_STREAM_M rows (the
# stream route's last) and one more (the wgmma route's first)
GG_STREAM_M = 192
GG_EDGES = [("one group", "bfloat16", 200, 256, 384, [0, 0, 200, 0]),
            ("empty groups, rows past the sum", "bfloat16", 300, 512, 256,
             [0, 70, 0, 0, 90, 0, 0, 31]),
            ("K, N not tile multiples", "bfloat16", 130, 200, 264,
             [50, 0, 61]),
            ("unaligned K, N", "bfloat16", 77, 147, 99, [20, 0, 40, 10]),
            ("fp32", "float32", 150, 256, 128, [60, 0, 70]),
            ("fp32 unaligned", "float32", 45, 37, 53, [10, 0, 30]),
            ("edges off 128, a 1-row group", "bfloat16", 400, 136, 520,
             [129, 1, 127, 0, 100]),
            ("K, N multiples of 8 below a box", "bfloat16", 90, 8, 24,
             [3, 40, 0, 20]),
            ("a sum past M", "bfloat16", 100, 64, 72, [60, 70, 5]),
            ("many small groups", "bfloat16", 1000, 64, 64,
             [7] * 100 + [0] * 20),
            ("M at the stream threshold", "bfloat16", GG_STREAM_M, 256, 264,
             [30, 0, 50, 48, 60]),
            ("M past the stream threshold", "bfloat16", GG_STREAM_M + 1, 256,
             264, [30, 0, 50, 48, 60])]
# kernel vs plain: |err| <= tol[0] * rms(plain) + tol[1] * |plain|.  bf16:
# both round the fp32 sum once to bf16 (another order: one ulp, 2^-7 of
# the value) and the rms share covers sums near zero; fp32: the order.
# A planted fault (one row moved into the next group) must fail it.
GG_TOL = {"bfloat16": (0.01, 2.0 ** -7), "float32": (1e-5, 1e-5)}
# the no-host-sync check: one moe_ep forward and backward at olmoe's
# widths (one layer's MoE), B 4 x S 16, under
# torch.cuda.set_sync_debug_mode("error"); against the dense dispatch on
# the card (nothing drops at tp 1), bf16 within GG_MOE_TOL (rms share,
# relative): other rounding orders of a bf16 chain of products
GG_MOE_TOKENS = ((4, 16), (4, 1))
GG_MOE_TOL = (0.1, 2.0 ** -6)
# the checks the grouped GEMM's redesign is held to at phase 12's shapes
# (reported, not raised): each of olmoe's training products within
# GG_TRAIN_MIN of its bound and their sum GG_TRAIN_GAIN times faster than
# the tile route; the decode forward faster than the tile route; the
# weight-bound T 4 cases no slower than it within GG_SLOWER_MAX
GG_TRAIN_MIN = 0.5
GG_TRAIN_GAIN = 2.5
GG_SLOWER_MAX = 0.03
# phase 13: the prefill step (launch.steps.make_prefill_step) and the dry
# run (launch.dryrun) against the card.  13a: phi4-mini at full depth,
# (batch, seq, timed calls, a warm-up call first, layers of the traced
# call; None: full depth) at B 4 x S 2048 and at prefill_32k's sequence
# at batch 1, the attention core on the flash-attention kernel at both
# (one launch an attention layer a call).  The peak at S 32768 must stay
# below the fp32 parameters, their bf16 cast and the (1, 32768, 200064)
# fp32 logits the last-token head avoids (PREFILL_LOGITS_BYTES)
PREFILL_ARCH = "phi4-mini-3.8b"
PREFILL_SHAPES = [(4, 2048, 3, True, None), (1, 32768, 3, True, None)]
PREFILL_LOGITS_BYTES = 1 * 32768 * 200064 * 4
# 13b: olmoe-1b-7b at full depth under the local mesh: 3 grouped-GEMM
# launches an MoE layer, every one on the wgmma route
PREFILL_MOE = ("olmoe-1b-7b", 4, 2048)
# 13b': mamba2-780m at full depth (48 SSM layers) through make_prefill_step
# at B 4 x S 2048: (arch, batch, seq, timed calls after a warm-up), the SSD
# chunk scan's forward on the kernel once an SSM layer a call
PREFILL_SSM = ("mamba2-780m", 4, 2048, 3)
# 13c: 2 layers at full width, B 4 x S 64: the prefill step's last-token
# logits on the card against the prompt stepped through the decode step
# on the card and against the prefill step on the CPU, LOGIT_TOL of the
# range, an MoE row held only if no token of it routes differently
# (MOE_CHECKED_MIN of the rows held); olmoe's capacity factor raised to
# its experts over its top-k, so neither prefill (256 tokens a buffer)
# nor decode (4) drops a token: a drop changes the result by definition.
# (arch, layers, compute dtype): olmoe in fp32, because at bf16 its top-8
# of 64 router flipped in every row between the 256-token prefill and the
# 4-token decode steps (4 of 4 rows on the H100): a row's last logits
# depend on every earlier position's routing
PREFILL_AGREE = (("phi4-mini-3.8b", 2, None), ("olmoe-1b-7b", 2, "float32"),
                 ("mamba2-780m", 2, "float32"))
# ... and mamba2-780m at bf16, held against the CPU's prefill alone: at
# bf16 the reference's own chunked prefill (bf16 scores, exp(cum) and
# carried state) and its stepped decode (a bf16 state rounded every step)
# differ by more than LOGIT_TOL at 2 layers, so that row logs its gap to
# decode beside the CPU's own (cpu_own_decode_gap_over_range); the fp32
# row above is held to decode
PREFILL_AGREE_CPU_ONLY = (("mamba2-780m", 2, None),)
PREFILL_AGREE_BATCH, PREFILL_AGREE_SEQ = 4, 64
# 13d: the dry run's cells: cost_cell on the local (1, 1) mesh for 13a's
# shapes (each call's device-busy time must be at least its H100
# compute_s), and the CLI on the fake (16, 16) mesh
DRYRUN_CLI = ["--arch", "phi4-mini-3.8b", "--shape", "prefill_32k",
              "--out", "build/dryrun.json", "--force"]
DRYRUN_TIMEOUT = 400
# phase 14: the flash-attention kernel (kernels/flash_attention.py) against
# its plain versions: (label, B, Sq, Sk, KV, G, D, Dv, causal, window,
# q_pos0, dtype).  phi4-mini at 11c's and 13a's shapes, h2o-danube's
# D 120 under its 4096 window, olmoe's G 1, whisper's encoder and its
# decoder's cross-attention (non-causal, Sq != Sk), one deepseek-v3 MLA
# layer (H 128, D 192, Dv 128, v a slice of a wider row), the rows of
# sequence-parallel rank 2 of 4 at S 16384 (q_pos0 8192), and olmoe in
# fp32 (13c's compute dtype)
FA_CASES = [
    ("phi4-mini B4 S2048", 4, 2048, 2048, 8, 3, 128, 128, True, None, 0,
     "bfloat16"),
    ("phi4-mini B1 S32768", 1, 32768, 32768, 8, 3, 128, 128, True, None, 0,
     "bfloat16"),
    ("danube S8192 w4096", 1, 8192, 8192, 8, 4, 120, 120, True, 4096, 0,
     "bfloat16"),
    ("olmoe G1 B4 S2048", 4, 2048, 2048, 16, 1, 128, 128, True, None, 0,
     "bfloat16"),
    ("whisper encoder S1500", 4, 1500, 1500, 12, 1, 64, 64, False, None, 0,
     "bfloat16"),
    ("whisper cross 448x1500", 4, 448, 1500, 12, 1, 64, 64, False, None, 0,
     "bfloat16"),
    ("deepseek-v3 MLA S4096", 1, 4096, 4096, 128, 1, 192, 128, True, None, 0,
     "bfloat16"),
    ("phi4-mini q_pos0 8192", 1, 4096, 16384, 8, 3, 128, 128, True, None,
     8192, "bfloat16"),
    ("olmoe fp32 B4 S1024", 4, 1024, 1024, 16, 1, 128, 128, True, None, 0,
     "float32"),
]
# the kernels line's case: phi4-mini at 11c's shape, forward + backward
FA_MAIN = "phi4-mini B4 S2048"
# kernel vs plain, |err| <= tol[0] * rms(plain) + tol[1] * |plain|, by
# dtype.  FA_TOL_F32 holds O to the plain masked softmax on fp32
# upcasts of the same inputs (bf16: the kernel rounds P
# before P V and its output, as the reference rounds its probabilities);
# FA_TOL_REF holds O to the plain version in the reference's dtypes (the
# card's path before the kernel: bf16 scores, the blockwise loop's bf16
# running output, far from the fp32 result at long rows); FA_TOL_GRAD
# holds dq, dk and dv to autograd of the fp32 plain version (bf16: the
# backward's delta = rowsum(dO O) reads the bf16-rounded O, as
# FlashAttention-2's does, and a row that sees few keys, whose exact dS
# is near 0, keeps that rounding's share: the early rows of a long
# sequence, where the gradients' rms is small, set the share);
# FA_TOL_GRAD_PLAIN holds them to the plain version of the kernel's
# backward (flash_attention_bwd_ref on the kernel's O and lse, fp32
# arithmetic, at the reference's blocks: the same algorithm in another
# order and blocking).  FA_TOL_LSE: (atol, rtol) of lse against the fp32
# plain version.  Each rms share is about 3x the largest measured (fp32
# O: 5x) on an H100 (PERF.md section 6).  A planted fault (each row's
# last 64 keys dropped, or the window one 64-key block short) must fail
# FA_TOL_F32 at every case of 4096 rows and up.
FA_TOL_F32 = {"bfloat16": (0.2, 2.0 ** -7), "float32": (1e-5, 1e-5)}
FA_TOL_REF = {"bfloat16": (1.0, 2.0 ** -6), "float32": (1e-5, 1e-5)}
FA_TOL_GRAD = {"bfloat16": (0.75, 2.0 ** -6), "float32": (1e-4, 1e-5)}
FA_TOL_GRAD_PLAIN = {"bfloat16": (0.1, 2.0 ** -6), "float32": (2e-5, 1e-5)}
FA_TOL_LSE = (2e-5, 1e-6)
FA_FAULT_MIN_S = 4096
# the plain versions' blocks in phase 14's timings (the reference's)
FA_PLAIN_BLOCKS = (512, 1024)
# the fp32 autograd reference's chunk: query rows a chunk with at most
# this many fp32 scores
FA_REF_SCORES = 5e8
FA_REPS = 5
# the sm90 route's checks (logged met / MISSED): at these cases its
# forward faster than SDPA's, and its forward + backward at least
# FA_REDESIGN_GAIN times faster than the mma route's in the same call
FA_REDESIGN = ("phi4-mini B4 S2048", "phi4-mini B1 S32768")
FA_REDESIGN_GAIN = 1.5
# calls a CUDA graph holds in phase 14's timings (each route's runs in
# turns; the graph is replayed 3 times)
FA_GRAPH_REPS = 4


# phase 15: the SSD chunk-scan kernel (kernels/ssd_scan.py) against its
# plain versions: (label, B, S, nh, hp, g, N, Q, dtype).  mamba2-780m (nh
# 48, hp 64, N 128, g 1) at 11c's shape and at prefill_32k's sequence (128
# chunks of 256), jamba-1.5's SSD geometry (nh 128, hp 128, N 128, g 8),
# 11b's and 13c's sequence (S 64: Q = min(256, 64), one chunk), S = Q at
# Q 256, and the reduced configs' geometry (Q = N = hp = 16, nh 8) in fp32
SSD_SCAN_CASES = [
    ("mamba2 B4 S2048", 4, 2048, 48, 64, 1, 128, 256, "bfloat16"),
    ("mamba2 B1 S32768", 1, 32768, 48, 64, 1, 128, 256, "bfloat16"),
    ("jamba B1 S4096", 1, 4096, 128, 128, 8, 128, 256, "bfloat16"),
    ("mamba2 B4 S64", 4, 64, 48, 64, 1, 128, 64, "bfloat16"),
    ("mamba2 B2 S=Q 256", 2, 256, 48, 64, 1, 128, 256, "bfloat16"),
    ("reduced fp32 B2 S64", 2, 64, 8, 16, 1, 16, 16, "float32"),
]
# the kernels line's case: mamba2-780m at 11c's shape
SSD_SCAN_MAIN = "mamba2 B4 S2048"
# kernel vs plain, |err| <= tol[0] * rms(plain) + tol[1] * |plain|, by
# dtype.  SSD_TOL_F32 holds y to ssd_chunk_scan_ref on fp32 upcasts of the
# same inputs (bf16: the kernel rounds each product's operands to bf16, the
# scores, the decay-weighted x or dy and the fp32 state among them, and
# its output); SSD_TOL_REF holds y to ssd_chunk_scan_ref in the
# reference's dtypes (the card's path before the kernel: the state carried
# in bf16, W, decay * dt and exp(cum) rounded to bf16, far from the fp32
# result); SSD_TOL_GRAD holds dx, ddt, dA, dB and dC to autograd of the
# fp32 plain version, SSD_TOL_GRAD_PLAIN to ssd_chunk_scan_bwd_ref (the
# kernel's algorithm in fp32 on the same inputs).  The shares are about 3x
# the largest measured on an H100 (PERF.md section 6).  Two planted faults
# (chunk 1's carried state dropped; the mask's diagonal dropped) must fail
# SSD_TOL_F32 at every case of more than one chunk.
SSD_TOL_F32 = {"bfloat16": (0.1, 2.0 ** -7), "float32": (1e-5, 1e-5)}
SSD_TOL_REF = {"bfloat16": (0.15, 2.0 ** -6), "float32": (1e-5, 1e-5)}
SSD_TOL_GRAD = {"bfloat16": (0.25, 2.0 ** -6), "float32": (1e-5, 1e-5)}
SSD_TOL_GRAD_PLAIN = {"bfloat16": (0.25, 2.0 ** -6),
                      "float32": (1e-5, 1e-5)}
# calls a CUDA graph holds in phase 15's timings
SSD_GRAPH_REPS = 4
# the sm90 route's check (logged met / MISSED): at SSD_SCAN_MAIN its
# forward + backward at least SSD_REDESIGN_GAIN times faster than the mma
# route's in the same call
SSD_REDESIGN_GAIN = 2.0

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


def device_profile(fn, top: int = 5, cpu: bool = True):
    """One ``torch.profiler`` traced run of ``fn``: its host wall ms,
    the device's busy ms (sum of the device events' own time) and the
    ``top`` device events by time as ``(ms, count, name)``.  ``cpu=False``
    records the device's activity alone (a training step launches tens
    of thousands of kernels, whose host-side events the trace need not
    hold)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA), reverse=True)
    return wall_ms, sum(r[0] for r in rows), rows[:top]


def op_profile(fn, top: int = OP_TOP) -> list:
    """One ``torch.profiler`` traced run of ``fn`` with the host's ops and
    their input shapes: the ``top`` (op, input shapes) pairs by the device
    time of the kernels each launched itself, as ``[ms, count, op,
    shapes]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key,
                    str(e.input_shapes))
                   for e in prof.key_averages(group_by_input_shape=True)
                   if e.device_type == DeviceType.CPU
                   and e.self_device_time_total > 0), reverse=True)
    return [list(r) for r in rows[:top]]


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


def build_train_kernels(device) -> float:
    """Compile the training kernels' Triton variants phase 11 launches
    first (the cross-entropy at both vocabularies in bf16, the norm and
    the update with fp32 and bf16 moments) by launches on small inputs:
    the seconds taken."""
    import torch
    from repro_torch.kernels import adamw as K
    from repro_torch.kernels import cross_entropy as X
    t0 = time.perf_counter()
    for _, v in XENT_VOCABS:
        logits = torch.zeros((2, v), dtype=torch.bfloat16, device=device)
        labels = torch.zeros(2, dtype=torch.int32, device=device)
        _, lse = X.cross_entropy_fwd_cuda(logits, labels)
        X.cross_entropy_bwd_cuda(logits, labels, lse,
                                 torch.ones((), device=device), out=logits)
    p = torch.zeros(4096, device=device)
    for dt in (torch.float32, torch.bfloat16):
        m = torch.zeros(4096, dtype=dt, device=device)
        K.adamw_step([p], [p.clone()], [m], [m.clone()], 1e-3,
                     torch.zeros((), dtype=torch.int32, device=device),
                     b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                     clip_norm=1.0)
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


def moe_layers(cfg) -> int:
    """MoE sublayers of ``cfg`` (each launches the grouped GEMM 3 times a
    forward under a mesh)."""
    from repro_torch.models import transformer as T
    return cfg.n_blocks * sum(
        1 for i, ch in enumerate(cfg.block_pattern)
        if T._has_ffn(cfg, ch) and T._use_moe(cfg, i))


@contextlib.contextmanager
def routing_recorded(routes: list):
    """Within: every ``moe_ep_apply_local`` call appends its router's
    top-k (each row's experts, sorted) to ``routes``, recomputed from its
    input as the call computes it."""
    import torch
    from repro_torch.models import moe_ep

    orig = moe_ep.moe_ep_apply_local

    def spy(cfg, p, x, *a, **kw):
        m = cfg.moe
        logits = (x.reshape(-1, x.shape[-1]) @ p["router"]).float()
        scores = (torch.sigmoid(logits) if m.router_score == "sigmoid"
                  else torch.softmax(logits, dim=-1))
        idx = torch.topk(scores, m.experts_per_tok, dim=-1).indices
        routes.append(idx.sort(-1).values.cpu())
        return orig(cfg, p, x, *a, **kw)

    moe_ep.moe_ep_apply_local = spy
    try:
        yield
    finally:
        moe_ep.moe_ep_apply_local = orig


def lm_model_phase(name: str, device, layers: int = LM_MODEL_LAYERS,
                   steps: int = LM_MODEL_STEPS, batch: int = LM_MODEL_BATCH,
                   seed: int = 0) -> dict:
    """Phase 10b: ``name`` at its published widths and vocabulary, cut to
    ``layers`` layers, random weights from ``seed``: ``steps``
    teacher-forced decode steps on ``device`` (the kernels) and with the
    same bf16 parameters on the CPU (the plain versions), both under the
    launchers' local mesh (MoE through ``moe_ep``).  The logits must
    agree within ``LOGIT_TOL`` of their range (an MoE row up to its
    first routing flip, ``MOE_CHECKED_MIN`` of the rows held); returns
    the largest gap, how often the argmax agrees and the flips."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data import make_batch
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.launch import meshctx
    from repro_torch.launch.train import local_mesh
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
    diverged = torch.zeros(batch, dtype=torch.bool)
    flips, held = 0, 0
    mesh = local_mesh()
    GG.reset_launches()
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        r_dev, r_cpu = [], []
        with meshctx.use_mesh(mesh, data_axes=("data",)):
            t0 = time.perf_counter()
            with routing_recorded(r_dev):
                got, st_dev = T.decode_step(cfg, cast, st_dev, tok.to(dev))
            got = got.cpu()
            t_dev += time.perf_counter() - t0
            t0 = time.perf_counter()
            with routing_recorded(r_cpu):
                want, st_cpu = T.decode_step(cfg, cpu, st_cpu, tok)
            t_cpu += time.perf_counter() - t0
        for a, b in zip(r_dev, r_cpu):
            flip = (a != b).any(-1)
            flips += int(flip.sum())
            diverged |= flip
        keep = ~diverged
        held += int(keep.sum())
        scale = float(want.abs().max())
        gap = float((got[keep] - want[keep]).abs().max()) \
            if bool(keep.any()) else 0.0
        if not (bool(torch.isfinite(got).all()) and gap <= LOGIT_TOL * scale):
            raise AssertionError(f"{name} step {t}: max |card - cpu| {gap} "
                                 f"over max |logit| {scale}")
        worst = max(worst, gap / scale)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    if held < MOE_CHECKED_MIN * steps * batch:
        raise AssertionError(f"{name}: {flips} routing flips left {held} of "
                             f"{steps * batch} (step, row) pairs to hold")
    n_moe = moe_layers(cfg)
    if dev.type == "cuda":
        gg_routes_check(name, GG.launches_by_route, 3 * n_moe * steps)
    if dev.type == "cuda" and GG.ragged_dot.launches != 3 * n_moe * steps:
        raise AssertionError(f"{name}: {GG.ragged_dot.launches} grouped-GEMM "
                             f"launches, expected {3 * n_moe * steps}")
    return {"arch": name, "layers": layers, "steps": steps, "batch": batch,
            "wall_s": time.perf_counter() - t_start,
            "max_gap_over_range": worst,
            "argmax_agree": agree / (steps * batch),
            "routing_flips": flips, "pairs_held": held,
            "grouped_gemm_launches": GG.ragged_dot.launches,
            "grouped_gemm_routes": dict(GG.launches_by_route),
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
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.launch.train import local_mesh
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
    mesh = local_mesh()
    with meshctx.use_mesh(mesh, data_axes=("data",)):
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
    SSD layer and token, three grouped-GEMM launches per MoE layer and
    token (``moe_ep`` under the CLI's local mesh).  Prints the CLI's
    lines; ``profile`` traces one more run of each for the device-busy
    share."""
    import re
    import torch
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import grouped_gemm as GG
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
        n_moe = moe_layers(cfg)

        def knob():
            return (tuning.tuned(int8_kv_cache=True) if int8
                    else contextlib.nullcontext())

        if on_card:
            torch.cuda.reset_peak_memory_stats()
        DA.gqa_decode_attention.launches = 0
        SD.ssd_decode_step.launches = 0
        GG.reset_launches()
        with knob():
            wall, text = run_lm_serve(argv)
        launched = (DA.gqa_decode_attention.launches,
                    SD.ssd_decode_step.launches, GG.ragged_dot.launches)
        routes = dict(GG.launches_by_route)
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
               "ssd_launches": launched[1],
               "grouped_gemm_launches": launched[2],
               "grouped_gemm_routes": routes, "lines": lines}
        if on_card:
            want = (tokens * n_attn, tokens * n_ssm, 3 * tokens * n_moe)
            if launched != want:
                raise AssertionError(f"{label}: launches {launched}, "
                                     f"expected {want}")
            gg_routes_check(label, routes, want[2])
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
               f"{launched[0]}, SSD {launched[1]}, grouped GEMM "
               f"{launched[2]} (by route {routes})")
        if "peak_gb" in row:
            msg += f", peak device memory {row['peak_gb']:.2f} GB"
        if "device_busy_ms" in row:
            busy, p_wall = row["device_busy_ms"], row["profiled_wall_ms"]
            msg += (f"; 8 traced decode steps: device busy {busy:.1f} of "
                    f"{p_wall:.1f} ms ({100 * busy / p_wall:.1f}%)")
        log(msg)
    return {"runs": out}


def bf16_ulps(got, want) -> int:
    """The largest distance, in bf16 ulps, between two bf16 tensors
    (values mapped onto a monotone integer line)."""
    import torch

    def line(t):
        i = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i + 32768), i)

    if got.shape != want.shape:
        raise AssertionError(f"shapes {tuple(got.shape)} {tuple(want.shape)}")
    return int((line(got) - line(want)).abs().max()) if got.numel() else 0


def xent_check(logits, labels, fault: bool = False) -> tuple:
    """Kernel against plain version for one logits matrix: ``(loss |err|,
    dlogits ulps, ok)``; the kernel's forward and backward launched
    directly, then through ``cross_entropy`` (the autograd Function,
    gradient written over a copy of the logits), which must give the
    same bits.  ``fault`` plants a wrong label in row 0 of the plain
    version's input: the check must fail."""
    import torch
    from repro_torch.kernels import cross_entropy as X
    loss_k, lse = X.cross_entropy_fwd_cuda(logits, labels)
    grad_k = X.cross_entropy_bwd_cuda(logits, labels, lse,
                                      torch.ones((), device=logits.device),
                                      out=torch.empty_like(logits))
    plain_labels = labels.clone()
    if fault:
        plain_labels[0] = (plain_labels[0] + 1) % logits.shape[1]
    loss_p = X.cross_entropy_rows_ref(logits, plain_labels)
    lg = logits.clone().requires_grad_(True)
    (grad_p,) = torch.autograd.grad(X.cross_entropy_ref(lg, plain_labels),
                                    lg)
    err = (loss_k - loss_p).abs()
    ok_loss = bool((err <= XENT_LOSS_RTOL * loss_p.abs()).all())
    ulps = bf16_ulps(grad_k, grad_p) if logits.dtype == torch.bfloat16 \
        else None
    ok_grad = ulps is not None and ulps <= 1
    # the autograd path: same launches, the gradient in place
    la = logits.clone().requires_grad_(True)
    mean = X.cross_entropy(la, labels)
    (ga,) = torch.autograd.grad(mean, la)
    torch.cuda.synchronize()
    if not (torch.equal(mean, loss_k.mean()) and torch.equal(ga, grad_k)
            and ga.data_ptr() == la.data_ptr()):
        raise AssertionError("cross_entropy's autograd path differs from "
                             "its kernels' direct launches")
    return float(err.max()), ulps, ok_loss and ok_grad


def xent_kernel_rows(device, seed: int = 0) -> list:
    """Phase 11a, cross-entropy: at each vocabulary, kernel against plain
    version (and a planted fault that must fail), then device times:
    the kernel's forward + backward by graph replay (the backward in
    place over a scratch copy), the plain version's and
    ``F.cross_entropy``'s on the fp32 logits (forward + backward under
    autograd, CUDA events over eager runs), beside the bound of
    ``XENT_BYTES`` a logit."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cross_entropy as X
    dev = torch.device(device)
    gen = torch.Generator(dev).manual_seed(seed)
    rows = XENT_ROWS
    out = []
    for arch, v in XENT_VOCABS:
        logits = (torch.randn((rows, v), generator=gen, device=dev) * 3.0
                  ).to(torch.bfloat16)
        labels = torch.randint(0, v, (rows,), generator=gen, device=dev,
                               dtype=torch.int32)
        err, ulps, ok = xent_check(logits, labels)
        if not ok:
            raise AssertionError(f"cross_entropy {arch} V {v}: loss |err| "
                                 f"{err}, dlogits {ulps} bf16 ulps")
        _, f_ulps, f_ok = xent_check(logits, labels, fault=True)
        if f_ok:
            raise AssertionError(f"cross_entropy {arch}: the planted fault "
                                 "passed the check")
        scratch = logits.clone()
        one = torch.ones((), device=dev)

        def kernel():
            _, lse = X.cross_entropy_fwd_cuda(scratch, labels)
            X.cross_entropy_bwd_cuda(scratch, labels, lse, one, out=scratch)

        def plain():
            lg = logits.detach().requires_grad_(True)
            torch.autograd.grad(X.cross_entropy_ref(lg, labels), lg)

        l32 = logits.float().requires_grad_(True)
        lab64 = labels.long()

        def library():
            torch.autograd.grad(F.cross_entropy(l32, lab64), l32)

        n_bytes = XENT_BYTES * rows * v + 4 * rows
        t_b = n_bytes / PEAK_BYTES
        t_o = 6.0 * rows * v / PEAK_F32_OPS
        row = {"arch": arch, "vocab": v, "rows": rows, "max_abs_err": err,
               "dlogits_ulps": ulps, "fault_ulps": f_ulps,
               "ms": graph_ms(kernel, REPS),
               "plain_ms": cuda_ms(plain, 3),
               "library_ms": cuda_ms(library, 3),
               "bound_ms": 1e3 * max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations"}
        del scratch, l32
        out.append(row)
        log(f"  cross_entropy {arch} ({rows} x {v} bf16): loss |err| "
            f"{err:.2e}, dlogits within {ulps} bf16 ulp (planted fault: "
            f"{f_ulps} ulps, refused); fwd + bwd kernel {row['ms']:.4f} ms,"
            f" plain {row['plain_ms']:.4f} ms, F.cross_entropy (fp32) "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.0f}%)")
    return out


def adamw_tree(device, seed: int = 0):
    """phi4-mini's parameter tree at ``ADAMW_LAYERS`` layers (fp32 masters) and
    random gradients, on ``device``: ``(cfg, params, grads)`` (leaf
    lists)."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import depth_variant
    from repro_torch.models import transformer as T
    dev = torch.device(device)
    cfg = depth_variant(ARCHS[ADAMW_ARCH], ADAMW_LAYERS)
    gen = torch.Generator(dev).manual_seed(seed)
    params = tree_util.leaves(T.init_params(cfg, gen, dev))
    # gradients of std 1e-4: a norm near 3.8 at 1.42e9 parameters, so the
    # clip scale (clip 1.0) is below 1 and enters every update
    grads = [torch.randn(p.shape, generator=gen, device=dev) * 1e-4
             for p in params]
    return cfg, params, grads


def adamw_kernel_rows(device, seed: int = 0) -> list:
    """Phase 11a, AdamW: over phi4-mini's tree with fp32 and with bf16
    moments: the norm kernel within ``ADAMW_NORM_RTOL`` of the plain norm;
    each leaf's update kernel, given the scalars from the kernel's norm,
    bit-exact to the plain version (p, m and v), leaf by leaf; planted
    faults (the plain norm of one leaf scaled by 1 + 1e-4; the plain
    update at an lr one ulp off) fail.  Device times of the whole step
    (norm + one launch a leaf; graph replay, in place), of the plain
    version and of ``clip_grad_norm_(foreach=True)`` +
    ``torch.optim.AdamW(fused=True).step()`` (CUDA events, eager), beside
    the bound of ``ADAMW_BYTES`` a parameter."""
    import torch
    from repro_torch.kernels import adamw as K
    from repro_torch.optim import AdamWConfig
    dev = torch.device(device)
    cfg, params, grads = adamw_tree(dev, seed)
    n = sum(p.numel() for p in params)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    lr = torch.full((), ADAMW_LR, device=dev)
    step = torch.full((), ADAMW_STEP, dtype=torch.int32, device=dev)
    out = []
    for mdt in ("float32", "bfloat16"):
        hp = AdamWConfig(moment_dtype=mdt)
        dt = getattr(torch, mdt)
        ms = [(torch.randn(p.shape, generator=gen, device=dev) * 1e-4
               ).to(dt) for p in params]
        vs = [(torch.rand(p.shape, generator=gen, device=dev) * 1e-8
               ).to(dt) for p in params]
        hyper = dict(b1=hp.b1, b2=hp.b2, eps=hp.eps,
                     weight_decay=hp.weight_decay)
        gnorm = K.grad_norm(grads)
        want_norm = float(K.grad_norm_ref(grads))
        norm_abs = abs(float(gnorm) - want_norm)
        norm_err = norm_abs / want_norm
        big = max(range(len(grads)), key=lambda i: grads[i].numel())
        faulty = K.grad_norm_ref(grads[:big] + [grads[big] * (1 + 1e-4)]
                                 + grads[big + 1:])
        fault_err = abs(float(gnorm) - float(faulty)) / float(faulty)
        if norm_err > ADAMW_NORM_RTOL or fault_err <= ADAMW_NORM_RTOL:
            raise AssertionError(f"grad_norm: relative error {norm_err} "
                                 f"(planted fault {fault_err})")
        scalars = K.adamw_scalars(gnorm, lr, step + 1, b1=hp.b1, b2=hp.b2,
                                  clip_norm=hp.clip_norm)
        off = scalars.clone()
        off[1] = torch.nextafter(off[1], torch.full((), 1.0, device=dev))
        unequal = 0
        fault_caught = False
        for p, g, m, v in zip(params, grads, ms, vs):
            pk, mk, vk = p.detach().clone(), m.clone(), v.clone()
            K._adamw_leaf_cuda(pk, g, mk, vk, scalars, **hyper)
            want = K.adamw_leaf_ref(p.detach(), g, m, v, scalars, **hyper)
            unequal += sum(int((a != b).sum())
                           for a, b in zip((pk, mk, vk), want))
            if not fault_caught:
                bad = K.adamw_leaf_ref(p.detach(), g, m, v, off, **hyper)
                fault_caught = not torch.equal(bad[0], pk)
        if unequal or not fault_caught:
            raise AssertionError(f"adamw_step ({mdt} moments): {unequal} "
                                 f"elements differ from the plain version "
                                 f"(planted fault caught: {fault_caught})")
        pl = [p.detach() for p in params]

        def kernel():
            K.adamw_step(pl, grads, ms, vs, lr, step, clip_norm=hp.clip_norm,
                         **hyper)

        def plain():
            gn = K.grad_norm_ref(grads)
            sc = K.adamw_scalars(gn, lr, step + 1, b1=hp.b1, b2=hp.b2,
                                 clip_norm=hp.clip_norm)
            for p, g, m, v in zip(pl, grads, ms, vs):
                np_, nm, nv = K.adamw_leaf_ref(p, g, m, v, sc, **hyper)
                p.copy_(np_)
                m.copy_(nm)
                v.copy_(nv)

        t_b = ADAMW_BYTES[mdt] * n / PEAK_BYTES
        t_o = ADAMW_OPS * n / PEAK_F32_OPS
        row = {"moments": mdt, "params": n, "leaves": len(params),
               "max_abs_err": norm_abs,
               "norm_rel_err": norm_err, "fault_rel_err": fault_err,
               "ms": graph_ms(kernel, 3), "plain_ms": cuda_ms(plain, 2),
               "bound_ms": 1e3 * max(t_b, t_o),
               "bound_by": "bytes" if t_b >= t_o else "operations",
               "library_ms": None}
        del ms, vs
        if mdt == "float32":
            lib = [p.detach().clone().requires_grad_(True) for p in params]
            for p, g in zip(lib, grads):
                p.grad = g.clone()
            opt = torch.optim.AdamW(lib, lr=ADAMW_LR, betas=(hp.b1, hp.b2),
                                    eps=hp.eps, weight_decay=hp.weight_decay,
                                    fused=True)

            def library():
                torch.nn.utils.clip_grad_norm_(lib, hp.clip_norm,
                                               foreach=True)
                opt.step()

            row["library_ms"] = cuda_ms(library, 2)
            del lib, opt
        out.append(row)
        lib_txt = ("" if row["library_ms"] is None else
                   f", clip_grad_norm_ + fused AdamW "
                   f"{row['library_ms']:.3f} ms")
        log(f"  adamw_step ({mdt} moments, {n} parameters in {len(params)} "
            f"leaves): norm rel err {norm_err:.1e} (planted fault "
            f"{fault_err:.1e}, refused), update bit-exact given the scale "
            f"(planted lr ulp refused); step {row['ms']:.3f} ms, plain "
            f"{row['plain_ms']:.3f} ms{lib_txt}, bound {row['bound_ms']:.3f}"
            f" ms ({row['bound_by']}, "
            f"{100 * row['bound_ms'] / row['ms']:.0f}%)")
    return out


def train_kernels_phase(device, seed: int = 0) -> dict:
    """Phase 11a: the two training kernels against their plain versions
    at the shapes 11c gives them; launches made here compare and are not
    counted."""
    t0 = time.perf_counter()
    xent = xent_kernel_rows(device, seed)
    adamw = adamw_kernel_rows(device, seed)
    return {"cross_entropy": xent, "adamw_step": adamw,
            "wall_s": time.perf_counter() - t0}


def train_model_phase(name: str, device, layers: int = TRAIN_MODEL_LAYERS,
                      batch: int = TRAIN_MODEL_BATCH,
                      seq: int = TRAIN_MODEL_SEQ, seed: int = 0) -> dict:
    """Phase 11b: ``name`` at published widths and vocabulary, cut to
    ``layers`` layers: one train step (``steps.make_train_step``) on
    ``device`` (the kernels) and one on the CPU (the plain versions) from
    the same parameters and batch.  Loss and gradient norm within
    ``TRAIN_TOL``; every updated parameter within one AdamW step's reach
    of the CPU's, and at most ``TRAIN_FLIP_MAX`` of the elements more than
    half an lr apart.  Both under the launchers' local mesh (MoE through
    ``moe_ep``)."""
    import dataclasses
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    t_start = time.perf_counter()
    dev = torch.device(device)
    cfg = dataclasses.replace(ARCHS[name], n_layers=layers)
    hp = AdamWConfig()
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    cpu = params.map(lambda t: t.detach().to("cpu", copy=True))
    p0 = [p.detach().clone() for p in tree_util.leaves(cpu)]
    batch = {k: torch.from_numpy(v) for k, v in make_batch(
        cfg, batch, seq, seed=seed, step=0).items()}
    shape = ShapeConfig("11b", seq, batch["tokens"].shape[0], "train")
    out = {}
    mesh = local_mesh()
    for label, tree, d in (("card", params, dev),
                           ("cpu", cpu, torch.device("cpu"))):
        fn, _ = lm_steps.make_train_step(cfg, d, shape, hp,
                                         lr_peak=TRAIN_LR, warmup=1,
                                         total_steps=10)
        t0 = time.perf_counter()
        FA.reset_launches()
        SS.reset_launches()
        with meshctx.use_mesh(mesh, data_axes=("data",)):
            tree, _, m = fn(tree, adamw_init(tree, hp), batch, 1)
        if label == "card":
            flash = dict(FA.launches_by_pass)
            flash_routes = dict(FA.launches_by_route)
            ssd = dict(SS.launches_by_pass)
            ssd_routes = dict(SS.launches_by_route)
        out[label] = (tree_util.leaves(tree),
                      {k: float(v) for k, v in m.items()},
                      time.perf_counter() - t0)
    (pk, mk, t_dev), (pc, mc, t_cpu) = out["card"], out["cpu"]
    loss_gap = abs(mk["loss"] - mc["loss"]) / abs(mc["loss"])
    norm_gap = abs(mk["grad_norm"] - mc["grad_norm"]) / mc["grad_norm"]
    lr = mc["lr"]
    worst, far, total = 0.0, 0, 0
    for a, b, start in zip(pk, pc, p0):
        gap = (a.detach().cpu() - b.detach()).abs()
        reach = 2 * lr * (1 + hp.weight_decay * start.abs()) \
            + 1e-6 * start.abs()
        worst = max(worst, float((gap / reach).max()))
        far += int((gap > lr / 2).sum())
        total += gap.numel()
    row = {"arch": name, "layers": layers, "batch": batch["tokens"].shape[0],
           "seq": seq, "loss_card": mk["loss"], "loss_cpu": mc["loss"],
           "grad_norm_card": mk["grad_norm"],
           "grad_norm_cpu": mc["grad_norm"], "lr": lr,
           "loss_rel_gap": loss_gap, "norm_rel_gap": norm_gap,
           "update_gap_over_reach": worst, "far_share": far / total,
           "card_s": t_dev, "cpu_s": t_cpu, "flash_launches": flash,
           "flash_routes": flash_routes, "ssd_launches": ssd,
           "ssd_routes": ssd_routes, "wall_s": time.perf_counter() - t_start}
    # the flash-attention kernel and the SSD chunk scan: a forward an
    # attention (SSM) layer, again in the block's recompute under remat,
    # and a backward
    n_attn = attention_layers(cfg) if dev.type == "cuda" else 0
    n_ssm = ssm_layers(cfg) if dev.type == "cuda" else 0
    ok = (loss_gap <= TRAIN_TOL and norm_gap <= TRAIN_TOL and worst <= 1.0
          and far / total <= TRAIN_FLIP_MAX and mk["lr"] == mc["lr"]
          and flash == {"fwd": 2 * n_attn, "bwd": n_attn}
          and ssd == {"fwd": 2 * n_ssm, "bwd": n_ssm})
    if not ok:
        raise AssertionError(f"{name} train step, card against CPU: {row}")
    fa_routes_check(f"{name} train step", flash_routes, cfg.compute_dtype)
    ssd_routes_check(f"{name} train step", ssd_routes, ssd, cfg, seq)
    return row


def fa_routes_check(label: str, routes: dict, compute_dtype: str) -> None:
    """Every flash-attention launch of a run took the route that
    ``flash_attention.route`` plans for its compute dtype: ``sm90`` for
    bf16, ``mma`` for fp32 (``launches_by_route``)."""
    want = "sm90" if compute_dtype == "bfloat16" else "mma"
    if any(n for r, n in routes.items() if r != want):
        raise AssertionError(f"{label}: flash-attention launches by route "
                             f"{routes}, all expected on {want} "
                             f"({compute_dtype})")


def ssd_routes_check(label: str, routes: dict, calls: dict, cfg,
                     seq: int) -> None:
    """Every SSD chunk-scan launch of a run took the route that
    ``ssd_scan.route`` plans for the run's compute dtype and ``cfg``'s SSD
    at ``seq``: ``sm90`` for bf16 (mamba2-780m's and jamba's geometry),
    ``mma`` for fp32; ``ROUTE_LAUNCHES`` a call (``launches_by_route``)."""
    import torch
    from repro_torch.kernels import ssd_scan as SS
    want = {r: 0 for r in SS.ROUTES}
    if calls["fwd"] or calls["bwd"]:
        s = cfg.ssm
        rt = SS.route(getattr(torch, cfg.compute_dtype),
                      SS.chunk_len(seq, s.chunk), s.d_state, s.head_dim)
        nf, nb = SS.ROUTE_LAUNCHES[rt]
        want[rt] = nf * calls["fwd"] + nb * calls["bwd"]
    if routes != want:
        raise AssertionError(f"{label}: SSD chunk-scan launches by route "
                             f"{routes}, expected {want} "
                             f"({cfg.compute_dtype})")


def train_loop(cfg, device, steps: int, batch: int, seq: int,
               trace_steps: int = 0, seed: int = 0,
               op_steps: int = 0) -> dict:
    """``launch.train.main``'s loop (its data stream, pinned batches, lr
    schedule and AdamW, under its local mesh) through
    ``steps.make_train_step`` for ``steps`` steps, the launches of the
    training kernels and the grouped GEMM counted over them; then
    ``trace_steps`` more in one ``torch.profiler`` trace, and
    ``op_steps`` more in one with the host's ops (:func:`op_profile`)."""
    import numpy as np
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.configs import ShapeConfig
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import adamw as KA, cross_entropy as KX
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import meshctx
    from repro_torch.launch import steps as lm_steps, train as lm_train
    from repro_torch.models import transformer as T
    from repro_torch.optim import AdamWConfig, adamw_init

    dev = torch.device(device)
    mesh = lm_train.local_mesh()
    total = steps + trace_steps
    fn, _ = lm_steps.make_train_step(
        cfg, dev, ShapeConfig("11c", seq, batch, "train"), AdamWConfig(),
        lr_peak=3e-4, warmup=max(2, steps // 10), total_steps=total)
    torch.cuda.reset_peak_memory_stats(dev)
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    opt = adamw_init(params)
    stream = SyntheticStream(cfg, batch, seq, seed=seed)
    state = {"params": params, "opt": opt, "step": 0}

    def one():
        b = lm_train._to_device(next(stream), dev)
        with meshctx.use_mesh(mesh, data_axes=("data",)):
            state["params"], state["opt"], m = fn(
                state["params"], state["opt"], b, state["step"])
        state["step"] += 1
        return float(m["loss"])

    KX.cross_entropy.launches = KA.grad_norm.launches = 0
    KA.adamw_step.launches = 0
    GG.reset_launches()
    FA.reset_launches()
    SS.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(one())
        times.append(time.perf_counter() - t0)
    launches = (KX.cross_entropy.launches, KA.grad_norm.launches,
                KA.adamw_step.launches, GG.ragged_dot.launches)
    row = {"steps": steps, "batch": batch, "seq": seq, "losses": losses,
           "median_ms": 1e3 * float(np.median(times)),
           "leaves": len(tree_util.leaves(params)),
           "moe_layers": moe_layers(cfg),
           "attention_layers": attention_layers(cfg),
           "flash_launches": dict(FA.launches_by_pass),
           "flash_routes": dict(FA.launches_by_route),
           "ssm_layers": ssm_layers(cfg),
           "ssd_launches": dict(SS.launches_by_pass),
           "ssd_routes": dict(SS.launches_by_route),
           "compute_dtype": cfg.compute_dtype,
           "xent_launches": launches[0], "norm_launches": launches[1],
           "update_launches": launches[2],
           "grouped_gemm_launches": launches[3],
           "grouped_gemm_routes": dict(GG.launches_by_route)}
    if trace_steps:
        t0 = time.perf_counter()
        wall, busy, top = device_profile(
            lambda: [one() for _ in range(trace_steps)], cpu=False)
        row.update(traced_steps=trace_steps, profiled_wall_ms=wall,
                   device_busy_ms=busy, top_device_events=top,
                   trace_s=time.perf_counter() - t0)
    if op_steps:
        row["op_traced_steps"] = op_steps
        row["top_ops_by_shape"] = op_profile(
            lambda: [one() for _ in range(op_steps)])
    row["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    stream.close()
    return row


def check_training(label: str, row: dict) -> None:
    """Finite losses that fall, and the kernels' launches: 2 cross-entropy
    launches a step (forward, backward; 4 with MTP, which no
    configuration here has), 1 norm and one update launch a leaf a step,
    12 grouped-GEMM launches an MoE layer a step (3 forward, 3 in the
    block's recompute under remat, a dx and a dw for each of the 3 in the
    backward), every one on ``grouped_gemm_sm90.cu`` (bf16), 2
    flash-attention forwards (one in the recompute) and a backward an
    attention layer a step, and 2 SSD chunk-scan forwards and a backward
    an SSM layer a step."""
    import math
    losses, steps = row["losses"], row["steps"]
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{label}: losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: loss did not fall: {losses}")
    want = (2 * steps, steps, steps * row["leaves"],
            12 * steps * row["moe_layers"])
    got = (row["xent_launches"], row["norm_launches"],
           row["update_launches"], row["grouped_gemm_launches"])
    if got != want:
        raise AssertionError(f"{label}: launches (cross_entropy, norm, "
                             f"update, grouped GEMM) {got}, expected "
                             f"{want}")
    gg_routes_check(label, row["grouped_gemm_routes"], want[3])
    n = steps * row["attention_layers"]
    if row["flash_launches"] != {"fwd": 2 * n, "bwd": n}:
        raise AssertionError(f"{label}: flash-attention calls "
                             f"{row['flash_launches']}, expected {2 * n} "
                             f"forwards and {n} backwards")
    fa_routes_check(label, row["flash_routes"], row["compute_dtype"])
    n = steps * row["ssm_layers"]
    if row["ssd_launches"] != {"fwd": 2 * n, "bwd": n}:
        raise AssertionError(f"{label}: SSD chunk-scan calls "
                             f"{row['ssd_launches']}, expected {2 * n} "
                             f"forwards and {n} backwards")


def train_full_phase(device, seed: int = 0) -> list:
    """Phase 11c: mamba2-780m at full width and depth through
    ``launch.train.main`` (20 steps, its log parsed), then 8 more steady
    steps of it traced; phi4-mini-3.8b and olmoe-1b-7b at full width cut
    to 8 and 4 layers through ``steps.make_train_step`` in the same loop
    (under its local mesh), 20 steps and 8 traced.  Checks :func:`check_training`; records ms/step, tokens/s,
    peak device memory and the device-busy share."""
    import re
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.configs.base import depth_variant
    from repro_torch.kernels import adamw as KA, cross_entropy as KX
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import train as lm_train

    dev = torch.device(device)
    rows = []
    for name, layers in TRAIN_FULL:
        cfg = ARCHS[name] if layers is None else depth_variant(ARCHS[name],
                                                               layers)
        t0 = time.perf_counter()
        if layers is None:
            argv = ["--arch", name, "--steps", str(TRAIN_FULL_STEPS),
                    "--batch", str(TRAIN_FULL_BATCH), "--seq",
                    str(TRAIN_FULL_SEQ), "--log-every", "1"]
            torch.cuda.reset_peak_memory_stats(dev)
            KX.cross_entropy.launches = KA.grad_norm.launches = 0
            KA.adamw_step.launches = 0
            GG.reset_launches()
            FA.reset_launches()
            SS.reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = lm_train.main(argv)
            lines = buf.getvalue().strip().splitlines()
            if rc != 0 or len(lines) != TRAIN_FULL_STEPS + 1:
                raise AssertionError(f"launch.train {argv}: exit {rc}, "
                                     f"{lines}")
            row = {"steps": TRAIN_FULL_STEPS, "batch": TRAIN_FULL_BATCH,
                   "seq": TRAIN_FULL_SEQ, "argv": argv, "lines": lines,
                   "losses": [float(line.split()[3]) for line in lines[:-1]],
                   "median_ms": float(re.fullmatch(
                       r"done: \d+ steps, median (\d+) ms/step",
                       lines[-1]).group(1)),
                   "xent_launches": KX.cross_entropy.launches,
                   "norm_launches": KA.grad_norm.launches,
                   "update_launches": KA.adamw_step.launches,
                   "grouped_gemm_launches": GG.ragged_dot.launches,
                   "grouped_gemm_routes": dict(GG.launches_by_route),
                   "moe_layers": moe_layers(cfg),
                   "attention_layers": attention_layers(cfg),
                   "flash_launches": dict(FA.launches_by_pass),
                   "flash_routes": dict(FA.launches_by_route),
                   "ssm_layers": ssm_layers(cfg),
                   "ssd_launches": dict(SS.launches_by_pass),
                   "ssd_routes": dict(SS.launches_by_route),
                   "compute_dtype": cfg.compute_dtype,
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
            traced = train_loop(cfg, dev, 2, TRAIN_FULL_BATCH,
                                TRAIN_FULL_SEQ, TRAIN_TRACE_STEPS, seed,
                                op_steps=OP_TRACE_STEPS)
            for k in ("leaves", "traced_steps", "profiled_wall_ms",
                      "device_busy_ms", "top_device_events", "trace_s",
                      "op_traced_steps", "top_ops_by_shape"):
                row[k] = traced[k]
            for line in (lines[0], lines[-2], lines[-1]):
                log(f"  {line}")
        else:
            row = train_loop(cfg, dev, TRAIN_FULL_STEPS, TRAIN_FULL_BATCH,
                             TRAIN_FULL_SEQ, TRAIN_TRACE_STEPS, seed)
        label = name if layers is None else f"{name} x{layers} layers"
        check_training(label, row)
        ssd_routes_check(label, row["ssd_routes"], row["ssd_launches"], cfg,
                         row["seq"])
        row.update(arch=name, layers=cfg.n_layers, label=label,
                   wall_s=time.perf_counter() - t0,
                   tok_s=row["batch"] * row["seq"] / (row["median_ms"] / 1e3))
        rows.append(row)
        busy, wall = row["device_busy_ms"], row["profiled_wall_ms"]
        log(f"  {label}: {row['steps']} steps at batch {row['batch']}, seq "
            f"{row['seq']}: loss {row['losses'][0]:.4f} -> "
            f"{row['losses'][-1]:.4f}, median {row['median_ms']:.0f} ms/step"
            f" ({row['tok_s']:.0f} tok/s), peak device memory "
            f"{row['peak_gb']:.2f} GB; launches cross_entropy "
            f"{row['xent_launches']}, norm {row['norm_launches']}, update "
            f"{row['update_launches']} ({row['leaves']} leaves), grouped "
            f"GEMM {row['grouped_gemm_launches']} (by route "
            f"{row['grouped_gemm_routes']}), flash attention "
            f"{row['flash_launches']}, SSD chunk scan "
            f"{row['ssd_launches']} (launches by route {row['ssd_routes']}); "
            f"{row['traced_steps']} traced steps: device busy {busy:.1f} of "
            f"{wall:.1f} ms ({100 * busy / wall:.1f}%; the trace took "
            f"{row['trace_s']:.1f} s); {row['wall_s']:.1f} s in all")
        for ms, count, ev in row["top_device_events"]:
            log(f"    {ms:9.3f} ms  x{count:<5d} {ev[:90]}")
        if "top_ops_by_shape" in row:
            log(f"  {label}: {row['op_traced_steps']} more traced step, ops "
                f"by the device time of the kernels each launched, with "
                f"their input shapes:")
            for ms, count, op, shapes in row["top_ops_by_shape"]:
                log(f"    {ms:9.3f} ms  x{count:<5d} {op} {shapes[:120]}")
        torch.cuda.empty_cache()
    return rows


def train_resume_phase(device=None, extra=()) -> dict:
    """Phase 11d: ``launch.train.main`` with ``RESUME_ARGS`` in a fresh
    directory (checkpoints at 3 and 6); step_6 read back and removed; the
    same command again resumes at 3 and writes step_6 anew, which must
    match the first within ``RESUME_TOL`` with the stream state equal."""
    import shutil
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import load_pytree
    from repro_torch.configs import ARCHS, reduced
    from repro_torch.launch import train as lm_train
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw_init

    dev_arg = [] if device is None else ["--device", str(device)]
    with tempfile.TemporaryDirectory() as d:
        argv = RESUME_ARGS + list(extra) + dev_arg + ["--ckpt-dir", d]
        args = lm_train.parser().parse_args(argv)
        cfg = reduced(ARCHS[args.arch])
        params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        template = {"params": params, "opt": adamw_init(params)}
        texts = []
        for _ in range(2):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = lm_train.main(argv)
            if rc != 0:
                raise AssertionError(f"launch.train {argv}: exit {rc}")
            texts.append(buf.getvalue().strip().splitlines())
            names = sorted(os.listdir(d))
            if names != ["LATEST", "step_0000000003", "step_0000000006"]:
                raise AssertionError(f"checkpoints {names}")
            six = os.path.join(d, "step_0000000006")
            tree, meta = load_pytree(template, six)
            if not texts[1:]:
                first, first_meta = tree, meta
                shutil.rmtree(six)
        if texts[1][0] != "[resume] from step 3":
            raise AssertionError(f"resume: {texts[1]}")
    worst = 0.0
    rtol, atol = RESUME_TOL
    for (k, a), (_, b) in zip(tree_util.flatten_with_paths(first),
                              tree_util.flatten_with_paths(tree)):
        gap = (a.double() - b.double()).abs()
        if not bool((gap <= atol + rtol * a.double().abs()).all()):
            raise AssertionError(f"resumed step_6 {k}: max gap "
                                 f"{float(gap.max())}")
        worst = max(worst, float(gap.max()))
    if meta != first_meta or meta["stream"] != {"step": 6, "seed": 0}:
        raise AssertionError(f"stream state {meta} against {first_meta}")
    return {"arch": args.arch, "argv": argv, "lines": texts,
            "max_abs_gap": worst, "metadata": meta}


def gg_group_sizes(groups: int, tokens: int, top_k: int, gen,
                   device) -> tuple:
    """``(group sizes (G,) int32 on device, hits, cap)``: ``tokens`` each
    routed to ``top_k`` distinct experts of ``groups`` by random scores,
    and moe_ep's capacity at tp 1."""
    import torch
    scores = torch.rand((tokens, groups), generator=gen)
    idx = torch.topk(scores, top_k, dim=-1).indices.reshape(-1)
    sizes = torch.bincount(idx, minlength=groups).to(torch.int32)
    hits = tokens * top_k
    cap = -(-max(int(GG_CF * hits), 8) // 8) * 8
    return sizes.to(device), hits, cap


def gg_bound(mode: int, hits: int, m: int, k: int, n: int, groups: int,
             nonempty: int, elem: int, peak_ops: float) -> tuple:
    """``(ms, "operations" | "bytes")`` of one grouped product: the larger
    of ``2·hits·K·N`` operations at ``peak_ops`` and the bytes it must
    move at the HBM rate: the rows of the groups read once, the weights of
    the non-empty groups (fwd, dx) read once, the output written once
    (dw: every group's)."""
    from repro_torch.kernels import grouped_gemm as GG
    ops = 2.0 * hits * k * n / peak_ops
    if mode == GG.FWD:
        nbytes = hits * k + nonempty * k * n + m * n
    elif mode == GG.DX:
        nbytes = hits * n + nonempty * k * n + m * k
    else:
        nbytes = hits * k + hits * n + groups * k * n
    t_bytes = elem * nbytes / PEAK_BYTES
    return 1e3 * max(ops, t_bytes), "operations" if ops >= t_bytes \
        else "bytes"


def chunked_scaled_within(got, want, scale: float, rtol: float,
                          chunk: int = 1 << 26) -> tuple:
    """:func:`scaled_within` a chunk of ``chunk`` elements at a time (a dw
    at deepseek-v3's widths is 3.8e9 elements: its fp32 copies would not
    fit beside it)."""
    import torch
    if got.shape != want.shape:
        return float("inf"), float("inf"), False
    g, w = got.reshape(-1), want.reshape(-1)
    n = w.numel()
    sq = sum(float(w[i:i + chunk].float().square().sum(dtype=torch.float64))
             for i in range(0, n, chunk))
    rms = (sq / n) ** 0.5 if n else 0.0
    err, ok = 0.0, True
    for i in range(0, n, chunk):
        wc = w[i:i + chunk].float()
        diff = (g[i:i + chunk].float() - wc).abs()
        err = max(err, float(diff.max()))
        ok = ok and bool((diff <= scale * rms + rtol * wc.abs()).all())
    return err, err / rms if rms else (float("inf") if err else 0.0), ok


def gg_check(label, got, want, sizes, mode, tol, fault=False) -> tuple:
    """``(max |err|, err over rms, ok)`` of a kernel output against the
    plain one, with the exact zeros the kernel owes: rows past the
    groups' sum (fwd, dx), an empty group's dw.  ``fault``: the caller
    expects it to fail and nothing raises."""
    from repro_torch.kernels import grouped_gemm as GG
    err, rel, ok = chunked_scaled_within(got, want, *tol)
    end = int(sizes.clamp(min=0).sum())
    if mode == GG.DW:
        zeros = all(bool((got[e] == 0).all())
                    for e in (sizes == 0).nonzero().flatten().tolist())
    else:
        zeros = bool((got[end:] == 0).all())
    ok = ok and zeros
    if not ok and not fault:
        raise AssertionError(f"grouped GEMM {label}: max |err| {err} "
                             f"({rel:.4f} of the rms; exact zeros {zeros})")
    return err, rel, ok


def gg_timing_ms(fn, out_bytes: int, device) -> float:
    """Device ms of ``fn()`` by graph replay; calls whose output passes a
    GB are captured 2 at a time, not ``REPS``."""
    if not str(device).startswith("cuda"):
        return dev_ms(fn, device)
    return graph_ms(fn, REPS if out_bytes < 1e9 else 2)


def gg_turns_ms(fn, other, out_bytes: int, device) -> tuple:
    """``(ms of fn, ms of other)`` timed in turns, fn, other, other, fn,
    each the faster of its two (``other`` None: fn's alone)."""
    if other is None:
        return gg_timing_ms(fn, out_bytes, device), None
    a = gg_timing_ms(fn, out_bytes, device)
    b = gg_timing_ms(other, out_bytes, device)
    b = min(b, gg_timing_ms(other, out_bytes, device))
    return min(a, gg_timing_ms(fn, out_bytes, device)), b


def gg_routes_check(label, routes: dict, total: int) -> None:
    """Every grouped-GEMM launch of a bf16 main-path run went to
    ``grouped_gemm_sm90.cu`` (the "wgmma" and "stream" routes), none to
    the ``tile`` route."""
    if routes["tile"] or routes["wgmma"] + routes["stream"] != total:
        raise AssertionError(f"{label}: grouped-GEMM launches by route "
                             f"{routes}, expected all {total} on wgmma or "
                             f"stream")


def gg_launch(kernel, a, b, sizes) -> tuple:
    """``(output, route)`` of one product through ``kernel`` (``GG._fwd``,
    ``_dx`` or ``_dw``), the route read from the launch counters
    ("plain" on the CPU)."""
    from repro_torch.kernels import grouped_gemm as GG
    before = dict(GG.launches_by_route)
    got = kernel(a, b, sizes)
    return got, next((r for r in GG.ROUTES
                      if GG.launches_by_route[r] != before[r]), "plain")


def gg_library(mode, a, b, sizes):
    """The yardstick ``torch._grouped_mm`` for the same product (bf16 on
    the card only), or ``None`` where this torch lacks it or refuses the
    operands."""
    import torch
    from repro_torch.kernels import grouped_gemm as GG
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None or a.dtype != torch.bfloat16 or not a.is_cuda:
        return None
    if bool((sizes < 0).any()) or int(sizes.sum()) > a.shape[0]:
        # its offsets must rise and stay in the buffer (a device-side
        # assert otherwise, which ends the process's CUDA context)
        log("    torch._grouped_mm n/a: group offsets past the buffer")
        return None
    offs = torch.cumsum(sizes.to(torch.int64), 0).to(torch.int32)
    if mode == GG.FWD:
        call = lambda: fn(a, b, offs=offs)                  # noqa: E731
    elif mode == GG.DX:
        call = lambda: fn(a, b.transpose(-2, -1), offs=offs)  # noqa: E731
    else:
        call = lambda: fn(a.t(), b, offs=offs)              # noqa: E731
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, ValueError) as e:
        log(f"    torch._grouped_mm refused: {str(e).splitlines()[0][:120]}")
        return None
    return call


def gg_products(label, x, w, dy, sizes, hits, device, tol, rows) -> None:
    """Forward, dx and dw of one case against the plain versions, and on
    grouped_gemm_sm90.cu's routes against ``ragged_dot_tiles_ref`` too
    (its algorithm); each timed beside the tile route on the same
    operands (``previous_ms``); each a row appended to ``rows``."""
    import torch
    from repro_torch.kernels import grouped_gemm as GG
    m, k = x.shape
    groups, _, n = w.shape
    nonempty = int((sizes > 0).sum())
    elem = x.element_size()
    peak = PEAK_BF16_OPS if x.dtype == torch.bfloat16 else PEAK_F32_OPS
    prods = [(GG.FWD, "fwd", x, w, GG.ragged_dot_ref, m * n, n),
             (GG.DX, "dx", dy, w, GG.ragged_dot_dx_ref, m * k, k),
             (GG.DW, "dw", x, dy, GG.ragged_dot_dw_ref, groups * k * n, n)]
    for mode, name, a, b, ref, out_elems, cols in prods:
        # on the card the kernel; on the CPU (a rehearsal) the plain version
        kernel = {GG.FWD: GG._fwd, GG.DX: GG._dx, GG.DW: GG._dw}[mode]
        planned = GG.route(mode, a.dtype, m, k, n,
                           GG.operands_aligned(a, b))
        got, route = gg_launch(kernel, a, b, sizes)
        if a.is_cuda:
            torch.cuda.synchronize()
            if route != planned:
                raise AssertionError(f"grouped GEMM {label} {name}: launched "
                                     f"on {route}, planned {planned}")
        want = ref(a, b, sizes)
        err, rel, _ = gg_check(f"{label} {name}", got, want, sizes, mode, tol)
        del want
        t_rel = None
        if planned in ("wgmma", "stream"):
            bm, bn = ((GG.WG_BM, GG.WG_BN) if planned == "wgmma"
                      else (GG.STREAM_BM, GG.STREAM_BN))
            tiles = GG.ragged_dot_tiles_ref(mode, a, b, sizes, bm, bn)
            _, t_rel, _ = gg_check(f"{label} {name} (tiles)", got, tiles,
                                   sizes, mode, tol)
            del tiles
        del got
        b_ms, b_by = gg_bound(mode, hits, m, k, n, groups, nonempty, elem,
                              peak)
        tile = None
        if a.is_cuda and route != "tile":
            tile = lambda: GG.ragged_dot_cuda(mode, a, b, sizes,  # noqa: E731
                                              route="tile")
        ms, prev_ms = gg_turns_ms(lambda: kernel(a, b, sizes), tile,
                                  out_elems * elem, device)
        plain_ms = cuda_ms(lambda: ref(a, b, sizes), 3) if a.is_cuda \
            else dev_ms(lambda: ref(a, b, sizes), device)
        lib = gg_library(mode, a, b, sizes)
        lib_ms = None if lib is None else gg_timing_ms(lib, out_elems * elem,
                                                      device)
        row = {"case": label, "product": name, "dtype": str(x.dtype)[6:],
               "M": m, "K": k, "N": n, "groups": groups,
               "nonempty": nonempty, "hits": hits, "route": route,
               "max_abs_err": err, "err_over_rms": rel,
               "tiles_err_over_rms": t_rel, "ms": ms, "previous_ms": prev_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}
        rows.append(row)
        log(f"  {label} {name}: M {m} K {k} N {n}, {nonempty}/{groups} "
            f"groups, {hits} rows, route {route}: max |err| {err:.3g} "
            f"({rel:.4f} of the rms"
            + ("" if t_rel is None else f"; tiles {t_rel:.4f}")
            + f"); kernel {ms:.4f} ms, bound {b_ms:.4f} ({b_by}, "
            f"{100 * b_ms / ms:.0f}%), tile route "
            + ("n/a" if prev_ms is None else f"{prev_ms:.4f}")
            + f", plain {plain_ms:.4f}, _grouped_mm "
            + ("n/a" if lib_ms is None else f"{lib_ms:.4f}"))


def gg_fault(x, w, dy, sizes, tol) -> None:
    """The planted fault: one row moved from the first non-empty group
    into the next, run by the kernel and held against the plain version
    on the true sizes; forward and dw must both fail the tolerance."""
    from repro_torch.kernels import grouped_gemm as GG
    bad = sizes.clone()
    g = int((sizes[:-1] > 0).nonzero()[0])
    bad[g] -= 1
    bad[g + 1] += 1
    for mode, a, b, ref in ((GG.FWD, x, w, GG.ragged_dot_ref),
                            (GG.DW, x, dy, GG.ragged_dot_dw_ref)):
        got, route = gg_launch(GG._fwd if mode == GG.FWD else GG._dw, a, b,
                               bad)
        _, rel, ok = gg_check("planted fault", got, ref(a, b, sizes), sizes,
                              mode, tol, fault=True)
        if ok:
            raise AssertionError(f"grouped GEMM: the planted fault (mode "
                                 f"{mode}, route {route}) passed ({rel:.4f} "
                                 f"of the rms)")
        log(f"  planted fault (one row into group {g + 1}), mode {mode}, "
            f"route {route}: {rel:.3f} of the rms, refused")


def gg_graph_check(device, seed: int = 0) -> dict:
    """grouped_gemm_sm90.cu under CUDA-graph capture: forward, dx and dw
    at olmoe's widths on a 5,120-row buffer (the wgmma route) and the
    decode buffer (the forward on the stream route) captured in one
    graph; each replay must equal the eager calls bit for bit (the outputs
    set to NaN before it), after another shape's call between replays,
    and after new group sizes are written into the captured tensors (the
    kernels read them on the device at every replay)."""
    import torch
    from repro_torch.kernels import grouped_gemm as GG
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed + 1)
    dgen = torch.Generator(dev).manual_seed(seed + 1)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=dgen, device=dev,
                           dtype=torch.bfloat16) * scale

    calls = []
    for tokens in (512, 4):
        sizes, _, cap = gg_group_sizes(64, tokens, 8, gen, dev)
        x, dy = randn(cap, 2048), randn(cap, 1024)
        w = randn(64, 2048, 1024, scale=2048 ** -0.5)
        calls += [(GG.FWD, x, w, sizes), (GG.DX, dy, w, sizes),
                  (GG.DW, x, dy, sizes)]

    def eager():
        return [GG.ragged_dot_cuda(*c) for c in calls]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    GG.reset_launches()
    with torch.cuda.graph(graph):
        outs = [GG.ragged_dot_cuda(*c) for c in calls]
    routes = dict(GG.launches_by_route)

    def replay_equal(label):
        for o in outs:
            o.fill_(float("nan"))
        graph.replay()
        want = eager()
        torch.cuda.synchronize()
        if not all(torch.equal(o, e) for o, e in zip(outs, want)):
            raise AssertionError(f"grouped GEMM graph replay {label}: "
                                 f"differs from the eager calls")

    replay_equal("first")
    GG.ragged_dot_cuda(GG.FWD, randn(300, 256), randn(5, 256, 264),
                       torch.tensor([60, 0, 100, 40, 50], dtype=torch.int32,
                                    device=dev))
    replay_equal("after another shape")
    for _, _, _, sizes in calls[::3]:
        sizes.copy_(sizes.flip(0))
    replay_equal("after new group sizes")
    del graph
    if routes != {"wgmma": 5, "stream": 1, "tile": 0}:
        raise AssertionError(f"grouped GEMM graph check: captured launches "
                             f"by route {routes}")
    log(f"  graph replay: {len(calls)} captured products (routes {routes}) "
        f"equal the eager calls bit for bit, after another shape's call "
        f"and after new group sizes")
    return {"captured": len(calls), "routes": routes}


def moe_no_sync_check(device, seed: int = 0, tokens=(4, 16)) -> dict:
    """One ``moe_ep`` forward and backward at olmoe-1b-7b's widths (one
    layer's MoE, bf16, ``tokens`` = (B, S)) under the local mesh with
    ``torch.cuda.set_sync_debug_mode("error")``: any host sync raises.
    The grouped GEMM launches 9 times (3 forward, a dx and a dw each
    backward), none on the tile route; output and x gradient against the
    dense dispatch (no mesh) on the same device."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.launch import meshctx
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import layers as L

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    cfg = ARCHS["olmoe-1b-7b"]
    gen = torch.Generator(dev).manual_seed(seed)
    p = {k: v.requires_grad_(True)
         for k, v in L.moe_init(cfg, gen, torch.bfloat16).items()}
    b, s = tokens
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=dev,
                    dtype=torch.float32).to(torch.bfloat16).requires_grad_(True)
    cot = torch.randn((b, s, cfg.d_model), generator=gen, device=dev)
    leaves = [p[k] for k in sorted(p)] + [x]
    mesh = local_mesh()

    def run(ctx_mesh):
        with meshctx.use_mesh(ctx_mesh, data_axes=("data",)):
            out, aux = L.moe_apply(cfg, p, x)
        loss = (out.float() * cot).sum() + aux
        return out, torch.autograd.grad(loss, leaves)

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
    GG.reset_launches()
    try:
        out, grads = run(mesh)
    finally:
        if on_card:
            torch.cuda.set_sync_debug_mode(0)
    launched = GG.ragged_dot.launches
    routes = dict(GG.launches_by_route)
    if on_card:
        if launched != 9:
            raise AssertionError(f"moe_ep: {launched} grouped-GEMM launches, "
                                 f"expected 9")
        gg_routes_check(f"moe_ep B {b} x S {s}", routes, 9)
    dense, dgrads = run(None)
    o_err, o_rel, o_ok = scaled_within(out.detach(), dense.detach(),
                                       *GG_MOE_TOL)
    x_err, x_rel, x_ok = scaled_within(grads[-1], dgrads[-1], *GG_MOE_TOL)
    if not (o_ok and x_ok and all(bool(torch.isfinite(g).all())
                                  for g in grads)):
        raise AssertionError(f"moe_ep against the dense dispatch: out "
                             f"{o_rel:.4f}, dx {x_rel:.4f} of the rms")
    log(f"  moe_ep forward + backward at olmoe's widths, B {b} x S {s}, "
        f"under set_sync_debug_mode('error'): no host sync, {launched} "
        f"grouped-GEMM launches (by route {routes}); against the dense "
        f"dispatch out {o_rel:.4f}, dx {x_rel:.4f} of the rms (limit "
        f"{GG_MOE_TOL})")
    return {"tokens": list(tokens), "launches": launched, "routes": routes,
            "out_over_rms": o_rel, "dx_over_rms": x_rel}


def gg_criteria(rows) -> dict:
    """The checks the redesign is held to (``GG_TRAIN_MIN``,
    ``GG_TRAIN_GAIN``, ``GG_SLOWER_MAX``), each ``(value, met)``, from
    phase 12's rows; logged, not raised."""
    def row(case, product):
        return next(r for r in rows if r["case"] == case
                    and r["product"] == product)

    train = [row("olmoe train B 4 x S 2048 up", p)
             for p in ("fwd", "dx", "dw")]
    out = {}
    for r in train:
        share = r["bound_ms"] / r["ms"]
        out[f"train {r['product']} share of bound"] = (
            share, share >= GG_TRAIN_MIN)
    gain = sum(r["previous_ms"] for r in train) / sum(r["ms"] for r in train)
    out["train fwd + dx + dw, tile route over kernel"] = (
        gain, gain >= GG_TRAIN_GAIN)
    dec = row("olmoe decode B 4 up", "fwd")
    out["decode fwd, tile route over kernel"] = (
        dec["previous_ms"] / dec["ms"], dec["ms"] < dec["previous_ms"])
    for case in ("deepseek-v3 T 4 up", "jamba-1.5 T 4 up"):
        for p in ("fwd", "dx", "dw"):
            r = row(case, p)
            slower = r["ms"] / r["previous_ms"] - 1
            out[f"{case} {p}, slower than the tile route by"] = (
                slower, slower <= GG_SLOWER_MAX)
    for k, (v, met) in out.items():
        log(f"  {k}: {v:.3f} ({'met' if met else 'MISSED'})")
    return {k: {"value": v, "met": met} for k, (v, met) in out.items()}


def grouped_gemm_phase(device, seed: int = 0, cases=GG_CASES,
                       edges=GG_EDGES) -> dict:
    """Phase 12: the grouped expert GEMM against its plain version on the
    card — forward, dx and dw at ``cases`` (olmoe's decode and training
    capacity buffers, deepseek-v3's and jamba's widths) and the
    ``edges``, within ``GG_TOL`` of each case's rms (and, on
    grouped_gemm_sm90.cu's routes, of ``ragged_dot_tiles_ref``), with a
    planted fault refused on the wgmma and stream routes; each product
    timed (graph replay) beside the tile route, its bound, the plain
    version and ``torch._grouped_mm``; a graph-replay check
    (:func:`gg_graph_check`); then the no-host-sync check of ``moe_ep``
    (:func:`moe_no_sync_check`) at ``GG_MOE_TOKENS``."""
    import torch
    from repro_torch.kernels import grouped_gemm as GG
    if GG.STREAM_MAX_M != GG_STREAM_M:
        raise AssertionError(f"the stream route's threshold "
                             f"{GG.STREAM_MAX_M}, GG_EDGES hold "
                             f"{GG_STREAM_M}")
    dev = torch.device(device)
    gen = torch.Generator().manual_seed(seed)
    # operands drawn on the device: deepseek-v3's weights are 3.8e9 values
    dgen = torch.Generator(dev).manual_seed(seed)
    rows = []
    tol = GG_TOL["bfloat16"]

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.randn(shape, generator=dgen, device=dev,
                           dtype=dtype) * scale

    for label, groups, d, f, tokens, top_k, down in cases:
        sizes, hits, cap = gg_group_sizes(groups, tokens, top_k, gen, dev)
        shapes = [("up", d, f)] + ([("down", f, d)] if down else [])
        for part, k, n in shapes:
            x = randn(cap, k)
            w = randn(groups, k, n, scale=k ** -0.5)
            dy = randn(cap, n)
            gg_products(f"{label} {part}", x, w, dy, sizes, hits, dev, tol,
                        rows)
            if label.startswith("olmoe") and part == "up":
                gg_fault(x, w, dy, sizes, tol)
            del x, w, dy
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    for label, dtype, m, k, n, sizes in edges:
        dt = getattr(torch, dtype)
        sz = torch.tensor(sizes, dtype=torch.int32, device=dev)
        hits = min(int(sz.clamp(min=0).sum()), m)
        gg_products(label, randn(m, k, dtype=dt),
                    randn(len(sizes), k, n, scale=k ** -0.5, dtype=dt),
                    randn(m, n, dtype=dt), sz, hits, dev, GG_TOL[dtype],
                    rows)
    out = {"rows": rows}
    if dev.type == "cuda":
        out["graph"] = gg_graph_check(dev, seed)
        out["criteria"] = gg_criteria(rows)
    out["moe"] = [moe_no_sync_check(dev, seed, t) for t in GG_MOE_TOKENS]
    return out


# ---------------------------------------------------------------------------
# phase 13: the prefill step and the dry run
# ---------------------------------------------------------------------------

_COST_CELLS = r"""
import json, sys
sys.modules["jax"] = None
from repro_torch.configs import ARCHS, ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
from repro_torch.configs.base import depth_variant
out = []
for b, s, layers in json.loads(sys.argv[2]):
    cfg = ARCHS[sys.argv[1]]
    rec = dryrun.cost_cell(cfg if layers is None else
                           depth_variant(cfg, layers),
                           ShapeConfig("prefill", s, b, "prefill"),
                           make_mesh((1, 1), ("data", "model")))
    rec["layers"] = layers
    out.append(rec)
print(json.dumps(out))
"""


def dryrun_start() -> dict:
    """Phase 13's host-only runs, started together and in the background
    (none touches the card: ``CUDA_VISIBLE_DEVICES`` is empty): the
    dry-run CLI on the fake (16, 16) mesh, ``cost_cell`` on the local
    (1, 1) mesh for 13a's shapes, and ``python -m
    repro_torch.launch.serve --production-mesh``."""
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    (ROOT / "build").mkdir(exist_ok=True)
    # the traced calls' cells, then each shape at full depth
    shapes = json.dumps([[b, s, layers] for b, s, _, _, layers
                         in PREFILL_SHAPES]
                        + [[b, s, None] for b, s, _, _, layers
                           in PREFILL_SHAPES if layers is not None])
    cmds = {
        "cli": [sys.executable, "-m", "repro_torch.launch.dryrun"]
        + DRYRUN_CLI,
        "cells": [sys.executable, "-c", _COST_CELLS, PREFILL_ARCH, shapes],
        "serve": [sys.executable, "-m", "repro_torch.launch.serve",
                  "--production-mesh"]}
    return {k: (subprocess.Popen(c, cwd=ROOT, env=env,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True),
                time.perf_counter())
            for k, c in cmds.items()}


def dryrun_collect(procs: dict) -> dict:
    """``{name: (returncode, stdout, stderr, seconds)}`` of
    :func:`dryrun_start`'s processes, each waited for (killed at
    ``DRYRUN_TIMEOUT``)."""
    out = {}
    try:
        for k, (p, t0) in procs.items():
            so, se = p.communicate(timeout=DRYRUN_TIMEOUT)
            out[k] = (p.returncode, so, se, time.perf_counter() - t0)
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    return out


def prefill_timed(fn, params, batch, reps: int, warm: bool,
                  device) -> tuple:
    """``(logits, [host ms of each call], peak GB)``: a warm-up call when
    ``warm``, then ``reps`` calls timed by host clock between device
    syncs, the peak device memory over the timed calls."""
    import torch
    if warm:
        fn(params, batch)
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    logits = None
    ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        logits = fn(params, batch)
        torch.cuda.synchronize(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return logits, ms, torch.cuda.max_memory_allocated(device) / 1e9


def prefill_full_phase(device, seed: int = 0) -> list:
    """Phase 13a: phi4-mini-3.8b at full depth (32 layers) through
    ``steps.make_prefill_step`` at ``PREFILL_SHAPES`` (random weights
    from ``seed``, the launchers' local mesh): last-token logits finite,
    the flash-attention kernel's launches over the timed calls (one an
    attention layer a call, no backward), the median host ms of the timed
    calls, prefill tokens/s, the peak device memory, and one
    ``torch.profiler`` trace of a call at the shape's traced depth (its
    device-busy ms).  At S 32768 the peak must
    stay under the fp32 parameters, their bf16 cast and
    ``PREFILL_LOGITS_BYTES``."""
    import statistics
    import torch
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.configs.base import depth_variant
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import transformer as T

    dev = torch.device(device)
    cfg = ARCHS[PREFILL_ARCH]
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    n_params = sum(t.numel() for t in params.parameters())
    rows = []
    mesh = local_mesh()
    with meshctx.use_mesh(mesh, data_axes=("data",)):
        for b, s, reps, warm, traced_layers in PREFILL_SHAPES:
            t_start = time.perf_counter()
            fn, _ = lm_steps.make_prefill_step(
                cfg, dev, ShapeConfig("prefill", s, b, "prefill"))
            batch = {"tokens": torch.from_numpy(make_batch(
                cfg, b, s, seed=seed, step=0)["tokens"]).to(dev)}
            FA.reset_launches()
            logits, ms, peak = prefill_timed(fn, params, batch, reps, warm,
                                             dev)
            flash = dict(FA.launches_by_pass)
            flash_routes = dict(FA.launches_by_route)
            want = (reps + int(warm)) * attention_layers(cfg)
            if flash != {"fwd": want, "bwd": 0}:
                raise AssertionError(f"prefill B {b} S {s}: flash-attention "
                                     f"calls {flash}, expected {want} "
                                     f"forwards")
            fa_routes_check(f"prefill B {b} S {s}", flash_routes,
                            cfg.compute_dtype)
            if tuple(logits.shape) != (b, cfg.vocab) or \
                    logits.dtype != torch.float32 or \
                    not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"prefill B {b} S {s}: logits "
                                     f"{tuple(logits.shape)} {logits.dtype}")
            if traced_layers is None:
                traced, tfn = params, fn
            else:
                # the first blocks of the same parameters
                traced = T.ParamTree({k: (list(params[k])[:traced_layers]
                                          if k == "blocks" else params[k])
                                      for k in params.keys()})
                tfn, _ = lm_steps.make_prefill_step(
                    depth_variant(cfg, traced_layers), dev,
                    ShapeConfig("prefill", s, b, "prefill"))
            wall, busy, top = device_profile(lambda: tfn(traced, batch),
                                             cpu=False)
            med = statistics.median(ms)
            row = {"arch": PREFILL_ARCH, "layers": cfg.n_layers, "batch": b,
                   "seq": s, "traced_layers": traced_layers or cfg.n_layers,
                   "calls_ms": ms, "median_ms": med,
                   "tok_s": b * s / (med / 1e3), "peak_gb": peak,
                   "flash_launches": flash, "flash_routes": flash_routes,
                   "profiled_wall_ms": wall, "device_busy_ms": busy,
                   "top_device_events": top,
                   "wall_s": time.perf_counter() - t_start}
            if s == 32768:
                limit = n_params * (4 + 2) + PREFILL_LOGITS_BYTES
                row["peak_limit_gb"] = limit / 1e9
                if peak * 1e9 >= limit:
                    raise AssertionError(f"prefill S {s}: peak {peak:.2f} GB"
                                         f" >= {limit / 1e9:.2f} GB")
            rows.append(row)
            log(f"  {PREFILL_ARCH} x{cfg.n_layers} layers, B {b} x S {s}: "
                f"{', '.join(f'{m:.1f}' for m in ms)} ms (median {med:.1f} "
                f"ms, {row['tok_s']:.0f} prefill tok/s), peak device memory "
                f"{peak:.2f} GB"
                + (f" (limit {row['peak_limit_gb']:.2f} GB)" if s == 32768
                   else "")
                + f"; flash attention {flash['fwd']} launches"
                + f"; one traced call ({row['traced_layers']} layers): "
                f"device busy {busy:.1f} of {wall:.1f} ms "
                f"({100 * busy / wall:.1f}%); {row['wall_s']:.1f} s in all")
            for t_ms, count, ev in top:
                log(f"    {t_ms:9.3f} ms  x{count:<7d} {ev[:90]}")
            del logits, batch
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return rows


def prefill_moe_phase(device, seed: int = 0) -> dict:
    """Phase 13b: olmoe-1b-7b at full depth (16 layers) through
    ``make_prefill_step`` at B 4 x S 2048 under the local mesh: the
    grouped GEMM's launches counted from 0 just before one call and read
    just after, 3 an MoE layer, every one on the wgmma route."""
    import torch
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import transformer as T

    name, b, s = PREFILL_MOE
    dev = torch.device(device)
    cfg = ARCHS[name]
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    fn, _ = lm_steps.make_prefill_step(
        cfg, dev, ShapeConfig("prefill", s, b, "prefill"))
    batch = {"tokens": torch.from_numpy(make_batch(
        cfg, b, s, seed=seed, step=0)["tokens"]).to(dev)}
    with meshctx.use_mesh(local_mesh(), data_axes=("data",)):
        fn(params, batch)                                  # warm-up
        torch.cuda.synchronize(dev)
        GG.reset_launches()
        t0 = time.perf_counter()
        logits = fn(params, batch)
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    launched, routes = GG.ragged_dot.launches, dict(GG.launches_by_route)
    want = 3 * moe_layers(cfg)
    if launched != want or routes["wgmma"] != want:
        raise AssertionError(f"{name} prefill: {launched} grouped-GEMM "
                             f"launches by route {routes}, expected {want} "
                             f"on wgmma")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill: non-finite logits")
    del params
    torch.cuda.empty_cache()
    return {"arch": name, "layers": cfg.n_layers, "batch": b, "seq": s,
            "ms": ms, "tok_s": b * s / (ms / 1e3),
            "grouped_gemm_launches": launched, "grouped_gemm_routes": routes}


def prefill_ssm_phase(device, seed: int = 0) -> dict:
    """Phase 13b': mamba2-780m at full depth (48 SSM layers) through
    ``make_prefill_step`` at B 4 x S 2048 under the local mesh: a warm-up
    call and ``PREFILL_SSM[3]`` timed calls, the SSD chunk scan's launches
    counted from 0 just before them and read just after (one forward an
    SSM layer a call, no backward), finite last-token logits, the median
    host ms of the timed calls, prefill tokens/s, the peak device memory
    and one ``torch.profiler`` trace of a call (its device-busy ms)."""
    import statistics
    import torch
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import transformer as T

    name, b, s, reps = PREFILL_SSM
    t_start = time.perf_counter()
    dev = torch.device(device)
    cfg = ARCHS[name]
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
    fn, _ = lm_steps.make_prefill_step(
        cfg, dev, ShapeConfig("prefill", s, b, "prefill"))
    batch = {"tokens": torch.from_numpy(make_batch(
        cfg, b, s, seed=seed, step=0)["tokens"]).to(dev)}
    with meshctx.use_mesh(local_mesh(), data_axes=("data",)):
        SS.reset_launches()
        logits, ms, peak = prefill_timed(fn, params, batch, reps, True, dev)
        ssd = dict(SS.launches_by_pass)
        ssd_routes = dict(SS.launches_by_route)
        wall, busy, top = device_profile(lambda: fn(params, batch),
                                         cpu=False)
    want = (reps + 1) * ssm_layers(cfg)
    if ssd != {"fwd": want, "bwd": 0}:
        raise AssertionError(f"{name} prefill: SSD chunk-scan calls {ssd}, "
                             f"expected {want} forwards")
    ssd_routes_check(f"{name} prefill", ssd_routes, ssd, cfg, s)
    if tuple(logits.shape) != (b, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{name} prefill: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    med = statistics.median(ms)
    row = {"arch": name, "layers": cfg.n_layers, "batch": b, "seq": s,
           "calls_ms": ms, "median_ms": med, "tok_s": b * s / (med / 1e3),
           "peak_gb": peak, "ssd_launches": ssd, "ssd_routes": ssd_routes,
           "profiled_wall_ms": wall,
           "device_busy_ms": busy, "top_device_events": top,
           "wall_s": time.perf_counter() - t_start}
    del params, logits, batch
    torch.cuda.empty_cache()
    return row


def prefill_agree_phase(name: str, layers: int, device, seed: int = 0,
                        compute_dtype=None, hold_decode: bool = True) -> dict:
    """Phase 13c: ``name`` at full width cut to ``layers`` layers, B 4 x
    S 64, under the local mesh: the prefill step's last-token logits on
    the card against the same prompt stepped through ``make_decode_step``
    on the card, and against the prefill step on the CPU with the same
    bf16 parameters; within ``LOGIT_TOL`` of the range on the rows held
    (an MoE row whose tokens route differently between the two runs of
    a pair is left out; ``MOE_CHECKED_MIN`` of the rows must be held).
    Without ``hold_decode`` the gap to decode is logged, not held, beside
    the CPU's own prefill against the prompt stepped through the decode
    step on the CPU."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCHS, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    from repro_torch.launch import meshctx, steps as lm_steps
    from repro_torch.launch.train import local_mesh
    from repro_torch.models import transformer as T

    t_start = time.perf_counter()
    dev = torch.device(device)
    cfg = dataclasses.replace(ARCHS[name], n_layers=layers)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts
            / cfg.moe.experts_per_tok))
    b, s = PREFILL_AGREE_BATCH, PREFILL_AGREE_SEQ
    cast = T.cast_params(cfg, T.init_params(
        cfg, torch.Generator(dev).manual_seed(seed), dev))
    cpu = cast.map(lambda t: t.to("cpu"))
    cpu.compute_dtype = cast.compute_dtype
    tokens = torch.from_numpy(make_batch(cfg, b, s, seed=seed,
                                         step=0)["tokens"])
    shape = ShapeConfig("agree", s, b, "prefill")
    r_card, r_dec, r_cpu = [], [], []
    with meshctx.use_mesh(local_mesh(), data_axes=("data",)):
        fn_card, _ = lm_steps.make_prefill_step(cfg, dev, shape)
        FA.reset_launches()
        SS.reset_launches()
        with routing_recorded(r_card):
            card = fn_card(cast, {"tokens": tokens.to(dev)}).cpu()
        flash = dict(FA.launches_by_pass)
        flash_routes = dict(FA.launches_by_route)
        ssd = dict(SS.launches_by_pass)
        ssd_routes = dict(SS.launches_by_route)
        want = attention_layers(cfg) if dev.type == "cuda" else 0
        if flash != {"fwd": want, "bwd": 0}:
            raise AssertionError(f"{name} prefill: flash-attention calls "
                                 f"{flash}, expected {want} forwards")
        want = ssm_layers(cfg) if dev.type == "cuda" else 0
        if ssd != {"fwd": want, "bwd": 0}:
            raise AssertionError(f"{name} prefill: SSD chunk-scan calls "
                                 f"{ssd}, expected {want} forwards")
        fa_routes_check(f"{name} prefill", flash_routes, cfg.compute_dtype)
        ssd_routes_check(f"{name} prefill", ssd_routes, ssd, cfg, s)
        fn_cpu, _ = lm_steps.make_prefill_step(cfg, "cpu", shape)
        with routing_recorded(r_cpu):
            host = fn_cpu(cpu, {"tokens": tokens})
        dec, _ = lm_steps.make_decode_step(
            cfg, dev, ShapeConfig("agree", s, b, "decode"))
        state = T.init_decode_state(cfg, cast, b, s)
        with routing_recorded(r_dec):
            for t in range(s):
                stepped, state = dec(cast, state, tokens[:, t:t + 1].to(dev))
        stepped = stepped.cpu()
        if not hold_decode:
            dec_cpu, _ = lm_steps.make_decode_step(
                cfg, "cpu", ShapeConfig("agree", s, b, "decode"))
            state_cpu = T.init_decode_state(cfg, cpu, b, s)
            for t in range(s):
                own, state_cpu = dec_cpu(cpu, state_cpu, tokens[:, t:t + 1])
            del state_cpu

    def flipped(a_routes, b_routes, per_step: bool):
        """Rows whose tokens route differently in any MoE layer."""
        rows = torch.zeros(b, dtype=torch.bool)
        n_moe = moe_layers(cfg)
        if not n_moe:
            return rows
        for i in range(n_moe):
            a = a_routes[i].reshape(b, s, -1)
            if per_step:       # decode: one (B, k) entry a layer a step
                other = torch.stack([b_routes[t * n_moe + i]
                                     for t in range(s)], dim=1)
            else:
                other = b_routes[i].reshape(b, s, -1)
            rows |= (a != other).any(-1).any(-1)
        return rows

    out = {"arch": name, "layers": layers, "batch": b, "seq": s,
           "compute_dtype": cfg.compute_dtype, "flash_launches": flash,
           "flash_routes": flash_routes, "ssd_launches": ssd,
           "ssd_routes": ssd_routes, "decode_held": hold_decode}
    if not hold_decode:
        out["cpu_own_decode_gap_over_range"] = float(
            (host - own).abs().max()) / float(own.abs().max())
    for label, other, routes, per_step in (("decode", stepped, r_dec, True),
                                           ("cpu", host, r_cpu, False)):
        keep = ~flipped(r_card, routes, per_step)
        held = int(keep.sum())
        if held < MOE_CHECKED_MIN * b:
            raise AssertionError(f"{name} prefill vs {label}: {b - held} of "
                                 f"{b} rows route differently")
        scale = float(other.abs().max())
        gap = float((card[keep] - other[keep]).abs().max()) if held else 0.0
        if not (bool(torch.isfinite(card).all())
                and (gap <= LOGIT_TOL * scale
                     or (label == "decode" and not hold_decode))):
            raise AssertionError(f"{name} prefill (card) vs {label}: max "
                                 f"|gap| {gap} over max |logit| {scale}")
        out[f"{label}_gap_over_range"] = gap / scale
        out[f"{label}_rows_held"] = held
        out[f"{label}_argmax_agree"] = float(
            (card.argmax(-1) == other.argmax(-1)).float().mean())
    out["wall_s"] = time.perf_counter() - t_start
    del cast, state
    torch.cuda.empty_cache()
    return out


def dryrun_check(done: dict, prefill_rows: list, card: str) -> dict:
    """Phase 13d and the launcher half of 13e from :func:`dryrun_collect`'s
    results: each 13a call's device-busy ms at least its cell's H100
    ``compute_s`` (the count walks the code the card ran: a share over
    100% means the FLOP count is wrong), ``memory_s`` printed as the
    unfused upper bound it is; the CLI's (16, 16) cell ``ok`` with its
    roofline terms; ``--production-mesh`` refused with the 256-rank
    message."""
    from repro_torch.configs import ARCHS
    cfg = ARCHS[PREFILL_ARCH]
    rc, so, se, secs = done["cells"]
    if rc != 0:
        raise AssertionError(f"cost_cell: exit {rc}: {se[-3000:]}")
    cells = json.loads(so.strip().splitlines()[-1])
    out = {"cells": [], "cells_s": secs}
    for row, rec in zip(prefill_rows, cells):
        if rec["layers"] not in (None, row["traced_layers"]) or (
                rec["layers"] is None
                and row["traced_layers"] != row["layers"]):
            raise AssertionError(f"cost_cell depth {rec['layers']} against "
                                 f"a trace of {row['traced_layers']}")
        if rec["status"] != "ok" or rec["n_chips"] != 1:
            raise AssertionError(f"cost_cell: {rec}")
        r = rec["roofline"]
        busy_s = row["device_busy_ms"] / 1e3
        share = r["compute_s"] / busy_s
        # the dry run walks every attention block, the masked ones too;
        # the kernel skips those: compute_s less the masked pairs' FLOPs
        b, s = row["batch"], row["seq"]
        masked = row["traced_layers"] * 2.0 * b * cfg.n_heads * (
            s * s - fa_pairs(s, s, True, cfg.sliding_window, 0)) \
            * 2 * cfg.hd
        valid_s = r["compute_s"] - masked / PEAK_BF16_OPS
        out["cells"].append({"batch": row["batch"], "seq": row["seq"],
                             "layers": row["traced_layers"],
                             "flops": rec["cost"]["flops"],
                             "bytes": rec["cost"]["bytes accessed"],
                             "compute_s": r["compute_s"],
                             "compute_s_valid_blocks": valid_s,
                             "memory_s_upper": r["memory_s"],
                             "device_busy_s": busy_s,
                             "compute_over_busy": share,
                             "compute_valid_over_busy": valid_s / busy_s,
                             "live_gib": rec["memory"]["live_gib"],
                             "count_s": rec["compile_s"]})
        log(f"  cost_cell (1, 1) B {row['batch']} x S {row['seq']}, "
            f"{row['traced_layers']} layers: "
            f"{rec['cost']['flops']:.4g} FLOPs, compute_s "
            f"{r['compute_s']:.4f} s = {100 * share:.1f}% of the traced "
            f"call's device-busy {busy_s:.4f} s; memory_s {r['memory_s']:.4f}"
            f" s (an upper bound: unfused bytes); counted in "
            f"{rec['compile_s']} s; from the valid blocks' FLOPs "
            f"{valid_s:.4f} s = {100 * valid_s / busy_s:.1f}% [{card}]")
        if busy_s < r["compute_s"]:
            log(f"  B {row['batch']} S {row['seq']}: device busy {busy_s} s"
                f" < compute_s {r['compute_s']} s, which counts the masked "
                f"attention blocks the kernel skips: held against "
                f"{valid_s} s from the valid blocks")
            if busy_s < valid_s:
                raise AssertionError(f"B {row['batch']} S {row['seq']}: "
                                     f"device busy {busy_s} s < compute_s "
                                     f"{valid_s} s of the valid blocks: the "
                                     f"FLOP count is wrong")
    full = {(r["batch"], r["seq"]): r for r in prefill_rows}
    for rec, (b, s, _, _, layers) in zip(
            cells[len(prefill_rows):],
            [x for x in PREFILL_SHAPES if x[4] is not None]):
        r = rec["roofline"]
        host_s = full[(b, s)]["median_ms"] / 1e3
        out["cells"].append({"batch": b, "seq": s, "layers": None,
                             "flops": rec["cost"]["flops"],
                             "compute_s": r["compute_s"],
                             "memory_s_upper": r["memory_s"],
                             "host_s": host_s,
                             "live_gib": rec["memory"]["live_gib"],
                             "count_s": rec["compile_s"]})
        log(f"  cost_cell (1, 1) B {b} x S {s} at full depth: "
            f"{rec['cost']['flops']:.4g} FLOPs, compute_s "
            f"{r['compute_s']:.4f} s = {100 * r['compute_s'] / host_s:.1f}%"
            f" of the timed call's {host_s:.2f} s (host clock); memory_s "
            f"{r['memory_s']:.4f} s (upper bound); counted in "
            f"{rec['compile_s']} s [{card}]")
    rc, so, se, secs = done["cli"]
    if rc != 0:
        raise AssertionError(f"dryrun CLI {DRYRUN_CLI}: exit {rc}: "
                             f"{se[-3000:]}")
    rec = json.loads((ROOT / "build" / "dryrun.json").read_text())[
        "phi4-mini-3.8b|prefill_32k|1pod"]
    if rec["status"] != "ok" or rec["mesh"] != "16x16":
        raise AssertionError(f"dryrun CLI: {rec}")
    r = rec["roofline"]
    out["cli"] = {"roofline": r, "memory": rec["memory"],
                  "head_sharding": rec["head_sharding"], "wall_s": secs}
    log(f"  dryrun CLI {' '.join(DRYRUN_CLI[:4])} on the fake (16, 16) mesh "
        f"({secs:.1f} s): per chip {r['flops']:.4g} FLOPs, compute "
        f"{r['compute_s']:.4g} s, memory {r['memory_s']:.4g} s (upper "
        f"bound), collective {r['collective_s']:.4g} s, dominant "
        f"{r['dominant']}; live {rec['memory']['live_gib']:.1f} GiB of "
        f"{rec['memory']['hbm_gib']:.1f}")
    rc, so, se, secs = done["serve"]
    if rc == 0 or "256 ranks" not in se:
        raise AssertionError(f"launch.serve --production-mesh: exit {rc}, "
                             f"{se[-2000:]}")
    out["production_mesh_refusal"] = se.strip().splitlines()[-1]
    log(f"  python -m repro_torch.launch.serve --production-mesh: exit {rc}:"
        f" {out['production_mesh_refusal']}")
    return out


def planner_rows() -> list:
    """Phase 13e: ``plan_parallelism`` under the H100 preset at train_4k
    for every arch."""
    from repro_torch.configs import ARCHS, STANDARD_SHAPES
    from repro_torch.core import planner
    rows = []
    for name in sorted(ARCHS):
        plan = planner.plan_parallelism(ARCHS[name],
                                        STANDARD_SHAPES["train_4k"],
                                        planner.H100_POD)
        rows.append({"arch": name, "pp": plan.pp,
                     "est_step_s": plan.est_step_s,
                     "tokens_per_s": plan.tokens_per_s,
                     "stages": [[s.blocks[0], s.blocks[1], s.tp, s.dup]
                                for s in plan.stages]})
        for line in plan.describe().splitlines():
            log(f"  {line}")
    return rows


# ---------------------------------------------------------------------------
# phase 14: the flash-attention kernel
# ---------------------------------------------------------------------------


def needed_share(got, want, rtol: float) -> float:
    """The least rms share ``scale`` with which ``got`` passes
    :func:`scaled_within` ``(got, want, scale, rtol)``."""
    g, w = got.float(), want.float()
    rms = float(w.square().mean().sqrt())
    excess = float(((g - w).abs() - rtol * w.abs()).max())
    return max(excess, 0.0) / rms if rms else float(excess > 0)


def attention_layers(cfg) -> int:
    """Attention sublayers of ``cfg``'s decoder blocks (each launches the
    flash-attention kernel once a forward on the card)."""
    return cfg.n_blocks * cfg.block_pattern.count("A")


def fa_pairs(sq: int, sk: int, causal: bool, window, q_pos0: int) -> int:
    """The (query row, key) pairs of one head that the mask lets through."""
    import numpy as np
    pos = q_pos0 + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = (np.maximum(0, pos - window + 1) if window is not None
          else np.zeros(sq, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def fa_bound(case) -> dict:
    """``{"fwd" | "fwd_bwd": (bound ms, "operations" | "bytes", FLOPs)}``
    of a phase 14 case: FLOPs 2·pairs·(D + Dv) forward and 2·pairs·(3D +
    2Dv) more backward over the valid pairs of every query head, against
    the bf16 tensor-core peak (fp32 inputs: the fp32 peak); bytes q, k, v
    and O once, and dO, dq, dk and dv in the backward, at the HBM rate."""
    _, b, sq, sk, kvh, g, d, dv, causal, window, q_pos0, dt = case
    pairs = b * kvh * g * fa_pairs(sq, sk, causal, window, q_pos0)
    elem = 2 if dt == "bfloat16" else 4
    peak = PEAK_BF16_OPS if dt == "bfloat16" else PEAK_F32_OPS
    f_fwd = 2.0 * pairs * (d + dv)
    f_bwd = 2.0 * pairs * (3 * d + 2 * dv)
    io = elem * (b * sq * kvh * g * (d + dv) + b * sk * kvh * (d + dv))
    out = {}
    for name, f, n_bytes in (("fwd", f_fwd, io),
                             ("fwd_bwd", f_fwd + f_bwd, 2 * io)):
        t_o, t_b = f / peak, n_bytes / PEAK_BYTES
        out[name] = (1e3 * max(t_o, t_b),
                     "operations" if t_o >= t_b else "bytes", f)
    return out


def fa_fp32_reference(q, k, v, do, causal: bool, window, q_pos0: int):
    """``(O, lse, dq, dk, dv)`` of the plain masked softmax attention on
    fp32 upcasts of the inputs, the gradients by autograd, a chunk of
    query rows at a time (at most ``FA_REF_SCORES`` scores; each chunk's
    keys cut to those its rows may see, the rest weighing exactly 0)."""
    import torch
    b, sq, kvh, g, d = q.shape
    sk = k.shape[1]
    kf, vf = (t.detach().to(torch.float32, copy=True).requires_grad_()
              for t in (k, v))
    rows = max(64, int(FA_REF_SCORES // (b * kvh * g * sk)) // 64 * 64)
    outs, lses, dqs = [], [], []
    for r0 in range(0, sq, rows):
        r1 = min(sq, r0 + rows)
        p0, p1 = q_pos0 + r0, q_pos0 + r1 - 1
        k0 = max(0, p0 - window + 1) if window is not None else 0
        k1 = min(sk, p1 + 1) if causal else sk
        qc = q[:, r0:r1].detach().to(torch.float32,
                                     copy=True).requires_grad_()
        s = torch.einsum("bqkgd,bskd->bkgqs", qc, kf[:, k0:k1]) \
            / math.sqrt(d)
        qi = torch.arange(p0, p1 + 1, device=q.device)[:, None]
        ki = torch.arange(k0, k1, device=q.device)[None, :]
        ok = torch.ones((r1 - r0, k1 - k0), dtype=torch.bool,
                        device=q.device)
        if causal:
            ok &= ki <= qi
        if window is not None:
            ok &= ki > qi - window
        s = s.masked_fill(~ok, -math.inf)
        lses.append(torch.logsumexp(s, -1).detach())
        o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1),
                         vf[:, k0:k1])
        o.backward(do[:, r0:r1].float())
        outs.append(o.detach())
        dqs.append(qc.grad)
        del s, o
    return (torch.cat(outs, 1), torch.cat(lses, -1), torch.cat(dqs, 1),
            kf.grad, vf.grad)


def fa_before(q, k, v, causal: bool, window, q_pos0: int):
    """The card's attention core before the kernel, in the reference's
    dtypes: ``_gqa_scores_ctx`` up to ``FLASH_THRESHOLD`` keys, the
    blockwise loop above."""
    from types import SimpleNamespace
    from repro_torch.models import layers as L
    mfn = L._mask_fn(SimpleNamespace(sliding_window=window), causal)
    if k.shape[1] > L.FLASH_THRESHOLD:
        return L.flash_attention(q, k, v, mfn, q_pos0)
    return L._gqa_scores_ctx(q, k, v, mfn, q_pos0)


def once_ms(fn, device) -> float:
    """ms of one call of ``fn()`` after a warm-up call: CUDA events on
    the card (a plain version's many launches issued from Python), the
    host clock on the CPU (a rehearsal only)."""
    if str(device).startswith("cuda"):
        return cuda_ms(fn, 1)
    fn()
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def fa_sdpa(q, k, v, do, causal: bool):
    """``(forward, forward + backward)`` closures of
    ``scaled_dot_product_attention(..., is_causal=causal, enable_gqa=True)``
    under its flash backend on the same tensors as (B, H, S, D) views, and
    its output in the kernel's layout; ``None`` where the backend refuses
    them."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    b, sq, kvh, g, d = q.shape
    qh = q.reshape(b, sq, kvh * g, d).transpose(1, 2)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    doh = do.reshape(b, sq, kvh * g, -1).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]

    def fwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal,
                                                  enable_gqa=True)

    def fwd_bwd():
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                                 enable_gqa=True)
        out.backward(doh)

    try:
        out = fwd()
        fwd_bwd()
    except RuntimeError:
        return None
    return fwd, fwd_bwd, out.transpose(1, 2).reshape(b, sq, kvh, g, -1)


def fa_inputs(case, gen, device) -> tuple:
    """q, k, v and O's gradient of a phase 14 case, normal draws from
    ``gen``; an MLA case's v is the value half of wider rows (as
    ``_mla_expand`` slices it from ``wkv_b``'s output)."""
    import torch
    _, b, sq, sk, kvh, g, d, dv, _, _, _, dt = case
    dtype = getattr(torch, dt)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    q = draw(b, sq, kvh, g, d)
    k = draw(b, sk, kvh, d)
    v = draw(b, sk, kvh, dv) if dv == d else \
        draw(b, sk, kvh, d - 64 + dv)[..., d - 64:]
    return q, k, v, draw(b, sq, kvh, g, dv)


def graph_replay_check(label: str, other_label: str, step, other_step,
                       failures) -> dict:
    """``step()`` (a forward and backward, returning its outputs) captured
    in one CUDA graph and replayed 3 times: each replay equal, bit for
    bit, to an eager call (the kernels are deterministic: no floating
    atomics); before the last replay ``other_step()``, an eager call of
    another shape."""
    import torch
    eager = step()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = step()
    same = []
    for r in range(3):
        if r == 2:
            other_step()
        graph.replay()
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, e) for a, e in zip(outs, eager)))
    del graph
    if not all(same):
        failures.append(f"graph check: replays equal to eager {same}")
    log(f"  {label}: forward + backward captured in one CUDA graph: 3 "
        f"replays equal to eager calls, the last after a {other_label} "
        f"call: {same}")
    return {"case": label, "other": other_label, "replays_equal": same}


def fa_graph_check(case, other, gen, device, failures) -> dict:
    """:func:`graph_replay_check` of ``case``'s flash-attention forward
    and backward, ``other``'s shape called before the last replay."""
    from repro_torch.kernels import flash_attention as FA

    def fwd_bwd(c):
        q, k, v, do = fa_inputs(c, gen, device)
        causal, window, q_pos0 = c[8:11]

        def step():
            o, lse = FA.flash_attention_fwd_cuda(q, k, v, causal, window,
                                                 q_pos0)
            return (o, lse) + FA.flash_attention_bwd_cuda(
                q, k, v, o, lse, do, causal, window, q_pos0)
        return step

    return graph_replay_check(case[0], other[0], fwd_bwd(case),
                              lambda: fwd_bwd(other)(), failures)


def fa_ms(fn, device) -> float:
    """Device ms of ``fn()`` on CUDA: ``FA_GRAPH_REPS`` calls in one CUDA
    graph (:func:`graph_ms`); the host's mean on the CPU (a rehearsal)."""
    if str(device).startswith("cuda"):
        return graph_ms(fn, FA_GRAPH_REPS)
    return dev_ms(fn, device)


def fa_redesign_checks(rows) -> dict:
    """The checks the sm90 route is held to at ``FA_REDESIGN`` (each
    ``(value, met)``): its forward faster than SDPA's, its forward +
    backward at least ``FA_REDESIGN_GAIN`` times faster than the mma
    route's in the same call; logged, not raised."""
    out = {}
    for r in rows:
        if r["case"] not in FA_REDESIGN or "mma_ms" not in r:
            continue
        if r["library_fwd_ms"] is not None:
            out[f"{r['case']} fwd, SDPA over sm90"] = (
                r["library_fwd_ms"] / r["fwd_ms"],
                r["fwd_ms"] < r["library_fwd_ms"])
        gain = r["mma_ms"] / r["ms"]
        out[f"{r['case']} fwd + bwd, mma route over sm90"] = (
            gain, gain >= FA_REDESIGN_GAIN)
    for k, (v, met) in out.items():
        log(f"  {k}: {v:.3f} ({'met' if met else 'MISSED'})")
    return {k: {"value": v, "met": met} for k, (v, met) in out.items()}


def flash_phase(device, seed: int = 0, cases=FA_CASES) -> dict:
    """Phase 14: the flash-attention kernel against its plain versions at
    ``cases``: O within ``FA_TOL_F32`` of the plain masked softmax on fp32
    upcasts and ``FA_TOL_REF`` of the card's path before the kernel in
    the reference's dtypes, lse within ``FA_TOL_LSE``, dq, dk and dv within
    ``FA_TOL_GRAD`` of autograd of the fp32 plain version; planted faults
    refused at ``FA_FAULT_MIN_S`` rows and up; a graph-replay check; each
    case timed by CUDA-graph replay (forward, forward + backward; a bf16
    case on the ``sm90`` and ``mma`` routes in turns) beside its bound,
    the plain versions (:func:`flash_attention_fwd_ref` and
    ``_bwd_ref`` at the reference's blocks; the path before the kernel)
    and SDPA's flash backend where it takes the case.  Launches made here
    compare; they are not counted.  On the CPU (a rehearsal) the plain
    versions stand in for the kernel."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    dev = torch.device(device)
    card = dev.type == "cuda"
    gen = torch.Generator(dev).manual_seed(seed)
    rows, failures = [], []
    t_phase = time.perf_counter()
    for case in cases:
        label, b, sq, sk, kvh, g, d, dv, causal, window, q_pos0, dt = case
        t0 = time.perf_counter()
        q, k, v, do = fa_inputs(case, gen, dev)

        # the planned route (sm90 for bf16, mma for fp32) unless `rt`
        planned = FA.route(getattr(torch, dt), d, dv)

        def fwd(qp=q_pos0, win=window, rt=None):
            if card:
                return FA.flash_attention_fwd_cuda(q, k, v, causal, win, qp,
                                                   route=rt)
            return FA.flash_attention_fwd_ref(q, k, v, causal, win, qp)

        def fwd_bwd(rt=None):
            if card:
                return FA.flash_attention_bwd_cuda(
                    q, k, v, *fwd(rt=rt), do, causal, window, q_pos0,
                    route=rt)
            return FA.flash_attention_bwd_ref(q, k, v, *fwd(), do, causal,
                                              window, q_pos0)

        t_first = time.perf_counter()
        o, lse = fwd()
        grads = FA.flash_attention_bwd_cuda(
            q, k, v, o, lse, do, causal, window, q_pos0) if card else \
            FA.flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window,
                                       q_pos0)
        if card:
            torch.cuda.synchronize(dev)
        t_first = time.perf_counter() - t_first
        o32, lse32, *g32 = fa_fp32_reference(q, k, v, do, causal, window,
                                             q_pos0)
        before = fa_before(q, k, v, causal, window, q_pos0)
        # each check's least passing rms share (at its rtol) beside its
        # limit
        err, rel, ok32 = scaled_within(o, o32, *FA_TOL_F32[dt])
        need = needed_share(o, o32, FA_TOL_F32[dt][1])
        err_ref, rel_ref, ok_ref = scaled_within(o, before, *FA_TOL_REF[dt])
        need_ref = needed_share(o, before, FA_TOL_REF[dt][1])
        lse_err, ok_lse = within(lse, lse32, *FA_TOL_LSE)
        g_plain = FA.flash_attention_bwd_ref(q, k, v, o, lse, do, causal,
                                             window, q_pos0,
                                             *FA_PLAIN_BLOCKS)
        grad, grad_plain = {}, {}
        for name, got, want, want_p in zip(("dq", "dk", "dv"), grads, g32,
                                           g_plain):
            _, _, g_ok = scaled_within(got, want, *FA_TOL_GRAD[dt])
            _, _, p_ok = scaled_within(got, want_p, *FA_TOL_GRAD_PLAIN[dt])
            grad[name] = needed_share(got, want, FA_TOL_GRAD[dt][1])
            grad_plain[name] = needed_share(got, want_p,
                                            FA_TOL_GRAD_PLAIN[dt][1])
            if not (g_ok and p_ok):
                failures.append(f"{label}: {name} needs an rms share of "
                                f"{grad[name]:.3g} (fp32 autograd), "
                                f"{grad_plain[name]:.3g} (plain backward)")
        del g_plain
        if not (ok32 and ok_ref and ok_lse):
            failures.append(f"{label}: O needs an rms share of {need:.3g} "
                            f"(fp32 plain), {need_ref:.3g} (plain, reference "
                            f"dtypes); lse |err| {lse_err:.3g}")
        faults = {}
        if sq >= FA_FAULT_MIN_S:
            planted = []
            if causal:        # each row's last block of keys dropped
                planted.append(("last keys dropped", q_pos0 - FA.BLOCK_K,
                                window))
            if window is not None:
                planted.append(("window one block short", q_pos0,
                                window - FA.BLOCK_K))
            for name, qp, win in planted:
                bad, _ = fwd(qp, win)
                _, _, passes = scaled_within(bad, o32, *FA_TOL_F32[dt])
                faults[name] = needed_share(bad, o32, FA_TOL_F32[dt][1])
                if passes:
                    failures.append(f"{label}: planted fault ({name}) "
                                    f"passes, rms share {faults[name]:.3g}")
                del bad
        del o32, lse32, g32, before, grads
        bounds = fa_bound(case)
        row = {"case": label, "B": b, "Sq": sq, "Sk": sk, "KV": kvh, "G": g,
               "D": d, "Dv": dv, "causal": causal, "window": window,
               "q_pos0": q_pos0, "dtype": dt,
               "pairs": b * kvh * g * fa_pairs(sq, sk, causal, window,
                                               q_pos0),
               "max_abs_err": err, "err_over_rms": rel,
               "max_abs_err_ref": err_ref, "err_ref_over_rms": rel_ref,
               "share_needed": need, "share_needed_ref": need_ref,
               "lse_err": lse_err, "grad_share_needed": grad,
               "grad_share_needed_plain": grad_plain,
               "fault_share_needed": faults, "first_call_s": t_first,
               "route": planned,
               "fwd_bound_ms": bounds["fwd"][0],
               "fwd_bound_by": bounds["fwd"][1],
               "bound_ms": bounds["fwd_bwd"][0],
               "bound_by": bounds["fwd_bwd"][1],
               "flops": bounds["fwd_bwd"][2],
               "plain_fwd_ms": once_ms(lambda: FA.flash_attention_fwd_ref(
                   q, k, v, causal, window, q_pos0, *FA_PLAIN_BLOCKS), dev),
               "plain_ms": once_ms(lambda: FA.flash_attention_bwd_ref(
                   q, k, v, *FA.flash_attention_fwd_ref(
                       q, k, v, causal, window, q_pos0, *FA_PLAIN_BLOCKS),
                   do, causal, window, q_pos0, *FA_PLAIN_BLOCKS), dev),
               "before_fwd_ms": once_ms(lambda: fa_before(
                   q, k, v, causal, window, q_pos0), dev),
               "library_fwd_ms": None, "library_ms": None}
        # the planned route timed in turns with the mma route (bf16)
        turns = ("mma", "sm90", "sm90", "mma") if planned == "sm90" \
            else (planned,)
        times = {rt: ([], []) for rt in turns}
        for rt in turns:
            times[rt][0].append(fa_ms(lambda: fwd(rt=rt), dev))
            times[rt][1].append(fa_ms(lambda: fwd_bwd(rt), dev))
        for rt, (tf, tb) in times.items():
            pre = "" if rt == planned else f"{rt}_"
            row[pre + "fwd_ms"] = sum(tf) / len(tf)
            row[pre + "ms"] = sum(tb) / len(tb)
            row[pre + "fwd_ms_runs"], row[pre + "ms_runs"] = tf, tb
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        row["fwd_share_of_bound"] = row["fwd_bound_ms"] / row["fwd_ms"]
        if "mma_ms" in row:
            row["mma_share_of_bound"] = row["bound_ms"] / row["mma_ms"]
            row["mma_fwd_share_of_bound"] = (row["fwd_bound_ms"]
                                             / row["mma_fwd_ms"])
        lib = (fa_sdpa(q, k, v, do, causal) if card and window is None
               and q_pos0 == 0 and d == dv and dt == "bfloat16" else None)
        if lib is not None:
            _, l_rel, l_ok = scaled_within(lib[2], o, *FA_TOL_REF[dt])
            if not l_ok:
                failures.append(f"{label}: SDPA disagrees with the kernel, "
                                f"{l_rel:.3g}")
            row["library_fwd_ms"] = cuda_ms(lib[0], FA_REPS)
            row["library_ms"] = cuda_ms(lib[1], FA_REPS)
            del lib
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        lib_s = ("none" if row["library_ms"] is None else
                 f"{row['library_fwd_ms']:.3f} / {row['library_ms']:.3f}")
        mma_s = ("" if "mma_ms" not in row else
                 f"; mma route {row['mma_fwd_ms']:.3f} / "
                 f"{row['mma_ms']:.3f} ms "
                 f"({100 * row['mma_share_of_bound']:.1f}%)")
        fault_s = "".join(f", planted fault ({k_}) {v_:.3g}"
                          for k_, v_ in faults.items())
        log(f"  flash attention {label} ({dt}): rms shares needed: O "
            f"{need:.3g} (fp32 plain), {need_ref:.3g} (reference dtypes), "
            f"dq {grad['dq']:.3g}, dk {grad['dk']:.3g}, dv {grad['dv']:.3g}"
            f" (fp32 autograd), dq {grad_plain['dq']:.3g}, dk "
            f"{grad_plain['dk']:.3g}, dv {grad_plain['dv']:.3g} (plain "
            f"backward); lse |err| {lse_err:.2e}{fault_s}; max |err| / rms "
            f"O {rel:.3g}"
            f"; first call {t_first:.2f} s; "
            f"{planned} route fwd {row['fwd_ms']:.3f} ms, fwd+bwd "
            f"{row['ms']:.3f} ms (bound {row['fwd_bound_ms']:.3f} / "
            f"{row['bound_ms']:.3f} ms, {row['bound_by']}; "
            f"{100 * row['share_of_bound']:.1f}%){mma_s}; plain "
            f"{row['plain_fwd_ms']:.1f} / {row['plain_ms']:.1f} ms, before "
            f"{row['before_fwd_ms']:.1f} ms; SDPA {lib_s} ms; "
            f"{row['wall_s']:.1f} s")
        del q, k, v, do, o, lse
        if card:
            torch.cuda.empty_cache()
    out = {"rows": rows}
    if card:
        main = next(c for c in cases if c[0] == FA_MAIN)
        other = next(c for c in cases if c[0] != FA_MAIN
                     and c[11] == main[11] and c[2] <= main[2])
        out["graph"] = fa_graph_check(main, other, gen, dev, failures)
        out["redesign"] = fa_redesign_checks(rows)
    if failures:
        raise AssertionError("flash attention: " + "; ".join(failures))
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 15: the SSD chunk-scan kernel
# ---------------------------------------------------------------------------


def ssm_layers(cfg) -> int:
    """Mamba-2 sublayers of ``cfg``'s decoder blocks (each runs the SSD
    chunk scan once a forward)."""
    return cfg.n_blocks * cfg.block_pattern.count("M")


def ssd_bound(case) -> dict:
    """``{"fwd" | "fwd_bwd": (bound ms, "operations" | "bytes", FLOPs)}``
    of a phase 15 case, with T = Q (Q + 1) / 2 the causal pairs of a
    chunk: FLOPs 2·B·nc·(g·N·T + nh·hp·T + 2·nh·Q·N·hp) forward (C B^T,
    W x, the chunk states, y_off) and 2·B·nc·(g·N·T + 2·nh·hp·T +
    2·nh·N·T + 4·nh·Q·N·hp) more backward (C B^T, dy x^T, W^T dy, the two
    dS products, and G, B D, x D^T, dy H^T), against the bf16 tensor-core
    peak (fp32 inputs: the fp32 peak); bytes x, B, C, dt read and y
    written forward, and dy read, dx, dB, dC, ddt written in the
    backward, at the HBM rate (x, B and C are read where they lie: no
    copy)."""
    _, b, S, nh, hp, g, n, Q, dt = case
    nc, T = S // Q, Q * (Q + 1) / 2
    elem = 2 if dt == "bfloat16" else 4
    peak = PEAK_BF16_OPS if dt == "bfloat16" else PEAK_F32_OPS
    f_fwd = 2.0 * b * nc * (g * n * T + nh * hp * T + 2 * nh * Q * n * hp)
    f_bwd = 2.0 * b * nc * (g * n * T + 2 * nh * hp * T + 2 * nh * n * T
                            + 4 * nh * Q * n * hp)
    io = elem * (2 * b * S * nh * hp + 2 * b * S * g * n) + 4 * b * S * nh
    out = {}
    for name, f, n_bytes in (("fwd", f_fwd, io),
                             ("fwd_bwd", f_fwd + f_bwd, 2 * io)):
        t_o, t_b = f / peak, n_bytes / PEAK_BYTES
        out[name] = (1e3 * max(t_o, t_b),
                     "operations" if t_o >= t_b else "bytes", f)
    return out


def ssd_inputs(case, gen, device) -> tuple:
    """x, dt, A, B, C and y's gradient of a phase 15 case: x, B and C
    views of one conv row (as the layer splits them), normal draws; dt a
    softplus of normal draws less 2; A = -linspace(1, 16, nh), the layer's
    initial A_log range."""
    import torch
    _, b, S, nh, hp, g, n, _, dt_name = case
    dtype = getattr(torch, dt_name)
    xbc = torch.randn((b, S, nh * hp + 2 * g * n), generator=gen,
                      device=device).to(dtype)
    x = xbc[..., :nh * hp].reshape(b, S, nh, hp)
    B = xbc[..., nh * hp:nh * hp + g * n].reshape(b, S, g, n)
    C = xbc[..., nh * hp + g * n:].reshape(b, S, g, n)
    dt = torch.nn.functional.softplus(
        torch.randn((b, S, nh), generator=gen, device=device) - 2.0)
    A = -torch.linspace(1.0, 16.0, nh, device=device)
    dy = torch.randn((b, S, nh, hp), generator=gen, device=device).to(dtype)
    return x, dt, A, B, C, dy


def ssd_calls(card: bool):
    """``(fwd, bwd)``: the kernel's entry points on the card (``route=``
    picks the route); on the CPU (a rehearsal) the plain versions in their
    place, whatever the route."""
    from repro_torch.kernels import ssd_scan as K
    if card:
        return K.ssd_chunk_scan_fwd_cuda, K.ssd_chunk_scan_bwd_cuda

    def fwd(x, dt, A, B, C, chunk, plant=0, route=None):
        return (K.ssd_chunk_scan_ref(x, dt, A, B, C, chunk),
                *K.ssd_chunk_states_ref(x, dt, A, B, C, chunk))

    def bwd(dy, x, dt, A, B, C, cum, state, chunk, route=None):
        return K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, chunk)

    return fwd, bwd


def ssd_plain(x, dt, A, B, C, chunk, dy=None, upcast=False):
    """The plain forward (``ssd_chunk_scan_ref``; on fp32 upcasts when
    ``upcast``), and with ``dy`` its gradients by autograd: ``(y, [dx,
    ddt, dA, dB, dC])``."""
    import torch
    from repro_torch.kernels import ssd_scan as K
    ins = [t.detach().float() if upcast else t.detach()
           for t in (x, dt, A, B, C)]
    if dy is None:
        with torch.no_grad():
            return K.ssd_chunk_scan_ref(*ins, chunk), None
    leaves = [t.clone().requires_grad_() for t in ins]
    y = K.ssd_chunk_scan_ref(*leaves, chunk)
    y.backward(dy.float() if upcast else dy)
    return y.detach(), [t.grad for t in leaves]


def ssd_graph_check(case, other, gen, device, failures) -> dict:
    """:func:`graph_replay_check` of ``case``'s SSD chunk-scan forward and
    backward, ``other``'s shape called before the last replay."""
    from repro_torch.kernels import ssd_scan as K

    def fwd_bwd(c):
        x, dt, A, B, C, dy = ssd_inputs(c, gen, device)

        def step():
            y, cum, st = K.ssd_chunk_scan_fwd_cuda(x, dt, A, B, C, c[7])
            return (y,) + K.ssd_chunk_scan_bwd_cuda(dy, x, dt, A, B, C, cum,
                                                    st, c[7])
        return step

    return graph_replay_check(case[0], other[0], fwd_bwd(case),
                              lambda: fwd_bwd(other)(), failures)


def ssd_ms(fn, card: bool, device) -> float:
    """Device ms of ``fn()`` by CUDA-graph replay (``SSD_GRAPH_REPS``
    calls a graph); the host's mean on the CPU (a rehearsal)."""
    return graph_ms(fn, SSD_GRAPH_REPS) if card else dev_ms(fn, device)


def ssd_route_checks(label, rt, dt_name, Q, S, x, dt, A, B, C, dy, y32, g32,
                     before, fwd_call, bwd_call, card, failures) -> dict:
    """One route's checks of a phase 15 case: y within ``SSD_TOL_F32`` of
    the fp32 plain forward and ``SSD_TOL_REF`` of the plain one in the
    reference's dtypes, the gradients within ``SSD_TOL_GRAD`` of autograd
    of the fp32 plain version and ``SSD_TOL_GRAD_PLAIN`` of
    ``ssd_chunk_scan_bwd_ref``, the planted faults refused (more than one
    chunk, on the card); each check's least passing rms share."""
    import torch
    from repro_torch.kernels import ssd_scan as K
    names = ("dx", "ddt", "dA", "dB", "dC")
    t_first = time.perf_counter()
    y, cum, st = fwd_call(x, dt, A, B, C, Q, route=rt)
    grads = bwd_call(dy, x, dt, A, B, C, cum, st, Q, route=rt)
    if card:
        torch.cuda.synchronize()
    t_first = time.perf_counter() - t_first
    err, rel, ok32 = scaled_within(y, y32, *SSD_TOL_F32[dt_name])
    need = needed_share(y, y32, SSD_TOL_F32[dt_name][1])
    _, rel_ref, ok_ref = scaled_within(y, before, *SSD_TOL_REF[dt_name])
    need_ref = needed_share(y, before, SSD_TOL_REF[dt_name][1])
    if not (ok32 and ok_ref):
        failures.append(f"{label} ({rt}): y needs an rms share of {need:.3g} "
                        f"(fp32 plain), {need_ref:.3g} (plain, reference "
                        f"dtypes)")
    g_plain = K.ssd_chunk_scan_bwd_ref(dy, x, dt, A, B, C, Q)
    grad, grad_plain = {}, {}
    for name, got, want, want_p in zip(names, grads, g32, g_plain):
        _, _, g_ok = scaled_within(got, want, *SSD_TOL_GRAD[dt_name])
        _, _, p_ok = scaled_within(got, want_p, *SSD_TOL_GRAD_PLAIN[dt_name])
        grad[name] = needed_share(got, want, SSD_TOL_GRAD[dt_name][1])
        grad_plain[name] = needed_share(got, want_p,
                                        SSD_TOL_GRAD_PLAIN[dt_name][1])
        if not (g_ok and p_ok):
            failures.append(f"{label} ({rt}): {name} needs an rms share of "
                            f"{grad[name]:.3g} (fp32 autograd), "
                            f"{grad_plain[name]:.3g} (plain backward)")
    del g_plain, grads
    faults = {}
    if card and S > Q:
        for fname, bit in (("state dropped", K.PLANT_STATE),
                           ("diagonal dropped", K.PLANT_DIAG)):
            bad, _, _ = fwd_call(x, dt, A, B, C, Q, plant=bit, route=rt)
            _, _, passes = scaled_within(bad, y32, *SSD_TOL_F32[dt_name])
            faults[fname] = needed_share(bad, y32, SSD_TOL_F32[dt_name][1])
            if passes:
                failures.append(f"{label} ({rt}): planted fault ({fname}) "
                                f"passes, rms share {faults[fname]:.3g}")
            del bad
    return {"max_abs_err": err, "err_over_rms": rel,
            "err_ref_over_rms": rel_ref, "share_needed": need,
            "share_needed_ref": need_ref, "grad_share_needed": grad,
            "grad_share_needed_plain": grad_plain,
            "fault_share_needed": faults, "first_call_s": t_first}


def ssd_redesign_checks(rows) -> dict:
    """The checks the sm90 route is held to (each ``(value, met)``):
    at ``SSD_SCAN_MAIN`` its forward + backward at least
    ``SSD_REDESIGN_GAIN`` times faster than the mma route's in the same
    call and its forward faster; at every bf16 case neither pass slower
    than the mma route's; logged, not raised."""
    out = {}
    for r in rows:
        if "mma_ms" not in r:
            continue
        gain, fgain = r["mma_ms"] / r["ms"], r["mma_fwd_ms"] / r["fwd_ms"]
        if r["case"] == SSD_SCAN_MAIN:
            out[f"{r['case']} fwd + bwd, mma route over sm90"] = (
                gain, gain >= SSD_REDESIGN_GAIN)
            out[f"{r['case']} fwd, mma route over sm90"] = (fgain,
                                                           fgain > 1.0)
        else:
            out[f"{r['case']} fwd + bwd and fwd, mma route over sm90 (the "
                f"lesser)"] = (min(gain, fgain), min(gain, fgain) >= 1.0)
    for k, (v, met) in out.items():
        log(f"  {k}: {v:.3f} ({'met' if met else 'MISSED'})")
    return {k: {"value": v, "met": met} for k, (v, met) in out.items()}


def ssd_phase(device, seed: int = 0, cases=SSD_SCAN_CASES) -> dict:
    """Phase 15: the SSD chunk-scan kernel against its plain versions at
    ``cases``, on the route :func:`ssd_scan.route` plans and, for a bf16
    case planned on ``sm90``, on the ``mma`` route too (``route=``), each
    held to the same limits (:func:`ssd_route_checks`); a graph-replay
    check on the planned route; each case's forward and forward + backward
    timed by CUDA-graph replay (a bf16 case on the two routes in turns:
    mma, sm90, sm90, mma) beside its bound and the plain version (the
    card's path before the kernel: ``ssd_chunk_scan_ref`` in the
    reference's dtypes under autograd; no PyTorch call computes the scan);
    the sm90 route's checks logged met / MISSED
    (:func:`ssd_redesign_checks`).  Launches made here compare; they are
    not counted.  On the CPU (a rehearsal) the plain versions stand in for
    the kernel on both routes."""
    import torch
    from repro_torch.kernels import ssd_scan as K
    dev = torch.device(device)
    card = dev.type == "cuda"
    fwd_call, bwd_call = ssd_calls(card)
    gen = torch.Generator(dev).manual_seed(seed)
    rows, failures = [], []
    t_phase = time.perf_counter()
    names = ("dx", "ddt", "dA", "dB", "dC")
    for case in cases:
        label, b, S, nh, hp, g, n, Q, dt_name = case
        t0 = time.perf_counter()
        x, dt, A, B, C, dy = ssd_inputs(case, gen, dev)
        planned = K.route(getattr(torch, dt_name), K.chunk_len(S, Q), n, hp)
        routes = (planned, "mma") if planned == "sm90" else (planned,)
        y32, g32 = ssd_plain(x, dt, A, B, C, Q, dy, upcast=True)
        before, _ = ssd_plain(x, dt, A, B, C, Q)
        row = {"case": label, "B": b, "S": S, "nh": nh, "hp": hp, "g": g,
               "N": n, "Q": Q, "dtype": dt_name, "chunks": S // Q,
               "route": planned}
        for rt in routes:
            got = ssd_route_checks(label, rt, dt_name, Q, S, x, dt, A, B, C,
                                   dy, y32, g32, before, fwd_call, bwd_call,
                                   card, failures)
            pre = "" if rt == planned else f"{rt}_"
            row.update({pre + k: v for k, v in got.items()})
        del y32, g32, before
        bounds = ssd_bound(case)

        def fwd(rt=None):
            return fwd_call(x, dt, A, B, C, Q, route=rt)

        def fwd_bwd(rt=None):
            y_, cum_, st_ = fwd(rt)
            return bwd_call(dy, x, dt, A, B, C, cum_, st_, Q, route=rt)

        def plain_fwd_bwd():
            ssd_plain(x, dt, A, B, C, Q, dy)

        row.update({
            "fwd_bound_ms": bounds["fwd"][0], "fwd_bound_by": bounds["fwd"][1],
            "bound_ms": bounds["fwd_bwd"][0], "bound_by": bounds["fwd_bwd"][1],
            "flops": bounds["fwd_bwd"][2],
            "plain_fwd_ms": once_ms(lambda: ssd_plain(x, dt, A, B, C, Q), dev),
            "plain_ms": once_ms(plain_fwd_bwd, dev), "library_ms": None})
        # the planned route timed in turns with the mma route (bf16 on sm90)
        turns = ("mma", "sm90", "sm90", "mma") if planned == "sm90" \
            else (planned,)
        times = {rt: ([], []) for rt in turns}
        for rt in turns:
            times[rt][0].append(ssd_ms(lambda: fwd(rt), card, dev))
            times[rt][1].append(ssd_ms(lambda: fwd_bwd(rt), card, dev))
        for rt, (tf, tb) in times.items():
            pre = "" if rt == planned else f"{rt}_"
            row[pre + "fwd_ms"] = sum(tf) / len(tf)
            row[pre + "ms"] = sum(tb) / len(tb)
            row[pre + "fwd_ms_runs"], row[pre + "ms_runs"] = tf, tb
            row[pre + "share_of_bound"] = row["bound_ms"] / row[pre + "ms"]
            row[pre + "fwd_share_of_bound"] = (row["fwd_bound_ms"]
                                               / row[pre + "fwd_ms"])
        row["wall_s"] = time.perf_counter() - t0
        rows.append(row)
        for rt in routes:
            pre = "" if rt == planned else f"{rt}_"
            grad, grad_p = (row[pre + "grad_share_needed"],
                            row[pre + "grad_share_needed_plain"])
            fault_s = "".join(f", planted fault ({k_}) {v_:.3g}" for k_, v_
                              in row[pre + "fault_share_needed"].items())
            log(f"  ssd chunk scan {label} ({dt_name}, {S // Q} chunks, {rt}"
                f" route): rms shares needed: y "
                f"{row[pre + 'share_needed']:.3g} (fp32 plain), "
                f"{row[pre + 'share_needed_ref']:.3g} (reference dtypes), "
                + ", ".join(f"{k_} {grad[k_]:.3g}" for k_ in names)
                + " (fp32 autograd), "
                + ", ".join(f"{k_} {grad_p[k_]:.3g}" for k_ in names)
                + f" (plain backward){fault_s}; first call "
                f"{row[pre + 'first_call_s']:.2f} s; fwd "
                f"{row[pre + 'fwd_ms']:.3f} ms, fwd+bwd {row[pre + 'ms']:.3f}"
                f" ms (bound {row['fwd_bound_ms']:.4f} / "
                f"{row['bound_ms']:.4f} ms, {row['bound_by']}; "
                f"{100 * row[pre + 'fwd_share_of_bound']:.1f}% / "
                f"{100 * row[pre + 'share_of_bound']:.1f}%)")
        log(f"    plain {row['plain_fwd_ms']:.2f} / {row['plain_ms']:.2f} ms;"
            f" library none; {row['wall_s']:.1f} s")
        del x, dt, A, B, C, dy
        if card:
            torch.cuda.empty_cache()
    out = {"rows": rows}
    if card:
        main = next(c for c in cases if c[0] == SSD_SCAN_MAIN)
        other = next(c for c in cases if c[0] != SSD_SCAN_MAIN
                     and c[8] == main[8] and c[2] <= main[2])
        out["graph"] = ssd_graph_check(main, other, gen, dev, failures)
    out["redesign"] = ssd_redesign_checks(rows)
    if failures:
        raise AssertionError("ssd chunk scan: " + "; ".join(failures))
    out["wall_s"] = time.perf_counter() - t_phase
    return out


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
    from repro_torch.kernels import grouped_gemm as GG
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SS
    with ThreadPoolExecutor(8) as pool:
        built = [pool.submit(bsm.build_library), pool.submit(DA.build_library),
                 pool.submit(I8.build_library), pool.submit(GG.build_library),
                 pool.submit(GG.build_sm90_library),
                 pool.submit(FA.build_library),
                 pool.submit(FA.build_library, FA.SOURCE_SM90),
                 pool.submit(SS.build_library),
                 pool.submit(SS.build_library, SS.SOURCE_SM90)]
        report["triton_build_s"] = build_triton_kernels(dev) \
            + build_train_kernels(dev)
        libs = [f.result() for f in built]
    report["build_s"] = time.perf_counter() - t0
    log(f"build: {', '.join(lib.name for lib in libs)} and the Triton SSD "
        f"step, cross-entropy and AdamW kernels in {report['build_s']:.2f} s"
        f" (Triton "
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

    # 12. the grouped expert GEMM, before the phases that run it ------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("phase 12: the grouped expert GEMM against its plain version; "
        "moe_ep with no host sync")
    report["grouped_gemm"] = grouped_gemm_phase(dev, args.seed)
    report["grouped_gemm"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log(f"grouped GEMM phase done in {report['grouped_gemm']['wall_s']:.1f} "
        f"s [{card}]")

    # 14. the flash-attention kernel, before the phases that run it ---------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("phase 14: the flash-attention kernel against its plain versions")
    report["flash"] = flash_phase(dev, args.seed)
    log(f"flash-attention phase done in {report['flash']['wall_s']:.1f} s "
        f"[{card}]")

    # 15. the SSD chunk-scan kernel, before the phases that run it ----------
    torch.cuda.empty_cache()
    log("phase 15: the SSD chunk-scan kernel against its plain versions")
    report["ssd_scan"] = ssd_phase(dev, args.seed)
    torch.cuda.empty_cache()
    log(f"SSD chunk-scan phase done in {report['ssd_scan']['wall_s']:.1f} s "
        f"[{card}]")

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
            f"agrees {100 * r['argmax_agree']:.1f}%, routing flips "
            f"{r['routing_flips']} ({r['pairs_held']} (step, row) pairs "
            f"held); card {r['device_s']:.2f}"
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

    # 11. LM training (python -m repro_torch.launch.train) and its kernels --
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("phase 11a: the training kernels against their plain versions")
    train_k = train_kernels_phase(dev, args.seed)
    torch.cuda.empty_cache()
    log("phase 11b: one train step at full width, 2 layers: kernels (card) "
        "against the plain versions (CPU)")
    train_models = [train_model_phase(name, dev, seed=args.seed)
                    for name in TRAIN_MODEL_ARCHS]
    for r in train_models:
        log(f"  {r['arch']} x{r['layers']} layers, batch {r['batch']}, seq "
            f"{r['seq']}: loss card {r['loss_card']:.5f} cpu "
            f"{r['loss_cpu']:.5f} (rel gap {r['loss_rel_gap']:.1e}), grad "
            f"norm card {r['grad_norm_card']:.5f} cpu {r['grad_norm_cpu']:.5f}"
            f" (rel gap {r['norm_rel_gap']:.1e}; tolerance {TRAIN_TOL}); "
            f"updates: largest gap {r['update_gap_over_reach']:.3f} of one "
            f"step's reach, {100 * r['far_share']:.3f}% of elements over lr/2"
            f" apart (at most {100 * TRAIN_FLIP_MAX:.0f}%); card "
            f"{r['card_s']:.2f} s, cpu {r['cpu_s']:.2f} s")
    torch.cuda.empty_cache()
    log(f"phase 11c: training at full width, {TRAIN_FULL_STEPS} steps, batch "
        f"{TRAIN_FULL_BATCH}, seq {TRAIN_FULL_SEQ}")
    train_full = train_full_phase(dev, args.seed)
    log("phase 11d: launch.train checkpoints at 3 and 6, step 6 removed, "
        "resumed")
    resumed = train_resume_phase()
    log(f"  {' / '.join(resumed['lines'][1][:2])}; resumed step_6 within "
        f"{resumed['max_abs_gap']:.2e} of the first (tolerance {RESUME_TOL}),"
        f" stream state {resumed['metadata']['stream']} equal")
    report["train"] = {"kernels": train_k, "models": train_models,
                       "full": train_full, "resume": resumed,
                       "wall_s": time.perf_counter() - t0}
    log(f"training phase done in {report['train']['wall_s']:.1f} s [{card}]")

    # 13. the prefill step and the dry run against the card ----------------
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    log("phase 13: the dry-run CLI, cost_cell on (1, 1) and launch.serve "
        "--production-mesh started on the host")
    host_runs = dryrun_start()
    try:
        log(f"phase 13a: {PREFILL_ARCH} at full depth through "
            f"make_prefill_step")
        pre = prefill_full_phase(dev, args.seed)
        log(f"phase 13b: {PREFILL_MOE[0]} at full depth, B {PREFILL_MOE[1]} x"
            f" S {PREFILL_MOE[2]}, under the local mesh")
        pre_moe = prefill_moe_phase(dev, args.seed)
        log(f"  {pre_moe['arch']} x{pre_moe['layers']} layers: "
            f"{pre_moe['ms']:.1f} ms ({pre_moe['tok_s']:.0f} prefill tok/s), "
            f"grouped GEMM {pre_moe['grouped_gemm_launches']} launches (by "
            f"route {pre_moe['grouped_gemm_routes']}) [{card}]")
        log(f"phase 13b': {PREFILL_SSM[0]} at full depth, B {PREFILL_SSM[1]}"
            f" x S {PREFILL_SSM[2]}, under the local mesh")
        pre_ssm = prefill_ssm_phase(dev, args.seed)
        log(f"  {pre_ssm['arch']} x{pre_ssm['layers']} layers: "
            f"{', '.join(f'{m:.1f}' for m in pre_ssm['calls_ms'])} ms "
            f"(median {pre_ssm['median_ms']:.1f} ms, "
            f"{pre_ssm['tok_s']:.0f} prefill tok/s), peak device memory "
            f"{pre_ssm['peak_gb']:.2f} GB; SSD chunk scan "
            f"{pre_ssm['ssd_launches']}; one traced call: device busy "
            f"{pre_ssm['device_busy_ms']:.1f} of "
            f"{pre_ssm['profiled_wall_ms']:.1f} ms ("
            f"{100 * pre_ssm['device_busy_ms'] / pre_ssm['profiled_wall_ms']:.1f}"
            f"%); {pre_ssm['wall_s']:.1f} s [{card}]")
        for t_ms, count, ev in pre_ssm["top_device_events"]:
            log(f"    {t_ms:9.3f} ms  x{count:<7d} {ev[:90]}")
        log(f"phase 13c: prefill (card) against decode (card) and prefill "
            f"(CPU), B {PREFILL_AGREE_BATCH} x S {PREFILL_AGREE_SEQ}")
        agree = [prefill_agree_phase(name, layers, dev, args.seed, dt)
                 for name, layers, dt in PREFILL_AGREE]
        agree += [prefill_agree_phase(name, layers, dev, args.seed, dt,
                                      hold_decode=False)
                  for name, layers, dt in PREFILL_AGREE_CPU_ONLY]
        for r in agree:
            own = ("" if r["decode_held"] else
                   f" (logged, not held; the CPU's own prefill against its "
                   f"decode {r['cpu_own_decode_gap_over_range']:.4f})")
            log(f"  {r['arch']} x{r['layers']} layers, "
                f"{r['compute_dtype']}: max |prefill - "
                f"decode| / max |logit| {r['decode_gap_over_range']:.4f}{own} "
                f"({r['decode_rows_held']} rows held, argmax agrees "
                f"{100 * r['decode_argmax_agree']:.0f}%), against the CPU "
                f"{r['cpu_gap_over_range']:.4f} ({r['cpu_rows_held']} rows "
                f"held, argmax {100 * r['cpu_argmax_agree']:.0f}%); tolerance"
                f" {LOGIT_TOL}; {r['wall_s']:.1f} s")
        log("phase 13d: the dry run against the card")
        done = dryrun_collect(host_runs)
    finally:
        for p, _ in host_runs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    dry = dryrun_check(done, pre, card)
    log("phase 13e: plan_parallelism on the H100 preset at train_4k")
    plans = planner_rows()
    report["prefill"] = {"full": pre, "moe": pre_moe, "ssm": pre_ssm,
                         "agree": agree,
                         "dryrun": dry, "plans": plans,
                         "wall_s": time.perf_counter() - t0}
    log(f"prefill and dry-run phase done in {report['prefill']['wall_s']:.1f}"
        f" s [{card}]")

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
    gg_rows = report["grouped_gemm"]["rows"]
    gg_train = [main_row(gg_rows, case="olmoe train B 4 x S 2048 up",
                         product=prod) for prod in ("fwd", "dx", "dw")]
    gg_dec = main_row(gg_rows, case="olmoe decode B 4 up", product="fwd")
    gg_lib = [r["library_ms"] for r in gg_train]
    gg_routes = {r: sum(row["grouped_gemm_routes"][r]
                        for row in runs + train_full + [pre_moe])
                 for r in ("wgmma", "stream", "tile")}
    xent = main_row(train_k["cross_entropy"], arch="phi4-mini-3.8b")
    aw = main_row(train_k["adamw_step"], moments="float32")
    kernels += [{
        "name": "cross_entropy",
        "route": "triton",
        "source": "src/repro_torch/kernels/csrc/cross_entropy.py",
        "replaces": "src/repro/models/transformer.py:272",
        "launches": sum(r["xent_launches"] for r in train_full),
        "max_abs_err": max(r["max_abs_err"]
                           for r in train_k["cross_entropy"]),
        # forward + backward at phi4-mini's B 4 x 2047 rows, V 200064
        "ms": xent["ms"],
        "plain_ms": xent["plain_ms"],
        "bound_ms": xent["bound_ms"],
        "bound_by": xent["bound_by"],
        "library_ms": xent["library_ms"],
    }, {
        "name": "adamw_step",
        "route": "triton",
        "source": "src/repro_torch/kernels/csrc/adamw_step.py",
        "replaces": "src/repro/optim/adamw.py:34",
        "launches": sum(r["norm_launches"] + r["update_launches"]
                        for r in train_full),
        "max_abs_err": max(r["max_abs_err"] for r in train_k["adamw_step"]),
        # one whole step (norm + one update launch a leaf) over phi4-mini's
        # tree at 8 layers, fp32 moments
        "ms": aw["ms"],
        "plain_ms": aw["plain_ms"],
        "bound_ms": aw["bound_ms"],
        "bound_by": aw["bound_by"],
        "library_ms": aw["library_ms"],
    }, {
        "name": "grouped_gemm",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_gemm_sm90.cu",
        "replaces": "src/repro/models/moe_ep.py:114",
        "launches": sum(r["grouped_gemm_launches"] for r in runs)
        + sum(r["grouped_gemm_launches"] for r in train_full)
        + pre_moe["grouped_gemm_launches"],
        # 10c's, 11c's and 13b's launches by route: every one on the new
        # source
        "launches_by_route": gg_routes,
        "max_abs_err": max(r["max_abs_err"] for r in gg_rows),
        # forward + dx + dw of olmoe's up projection at 11c's shape (65,536
        # hits in a capacity buffer of 81,920 rows, 64 experts)
        "ms": sum(r["ms"] for r in gg_train),
        "plain_ms": sum(r["plain_ms"] for r in gg_train),
        "bound_ms": sum(r["bound_ms"] for r in gg_train),
        "bound_by": max(("operations", "bytes"), key=lambda by: sum(
            r["bound_ms"] for r in gg_train if r["bound_by"] == by)),
        "library_ms": None if None in gg_lib else sum(gg_lib),
        # the same products on grouped_gemm.cu's tiles (the "tile" route),
        # timed in turns with the new one
        "previous_ms": sum(r["previous_ms"] for r in gg_train),
        # the forward at 10c's decode shape (32 hits, cap 40; the stream
        # route)
        "decode_ms": gg_dec["ms"],
        "decode_previous_ms": gg_dec["previous_ms"],
        "decode_bound_ms": gg_dec["bound_ms"],
        "decode_plain_ms": gg_dec["plain_ms"],
        "decode_library_ms": gg_dec["library_ms"],
    }]
    fa = main_row(report["flash"]["rows"], case=FA_MAIN)
    # 11c's, 13a's and 13c's calls: a forward one launch, a backward three
    fa_calls = [r["flash_launches"] for r in train_full]
    fa_calls += [r["flash_launches"] for r in pre]
    fa_calls += [r["flash_launches"] for r in agree]
    fa_pass = {k: sum(c[k] for c in fa_calls) for k in ("fwd", "bwd")}
    fa_routes = {k: sum(r["flash_routes"][k] for r in train_full + pre + agree)
                 for k in FA.ROUTES}
    kernels += [{
        "name": "flash_attention",
        "route": "cuda",
        # bf16 on the sm90 route (wgmma fed by TMA); fp32 (13c's olmoe) on
        # flash_attention.cu's mma route
        "source": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
        "replaces": "src/repro/models/layers.py:130",
        "launches": fa_pass["fwd"] + 3 * fa_pass["bwd"],
        "calls_by_pass": fa_pass,
        "launches_by_route": fa_routes,
        "max_abs_err": max(r["max_abs_err"] for r in report["flash"]["rows"]),
        # forward + backward at phi4-mini's 11c shape (B 4 x S 2048, KV 8,
        # G 3, D 128, causal) on the sm90 route; plain:
        # flash_attention_fwd_ref + _bwd_ref at the reference's 512 x 1024
        # blocks; mma: flash_attention.cu on the same inputs, in turns
        "ms": fa["ms"],
        "mma_ms": fa["mma_ms"],
        "mma_fwd_ms": fa["mma_fwd_ms"],
        "plain_ms": fa["plain_ms"],
        "bound_ms": fa["bound_ms"],
        "bound_by": fa["bound_by"],
        "library_ms": fa["library_ms"],
        "fwd_ms": fa["fwd_ms"],
        "fwd_bound_ms": fa["fwd_bound_ms"],
        "fwd_plain_ms": fa["plain_fwd_ms"],
        "fwd_library_ms": fa["library_fwd_ms"],
        # the card's path before the kernel (the naive fp32 scores)
        "fwd_before_ms": fa["before_fwd_ms"],
    }]
    sc = main_row(report["ssd_scan"]["rows"], case=SSD_SCAN_MAIN)
    # 11c's, 13b''s and 13c's calls and their launches by route (bf16 on
    # the sm90 route: four a forward, seven a backward; 13c's fp32 on mma)
    sc_runs = train_full + [pre_ssm] + agree
    sc_pass = {k: sum(r["ssd_launches"][k] for r in sc_runs)
               for k in ("fwd", "bwd")}
    sc_routes = {k: sum(r["ssd_routes"][k] for r in sc_runs)
                 for k in SS.ROUTES}
    kernels += [{
        "name": "ssd_chunk_scan",
        "route": "cuda",
        # bf16 on the sm90 route (wgmma fed by TMA); fp32 (13c) on
        # ssd_chunk_scan.cu's mma route
        "source": "src/repro_torch/kernels/csrc/ssd_chunk_scan_sm90.cu",
        "replaces": "src/repro/models/ssm.py:93",
        "launches": sum(sc_routes.values()),
        "calls_by_pass": sc_pass,
        "launches_by_route": sc_routes,
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["ssd_scan"]["rows"]),
        # forward + backward at mamba2-780m's 11c shape (B 4 x S 2048, 48
        # heads, head_dim 64, d_state 128, Q 256) on the sm90 route;
        # previous: the mma route (ssd_chunk_scan.cu) on the same inputs,
        # in turns; plain: ssd_chunk_scan_ref in the reference's dtypes
        # under autograd, the card's path before the kernel
        "ms": sc["ms"],
        "previous_ms": sc["mma_ms"],
        "plain_ms": sc["plain_ms"],
        "bound_ms": sc["bound_ms"],
        "bound_by": sc["bound_by"],
        "library_ms": None,
        "fwd_ms": sc["fwd_ms"],
        "previous_fwd_ms": sc["mma_fwd_ms"],
        "fwd_bound_ms": sc["fwd_bound_ms"],
        "fwd_plain_ms": sc["plain_fwd_ms"],
    }]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on the main path")
    report["kernels"] = kernels
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    log("kernels: bitserial_mvm, int8_matmul, gqa_decode_attention, "
        "grouped_gemm, flash_attention and ssd_chunk_scan (cuda, sm_90a; "
        "grouped_gemm_sm90.cu, flash_attention_sm90.cu and "
        "ssd_chunk_scan_sm90.cu on every bf16 launch, grouped_gemm.cu's"
        " tiles and the mma routes of flash_attention.cu and "
        "ssd_chunk_scan.cu for fp32), "
        "ssd_decode_step, cross_entropy and adamw_step (triton)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
