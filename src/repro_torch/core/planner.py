"""Alg. 1 at pod scale: capacity-constrained model partitioning.

Host code: a copy of :mod:`repro.core.planner`; the port imports nothing
of ``repro``.  :class:`PodSpec`'s defaults stay the reference's TPU v5e
pod, which its tests assert against; :data:`H100_POD` (also
``PodSpec.h100()``) is the same model on NVIDIA H100 SXM GPUs.  What
follows is the reference's account.

CIMFlow's core problem — partition a DNN across a grid of
capacity-limited compute-in-memory cores connected by a NoC, duplicating
weights into vacant cores when the cost model says it pays — is
isomorphic to placing an LLM on a TPU pod:

====================  =====================================
digital CIM chip      TPU pod
====================  =====================================
core SRAM capacity    chip HBM budget for params/opt state
NoC links             ICI links
execution stage       pipeline stage (weights resident)
weight duplication    data-parallel replication of a stage
inter-op pipeline     tensor parallelism within a stage
====================  =====================================

The planner reuses the paper's DP over dependency closures (a decoder
stack condenses to a chain, so closures are prefixes) with a TPU cost
model: per-stage interval = max(compute, HBM, ICI) per microbatch;
duplication multiplies throughput and divides the data-parallel batch.
Its output (`ParallelismPlan`) documents the recommended
(PP x DP x TP) decomposition per architecture and drives the elastic
re-mesh policy in :mod:`repro_torch.runtime.elastic`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["PodSpec", "PlanStage", "ParallelismPlan", "plan_parallelism",
           "H100_POD"]


@dataclass(frozen=True)
class PodSpec:
    n_chips: int = 256
    peak_flops: float = 197e12        # bf16/chip
    hbm_bytes: float = 16e9
    hbm_bw: float = 819e9
    ici_bw: float = 50e9              # per link
    ici_links: int = 4
    mfu_target: float = 0.5           # achievable fraction of peak
    param_bytes: float = 2.0          # bf16 weights
    opt_bytes: float = 4.0            # moments (bf16 m+v) per param
    hbm_budget_frac: float = 0.85     # params+opt share of HBM
    max_tp: int = 16                  # one ICI dimension

    @classmethod
    def h100(cls, n_chips: int = 256) -> "PodSpec":
        """``n_chips`` NVIDIA H100 SXM GPUs (80 GB) in HGX nodes of 8.

        Compute and memory: 989e12 dense bf16 FLOP/s, 80e9 bytes of HBM3
        at 3.35e12 B/s (NVIDIA H100 Tensor Core GPU data sheet, SXM
        column), the constants of the port's kernel bounds.

        Links.  Inside a node each GPU drives NVLink 4: 18 links of 25
        GB/s each way, 450 GB/s in all (the data sheet's "900 GB/s" is
        both directions).  Between nodes each GPU owns one ConnectX-7
        port, 400 Gb/s NDR InfiniBand = 50 GB/s each way (NVIDIA DGX H100
        user guide: 8 x ConnectX-7 a node).  ``max_tp = 8`` keeps a
        tensor-parallel group inside one node's NVLink domain, so the
        planner's TP all-reduce term (``ici_links x ici_bw``) is the
        NVLink figure: one "link" of 450 GB/s.  Data-parallel and
        pipeline traffic, which cross nodes, are not in the planner's
        interval (as in the reference)."""
        return cls(n_chips=n_chips, peak_flops=989e12, hbm_bytes=80e9,
                   hbm_bw=3.35e12, ici_bw=NVLINK4_BW, ici_links=1,
                   max_tp=8)


# NVLink 4 between the GPUs of one HGX H100 node: 18 links x 25 GB/s each
# way (NVIDIA H100 data sheet: 900 GB/s bidirectional)
NVLINK4_BW = 18 * 25e9
# one 400 Gb/s NDR InfiniBand port a GPU between nodes (NVIDIA DGX H100
# user guide: 8 x ConnectX-7), each way
IB_NDR_BW = 400e9 / 8


@dataclass
class PlanStage:
    blocks: Tuple[int, int]           # [lo, hi) block range
    tp: int                           # chips per model replica (within stage)
    dup: int                          # stage replicas (data parallel)
    bytes_per_chip: float
    interval_s: float                 # per-microbatch steady state

    @property
    def chips(self) -> int:
        return self.tp * self.dup


@dataclass
class ParallelismPlan:
    arch: str
    shape: str
    pod: PodSpec
    stages: List[PlanStage]
    est_step_s: float
    tokens_per_s: float

    @property
    def pp(self) -> int:
        return len(self.stages)

    def describe(self) -> str:
        rows = [f"plan[{self.arch} x {self.shape}]: PP={self.pp}, "
                f"step≈{self.est_step_s * 1e3:.1f} ms, "
                f"{self.tokens_per_s / 1e6:.2f} Mtok/s"]
        for i, s in enumerate(self.stages):
            rows.append(
                f"  stage{i}: blocks[{s.blocks[0]}:{s.blocks[1]}) "
                f"tp={s.tp} dup={s.dup} "
                f"{s.bytes_per_chip / 2**30:.1f} GiB/chip "
                f"interval={s.interval_s * 1e3:.2f} ms")
        return "\n".join(rows)


def _block_stats(cfg: ArchConfig) -> Tuple[float, float, float]:
    """(bytes, flops/token, act_bytes/token) for one scan block."""
    total = cfg.param_count()
    embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    block_params = (total - embed) / cfg.n_blocks
    # training flops/token ≈ 6 x active params
    if cfg.moe is not None:
        m = cfg.moe
        per_expert = (3 if cfg.act == "swiglu" else 2) \
            * cfg.d_model * m.d_ff
        n_moe = sum(1 for i in range(len(cfg.block_pattern))
                    if i % max(m.moe_stride, 1) == 0)
        inactive = n_moe * (m.n_experts - m.experts_per_tok) * per_expert
        active = block_params - inactive
    else:
        active = block_params
    return (block_params, 6.0 * active,
            2.0 * cfg.d_model * len(cfg.block_pattern))


def _stage_plan(cfg: ArchConfig, shape: ShapeConfig, pod: PodSpec,
                n_stage_blocks: int, chips: int,
                tokens_per_micro: float) -> Optional[PlanStage]:
    """OptimalMapping analogue: choose (tp, dup) for one stage."""
    block_bytes, flops_tok, act_tok = _block_stats(cfg)
    per_param = pod.param_bytes + (pod.opt_bytes
                                   if shape.kind == "train" else 0.0)
    stage_bytes = n_stage_blocks * block_bytes / pod.param_bytes \
        * per_param
    budget = pod.hbm_bytes * pod.hbm_budget_frac
    tp_min = max(1, math.ceil(stage_bytes / budget))
    if tp_min > chips:
        return None
    best: Optional[PlanStage] = None
    tp = 1 << max(0, (tp_min - 1).bit_length())      # pow2 TP degrees
    while tp <= min(pod.max_tp, chips):
        dup = chips // tp
        if dup < 1:
            break
        compute = (tokens_per_micro / dup) * n_stage_blocks \
            * flops_tok / (tp * pod.peak_flops * pod.mfu_target)
        # TP all-reduce per block: ~4 x act bytes x 2 (fwd+bwd)
        coll = 0.0
        if tp > 1:
            coll = (tokens_per_micro / dup) * n_stage_blocks \
                * act_tok * 8.0 / (pod.ici_links * pod.ici_bw)
        interval = max(compute, coll)
        cand = PlanStage(blocks=(0, n_stage_blocks), tp=tp, dup=dup,
                         bytes_per_chip=stage_bytes / tp,
                         interval_s=interval)
        if best is None or cand.interval_s < best.interval_s:
            best = cand
        tp *= 2
    return best


def plan_parallelism(cfg: ArchConfig, shape: ShapeConfig,
                     pod: PodSpec = PodSpec(),
                     n_micro: int = 8) -> ParallelismPlan:
    """DP over chain prefixes (Alg. 1 on the block chain)."""
    nb = cfg.n_blocks
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    tokens_per_micro = tokens / n_micro
    INF = float("inf")
    dp: List[float] = [INF] * (nb + 1)
    prev: List[int] = [-1] * (nb + 1)
    plans: List[Optional[PlanStage]] = [None] * (nb + 1)
    dp[0] = 0.0
    # cache stage costs by length (chain is homogeneous per block)
    memo: Dict[int, Optional[PlanStage]] = {}

    for i in range(1, nb + 1):
        for j in range(i):
            length = i - j
            if length not in memo:
                # chips split evenly across the prospective stage count;
                # evaluated per candidate partition below via interval sum
                memo[length] = None
            # candidate cost computed lazily with chips = n/areas; handle
            # by assuming equal chip share per stage in this partition:
            pass
        # two-pass DP: enumerate stage length directly
        for j in range(i):
            length = i - j
            # chips proportional to the stage's share of total blocks —
            # balanced pipelines get equal intervals
            chips = max(1, int(pod.n_chips * length / nb))
            sp = _stage_plan(cfg, shape, pod, length, chips,
                             tokens_per_micro)
            if sp is None:
                continue
            # pipeline cost model: sum of intervals approximates the
            # bottleneck x stages for balanced partitions; fill added once
            cost = dp[j] + sp.interval_s * n_micro / max(1, 1)
            if cost < dp[i]:
                dp[i], prev[i] = cost, j
                plans[i] = PlanStage(blocks=(j, i), tp=sp.tp, dup=sp.dup,
                                     bytes_per_chip=sp.bytes_per_chip,
                                     interval_s=sp.interval_s)
    if dp[nb] == INF:
        raise ValueError(f"{cfg.name}: no feasible plan on "
                         f"{pod.n_chips} chips")
    stages: List[PlanStage] = []
    i = nb
    while i > 0:
        stages.append(plans[i])          # type: ignore[arg-type]
        i = prev[i]
    stages.reverse()
    # pipeline step estimate: bottleneck interval x microbatches + fill
    bott = max(s.interval_s for s in stages)
    fill = sum(s.interval_s for s in stages)
    step = bott * n_micro + fill
    return ParallelismPlan(arch=cfg.name, shape=shape.name, pod=pod,
                           stages=stages, est_step_s=step,
                           tokens_per_s=tokens / step)


H100_POD = PodSpec.h100()
