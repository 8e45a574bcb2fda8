"""Compiled-artifact analysis: collective bytes, roofline terms.

Host code: a copy of :mod:`repro.launch.analysis`.  :class:`HW`'s
defaults stay the reference's TPU v5e chip, which its tests assert
against; :data:`H100` (also ``HW.h100()``) holds one NVIDIA H100 SXM
GPU's constants, the default of the port's dry run
(:mod:`repro_torch.launch.dryrun`), which feeds :func:`roofline_terms`
with its own counts in place of XLA's (``collective_bytes`` still parses
HLO text, for the reference's records).  What follows is the
reference's account.

``cost_analysis()`` gives HLO FLOPs/bytes but not collective traffic, so
we parse the optimized HLO text and sum result-buffer sizes per
collective kind (DESIGN.md §Roofline).  Hardware constants target
TPU v5e-class chips per the assignment: 197 TFLOP/s bf16, 819 GB/s HBM,
~50 GB/s per ICI link.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["HW", "H100", "collective_bytes", "roofline_terms",
           "RooflineTerms", "model_flops", "flash_addons"]


@dataclass(frozen=True)
class HW:
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # B/s per chip
    ici_bw: float = 50e9                # B/s per link
    ici_links: int = 4                  # usable mesh links per chip
    hbm_bytes: float = 16e9             # capacity per chip

    @classmethod
    def h100(cls) -> "HW":
        """One NVIDIA H100 SXM GPU: 989e12 dense bf16 FLOP/s, 80e9 bytes of
        HBM3 at 3.35e12 B/s (NVIDIA's H100 data sheet; the port's kernel
        bounds use the same), and the link term of a mesh axis that
        crosses nodes.  A 16-wide model axis, or the data axis, of the
        (16, 16) production mesh spans two or more 8-GPU HGX nodes, so a
        ring over it has a hop on InfiniBand: one 400 Gb/s NDR port a
        GPU, 50e9 B/s each way (NVIDIA DGX H100 user guide: 8 x
        ConnectX-7 a node).  The preset takes that slowest hop as the
        ring's rate, with one link a GPU (``ici_links = 1``): the
        collective term is the bytes through one GPU's NIC.  Inside a
        node NVLink 4 runs at 450e9 B/s each way (``core.planner``'s
        ``NVLINK4_BW``); a collective confined to 8 GPUs would be 9x
        faster than this term says."""
        return cls(peak_flops=989e12, hbm_bw=3.35e12, ici_bw=400e9 / 8,
                   ici_links=1, hbm_bytes=80e9)


H100 = HW.h100()

DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
    "s4": 1, "u4": 1,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                "all-to-all", "collective-permute")

# result shape like  bf16[16,4096,448]{2,1,0:T(8,128)(2,1)}
_SHAPE_RE = re.compile(r"([a-z]+[0-9]+(?:e[0-9]+m[0-9]+(?:fn)?)?|pred)"
                       r"\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^=]*\)|\S+)\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|"
    r"collective-permute)(?:-start|-done)?\(",
    re.M)


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        nbytes = DTYPE_BYTES.get(dtype)
        if nbytes is None:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * nbytes
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Result-buffer bytes per collective kind (``-start`` ops only are
    counted once; ``-done`` carries no new payload)."""
    out: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
    out["count"] = 0
    for m in _OP_RE.finditer(hlo_text):
        shape_text, kind = m.group(1), m.group(2)
        if "-done" in m.group(0):
            continue
        out[kind] += _shape_bytes(shape_text)
        out["count"] += 1
    return out


@dataclass
class RooflineTerms:
    """Per-chip roofline terms in seconds + supporting numbers."""

    flops: float                 # HLO flops per chip (per step)
    hbm_bytes: float             # HLO bytes accessed per chip
    coll_link_bytes: float       # bytes crossing one ICI link
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    collectives: Dict[str, int] = field(default_factory=dict)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_link_bytes": self.coll_link_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "collectives": self.collectives,
        }


def roofline_terms(cost: Dict, coll: Dict[str, int],
                   hw: HW = HW(),
                   extra_link_bytes: float = 0.0) -> RooflineTerms:
    """Three-term roofline from per-chip cost analysis + collectives.

    Link-byte model per chip (ring algorithms on a 2-D torus):
      all-reduce R result     -> 2R bytes through the busiest link
      all-gather R result     -> R
      reduce-scatter R result -> R x (n-1) ≈ its input ≈ R·n ... counted
                                 via result x 1 (conservative lower bound)
      all-to-all / permute R  -> R
    divided by the ``ici_links`` a chip can drive concurrently.
    """
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    link_bytes = (2.0 * coll.get("all-reduce", 0)
                  + 1.0 * coll.get("all-gather", 0)
                  + 1.0 * coll.get("reduce-scatter", 0)
                  + 1.0 * coll.get("all-to-all", 0)
                  + 1.0 * coll.get("collective-permute", 0))
    link_bytes = link_bytes / hw.ici_links + extra_link_bytes
    compute_s = flops / hw.peak_flops
    memory_s = hbm / hw.hbm_bw
    coll_s = link_bytes / hw.ici_bw
    dom = max(("compute", compute_s), ("memory", memory_s),
              ("collective", coll_s), key=lambda kv: kv[1])[0]
    return RooflineTerms(flops=flops, hbm_bytes=hbm,
                         coll_link_bytes=link_bytes,
                         compute_s=compute_s, memory_s=memory_s,
                         collective_s=coll_s, dominant=dom,
                         collectives=dict(coll))


def flash_addons(cfg, shape, n_chips: int, tp: int,
                 head_choice: str,
                 block_q: int = 512) -> Tuple[float, float]:
    """(extra HBM bytes, extra ICI link bytes) per chip per step for the
    blockwise-attention inner scans, which the cost probes count once.

    HBM: every query block streams the full K/V (window-clipped under
    SWA) — the defining flash traffic.  ICI: when attention falls back to
    head_dim sharding (heads % tp != 0), every score tile is psum'ed over
    the model axis; that S²-proportional collective is a baseline finding
    addressed in §Perf.  Training multiplies by ~4 (fwd + remat fwd +
    2x bwd).
    """
    seq = shape.seq_len
    if shape.kind not in ("train", "prefill") or seq <= 2048:
        return 0.0, 0.0
    n_attn = cfg.n_blocks * cfg.block_pattern.count("A")
    if n_attn == 0:
        return 0.0, 0.0
    dp = max(n_chips // tp, 1)
    b_loc = max(shape.global_batch // dp, 1)
    if cfg.mla is not None:
        kvh, hd = cfg.n_heads, (cfg.mla.qk_nope_head_dim
                                + cfg.mla.qk_rope_head_dim)
    else:
        kvh, hd = cfg.n_kv_heads, cfg.hd
    heads = cfg.n_heads
    if head_choice == "heads":
        kvh_loc, hd_loc, h_loc = max(kvh // tp, 1), hd, heads // tp
    elif head_choice == "head_dim":
        kvh_loc, hd_loc, h_loc = kvh, hd // tp, heads
    else:
        kvh_loc, hd_loc, h_loc = kvh, hd, heads
    nq = -(-seq // block_q)
    if head_choice == "sequence":
        # seq-parallel attention: full heads per chip, 1/tp of the query
        # blocks, full K/V streamed; the S-linear all-to-alls are real
        # per-layer collectives the probes measure directly
        kvh_loc, hd_loc, h_loc = kvh, hd, heads
        nq = max(nq // tp, 1)
    kv_span = min(seq, (cfg.sliding_window or seq) + block_q)
    passes = 4.0 if shape.kind == "train" else 1.0
    # HBM: per q-block read of K+V (bf16) across all attention layers
    hbm = passes * n_attn * b_loc * nq * kv_span * kvh_loc * hd_loc \
        * 2 * 2.0
    # ICI: head_dim sharding psums every (block_q x block_k) score tile
    link = 0.0
    if head_choice == "head_dim" and tp > 1:
        tiles = nq * (-(-kv_span // 1024))          # nk per q block
        tile_bytes = b_loc * kvh_loc * (heads // max(kvh, 1)) \
            * block_q * 1024 * 4.0
        link = passes * n_attn * tiles * tile_bytes * 2.0 / 4.0
    return hbm, link


def model_flops(cfg, shape, n_chips: int) -> float:
    """MODEL_FLOPS per chip per step: 6·N·D for training (N = active
    params), 2·N·D for prefill, 2·N per decoded token."""
    n_active = _active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens / n_chips


def _active_params(cfg) -> float:
    """Params touched per token (MoE: top-k of the routed experts)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return float(total)
    m = cfg.moe
    # subtract inactive routed-expert params
    per_expert = (3 if cfg.act == "swiglu" else 2) * cfg.d_model * m.d_ff
    n_moe_layers = sum(1 for _ in range(cfg.n_blocks)
                       for i, ch in enumerate(cfg.block_pattern)
                       if cfg.family != "ssm"
                       and i % max(m.moe_stride, 1) == 0)
    inactive = n_moe_layers * (m.n_experts - m.experts_per_tok) \
        * per_expert
    return float(total - max(inactive, 0))
