"""Architecture + shape configuration system.

Every assigned architecture is one :class:`ArchConfig` (exact public
hyper-parameters) in its own ``configs/<id>.py``, plus the standard shape
set (``train_4k`` / ``prefill_32k`` / ``decode_32k`` / ``long_500k``).
``reduced()`` derives the CPU-smoke-test configuration of the same family.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["MlaConfig", "SsmConfig", "MoeConfig", "ArchConfig",
           "ShapeConfig", "STANDARD_SHAPES", "reduced"]


@dataclass(frozen=True)
class MlaConfig:
    """Multi-head Latent Attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SsmConfig:
    """Mamba-2 SSD block geometry."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    experts_per_tok: int
    d_ff: int                   # per-expert hidden dim
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    router_score: str = "softmax"     # softmax | sigmoid (dsv3)
    capacity_factor: float = 1.25
    moe_stride: int = 1         # MoE every Nth sublayer (Jamba: 2)


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None      # default d_model // n_heads
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    act: str = "swiglu"                 # swiglu | gelu
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    tie_embeddings: bool = False
    moe: Optional[MoeConfig] = None
    mla: Optional[MlaConfig] = None
    ssm: Optional[SsmConfig] = None
    # hybrid interleave: sublayer pattern per scan block, e.g. "MMMMMMMA"
    # (M = Mamba-2, A = attention); dense transformers use "A", pure SSM "M"
    block_pattern: str = "A"
    # encoder-decoder (whisper): encoder layer count; frontend is a stub
    encoder_layers: int = 0
    encoder_seq: int = 0                # precomputed frame/patch positions
    # vision-language (llava): patch embeddings prepended to text
    vision_tokens: int = 0
    mtp: bool = False                   # multi-token-prediction head (dsv3)
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    notes: str = ""

    # -- derived ---------------------------------------------------------------

    def __post_init__(self):
        if self.n_layers % len(self.block_pattern):
            raise ValueError(
                f"{self.name}: {self.n_layers} layers not divisible by "
                f"pattern {self.block_pattern!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def attention_free(self) -> bool:
        return "A" not in self.block_pattern

    @property
    def subquadratic(self) -> bool:
        """Can this arch run long_500k decode?"""
        return self.attention_free or self.sliding_window is not None \
            or self.family == "hybrid"

    def param_count(self) -> int:
        """Analytic parameter count, mirroring the model structure:
        every sublayer gets an FFN (MoE on ``moe_stride`` sublayers)
        except in pure-SSM stacks."""
        d = self.d_model
        n = 0
        n += self.vocab * d                       # embed
        if not self.tie_embeddings:
            n += self.vocab * d                   # lm head
        for _ in range(self.n_blocks):
            for i, ch in enumerate(self.block_pattern):
                n += d                            # sublayer norm
                if ch == "A":
                    n += self._attn_params()
                    if self.encoder_layers:       # cross-attention block
                        n += 4 * d * self.n_heads * self.hd + d
                else:
                    n += self._ssm_params()
                if self.family != "ssm":
                    use_moe = (self.moe is not None
                               and i % max(self.moe.moe_stride, 1) == 0)
                    n += d + self._ffn_params(use_moe)
        n += d                                    # final norm
        if self.encoder_layers:
            n += self.encoder_layers * (
                4 * d * self.n_heads * self.hd + self._ffn_params(False)
                + 2 * d) + d
        if self.mtp:
            n += 2 * d * d + d
        return n

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            n = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
            return n
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        return q + kv + o

    def _ffn_params(self, use_moe: bool = True) -> int:
        d = self.d_model
        if self.moe is not None and use_moe:
            m = self.moe
            per = 3 * d * m.d_ff if self.act == "swiglu" else 2 * d * m.d_ff
            n = m.n_experts * per + d * m.n_experts       # router
            if m.n_shared_experts:
                sf = m.shared_d_ff or m.d_ff
                n += m.n_shared_experts * 3 * d * sf
            return n
        if self.act == "swiglu":
            return 3 * d * self.d_ff
        return 2 * d * self.d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        assert s is not None
        d = self.d_model
        d_in = s.expand * d
        n_heads = d_in // s.head_dim
        conv_dim = d_in + 2 * s.n_groups * s.d_state
        n = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
        n += conv_dim * s.d_conv                                   # conv1d
        n += n_heads * 2                                           # A, D
        n += d_in * d                                              # out_proj
        return n


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str           # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


STANDARD_SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


def depth_variant(cfg: ArchConfig, k: int) -> ArchConfig:
    """Same architecture at ``k`` scan blocks (full width) — the roofline
    cost probes reconstruct per-step totals from depth-1/-2 compiles."""
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-d{k}",
        n_layers=k * len(cfg.block_pattern),
        encoder_layers=k if cfg.encoder_layers else 0)


def reduced(cfg: ArchConfig, *, layers_per_kind: int = 1,
            d_model: int = 64, vocab: int = 256) -> ArchConfig:
    """Small same-family config for CPU smoke tests."""
    pat = cfg.block_pattern
    d = d_model
    n_heads = max(2, min(cfg.n_heads, 4))
    hd = d // n_heads
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=len(pat) * layers_per_kind,
        d_model=d, n_heads=n_heads,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=d * 2, vocab=vocab, head_dim=hd,
        sliding_window=16 if cfg.sliding_window else None,
        moe=None if cfg.moe is None else MoeConfig(
            n_experts=4, experts_per_tok=min(2, cfg.moe.experts_per_tok),
            d_ff=d, n_shared_experts=min(1, cfg.moe.n_shared_experts),
            shared_d_ff=d if cfg.moe.n_shared_experts else 0,
            router_score=cfg.moe.router_score),
        mla=None if cfg.mla is None else MlaConfig(
            q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=hd,
            qk_rope_head_dim=8, v_head_dim=hd),
        ssm=None if cfg.ssm is None else SsmConfig(
            d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1,
            chunk=16),
        encoder_layers=layers_per_kind if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_layers else 0,
        vision_tokens=8 if cfg.vision_tokens else 0,
        param_dtype="float32", compute_dtype="float32",
    )
    return dataclasses.replace(cfg, **kw)
