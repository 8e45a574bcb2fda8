"""Jamba-1.5-Large-398B [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave with MoE every other sublayer (16 experts, top-2).
Mamba sublayers use Mamba-2 SSD geometry (documented adaptation)."""
from .base import ArchConfig, MoeConfig, SsmConfig

ARCH = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536, head_dim=128,
    norm="rmsnorm", act="swiglu",
    block_pattern="MMMMMMMA",
    moe=MoeConfig(n_experts=16, experts_per_tok=2, d_ff=24576,
                  moe_stride=2),
    ssm=SsmConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                  n_groups=8, chunk=256),
    notes="hybrid: modest KV (1 attn per 8) + SSM state -> "
          "long_500k runs",
)
