"""OLMoE-1B-7B [arXiv:2409.02060] — 64-expert top-8 MoE, 1B active."""
from .base import ArchConfig, MoeConfig

ARCH = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304, head_dim=128,
    norm="rmsnorm", act="swiglu",
    moe=MoeConfig(n_experts=64, experts_per_tok=8, d_ff=1024),
    notes="full attention -> long_500k skipped",
)
