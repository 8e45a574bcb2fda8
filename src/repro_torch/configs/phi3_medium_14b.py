"""Phi-3-medium-14B [arXiv:2404.14219] — dense GQA decoder."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab=100352, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    notes="RoPE SwiGLU GQA; full attention -> long_500k skipped",
)
