"""Phi-4-mini-3.8B [arXiv:2412.08905] — dense GQA, 200k vocab."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    tie_embeddings=True,
    notes="RoPE SwiGLU GQA; full attention -> long_500k skipped",
)
