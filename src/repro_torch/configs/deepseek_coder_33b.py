"""DeepSeek-Coder-33B [arXiv:2401.14196] — llama-arch dense GQA."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=19200, vocab=32256, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=100_000.0,
    notes="llama architecture; full attention -> long_500k skipped",
)
