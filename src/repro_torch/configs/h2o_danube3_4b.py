"""H2O-Danube-3-4B [arXiv:2401.16818] — llama/mistral mix with sliding-
window attention (window 4096) -> long_500k decodes in O(window)."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, head_dim=120,
    norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    sliding_window=4096,
    notes="SWA ring KV cache; long_500k runs",
)
