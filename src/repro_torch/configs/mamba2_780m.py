"""Mamba-2-780M [arXiv:2405.21060] — attention-free SSD stack."""
from .base import ArchConfig, SsmConfig

ARCH = ArchConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=0, vocab=50280,
    norm="rmsnorm", act="swiglu", tie_embeddings=True,
    block_pattern="M",
    ssm=SsmConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk=256),
    notes="SSD (state-space duality); constant-state decode -> "
          "long_500k runs",
)
