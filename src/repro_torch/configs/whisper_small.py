"""Whisper-small [arXiv:2212.04356] — encoder-decoder; the conv/audio
frontend is a STUB (input_specs provides precomputed frame embeddings).
Decoder self-attention uses RoPE in place of learned positions
(documented adaptation, DESIGN.md §Arch-applicability)."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865, head_dim=64,
    norm="layernorm", act="gelu",
    encoder_layers=12, encoder_seq=1500,
    notes="enc-dec; cross-attention decode; full attention -> "
          "long_500k skipped",
)
