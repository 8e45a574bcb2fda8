"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b].
The anyres vision frontend is a STUB: input_specs supplies precomputed
patch embeddings (576 tokens / image tile) prepended to the text."""
from .base import ArchConfig

ARCH = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=1_000_000.0,
    vision_tokens=576,
    notes="mistral backbone; full attention -> long_500k skipped",
)
