"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA + 256-expert top-8 MoE
(1 shared expert), sigmoid routing, MTP head.  The paper's first-3-dense-
layers exception is folded into the uniform MoE stack for scan-over-
layers (documented adaptation)."""
from .base import ArchConfig, MlaConfig, MoeConfig

ARCH = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280, head_dim=128,
    norm="rmsnorm", act="swiglu", rope_theta=10_000.0,
    moe=MoeConfig(n_experts=256, experts_per_tok=8, d_ff=2048,
                  n_shared_experts=1, shared_d_ff=2048,
                  router_score="sigmoid"),
    mla=MlaConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    mtp=True,
    notes="MLA latent KV shrinks cache; attention still quadratic -> "
          "long_500k skipped",
)
