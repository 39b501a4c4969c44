"""granite-moe-1b-a400m — MoE LM, 32 experts top-8, every layer MoE.

[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d_model=1024 16H (GQA kv=8)
expert d_ff=512 vocab=49155. A copy of the JAX package's config.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=0, vocab_size=49155,
    pattern=(GLOBAL_ATTN,), rope_theta=10_000.0,
    moe=MoEConfig(n_experts=32, n_active=8, d_ff_expert=512),
    tie_embeddings=True,
)

REDUCED = ModelConfig(
    name="granite-reduced", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=0, vocab_size=512,
    pattern=(GLOBAL_ATTN,), rope_theta=10_000.0,
    moe=MoEConfig(n_experts=8, n_active=2, d_ff_expert=32),
    tie_embeddings=True,
)
