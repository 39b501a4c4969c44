"""qwen3-32b — dense GQA with per-head qk RMSNorm.

[hf:Qwen/Qwen3-32B family] 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, head_dim 128 (projections are non-square), rope theta 1M.
A copy of the JAX package's config.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936,
    pattern=(GLOBAL_ATTN,), rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="qwen3-reduced", family="dense",
    n_layers=4, d_model=64, n_heads=8, n_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=512,
    pattern=(GLOBAL_ATTN,), rope_theta=1_000_000.0,
    qk_norm=True, tie_embeddings=False,
)
