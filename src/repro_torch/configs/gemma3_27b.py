"""gemma3-27b — dense, 5:1 local:global sliding-window attention, 128k ctx.

[hf:google/gemma-3-*-pt; assignment-verified dims] 62L d_model=5376 32H
(GQA kv=16) d_ff=21504 vocab=262144. Local layers use a 1024 sliding window
with rope theta 10k; every 6th layer is global with theta 1M. qk-norm,
post-block norms, (1+w) RMSNorm, embedding scaled by sqrt(d). The two
layers after the ten groups of six are local (the remainder).
A copy of the JAX package's config.
"""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig

_PATTERN = (LOCAL_ATTN,) * 5 + (GLOBAL_ATTN,)

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    pattern=_PATTERN, remainder=(LOCAL_ATTN, LOCAL_ATTN),
    window_size=1024, rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    qk_norm=True, act="gelu",
    scale_embed=True, scale_plus_one_norm=True, post_block_norm=True,
    tie_embeddings=True, subquadratic=True,
)

REDUCED = ModelConfig(
    name="gemma3-reduced", family="dense",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    pattern=_PATTERN, remainder=(LOCAL_ATTN, LOCAL_ATTN),
    window_size=16, rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    qk_norm=True, act="gelu",
    scale_embed=True, scale_plus_one_norm=True, post_block_norm=True,
    tie_embeddings=True, subquadratic=True,
)
