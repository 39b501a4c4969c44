"""gemma2-27b — dense, alternating local/global attention, logit softcaps.

[arXiv:2408.00118] 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
Sliding window 4096 on alternating layers; attention-logit softcap 50,
final-logit softcap 30; (1+w) RMSNorm, post-block norms, scaled embeddings.
A copy of the JAX package's config.
"""
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window_size=4096, rope_theta=10_000.0,
    attn_softcap=50.0, logit_softcap=30.0, act="gelu",
    scale_embed=True, scale_plus_one_norm=True, post_block_norm=True,
    tie_embeddings=True, subquadratic=True,
)

REDUCED = ModelConfig(
    name="gemma2-reduced", family="dense",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=512,
    pattern=(LOCAL_ATTN, GLOBAL_ATTN),
    window_size=16, rope_theta=10_000.0,
    attn_softcap=50.0, logit_softcap=30.0, act="gelu",
    scale_embed=True, scale_plus_one_norm=True, post_block_norm=True,
    tie_embeddings=True, subquadratic=True,
)
