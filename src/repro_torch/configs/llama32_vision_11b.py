"""llama-3.2-vision-11b — text backbone with gated cross-attention image
layers every 5th layer (indices 3, 8, 13, ...).

[hf:meta-llama/Llama-3.2-11B-Vision] 40L d_model=4096 32H (GQA kv=8)
d_ff=14336 vocab=128256. The vision frontend is a stub: a request carries
1601 precomputed patch embeddings per sample at d_model (post-projector).
A copy of the JAX package's config.
"""
from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, ModelConfig

_PATTERN = (GLOBAL_ATTN, GLOBAL_ATTN, GLOBAL_ATTN, CROSS_ATTN, GLOBAL_ATTN)

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    pattern=_PATTERN, rope_theta=500_000.0,
    qk_norm=False, n_img_tokens=1601,
    tie_embeddings=False,
)

REDUCED = ModelConfig(
    name="llama32v-reduced", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    pattern=_PATTERN, rope_theta=500_000.0,
    n_img_tokens=17,
    tie_embeddings=False,
)
