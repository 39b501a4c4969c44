"""smollm-135m — llama-architecture small dense LM.

[hf:HuggingFaceTB/SmolLM-135M] 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152. A copy of the JAX package's config.
"""
from repro_torch.configs.base import GLOBAL_ATTN, ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab_size=49152,
    pattern=(GLOBAL_ATTN,), rope_theta=10_000.0,
    tie_embeddings=True, attn_shard="seq",
)

REDUCED = ModelConfig(
    name="smollm-reduced", family="dense",
    n_layers=4, d_model=48, n_heads=3, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
    pattern=(GLOBAL_ATTN,), rope_theta=10_000.0,
    tie_embeddings=True, attn_shard="seq",
)
