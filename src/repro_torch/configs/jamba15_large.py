"""jamba-1.5-large-398b — hybrid Mamba+attention (1:7) with 16-expert top-2
MoE every other layer.

[arXiv:2403.19887 / Jamba-1.5] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536. Jamba block = 8 layers: attention at offset 4, Mamba elsewhere;
MoE at odd offsets. No rope (Mamba provides positionality). Optimizer:
adafactor (398B params). A copy of the JAX package's config.
"""
from repro_torch.configs.base import (GLOBAL_ATTN, MAMBA, ModelConfig,
                                      MoEConfig, SSMConfig)

_PATTERN = (MAMBA, MAMBA, MAMBA, MAMBA, GLOBAL_ATTN, MAMBA, MAMBA, MAMBA)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab_size=65536,
    pattern=_PATTERN, use_rope=False,
    moe=MoEConfig(n_experts=16, n_active=2, d_ff_expert=24576,
                  period=2, first=1),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=False, optimizer="adafactor", subquadratic=True,
    expert_shard="data",
)

REDUCED = ModelConfig(
    name="jamba-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512,
    pattern=_PATTERN, use_rope=False,
    moe=MoEConfig(n_experts=4, n_active=2, d_ff_expert=128,
                  period=2, first=1),
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    tie_embeddings=False, subquadratic=True,
)
