"""xlstm-125m — sLSTM + mLSTM blocks (xLSTM[5:1] layout).

[arXiv:2405.04517] 12L d_model=768 4H vocab=50304, d_ff=0 (the blocks carry
their own up/down projections). A copy of the JAX package's config.
"""
from repro_torch.configs.base import MLSTM, SLSTM, ModelConfig, SSMConfig

_PATTERN = (MLSTM,) * 5 + (SLSTM,)

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab_size=50304,
    pattern=_PATTERN,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    tie_embeddings=True, attn_shard="seq", subquadratic=True,
)

REDUCED = ModelConfig(
    name="xlstm-reduced", family="ssm",
    n_layers=6, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=256,
    pattern=_PATTERN,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2),
    tie_embeddings=True, attn_shard="seq", subquadratic=True,
)
