"""Config system: model configs and the registry.

A copy of the JAX package's `configs/base.py` with the dtypes kept as
names (`param_dtype="bfloat16"`) and no array library imported: every
architecture is a frozen `ModelConfig`, `get_config(name)` resolves it and
`reduced(name)` gives its CPU smoke-test variant (same family and pattern,
tiny dims). Only the configs this port runs are registered; asking for
another raises, naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Tuple

# Layer kinds appearing in superblock patterns.
GLOBAL_ATTN, LOCAL_ATTN, MAMBA, MLSTM, SLSTM, CROSS_ATTN = (
    "global", "local", "mamba", "mlstm", "slstm", "cross")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention dims."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba / xLSTM state-space dims."""
    d_state: int = 16
    d_conv: int = 4          # GFID 1-D conv mode: W_f=4, S=1, T=4
    expand: int = 2
    dt_rank: int = 0         # 0 -> ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    n_active: int = 0
    d_ff_expert: int = 0
    n_shared: int = 0
    # which layers carry MoE FFN: every `period`-th starting at `first`.
    period: int = 1
    first: int = 0
    router_noise: float = 0.0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | vlm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern: repeated superblock + optional remainder
    pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    remainder: Tuple[str, ...] = ()
    remainder_first: bool = False
    use_rope: bool = True
    # attention details
    window_size: int = 0            # sliding window for LOCAL_ATTN layers
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0
    qk_norm: bool = False
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    attn_bias: bool = False
    mla: Optional[MLAConfig] = None
    # ffn
    act: str = "silu"
    gated_ffn: bool = True          # SwiGLU-style (False -> plain MLP)
    moe: Optional[MoEConfig] = None
    # ssm
    ssm: Optional[SSMConfig] = None
    # modality
    is_encoder: bool = False
    n_img_tokens: int = 0
    d_frontend: int = 0
    # norm / embedding
    norm_eps: float = 1e-6
    scale_embed: bool = False       # gemma: embed * sqrt(d_model)
    scale_plus_one_norm: bool = False  # gemma RMSNorm (1 + w)
    tie_embeddings: bool = True
    use_layer_norm: bool = False
    post_block_norm: bool = False
    # numerics / optimizer policy
    param_dtype: str = "bfloat16"
    optimizer: str = "adamw"
    # sharding policy knobs
    attn_shard: str = "heads"
    expert_shard: str = "data"
    # serving
    supports_decode: bool = True
    subquadratic: bool = False

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        n_rep = (self.n_layers - len(self.remainder)) // len(self.pattern)
        body = self.pattern * n_rep
        kinds = (tuple(self.remainder) + body if self.remainder_first
                 else body + tuple(self.remainder))
        if len(kinds) != self.n_layers:
            raise ValueError(f"{self.name}: pattern and remainder give "
                             f"{len(kinds)} layers, not {self.n_layers}")
        return tuple(kinds)

    @property
    def n_groups(self) -> int:
        return (self.n_layers - len(self.remainder)) // len(self.pattern)

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return i >= self.moe.first and (i - self.moe.first) % self.moe.period == 0

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim


# The configs this port runs; the rest of the reference's registry comes
# with their model families.
PORTED = ("smollm_135m", "xlstm_125m", "granite_moe_1b",
          "llama32_vision_11b", "gemma2_27b")

ALIASES = {"smollm-135m": "smollm_135m", "xlstm-125m": "xlstm_125m",
           "granite-moe-1b-a400m": "granite_moe_1b",
           "llama-3.2-vision-11b": "llama32_vision_11b",
           "gemma2-27b": "gemma2_27b"}


def _module(name: str):
    name = ALIASES.get(name, name).replace("-", "_")
    if name not in PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported to repro_torch yet (ported: "
            f"{PORTED}); see ROADMAP queue 1, item 10 (other model families)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def reduced(name: str) -> ModelConfig:
    """CPU smoke-test variant of an arch: same family & pattern, tiny dims."""
    return _module(name).REDUCED
