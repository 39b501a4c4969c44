"""Top-level model assembly: parameter trees, full-sequence forward and
prefill, and single-token decode over an explicit state tree. A copy of the
JAX package's `models/transformer.py` for five families: dense decoders
whose layers are GLOBAL_ATTN or LOCAL_ATTN (sliding-window) blocks with a
dense FFN (gemma2's alternation of the two included), MoE decoders whose
GLOBAL_ATTN blocks carry the MoE FFN of `models/moe.py` (the dense
dispatch; `forward(..., return_aux=True)` returns its load-balancing loss
as the reference's `forward` does), the SSM family's xLSTM, whose
MLSTM and SLSTM blocks carry their own projections (no FFN), the hybrid
(jamba), whose MAMBA and GLOBAL_ATTN blocks each carry a dense or MoE FFN,
and the VLM (llama-3.2-vision), whose CROSS_ATTN blocks attend to a
batch's `image_embeds` (B, n_img_tokens, d_model) through a tanh gate.

The reference runs the layer groups under `jax.lax.scan`; the port loops
over the stacked group axis in Python, so each layer's engine ops are
called (and captured into programs) one by one. Parameter and state trees
keep the reference's layout: `params["groups"][j]` stacks layer j of every
group on axis 0, and the decode state is `{"groups": {j: leaves}, "rem":
{}}`: an attention layer's `{"k", "v"}` of `(n_groups, B, max_len,
kv_heads, head_dim)` (a local layer's a ring of min(max_len, window_size)
slots, which the prefill fills with the prompt's last keys, rolled to the
slots pos % length, as the reference's), a cross layer's image cache of
`(n_groups, B, n_img_tokens, kv_heads, head_dim)` (filled by prefill,
read unchanged by decode), a Mamba or xLSTM layer's conv tail and fp32
memory (`models/ssm.py`), each stacked over the groups. Decode and prefill
write the state in place.

Parameter dtypes: the dense family's default is the config's
`param_dtype` (bf16 for every LM config), as in the reference; its
projections then run on bf16 operands (the bf16 GEMM kernel on "cuda"),
the norms, rope and attention scores promote to fp32 where the reference's
do, and the logits come out fp32. The hybrid's Mamba blocks take bf16
parameters too (jamba's default). The xLSTM keeps fp32 parameters: its
row-invariant decode sums were established in fp32, and bf16 xLSTM
parameters raise (ROADMAP queue 1, item 10). Caches are bf16
(`state_dtype`), as in the reference; the recurrent memory is fp32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch import engine
from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, MAMBA, MLSTM,
                                      SLSTM, ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.layers import (
    D_MODEL, VOCAB, DefTree, ParamDef, embed_def, embed_lookup, init_tree,
    layer_norm, resolve_device, rms_norm, shape_tree,
    stack_defs, tree_map, unembed)
from repro_torch.models.layers import params_from_jax  # noqa: F401 (re-exported)

SSM_KINDS = (MAMBA, MLSTM, SLSTM)
XLSTM_KINDS = (MLSTM, SLSTM)        # blocks with their own projections, no FFN
_SSM_DEFS = {MAMBA: ssm.mamba_defs, MLSTM: ssm.mlstm_defs,
             SLSTM: ssm.slstm_defs}
_SSM_FORWARD = {MAMBA: ssm.mamba_forward, MLSTM: ssm.mlstm_forward,
                SLSTM: ssm.slstm_forward}
_SSM_INIT = {MAMBA: ssm.mamba_init_state, MLSTM: ssm.mlstm_init_state,
             SLSTM: ssm.slstm_init_state}
_SSM_DECODE = {MAMBA: ssm.mamba_decode, MLSTM: ssm.mlstm_decode,
               SLSTM: ssm.slstm_decode}
# the layer kinds each family with recurrent blocks runs
_FAMILY_KINDS = {"ssm": SSM_KINDS, "hybrid": (MAMBA, GLOBAL_ATTN)}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's model code does not run yet: it runs dense
    and MoE decoders of GLOBAL_ATTN and LOCAL_ATTN layers, the VLM's
    GLOBAL_ATTN and CROSS_ATTN layers over precomputed image embeddings,
    the SSM family's Mamba, mLSTM and sLSTM blocks and the hybrid's
    (jamba's) MAMBA and GLOBAL_ATTN layers with a dense or MoE FFN; not
    MLA, front ends, encoders, a hybrid's LOCAL or CROSS layers or the
    other families."""
    recurrent = cfg.family in _FAMILY_KINDS
    if cfg.family not in ("dense", "moe", "ssm", "vlm", "hybrid") \
            or (cfg.family == "moe" and cfg.moe is None) \
            or (cfg.moe is not None and cfg.family not in ("moe", "hybrid")) \
            or recurrent != (cfg.ssm is not None):
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) is not ported to repro_torch yet: "
            "only dense, MoE, VLM and hybrid decoder LMs and the SSM family; "
            "see ROADMAP queue 1, item 10")
    for kind in cfg.layer_kinds:
        if recurrent and kind not in _FAMILY_KINDS[cfg.family]:
            raise NotImplementedError(
                f"{cfg.name}: {kind!r} layers of the {cfg.family} family are "
                "not ported to repro_torch yet; see ROADMAP queue 1, item 10")
        if kind in SSM_KINDS:
            if not recurrent:
                raise NotImplementedError(
                    f"{cfg.name}: {kind!r} layers run only in the SSM and "
                    "hybrid families; see ROADMAP queue 1, item 10")
            continue
        attn.check_supported(cfg, kind)
    if cfg.d_frontend or cfg.is_encoder:
        raise NotImplementedError(
            f"{cfg.name}: front ends (d_frontend, in_proj) and encoders are "
            "not ported to repro_torch yet; see ROADMAP queue 1, item 10")
    if (CROSS_ATTN in cfg.layer_kinds) != (cfg.family == "vlm") \
            or (cfg.family == "vlm") != bool(cfg.n_img_tokens):
        raise NotImplementedError(
            f"{cfg.name}: cross-attention layers and image tokens run only "
            "together, in the VLM family; see ROADMAP queue 1, item 10")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _norm_defs(cfg: ModelConfig, name: str) -> Dict[str, ParamDef]:
    if cfg.use_layer_norm:
        return {f"{name}_scale": ParamDef((cfg.d_model,), (D_MODEL,), "ones"),
                f"{name}_bias": ParamDef((cfg.d_model,), (D_MODEL,), "zeros")}
    return {f"{name}_scale": ParamDef(
        (cfg.d_model,), (D_MODEL,), "zeros" if cfg.scale_plus_one_norm
        else "ones")}


def _apply_norm(cfg: ModelConfig, p: Dict, name: str,
                x: torch.Tensor) -> torch.Tensor:
    if cfg.use_layer_norm:
        return layer_norm(x, p[f"{name}_scale"], p[f"{name}_bias"],
                          cfg.norm_eps)
    # the recurrent families' norms sum in a fixed order: their decode
    # carries a recurrent state, and served tokens are held bitwise against
    # a one-row decode
    return rms_norm(x, p[f"{name}_scale"], cfg.norm_eps,
                    scale_plus_one=cfg.scale_plus_one_norm,
                    fixed_order=cfg.family in _FAMILY_KINDS)


def block_defs(cfg: ModelConfig, kind: str, use_moe: bool) -> DefTree:
    defs: Dict[str, Any] = {}
    defs.update(_norm_defs(cfg, "pre"))
    if kind in SSM_KINDS:
        defs[kind] = _SSM_DEFS[kind](cfg)
    else:
        defs["attn"] = attn.attention_defs(cfg, kind)
    if cfg.post_block_norm:
        defs.update(_norm_defs(cfg, "post"))
    if _has_ffn(cfg, kind, use_moe):
        defs.update(_norm_defs(cfg, "pre_ffn"))
        if use_moe:
            defs["moe"] = moe_mod.moe_defs(cfg)
        else:
            defs["ffn"] = ffn_mod.ffn_defs(cfg)
        if cfg.post_block_norm:
            defs.update(_norm_defs(cfg, "post_ffn"))
    return defs


def _has_ffn(cfg: ModelConfig, kind: str, use_moe: bool) -> bool:
    """A dense or MoE FFN after the mixer: for attention and Mamba blocks,
    not for the xLSTM blocks, which carry their own projections."""
    return (cfg.d_ff > 0 or use_moe) and kind not in XLSTM_KINDS


def _group_layout(cfg: ModelConfig) -> Tuple[List[Tuple[str, bool]],
                                             List[Tuple[str, bool]]]:
    """Static (kind, use_moe) per position: (group pattern, remainder)."""
    kinds = cfg.layer_kinds
    rem_n = len(cfg.remainder)
    if cfg.remainder_first:
        rem_idx = range(rem_n)
        grp_idx = range(rem_n, rem_n + len(cfg.pattern))
    else:
        rem_idx = range(cfg.n_layers - rem_n, cfg.n_layers)
        grp_idx = range(len(cfg.pattern))
    group = [(kinds[i], cfg.is_moe_layer(i)) for i in grp_idx]
    rem = [(kinds[i], cfg.is_moe_layer(i)) for i in rem_idx]
    for g in range(cfg.n_groups):
        base = (rem_n if cfg.remainder_first else 0) + g * len(cfg.pattern)
        for j in range(len(cfg.pattern)):
            if (kinds[base + j], cfg.is_moe_layer(base + j)) != group[j]:
                raise ValueError(
                    f"group layout not uniform at layer {base + j}")
    return group, rem


def model_defs(cfg: ModelConfig) -> DefTree:
    check_supported(cfg)
    group, rem = _group_layout(cfg)
    defs: Dict[str, Any] = {"embed": embed_def(cfg.vocab_size, cfg.d_model)}
    group_defs = {str(j): block_defs(cfg, k, m)
                  for j, (k, m) in enumerate(group)}
    defs["groups"] = stack_defs(group_defs, cfg.n_groups)
    defs["rem"] = {str(j): block_defs(cfg, k, m)
                   for j, (k, m) in enumerate(rem)}
    defs.update(_norm_defs(cfg, "final"))
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size),
                                   (D_MODEL, VOCAB))
    return defs


def param_dtype(cfg: ModelConfig,
                dtype: Optional[torch.dtype] = None) -> torch.dtype:
    """The parameters' dtype: `dtype` when given, else the config's
    `param_dtype`, and fp32 for the xLSTM, which takes no other."""
    if any(kind in XLSTM_KINDS for kind in cfg.layer_kinds):
        if dtype not in (None, torch.float32):
            raise NotImplementedError(
                f"{cfg.name}: {dtype} xLSTM parameters are not ported (its "
                "decode sums are row-invariant in fp32); see ROADMAP queue 1, "
                "item 10")
        return torch.float32
    return dtype if dtype is not None else getattr(torch, cfg.param_dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device=None,
                dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Random parameters in `param_dtype(cfg, dtype)` on `device` (default:
    the GPU; raises when there is none), drawn in fp32 by a
    `torch.Generator` on that device seeded with `seed`, then cast one leaf
    at a time. A GPU's generator draws other numbers than the host's."""
    dev = resolve_device(device)
    return init_tree(model_defs(cfg), torch.Generator(device=dev).manual_seed(seed),
                     param_dtype(cfg, dtype), dev)


def param_shapes(cfg: ModelConfig,
                 dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The parameter tree as `meta` tensors in `param_dtype(cfg, dtype)`:
    shapes and dtypes, no storage."""
    return shape_tree(model_defs(cfg), param_dtype(cfg, dtype))


def _layer(tree: Any, i: int) -> Any:
    """Layer i of a tree stacked over the groups (views, no copies)."""
    return tree_map(lambda a: a[i], tree)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _mixer_forward(cfg: ModelConfig, kind: str, p: Dict, h: torch.Tensor,
                   positions: torch.Tensor, img: Optional[torch.Tensor],
                   state_dtype) -> Tuple[Any, Any]:
    """The block's sequence mixer on the normed input. Returns (sub, piece):
    for self attention the (k, v) it computed; for cross attention, when
    `state_dtype` is given, the image's (k, v) projected a second time for
    the decode cache, as the reference's prefill does (else None); for a
    recurrent (Mamba or xLSTM) block its decode state when `state_dtype` is
    given (the conv tail in that dtype), else None."""
    if kind in SSM_KINDS:
        fwd = _SSM_FORWARD[kind]
        if state_dtype is None:
            return fwd(cfg, p[kind], h), None
        return fwd(cfg, p[kind], h, return_state=True,
                   state_dtype=state_dtype)
    sub, kv = attn.attention_forward(cfg, p["attn"], h, positions, kind,
                                     img_embeds=img)
    if kind == CROSS_ATTN and state_dtype is not None:
        kv = tuple(attn._split_heads(engine.proj(img, p["attn"][w]),
                                     cfg.n_kv_heads) for w in ("wk", "wv"))
    return sub, kv


def _ffn_residual(cfg: ModelConfig, kind: str, use_moe: bool, p: Dict,
                  x: torch.Tensor, decode: bool = False,
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The FFN's residual step. Returns (x, aux): an MoE layer's
    load-balancing loss, else None. A decode step runs the MoE's dense
    dispatch, a full sequence `moe_forward`, as the reference does."""
    aux = None
    if _has_ffn(cfg, kind, use_moe):
        h = _apply_norm(cfg, p, "pre_ffn", x)
        if use_moe:
            moe_fn = moe_mod.moe_forward_dense if decode \
                else moe_mod.moe_forward
            sub, aux = moe_fn(cfg, p["moe"], h)
        else:
            sub = ffn_mod.ffn_forward(cfg, p["ffn"], h)
        if cfg.post_block_norm:
            sub = _apply_norm(cfg, p, "post_ffn", sub)
        x = x + sub
    return x, aux


def block_forward(cfg: ModelConfig, kind: str, use_moe: bool, p: Dict,
                  x: torch.Tensor, positions: torch.Tensor,
                  img_embeds: Optional[torch.Tensor] = None,
                  state_dtype: Optional[torch.dtype] = None,
                  ) -> Tuple[torch.Tensor, Any, Optional[torch.Tensor]]:
    """One residual block. Returns (x, piece, aux): the mixer's (k, v) for
    a self-attention layer, the image cache's (k, v) for a cross layer and
    its decode state for a recurrent layer when `state_dtype` is given (else
    None); an MoE layer's load-balancing loss (else None)."""
    h = _apply_norm(cfg, p, "pre", x)
    sub, piece = _mixer_forward(cfg, kind, p, h, positions, img_embeds,
                                state_dtype)
    if cfg.post_block_norm:
        sub = _apply_norm(cfg, p, "post", sub)
    x, aux = _ffn_residual(cfg, kind, use_moe, p, x + sub)
    return x, piece, aux


def embed_inputs(cfg: ModelConfig, params: Dict, batch: Dict,
                 ) -> Tuple[torch.Tensor, torch.Tensor,
                            Optional[torch.Tensor]]:
    """-> (x, positions, img), from `batch["tokens"]` (B, S), optional
    `batch["positions"]` and, for a VLM, `batch["image_embeds"]` (B,
    n_img_tokens, d_model) (None for the other families). Images narrower
    than the parameters (bf16 beside fp32) are widened to their dtype,
    exactly, where the reference's products promote them; the kernels take
    one dtype. The reference's `in_proj` of the image applies only with a
    `d_frontend`, which `check_supported` refuses."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = embed_lookup(params["embed"], tokens, scale_by_dim=cfg.scale_embed)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    img = None
    if cfg.n_img_tokens:
        img = batch.get("image_embeds")
        want = (b, cfg.n_img_tokens, cfg.d_model)
        if img is None or tuple(img.shape) != want:
            raise ValueError(
                f"{cfg.name}: a batch needs image_embeds of shape {want}, got "
                f"{None if img is None else tuple(img.shape)}")
        if torch.promote_types(img.dtype, x.dtype) == x.dtype:
            img = img.to(x.dtype)
    return x, positions, img


def _blocks(cfg: ModelConfig):
    """(params path, layer index or None, kind, use_moe) of every layer in
    execution order: the remainder before or after the stacked groups."""
    group, rem = _group_layout(cfg)
    rem_steps = [(("rem", str(j)), None, k, m) for j, (k, m) in enumerate(rem)]
    grp_steps = [(("groups", str(j)), i, k, m)
                 for i in range(cfg.n_groups) for j, (k, m) in enumerate(group)]
    return (rem_steps + grp_steps if cfg.remainder_first
            else grp_steps + rem_steps)


def _at(tree: Dict, path, i: Optional[int]) -> Any:
    sub = tree[path[0]][path[1]]
    return sub if i is None else _layer(sub, i)


def forward(cfg: ModelConfig, params: Dict, batch: Dict,
            return_aux: bool = False):
    """Full-sequence forward. Returns the final hidden state (B, S, D), or
    with `return_aux` the reference's (hidden, aux): the MoE layers'
    load-balancing losses summed in layer order (fp32 zero without MoE)."""
    x, positions, img = embed_inputs(cfg, params, batch)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for path, i, kind, use_moe in _blocks(cfg):
        x, _, aux = block_forward(cfg, kind, use_moe, _at(params, path, i),
                                  x, positions, img)
        if aux is not None:
            aux_total = aux_total + aux
    x = _apply_norm(cfg, params, "final", x)
    return (x, aux_total) if return_aux else x


def logits_fn(cfg: ModelConfig, params: Dict,
              hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = unembed(hidden, params["embed"])
    else:
        logits = engine.dense(hidden, params["lm_head"])
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# Decode state (grouped layout mirroring the parameter tree)
# ---------------------------------------------------------------------------

def init_decode_state(cfg: ModelConfig, batch: int, max_len: int,
                      dtype: torch.dtype = torch.bfloat16,
                      device=None) -> Dict:
    """Zero decode state: {"groups": {j: leaves stacked over n_groups},
    "rem": {j: leaves}} (on `device`; `meta` for shapes alone)."""
    check_supported(cfg)
    group, rem = _group_layout(cfg)
    g = cfg.n_groups

    def layer_state(kind):
        if kind in SSM_KINDS:
            return _SSM_INIT[kind](cfg, batch, dtype, device)
        if kind == CROSS_ATTN:
            return attn.init_cross_cache(cfg, batch, dtype, device)
        return attn.init_kv_cache(cfg, kind, batch, max_len, dtype, device)

    state: Dict[str, Any] = {"groups": {}, "rem": {}}
    for j, (kind, _) in enumerate(group):
        state["groups"][str(j)] = tree_map(
            lambda a: a.unsqueeze(0).repeat((g,) + (1,) * a.ndim),
            layer_state(kind))
    for j, (kind, _) in enumerate(rem):
        state["rem"][str(j)] = layer_state(kind)
    return state


# ---------------------------------------------------------------------------
# Decode (one token against the grouped state)
# ---------------------------------------------------------------------------

def _write_state(st: Dict, new: Dict) -> None:
    """Copy a layer's new state into its (stacked) state leaves, in place."""
    for key, val in new.items():
        st[key].copy_(val)


def _block_decode(cfg: ModelConfig, kind: str, use_moe: bool, p: Dict,
                  st: Dict, x: torch.Tensor, pos: torch.Tensor,
                  ) -> torch.Tensor:
    """One residual block for one token; updates the layer's state `st` in
    place."""
    h = _apply_norm(cfg, p, "pre", x)
    if kind in SSM_KINDS:
        sub, new = _SSM_DECODE[kind](cfg, p[kind], h, st)
        _write_state(st, new)
    else:
        sub, _ = attn.attention_decode(cfg, p["attn"], h, st, pos, kind)
    if cfg.post_block_norm:
        sub = _apply_norm(cfg, p, "post", sub)
    return _ffn_residual(cfg, kind, use_moe, p, x + sub, decode=True)[0]


def decode_step(cfg: ModelConfig, params: Dict, state: Dict,
                tokens: torch.Tensor, pos) -> Tuple[torch.Tensor, Dict]:
    """One decode step. tokens: (B, 1) int; pos: a scalar absolute
    position, or a (B,) int vector of per-row positions (continuous
    batching; see `attention.attention_decode`; the recurrent blocks read no
    position). Writes each layer's new key and value, or its new recurrent
    state, into `state` in place and returns (logits (B, 1, V), state)."""
    x = embed_lookup(params["embed"], tokens, scale_by_dim=cfg.scale_embed)
    for path, i, kind, use_moe in _blocks(cfg):
        x = _block_decode(cfg, kind, use_moe, _at(params, path, i),
                          _at(state, path, i), x, pos)
    x = _apply_norm(cfg, params, "final", x)
    return logits_fn(cfg, params, x), state


# ---------------------------------------------------------------------------
# Prefill (full sequence, filling the grouped state)
# ---------------------------------------------------------------------------

def _block_prefill(cfg: ModelConfig, kind: str, use_moe: bool, p: Dict,
                   st: Dict, x: torch.Tensor, positions: torch.Tensor,
                   img: Optional[torch.Tensor],
                   state_dtype: torch.dtype) -> torch.Tensor:
    """One residual block; writes its state into `st` in place: k and v
    (cast to the cache dtype) into the first S slots for self attention
    (into a local layer's shorter ring, its last keys rolled by S %
    length, so that position p lands at slot p % length) and into the
    whole image cache for cross attention, the whole recurrent state (conv
    tail in the cache dtype) for Mamba and xLSTM."""
    x, piece, _ = block_forward(cfg, kind, use_moe, p, x, positions, img,
                                state_dtype=state_dtype)
    if kind in SSM_KINDS:
        _write_state(st, piece)
    else:
        k, v = piece
        n, cl = k.shape[1], st["k"].shape[1]
        if cl < n:                      # SWA ring cache: keep the tail
            k = torch.roll(k[:, -cl:], shifts=n % cl, dims=1)
            v = torch.roll(v[:, -cl:], shifts=n % cl, dims=1)
            n = cl
        st["k"][:, :n] = k.to(st["k"].dtype)
        st["v"][:, :n] = v.to(st["v"].dtype)
    return x


def prefill(cfg: ModelConfig, params: Dict, batch: Dict, max_len: int,
            state_dtype: torch.dtype = torch.bfloat16,
            ) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence prefill filling a fresh decode state of `max_len`
    slots. Returns (last-token logits (B, V), state)."""
    x, positions, img = embed_inputs(cfg, params, batch)
    if x.shape[1] > max_len:
        raise ValueError(f"prompt of {x.shape[1]} tokens exceeds "
                         f"max_len={max_len}")
    state = init_decode_state(cfg, x.shape[0], max_len, state_dtype,
                              x.device)
    for path, i, kind, use_moe in _blocks(cfg):
        x = _block_prefill(cfg, kind, use_moe, _at(params, path, i),
                           _at(state, path, i), x, positions, img,
                           state_dtype)
    x = _apply_norm(cfg, params, "final", x)
    return logits_fn(cfg, params, x[:, -1]), state
