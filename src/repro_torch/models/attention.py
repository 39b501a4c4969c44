"""Attention: GQA with global or sliding-window causal masking and the
VLM's gated cross attention, full-sequence (prefill) and single-token
(decode) paths. A copy of the JAX package's `models/attention.py` for
GLOBAL_ATTN, LOCAL_ATTN and CROSS_ATTN layers.

All projections are FC-mode GEMMs of the multi-mode engine; the score and
value contractions are plain tensor ops, as in the reference, in fp32 with
TF32 off. A prefill over 1024 tokens (the query's length) runs the chunked
attention of `models/flash.py` instead of the dense one, as the reference
does; on the "cuda" backend that is the hand-written flash kernel, for a
cross layer at Sq = the prompt against Skv = the image tokens, not causal.
A cross layer's keys and values come from the image embeddings, without
rope; its output is scaled by tanh(gate) and its decode reads the image
K/V cache that the prefill filled. A LOCAL_ATTN layer sees the keys less
than `window_size` positions behind the query, on both paths (the kernels
take the window and visit only its band); its decode cache is a ring of
min(max_len, window_size) slots, written at pos % length and masked by
age, as the reference's. qk-norm (qwen3, gemma3) normalises each head of
q and k before rope; gemma3's local layers take their own rope theta
(`_rope_theta`). `chunked_attention` is the reference's plain scan
formulation of the same contraction; no model path calls it, in either
package. Not ported (it raises, naming its ROADMAP item): MLA.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch import engine
from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      ModelConfig)
from repro_torch.core.quant import no_tf32
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (D_MODEL, HEADS, ParamDef, apply_rope,
                                       rms_norm)

NEG_INF = -2.0e38


def check_supported(cfg: ModelConfig, kind: str) -> None:
    """Raise for what this slice does not port."""
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported to repro_torch "
                                  "yet; see ROADMAP queue 1, item 10")
    if kind not in (GLOBAL_ATTN, LOCAL_ATTN, CROSS_ATTN):
        raise NotImplementedError(
            f"{kind!r} layers are not ported to repro_torch yet (attention "
            "layers: global, local and cross); see ROADMAP queue 1, item 10")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig, kind: str) -> Dict[str, ParamDef]:
    check_supported(cfg, kind)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": ParamDef((d, h * hd), (D_MODEL, HEADS)),
        "wk": ParamDef((d, kv * hd), (D_MODEL, None)),
        "wv": ParamDef((d, kv * hd), (D_MODEL, None)),
        "wo": ParamDef((h * hd, d), (HEADS, D_MODEL)),
    }
    if cfg.qk_norm:
        defs["q_norm"] = ParamDef((hd,), (None,), "ones")
        defs["k_norm"] = ParamDef((hd,), (None,), "ones")
    if kind == CROSS_ATTN:
        dv = cfg.d_frontend or cfg.d_model
        defs["wk"] = ParamDef((dv, kv * hd), (D_MODEL, None))
        defs["wv"] = ParamDef((dv, kv * hd), (D_MODEL, None))
        defs["gate"] = ParamDef((1,), (None,), "zeros")   # tanh-gated residual
        defs["k_norm_cross"] = ParamDef((hd,), (None,), "ones")
    return defs


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, -1)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, softcap_val: float = 0.0,
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """O(S^2)-memory attention. q: (B, Sq, H, Dk); k: (B, Skv, KV, Dk);
    v: (B, Skv, KV, Dv) -> (B, Sq, H, Dv), in q's dtype. Query i sits at
    position i + q_offset; `window` keeps the keys less than `window`
    positions behind it."""
    b, sq, h, dk = q.shape
    _, skv, n_kv, dv = v.shape
    g = h // n_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    qg = q.reshape(b, sq, n_kv, g, dk)
    with no_tf32():
        s = torch.einsum("bskgd,bukd->bkgsu", qg.float(), k.float()) * scale
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        if causal or window:
            qp = torch.arange(sq, device=q.device) + q_offset
            kp = torch.arange(skv, device=q.device)
            mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window:
                mask &= qp[:, None] - kp[None, :] < window
            s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgsu,bukd->bskgd", p, v.float())
    return o.reshape(b, sq, h, dv).to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, softcap_val: float = 0.0,
                      q_offset: int = 0, q_chunk: int = 512,
                      kv_chunk: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over kv chunks inside a loop over q chunks,
    with no (Sq, Skv) score matrix: the reference's `chunked_attention`
    (its two `lax.scan`s as Python loops, in the same order). q: (B, Sq,
    H, Dk); k: (B, Skv, KV, Dk); v: (B, Skv, KV, Dv) -> (B, Sq, H, Dv) in
    q's dtype; query i sits at position i + q_offset. Both lengths are
    padded to whole chunks; padded keys are masked, padded queries cut."""
    b, sq, h, dk = q.shape
    _, skv, n_kv, dv = v.shape
    g = h // n_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    nq, nkv = -(-sq // q_chunk), -(-skv // kv_chunk)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - sq))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nkv * kv_chunk - skv))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nkv * kv_chunk - skv))
    qc = q.reshape(b, nq, q_chunk, n_kv, g, dk).float()
    kc = k.reshape(b, nkv, kv_chunk, n_kv, dk).float()
    vc = v.reshape(b, nkv, kv_chunk, n_kv, dv).float()
    dev = q.device
    kv_pos = torch.arange(nkv * kv_chunk, device=dev).reshape(nkv, kv_chunk)
    neg = torch.full((), NEG_INF, device=dev)
    outs = []
    with no_tf32():
        for i in range(nq):
            qp = torch.arange(q_chunk, device=dev) + i * q_chunk + q_offset
            o = torch.zeros((b, n_kv, g, q_chunk, dv), device=dev)
            m_run = torch.full((b, n_kv, g, q_chunk), NEG_INF, device=dev)
            l_run = torch.zeros((b, n_kv, g, q_chunk), device=dev)
            for j in range(nkv):
                kp = kv_pos[j]
                s = torch.einsum("bckgd,bukd->bkgcu", qc[:, i],
                                 kc[:, j]) * scale
                if softcap_val:
                    s = softcap_val * torch.tanh(s / softcap_val)
                mask = (kp < skv)[None, :].expand(q_chunk, kv_chunk)
                if causal:
                    mask = mask & (qp[:, None] >= kp[None, :])
                if window:
                    mask = mask & (qp[:, None] - kp[None, :] < window)
                s = torch.where(mask, s, neg)
                m_new = torch.maximum(m_run, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m_run - m_new)
                l_run = l_run * alpha + p.sum(dim=-1)
                o = o * alpha[..., None] + torch.einsum(
                    "bkgcu,bukd->bkgcd", p, vc[:, j])
                m_run = m_new
            o = o / torch.clamp(l_run[..., None], min=1e-37)
            outs.append(o.permute(0, 3, 1, 2, 4))          # (B, C, KV, g, Dv)
    out = torch.stack(outs, dim=1).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq].to(q.dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------

def attention_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      positions: torch.Tensor, kind: str,
                      img_embeds: Optional[torch.Tensor] = None,
                      use_chunked: Optional[bool] = None,
                      ) -> Tuple[torch.Tensor,
                                 Optional[Tuple[torch.Tensor, torch.Tensor]]]:
    """Returns (out, kv): a self-attention layer's (k, v), so prefill can
    seed the cache; None for a cross layer, whose keys and values are
    projected from `img_embeds` (B, n_img, d_model) without rope and
    attended without a mask. The attention is chunked (`models/flash.py`)
    when `use_chunked` says so, else past 1024 query tokens, as in the
    reference."""
    check_supported(cfg, kind)
    b, s, _ = x.shape
    hd = cfg.head_dim
    cross = kind == CROSS_ATTN
    q = _split_heads(engine.proj(x, p["wq"]), cfg.n_heads)
    if cross and img_embeds is None:
        raise ValueError("a cross-attention layer needs img_embeds")
    src = img_embeds if cross else x
    k = _split_heads(engine.proj(src, p["wk"]), cfg.n_kv_heads)
    v = _split_heads(engine.proj(src, p["wv"]), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm_cross" if cross else "k_norm"],
                     cfg.norm_eps)
    if cfg.use_rope and not cross:
        theta = _rope_theta(cfg, kind)
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    chunked = use_chunked if use_chunked is not None else s > 1024
    fn = flash_attention if chunked else dense_attention
    o = fn(q, k, v, causal=not (cross or cfg.is_encoder),
           window=_window(cfg, kind), softcap_val=cfg.attn_softcap)
    out = engine.proj(o.reshape(b, s, cfg.n_heads * hd), p["wo"])
    if cross:
        return _gated(out, p["gate"]), None
    return out, (k, v)


def _window(cfg: ModelConfig, kind: str) -> int:
    """A local layer's sliding window; 0 (none) for the other kinds."""
    return cfg.window_size if kind == LOCAL_ATTN else 0


def _rope_theta(cfg: ModelConfig, kind: str) -> float:
    """The reference's choice: a local layer's own theta where the config
    sets one (gemma3), else the config's."""
    return (cfg.rope_theta_local
            if (kind == LOCAL_ATTN and cfg.rope_theta_local)
            else cfg.rope_theta)


def _gated(out: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """A cross layer's output scaled by tanh(gate): tanh in fp32, cast to
    the output's dtype, then the product, in the reference's order."""
    return torch.tanh(gate.float()).to(out.dtype) * out


# ---------------------------------------------------------------------------
# Decode (single new token against a cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zero cache for one attention layer (`meta` tensors on the `meta`
    device): `max_len` slots, or for a local layer a ring of
    min(max_len, window_size)."""
    check_supported(cfg, kind)
    window = _window(cfg, kind)
    shape = (batch, min(max_len, window) if window else max_len,
             cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cross_cache(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    """Zero image K/V cache for one cross layer: (B, n_img_tokens,
    kv_heads, head_dim) each, filled once by prefill."""
    shape = (batch, cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _decode_core(qg: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                 pos: torch.Tensor, softcap_val: float,
                 window: int = 0) -> torch.Tensor:
    """Scores, exact mask, softmax and weighted sum of one decode token per
    row. qg (B, KV, g, hd) fp32; ck, cv (B, L, KV, hd) in the cache dtype,
    upcast exactly to fp32 (the reference's einsum promotes the same way);
    pos (B,). With a `window`, the cache is a ring written at pos % L: slot
    i is valid when its age (pos % L - i) % L is under the window and at
    most pos. Row-wise: row b reads only row b of each input."""
    hd = qg.shape[-1]
    with no_tf32():
        s = torch.einsum("bkgd,bukd->bkgu", qg, ck.float()) / math.sqrt(hd)
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        cache_len = ck.shape[1]
        idx = torch.arange(cache_len, device=ck.device)
        if window:
            age = (pos[:, None] % cache_len - idx[None, :]) % cache_len
            valid = (age < window) & (age <= pos[:, None])
        else:
            valid = idx[None, :] <= pos[:, None]
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
        pr = torch.softmax(s, dim=-1)
        return torch.einsum("bkgu,bukd->bkgd", pr, cv.float())


def attention_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, cache: Dict,
                     pos: torch.Tensor, kind: str,
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); pos: a scalar int position, or a (B,) int vector of
    per-row positions (continuous batching: every row at its own depth).
    Writes the new key and value into `cache` in place (row b at slot
    pos[b], or pos[b] % the ring's length for a local layer, cast to the
    cache dtype) and returns (out, cache). A cross layer attends to its
    image cache (`init_cross_cache`) and returns it unchanged.

    A scalar position runs as the vector of B copies of it, so the two
    paths are the same arithmetic. Masked scores are NEG_INF, whose softmax
    weight is exactly 0.0 in fp32, so the slots past `pos` (zeros in a
    dense cache, recycled blocks in a paged one) contribute exactly 0."""
    check_supported(cfg, kind)
    b = x.shape[0]
    hd = cfg.head_dim
    q = _split_heads(engine.proj(x, p["wq"]), cfg.n_heads)
    if kind == CROSS_ATTN:
        # the image keys and values were projected at prefill and stay
        # in the cache unchanged; no rope, no mask
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        o = dense_attention(q, cache["k"], cache["v"], causal=False,
                            softcap_val=cfg.attn_softcap)
        out = engine.proj(o.reshape(b, 1, cfg.n_heads * hd), p["wo"])
        return _gated(out, p["gate"]), cache
    k = _split_heads(engine.proj(x, p["wk"]), cfg.n_kv_heads)
    v = _split_heads(engine.proj(x, p["wv"]), cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    pos = torch.as_tensor(pos, device=x.device)
    posv = (pos.expand(b) if pos.ndim == 0 else pos).long()
    if cfg.use_rope:
        theta = _rope_theta(cfg, kind)
        q = apply_rope(q, posv[:, None], theta)
        k = apply_rope(k, posv[:, None], theta)

    window = _window(cfg, kind)
    ck, cv = cache["k"], cache["v"]
    slot = posv % ck.shape[1] if window else posv      # ring buffer for SWA
    rows = torch.arange(b, device=x.device)
    ck.index_put_((rows, slot), k[:, 0].to(ck.dtype))
    cv.index_put_((rows, slot), v[:, 0].to(cv.dtype))

    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, g, hd).float()
    o = _decode_core(qg, ck, cv, posv, cfg.attn_softcap, window)
    out = engine.proj(o.reshape(b, 1, cfg.n_heads * hd).to(x.dtype), p["wo"])
    return out, cache
