"""Memory-bounded attention: the forward of the JAX package's
`models/flash.py::flash_attention_jnp`, the chunked prefill that
`attention_forward` switches to past 1024 tokens.

Layout q (B, Sq, H, Dk), k/v (B, Skv, KV, D), GQA by head grouping. The
reference's forward runs an online softmax over kv chunks inside a loop
over q chunks, pads both to whole chunks (padded keys masked by position),
and supports causal and sliding-window masks, a logit softcap and a q
position offset; a causal window visits only the kv chunks of its band.
Masked scores are NEG_INF = -2e38 and the softmax sum is clamped at 1e-37.

Backends (the ambient `EngineConfig`):
  * "cuda"  — global attention (no window, softcap or q offset) is one
    launch of the hand-written kernel (`kernels.ops.flash_attention`):
    causal self attention, or a cross layer's unmasked attention of Sq
    prompt tokens against Skv image tokens (the kernel takes the two
    lengths apart); the rest raises `NotImplementedError` (ROADMAP queue
    1, item 8), never a quiet run of the plain version;
  * "torch" and "ref" — the chunked forward below, in plain torch ops (fp32
    with TF32 off), which also runs on `meta` tensors for program capture.

Forward only: the reference's custom VJP (its memory-bounded backward) is
ROADMAP queue 1, item 13. Attention is no engine op, as in the reference,
so a program's recorded ops do not change with this path.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant import no_tf32
from repro_torch.engine.config import current_config
from repro_torch.kernels import ops

NEG_INF = -2.0e38


def _mask(qp: torch.Tensor, kp: torch.Tensor, kval: torch.Tensor,
          causal: bool, window: int) -> torch.Tensor:
    m = kval[None, :]
    if causal:
        m = m & (qp[:, None] >= kp[None, :])
    if window:
        m = m & (qp[:, None] - kp[None, :] < window)
    return m


def _online_softmax(qb: torch.Tensor, kv_blocks, qp: torch.Tensor,
                    causal: bool, window: int, softcap_val: float,
                    scale: float, skv_orig: int, dv: int) -> torch.Tensor:
    """One q chunk qb (B, KV, G, C, Dk) against the kv chunks of
    `kv_blocks`, an iterable of (kb (B, KV, U, Dk), vb (B, KV, U, Dv),
    kp (U,) key positions): the normalized fp32 output (B, KV, G, C, Dv)."""
    dev = qb.device
    o = torch.zeros(qb.shape[:-1] + (dv,), device=dev)
    m_run = torch.full(qb.shape[:-1], NEG_INF, device=dev)
    l_run = torch.zeros(qb.shape[:-1], device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for kb, vb, kp in kv_blocks:
        s = torch.einsum("bkgcd,bkud->bkgcu", qb, kb) * scale
        if softcap_val:
            s = softcap_val * torch.tanh(s / softcap_val)
        s = torch.where(_mask(qp, kp, kp < skv_orig, causal, window),
                        s, neg)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m_run - m_new)
        l_run = l_run * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bkgcu,bkud->bkgcd", p, vb)
        m_run = m_new
    return o / torch.clamp(l_run[..., None], min=1e-37)


def _chunked_forward(qg, kg, vg, causal, window, softcap_val, q_offset,
                     q_chunk, kv_chunk, scale, skv_orig, windowed, out_dtype):
    """The reference's `_fwd_impl` (every kv chunk) or `_win_fwd` (the band
    of `n_rel` chunks around each q chunk) on padded, grouped fp32 tensors:
    qg (B, KV, G, Sq_pad, Dk), kg/vg (B, KV, Skv_pad, D). Returns
    (B, KV, G, Sq_pad, Dv), each q chunk rounded to `out_dtype` as the
    reference rounds it."""
    sq, skv = qg.shape[3], kg.shape[2]
    nkv = skv // kv_chunk
    dev = qg.device

    def chunk(ci):
        lo = ci * kv_chunk
        return (kg[:, :, lo:lo + kv_chunk], vg[:, :, lo:lo + kv_chunk],
                torch.arange(lo, lo + kv_chunk, device=dev))

    n_rel = min(nkv, (window + 2 * q_chunk - 2) // q_chunk + 1) \
        if windowed else nkv
    outs = []
    for qi in range(sq // q_chunk):
        qb = qg[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]
        qp = torch.arange(qi * q_chunk, (qi + 1) * q_chunk,
                          device=dev) + q_offset
        start = 0
        if windowed:   # the lowest chunk the band can touch, clipped
            lo = qi * q_chunk + q_offset - window + 1
            start = min(max(lo // q_chunk, 0), nkv - n_rel)
        o = _online_softmax(qb, (chunk(start + r) for r in range(n_rel)),
                            qp, causal, window, softcap_val, scale, skv_orig,
                            vg.shape[-1])
        outs.append(o.to(out_dtype))
    return torch.cat(outs, dim=3)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0, softcap_val: float = 0.0,
                    q_offset: int = 0, q_chunk: int = 512,
                    kv_chunk: int = 1024,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked attention forward, the counterpart of the reference's
    `flash_attention_jnp`. q: (B, Sq, H, Dk); k/v: (B, Skv, KV, D) ->
    (B, Sq, H, Dv) in q's dtype. On the "cuda" backend the kernel runs with
    its own tiles (`q_chunk` and `kv_chunk` do not apply)."""
    b, sq, h, dk = q.shape
    _, skv, n_kv, dv = v.shape
    g = h // n_kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dk)
    if current_config().backend == "cuda":
        if window or softcap_val or q_offset:
            raise NotImplementedError(
                f"flash attention with window={window}, softcap_val="
                f"{softcap_val}, q_offset={q_offset} has no CUDA kernel yet "
                "(the kernel runs global causal or unmasked attention); see "
                "ROADMAP queue 1, item 8 (local attention)")
        return ops.flash_attention(q, k, v, causal=causal, scale=scale)
    windowed = bool(window) and window < skv and causal
    if windowed:
        q_chunk = kv_chunk = min(q_chunk, kv_chunk, sq, skv)
    else:
        q_chunk, kv_chunk = min(q_chunk, sq), min(kv_chunk, skv)
    nq, nkv = -(-sq // q_chunk), -(-skv // kv_chunk)
    pq, pkv = nq * q_chunk - sq, nkv * kv_chunk - skv

    qg = q.reshape(b, sq, n_kv, g, dk).permute(0, 2, 3, 1, 4)
    kg, vg = k.transpose(1, 2), v.transpose(1, 2)
    # padded keys never win the softmax: masked by position
    qg = torch.nn.functional.pad(qg, (0, 0, 0, pq))
    kg = torch.nn.functional.pad(kg, (0, 0, 0, pkv))
    vg = torch.nn.functional.pad(vg, (0, 0, 0, pkv))
    with no_tf32():
        out = _chunked_forward(qg.float(), kg.float(), vg.float(), causal,
                               window, float(softcap_val), int(q_offset),
                               q_chunk, kv_chunk, scale, skv, windowed,
                               q.dtype)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq].to(q.dtype)
