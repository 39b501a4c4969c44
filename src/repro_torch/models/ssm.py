"""State-space and recurrent blocks: Mamba (jamba's selective SSM), mLSTM
(matrix memory, chunkwise-parallel) and sLSTM (scalar memory, recurrent
with a block-diagonal R) of xLSTM. A copy of the JAX package's
`models/ssm.py`.

All three share the repo's execution contract:
  * projections are FC-mode GEMMs of the engine (`engine.proj`),
  * the short depthwise conv (W_f = 4, S = 1) is the engine's 1-D conv mode
    (`engine.conv1d_depthwise`), the `gfid_conv1d_depthwise` kernel on the
    "cuda" backend,
  * the sequence is processed in chunks (Mamba, mLSTM) or token by token
    (sLSTM), carrying O(1) state. The reference runs them under
    `jax.lax.scan`; the port runs Python loops. Mamba's selective scan is
    plain JAX in the reference and plain torch ops here: it reaches no
    kernel.

Decode carries explicit recurrent state: the conv tail (the last
`d_conv - 1` *inputs* of the conv, in `state_dtype`) and the fp32 memory
(Mamba's `h`; `c`, `n`, `m`, and `h` for the sLSTM). A decode step applies
the conv window itself (outside the engine, as the reference does), taps
in ascending order from zeros as the 1-D mode sums them. A state is taken
only from a sequence of at least `d_conv - 1` tokens: the reference cannot
serve a shorter prompt either (ROADMAP section 3).

A decode row gets the same bits at any batch size: the state contractions
are a product and a sum over a strided axis or `layers.row_sum`, and the
norms and the mLSTM's denominator sum with `layers.row_sum` (on the card,
`einsum` and an innermost `torch.sum` pick their algorithm by the count of
rows; ROADMAP section 3). The reference uses `einsum` and `mean`.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import engine
from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import no_tf32
from repro_torch.models.layers import (ACTIVATIONS, CONV, D_FF, D_MODEL,
                                       HEADS, STATE, ParamDef, rms_norm,
                                       row_sum)

NEG_BIG = -1e30      # the reference's "minus infinity" of the stabilizers


def _conv_tail(cfg: ModelConfig, x: torch.Tensor,
               state_dtype: torch.dtype) -> torch.Tensor:
    """The last `d_conv - 1` rows of the conv's input x (B, L, D): the
    decode state's conv window. Raises for a shorter sequence."""
    n = cfg.ssm.d_conv - 1
    if x.shape[1] < n:
        raise ValueError(
            f"{cfg.name}: a decode state needs a prompt of at least "
            f"d_conv - 1 = {n} tokens, got {x.shape[1]} (the reference "
            "cannot serve it either; ROADMAP section 3)")
    return x[:, x.shape[1] - n:].to(state_dtype)


def _window_conv(window: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The causal conv's output at the last position of its window (B, W_f,
    D): fp32 (B, D), the reference's `einsum("bwd,wd->bd")` summed as the
    1-D mode sums it, taps in ascending order from zeros."""
    win = window.float()
    acc = torch.zeros_like(win[:, 0])
    for i in range(w.shape[0]):
        acc = acc + win[:, i] * w[i].float()
    return acc


def _group_rms_norm(x: torch.Tensor, scale: torch.Tensor, n_groups: int,
                    eps: float) -> torch.Tensor:
    b, l, d = x.shape
    xg = x.reshape(b, l, n_groups, d // n_groups).float()
    var = row_sum(xg * xg) / xg.shape[-1]
    xg = xg * torch.rsqrt(var + eps)
    return (xg.reshape(b, l, d) * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Mamba (selective SSM)
# ---------------------------------------------------------------------------

def _dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def _d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def mamba_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, di, ds = cfg.d_model, _d_inner(cfg), cfg.ssm.d_state
    dr = _dt_rank(cfg)
    return {
        "w_in": ParamDef((d, 2 * di), (D_MODEL, D_FF)),
        "conv_w": ParamDef((cfg.ssm.d_conv, di), (CONV, D_FF), scale=0.5),
        "conv_b": ParamDef((di,), (D_FF,), "zeros"),
        "w_x": ParamDef((di, dr + 2 * ds), (D_FF, None)),
        "w_dt": ParamDef((dr, di), (None, D_FF)),
        "dt_bias": ParamDef((di,), (D_FF,), "zeros"),
        "a_log": ParamDef((di, ds), (D_FF, STATE), "ones"),
        "d_skip": ParamDef((di,), (D_FF,), "ones"),
        "norm": ParamDef((di,), (D_FF,), "ones"),       # Jamba inner RMSNorm
        "w_out": ParamDef((di, d), (D_FF, D_MODEL)),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus` as XLA's CPU compiler computes it: log-add-exp with
    0, max(x, 0) + log1p(exp(-|x|)), each op rounded to x's dtype.
    `F.softplus` returns x itself above a threshold and rounds once."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as XLA's CPU compiler computes it: x * (1 / (1 +
    exp(-x))), each op rounded to x's dtype. `F.silu` rounds a bf16 result
    once, which differs from it in the last bit of about a third of bf16
    elements."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _inclusive_scan(decay: torch.Tensor, inject: torch.Tensor,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of (decay, inject) pairs over axis 1 under the
    reference's combine (a1, u1) . (a2, u2) = (a1 a2, a2 u1 + u2): a
    Hillis-Steele doubling, step k combining each row with the row 2**k
    before it, elementwise per (b, d, s). The reference's
    `associative_scan` pairs the rows in another tree, so the products are
    associated in another order (within a tolerance, not bitwise)."""
    n, off = decay.shape[1], 1
    while off < n:
        inject = torch.cat([inject[:, :off], decay[:, off:] * inject[:, :-off]
                            + inject[:, off:]], dim=1)
        decay = torch.cat([decay[:, :off], decay[:, off:] * decay[:, :-off]],
                          dim=1)
        off *= 2
    return decay, inject


def _ssm_scan_chunked(x, dt, b_in, c_in, a, chunk: int):
    """Selective scan h_t = exp(dt_t a) h_{t-1} + dt_t b_t x_t; y_t = c_t.h_t.

    x, dt: (B, L, Di); b_in, c_in: (B, L, Ds); a: (Di, Ds), all fp32.
    The chunks of `chunk` rows run in a Python loop carrying h (B, Di, Ds)
    in fp32; inside a chunk `_inclusive_scan` keeps the (B, Q, Di, Ds)
    state tensor transient. The last chunk is padded with rows of dt = 0,
    whose decay is 1 and inject 0, so the final state is the last real
    row's. y sums over Ds with `row_sum`. Returns (y (B, L, Di), h)."""
    bsz, l, di = x.shape
    ds = a.shape[1]
    q = min(chunk, l)
    nq = -(-l // q)
    pad = nq * q - l
    if pad:
        x, dt, b_in, c_in = (F.pad(v, (0, 0, 0, pad))
                             for v in (x, dt, b_in, c_in))
    h = torch.zeros((bsz, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for j in range(nq):
        sl = slice(j * q, (j + 1) * q)
        xq, dtq, bq, cq = x[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl]
        decay = torch.exp(dtq[..., None] * a)            # (B, Q, Di, Ds)
        inject = (dtq * xq)[..., None] * bq[:, :, None, :]
        dec_c, inj_c = _inclusive_scan(decay, inject)
        hq = dec_c * h[:, None] + inj_c                  # (B, Q, Di, Ds)
        ys.append(row_sum(hq * cq[:, :, None, :])[..., 0])   # "bqds,bqs->bqd"
        h = hq[:, -1]
    y = torch.cat(ys, dim=1) if nq > 1 else ys[0]
    return y[:, :l], h


def _mamba_out(cfg: ModelConfig, p: Dict, y: torch.Tensor, xc: torch.Tensor,
               z: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The block's output from the scan's y (fp32): the skip term in fp32,
    the inner RMSNorm (fixed-order sum) on y in the block's dtype, the
    silu(z) gate and the output projection."""
    y = y + xc.float() * p["d_skip"].float()
    y = rms_norm(y.to(dtype), p["norm"], cfg.norm_eps, fixed_order=True)
    return engine.proj(y * _silu(z), p["w_out"])


def mamba_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  chunk: int = 256, return_state: bool = False,
                  state_dtype: torch.dtype = torch.bfloat16):
    """x: (B, L, D) -> (B, L, D); with `return_state` also the decode state
    {"conv": the conv's last d_conv - 1 inputs in `state_dtype`, "h": the
    scan's final fp32 state}."""
    di, ds, dr = _d_inner(cfg), cfg.ssm.d_state, _dt_rank(cfg)
    xz = engine.proj(x, p["w_in"])
    xm_pre, z = torch.split(xz, di, dim=-1)
    xm = _silu(engine.conv1d_depthwise(xm_pre, p["conv_w"], causal=True)
               + p["conv_b"])
    proj = engine.proj(xm, p["w_x"])
    dt_in, b_in, c_in = torch.split(proj, [dr, ds, ds], dim=-1)
    dt = _softplus(engine.proj(dt_in, p["w_dt"]) + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"].float())
    with no_tf32():
        y, h_fin = _ssm_scan_chunked(xm.float(), dt, b_in.float(),
                                     c_in.float(), a, chunk)
    out = _mamba_out(cfg, p, y, xm, z, x.dtype)
    if return_state:
        return out, {"conv": _conv_tail(cfg, xm_pre, state_dtype),
                     "h": h_fin}
    return out


def mamba_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict:
    di, ds = _d_inner(cfg), cfg.ssm.d_state
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                                device=device),
            "h": torch.zeros((batch, di, ds), dtype=torch.float32,
                             device=device)}


def mamba_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Dict,
                 ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, D); O(1) recurrent update. The reference's
    `einsum("bds,bs->bd")` is a product summed over Ds by `row_sum`."""
    di, ds, dr = _d_inner(cfg), cfg.ssm.d_state, _dt_rank(cfg)
    xz = engine.proj(x[:, 0], p["w_in"])
    xm, z = torch.split(xz, di, dim=-1)
    window = torch.cat([state["conv"], xm[:, None].to(state["conv"].dtype)],
                       dim=1)
    xc = _window_conv(window, p["conv_w"]) + p["conv_b"].float()
    xc = _silu(xc).to(x.dtype)
    proj = engine.proj(xc, p["w_x"])
    dt_in, b_in, c_in = torch.split(proj, [dr, ds, ds], dim=-1)
    dt = _softplus(engine.proj(dt_in, p["w_dt"]) + p["dt_bias"]).float()
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt[..., None] * a)                 # (B, Di, Ds)
    h = (decay * state["h"]
         + (dt * xc.float())[..., None] * b_in.float()[:, None, :])
    y = row_sum(h * c_in.float()[:, None, :])[..., 0]
    out = _mamba_out(cfg, p, y, xc, z, x.dtype)[:, None]
    return out, {"conv": window[:, 1:], "h": h}


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, chunkwise-parallel)
# ---------------------------------------------------------------------------

def mlstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di = cfg.ssm.expand * d
    h = cfg.n_heads
    return {
        "w_up": ParamDef((d, 2 * di), (D_MODEL, D_FF)),
        "conv_w": ParamDef((cfg.ssm.d_conv, di), (CONV, D_FF), scale=0.5),
        "conv_b": ParamDef((di,), (D_FF,), "zeros"),
        "wq": ParamDef((di, di), (D_FF, None)),
        "wk": ParamDef((di, di), (D_FF, None)),
        "wv": ParamDef((di, di), (D_FF, None)),
        "w_if": ParamDef((di, 2 * h), (D_FF, None), scale=0.02),
        "b_if": ParamDef((2 * h,), (None,), "zeros"),
        "norm": ParamDef((di,), (D_FF,), "ones"),       # per-head groupnorm
        "w_down": ParamDef((di, d), (D_FF, D_MODEL)),
    }


def _mlstm_chunk(carry, qq, kk, vv, ii, ff, scale):
    """One chunk of the stabilized mLSTM: (B, H, Q, Dh) q/k/v, (B, H, Q)
    log input gate and log forget gate, from the carry (c (B,H,Dh,Dh),
    n (B,H,Dh), m (B,H)). Returns (carry at the chunk's end, h (B,H,Q,Dh))."""
    c0, n0, m0 = carry
    qchunk = qq.shape[2]
    bcum = torch.cumsum(ff, dim=-1)                      # (B,H,Q) inclusive
    # D[j,l] = b_j - b_l + i_l  (l <= j)
    dmat = bcum[..., :, None] - bcum[..., None, :] + ii[..., None, :]
    tri = torch.ones((qchunk, qchunk), dtype=torch.bool,
                     device=qq.device).tril()
    dmat = torch.where(tri, dmat, torch.tensor(float("-inf"),
                                               device=qq.device))
    m_intra = dmat.amax(dim=-1)                          # (B,H,Q)
    m_j = torch.maximum(bcum + m0[..., None], m_intra)

    w_intra = torch.exp(dmat - m_j[..., None])           # (B,H,Q,Q)
    s = torch.einsum("bhqd,bhld->bhql", qq, kk) * scale
    num = torch.einsum("bhql,bhld->bhqd", w_intra * s, vv)
    den = (w_intra * s).sum(dim=-1)
    # inter-chunk contribution
    dec = torch.exp(bcum + m0[..., None] - m_j)          # (B,H,Q)
    num = num + dec[..., None] * torch.einsum("bhqd,bhde->bhqe", qq,
                                              c0) * scale
    den = den + dec * torch.einsum("bhqd,bhd->bhq", qq, n0) * scale
    hh = num / torch.maximum(den.abs(), torch.exp(-m_j))[..., None]

    # carry update (state at j = Q - 1)
    b_end = bcum[..., -1]
    m_end = m_j[..., -1]
    w_end = torch.exp(bcum[..., -1:] - bcum + ii - m_end[..., None])
    carry_dec = torch.exp(b_end + m0 - m_end)
    c1 = (carry_dec[..., None, None] * c0
          + torch.einsum("bhl,bhld,bhle->bhde", w_end, kk * scale, vv))
    n1 = (carry_dec[..., None] * n0
          + torch.einsum("bhl,bhld->bhd", w_end, kk * scale))
    return (c1, n1, m_end), hh


def _mlstm_core_chunked(q, k, v, i_raw, lf, chunk: int):
    """Chunkwise-parallel stabilized mLSTM.

    q, k, v: (B, H, L, Dh); i_raw (log input gate argument), lf (log forget
    gate = logsigmoid(f_raw)): (B, H, L). Returns h (B, H, L, Dh) and the
    final (c, n, m). The sequence is padded to whole chunks (pad steps
    carry an input gate of -1e30, so they add nothing) and the chunks run
    in a Python loop."""
    b, h, l, dh = q.shape
    qchunk = min(chunk, l)
    nq = -(-l // qchunk)
    pad = nq * qchunk - l
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, pad), value=NEG_BIG)
        lf = F.pad(lf, (0, pad))
    scale = 1.0 / math.sqrt(dh)
    carry = (torch.zeros((b, h, dh, dh), dtype=torch.float32,
                         device=q.device),
             torch.zeros((b, h, dh), dtype=torch.float32, device=q.device),
             torch.full((b, h), NEG_BIG, dtype=torch.float32,
                        device=q.device))
    hs = []
    with no_tf32():
        for j in range(nq):
            sl = slice(j * qchunk, (j + 1) * qchunk)
            carry, hh = _mlstm_chunk(carry, q[:, :, sl], k[:, :, sl],
                                     v[:, :, sl], i_raw[..., sl],
                                     lf[..., sl], scale)
            hs.append(hh)
    out = torch.cat(hs, dim=2) if nq > 1 else hs[0]
    return out[:, :, :l], carry


def mlstm_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  chunk: int = 256, return_state: bool = False,
                  state_dtype: torch.dtype = torch.bfloat16):
    b, l, d = x.shape
    h = cfg.n_heads
    di = cfg.ssm.expand * d
    dh = di // h
    xz = engine.proj(x, p["w_up"])
    xm, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(engine.conv1d_depthwise(xm, p["conv_w"]) + p["conv_b"])

    def heads(t):
        return t.reshape(b, l, h, dh).permute(0, 2, 1, 3).float()

    q, k = heads(engine.proj(xc, p["wq"])), heads(engine.proj(xc, p["wk"]))
    v = heads(engine.proj(xm, p["wv"]))
    gates = (engine.proj(xc, p["w_if"]) + p["b_if"]).float()
    i_raw = gates[..., :h].transpose(1, 2)
    lf = F.logsigmoid(gates[..., h:]).transpose(1, 2)
    hh, (c_f, n_f, m_f) = _mlstm_core_chunked(q, k, v, i_raw, lf, chunk)
    hh = hh.permute(0, 2, 1, 3).reshape(b, l, di).to(x.dtype)
    hh = _group_rms_norm(hh, p["norm"], h, cfg.norm_eps)
    out = engine.proj(hh * F.silu(z), p["w_down"])
    if return_state:
        return out, {"conv": _conv_tail(cfg, xm, state_dtype), "c": c_f,
                     "n": n_f, "m": m_f}
    return out


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict:
    di = cfg.ssm.expand * cfg.d_model
    h = cfg.n_heads
    dh = di // h
    f32 = torch.float32
    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=dtype,
                                device=device),
            "c": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "m": torch.full((batch, h), NEG_BIG, dtype=f32, device=device)}


def mlstm_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Dict,
                 ) -> Tuple[torch.Tensor, Dict]:
    b = x.shape[0]
    h = cfg.n_heads
    di = cfg.ssm.expand * cfg.d_model
    dh = di // h
    xz = engine.proj(x[:, 0], p["w_up"])
    xm, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([state["conv"], xm[:, None].to(state["conv"].dtype)],
                       dim=1)
    xc = _window_conv(window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc).to(x.dtype)

    def heads(t):
        return t.reshape(b, h, dh).float()

    q, k = heads(engine.proj(xc, p["wq"])), heads(engine.proj(xc, p["wk"]))
    v = heads(engine.proj(xm, p["wv"]))
    gates = (engine.proj(xc, p["w_if"]) + p["b_if"]).float()
    i_raw, f_raw = gates[..., :h], gates[..., h:]
    lf = F.logsigmoid(f_raw)
    scale = 1.0 / math.sqrt(dh)

    m_new = torch.maximum(lf + state["m"], i_raw)
    dec = torch.exp(lf + state["m"] - m_new)[..., None]
    inp = torch.exp(i_raw - m_new)[..., None]
    c = dec[..., None] * state["c"] + inp[..., None] * (k * scale)[..., None] \
        * v[..., None, :]
    n = dec * state["n"] + inp * (k * scale)
    num = (q[..., None] * c).sum(dim=-2)             # "bhd,bhde->bhe"
    den = row_sum(q * n)[..., 0]                     # "bhd,bhd->bh"
    hh = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    hh = hh.reshape(b, 1, di).to(x.dtype)
    hh = _group_rms_norm(hh, p["norm"], h, cfg.norm_eps)
    out = engine.proj(hh * F.silu(z)[:, None], p["w_down"])
    return out, {"conv": window[:, 1:], "c": c, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, recurrent with block-diagonal R)
# ---------------------------------------------------------------------------

def slstm_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    dff = int(d * 4 / 3 / 64) * 64 * 2 or 2 * d  # paper's 4/3 gated MLP
    return {
        "conv_w": ParamDef((cfg.ssm.d_conv, d), (CONV, D_MODEL), scale=0.5),
        "conv_b": ParamDef((d,), (D_MODEL,), "zeros"),
        "w_gates": ParamDef((d, 4 * d), (D_MODEL, None)),
        "r_gates": ParamDef((h, dh, 4 * dh), (HEADS, None, None), scale=0.02),
        "b_gates": ParamDef((4 * d,), (None,), "zeros"),
        "norm": ParamDef((d,), (D_MODEL,), "ones"),
        "w_up": ParamDef((d, dff), (D_MODEL, D_FF)),
        "w_down": ParamDef((dff // 2, d), (D_FF, D_MODEL)),
    }


def _slstm_step(p: Dict, carry, zifo: torch.Tensor):
    """One recurrence step. zifo: (B, 4, H, Dh) pre-activations (no R
    term)."""
    h_prev, c_prev, n_prev, m_prev = carry
    rec = (h_prev[..., None] * p["r_gates"].float()).sum(dim=-2)  # bhd,hde
    rec = rec.reshape(*h_prev.shape[:2], 4, -1).permute(0, 2, 1, 3)
    z_r, i_r, f_r, o_r = [zifo[:, j] + rec[:, j] for j in range(4)]
    z = torch.tanh(z_r)
    o = torch.sigmoid(o_r)
    lf = F.logsigmoid(f_r)
    m_new = torch.maximum(lf + m_prev, i_r)
    i_g = torch.exp(i_r - m_new)
    f_g = torch.exp(lf + m_prev - m_new)
    c = f_g * c_prev + i_g * z
    n = torch.clamp_min(f_g * n_prev + i_g, 1e-6)
    h_new = o * (c / n)
    return (h_new, c, n, m_new), h_new


def _slstm_out(cfg: ModelConfig, p: Dict, hs: torch.Tensor) -> torch.Tensor:
    """The block's output from its hidden states hs (B, L, D): group norm,
    then the gated 4/3 up-projection (part of the sLSTM block)."""
    hs = _group_rms_norm(hs, p["norm"], cfg.n_heads, cfg.norm_eps)
    up = engine.proj(hs, p["w_up"])
    u1, u2 = torch.chunk(up, 2, dim=-1)
    return engine.proj(ACTIVATIONS["gelu"](u1) * u2, p["w_down"])


def slstm_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                  return_state: bool = False,
                  state_dtype: torch.dtype = torch.bfloat16):
    b, l, d = x.shape
    hh = cfg.n_heads
    dh = d // hh
    xc = F.silu(engine.conv1d_depthwise(x, p["conv_w"]) + p["conv_b"])
    pre = (engine.proj(xc, p["w_gates"]) + p["b_gates"]).float()
    pre = pre.reshape(b, l, 4, hh, dh)

    init = slstm_init_state(cfg, b, device=x.device)
    carry = (init["h"], init["c"], init["n"], init["m"])
    hs = []
    for t in range(l):
        carry, h_t = _slstm_step(p, carry, pre[:, t])
        hs.append(h_t)
    hs = torch.stack(hs, dim=1).reshape(b, l, d).to(x.dtype)
    out = _slstm_out(cfg, p, hs)
    if return_state:
        h_f, c_f, n_f, m_f = carry
        return out, {"conv": _conv_tail(cfg, x, state_dtype), "h": h_f,
                     "c": c_f, "n": n_f, "m": m_f}
    return out


def slstm_init_state(cfg: ModelConfig, batch: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h

    def full(v):
        return torch.full((batch, h, dh), v, dtype=torch.float32,
                          device=device)

    return {"conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d), dtype=dtype,
                                device=device),
            "h": full(0.0), "c": full(0.0), "n": full(1e-6),
            "m": full(NEG_BIG)}


def slstm_decode(cfg: ModelConfig, p: Dict, x: torch.Tensor, state: Dict,
                 ) -> Tuple[torch.Tensor, Dict]:
    b = x.shape[0]
    hh = cfg.n_heads
    d = cfg.d_model
    dh = d // hh
    window = torch.cat([state["conv"], x[:, :1].to(state["conv"].dtype)],
                       dim=1)
    xc = _window_conv(window, p["conv_w"]) + p["conv_b"]
    xc = F.silu(xc).to(x.dtype)
    pre = (engine.proj(xc, p["w_gates"]) + p["b_gates"]).float()
    pre = pre.reshape(b, 4, hh, dh)
    carry = (state["h"], state["c"], state["n"], state["m"])
    (h_new, c, n, m), _ = _slstm_step(p, carry, pre)
    out = _slstm_out(cfg, p, h_new.reshape(b, 1, d).to(x.dtype))
    return out, {"conv": window[:, 1:], "h": h_new, "c": c, "n": n, "m": m}
