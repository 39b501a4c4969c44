"""Mixture-of-Experts FFN with top-k routing and shared experts: the
exact, capacity-free dense dispatch of the JAX package's `models/moe.py`.

Every token goes through every expert's gated FFN as grouped FC-mode GEMMs
over the stacked expert weights (`engine.einsum("ecd,edf->ecf", ...)`), and
a (T, E) combine matrix keeps the top-k experts' outputs, weighted. That is
E / k times the active experts' work, as the reference's single-device
path does; on the "cuda" backend each grouped einsum is one launch of the
hand-written GEMM kernel (`kernels/gfid_matmul.py`), where the reference
sends it to XLA.

A token's output is bitwise the same at any token count T, so that the
router's choice never depends on a token's batchmates (top-k turns a
last-bit difference in the router's input into another expert):

  * the router's GEMM is the row-invariant GEMM kernel; its softmax takes
    the sum of a row with `layers.row_sum`, in an order fixed by E alone;
  * top-k is a stable descending sort: the lower index first on ties, as
    `jax.lax.top_k` (`torch.topk` promises no order);
  * the dispatch `einsum("te,td->etd")` is an outer product, written
    elementwise, and the combine `einsum("etd,te->td")` a product summed
    over E by `layers.row_sum`, never a reduction whose order follows T.

The expert-parallel dispatch (`moe_forward_ep`, `_pack_local`: packing,
capacity and `all_to_all` over a mesh) is not ported: `moe_forward` with a
mesh raises (ROADMAP queue 1, item 11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import engine
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models.layers import (ACTIVATIONS, D_FF, D_MODEL, EXPERTS,
                                       ParamDef, row_sum)


def moe_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    mc: MoEConfig = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    defs = {
        "router": ParamDef((d, e), (D_MODEL, None), scale=0.02),
        "w_in": ParamDef((e, d, f), (EXPERTS, D_MODEL, D_FF)),
        "w_gate": ParamDef((e, d, f), (EXPERTS, D_MODEL, D_FF)),
        "w_out": ParamDef((e, f, d), (EXPERTS, D_FF, D_MODEL)),
    }
    if mc.n_shared:
        fs = mc.d_ff_expert * mc.n_shared
        defs["shared_w_in"] = ParamDef((d, fs), (D_MODEL, D_FF))
        defs["shared_w_gate"] = ParamDef((d, fs), (D_MODEL, D_FF))
        defs["shared_w_out"] = ParamDef((fs, d), (D_FF, D_MODEL))
    return defs


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, `exp(x - max) / sum` as the reference's
    `jax.nn.softmax`, with the sum in `row_sum`'s fixed order."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / row_sum(e)


def router_probs(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing. x: (T, D) -> (weights (T, k), idx (T, k) int64,
    probs (T, E)), in fp32. Ties go to the lower expert index."""
    logits = engine.einsum("td,de->te", x.float(), p["router"].float())
    probs = _softmax(logits)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe.n_active
    weights, idx = top[:, :k], idx[:, :k]
    weights = weights / torch.clamp(row_sum(weights), min=1e-9)
    return weights, idx, probs


def load_balance_loss(probs: torch.Tensor, idx: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary load-balancing loss (a scalar, fp32)."""
    me = probs.mean(dim=0)
    ce = torch.zeros(n_experts, dtype=torch.float32, device=probs.device)
    ce = ce.index_add(0, idx.reshape(-1),
                      torch.ones(idx.numel(), dtype=torch.float32,
                                 device=probs.device))
    ce = ce / torch.clamp(ce.sum(), min=1.0)
    return n_experts * torch.sum(me * ce)


def _shared_ffn(cfg: ModelConfig, p: Dict, xt: torch.Tensor) -> torch.Tensor:
    act = ACTIVATIONS[cfg.act]
    hs = engine.dense(xt, p["shared_w_in"])
    gs = engine.dense(xt, p["shared_w_gate"])
    return engine.dense((act(gs) * hs).to(xt.dtype), p["shared_w_out"],
                        out_dtype=xt.dtype)


def _expert_gemms(cfg: ModelConfig, p: Dict, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D) through each expert's gated FFN — grouped
    FC-mode GEMMs over the stacked expert weights."""
    act = ACTIVATIONS[cfg.act]
    h = engine.einsum("ecd,edf->ecf", xe, p["w_in"],
                      accum_dtype=torch.float32)
    g = engine.einsum("ecd,edf->ecf", xe, p["w_gate"],
                      accum_dtype=torch.float32)
    h = (act(g) * h).to(xe.dtype)
    return engine.einsum("ecf,efd->ecd", h, p["w_out"],
                         accum_dtype=torch.float32, out_dtype=xe.dtype)


def moe_forward_dense(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux_loss). O(E*T*D)
    memory: every expert sees every token."""
    mc: MoEConfig = cfg.moe
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    weights, idx, probs = router_probs(cfg, p, xt)
    aux = load_balance_loss(probs, idx, mc.n_experts)

    comb = torch.zeros((b * s, mc.n_experts), dtype=torch.float32,
                       device=x.device).scatter_add(1, idx, weights)
    disp = (comb > 0).to(xt.dtype)
    xe = disp.T[:, :, None] * xt[None]            # "te,td->etd"
    ye = _expert_gemms(cfg, p, xe)
    y = row_sum(ye.float() * comb.T[:, :, None], dim=0)[0].to(x.dtype)
    if mc.n_shared:
        y = y + _shared_ffn(cfg, p, xt)
    return y.reshape(b, s, d), aux


def moe_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor, *, mesh=None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's dispatch-engine selection: its expert-parallel path
    needs a mesh, which this port does not take yet; without one it is the
    dense dispatch."""
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel MoE dispatch (a mesh) is not ported to "
            "repro_torch yet; see ROADMAP queue 1, item 11")
    return moe_forward_dense(cfg, p, x)
