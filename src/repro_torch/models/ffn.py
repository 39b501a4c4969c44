"""Dense FFN (gated SwiGLU / plain MLP) — pure FC-mode GEMMs, routed
through `repro_torch.engine` (the paper's FC mode, W_f = 1). A copy of the
JAX package's `models/ffn.py`."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import engine
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ACTIVATIONS, D_FF, D_MODEL, ParamDef


def ffn_defs(cfg: ModelConfig, d_ff: int = 0) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    defs = {
        "w_in": ParamDef((d, f), (D_MODEL, D_FF)),
        "w_out": ParamDef((f, d), (D_FF, D_MODEL)),
    }
    if cfg.gated_ffn:
        defs["w_gate"] = ParamDef((d, f), (D_MODEL, D_FF))
    return defs


def ffn_forward(cfg: ModelConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    # Activations the GEMM kernel runs as its epilogue ride the GEMM (one
    # launch); others (silu, ...) stay plain ops after it.
    fused = cfg.act in engine.EPILOGUE_ACTS
    if cfg.gated_ffn:
        h = engine.dense(x, p["w_in"])
        g = engine.dense(x, p["w_gate"], act=cfg.act if fused else None)
        if not fused:
            g = ACTIVATIONS[cfg.act](g)
        h = g * h
    else:
        h = engine.dense(x, p["w_in"], act=cfg.act if fused else None)
        if not fused:
            h = ACTIVATIONS[cfg.act](h)
    return engine.dense(h.to(x.dtype), p["w_out"], out_dtype=x.dtype)
