"""Library oracles for the kernels: the library's own convolution and
matrix product, and plain dense attention, the ground truth the kernel
tests hold the GFID paths and the flash kernel against."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import gfid, quant


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               pad: int = 0, groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC in x's dtype, fp32 or bf16, accumulated in fp32
    (the library's direct conv, TF32 off)."""
    return gfid.conv2d_reference(x, w, stride, pad, groups)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype, fp32 or bf16, accumulated in fp32 (the library's
    product on the widened operands, TF32 off), as the reference's
    `preferred_element_type=float32` then `.astype(x.dtype)`."""
    with quant.no_tf32():
        return torch.matmul(x.float(), w.float()).to(x.dtype)


def conv1d_depthwise_ref(x: torch.Tensor, w: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """(B, L, D) x (W_f, D) depthwise 1-D conv (the library's grouped
    conv, TF32 off)."""
    return gfid.conv1d_depthwise_reference(x, w, causal=causal)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v: (B, H, S, D) (kv heads pre-broadcast): dense softmax
    attention in fp32 with TF32 off, masked scores -1e30, in q's dtype."""
    s = q.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    with quant.no_tf32():
        s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        if causal:
            mask = torch.tril(torch.ones((s, k.shape[2]), dtype=torch.bool,
                                         device=q.device))
            s_mat = torch.where(mask, s_mat,
                                torch.full((), -1e30, device=q.device))
        p = torch.softmax(s_mat, dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
