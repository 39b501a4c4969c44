"""GFID — Generalized Fully-connected Inspired Dataflow (paper §2.1, §3), in
PyTorch ops.

`conv2d_gfid` computes a convolution as `H_f * W_f` *shifted GEMM
accumulations* over the input, never materializing the im2col expansion —
the same lowering as `repro.core.gfid.conv2d_gfid`. It is the engine's
"torch" backend and the plain version the hand-written conv kernel is held
against. `conv2d_reference` is the library's own convolution, the "ref"
baseline. `conv2d_gfid_int8` and `conv2d_reference_int8` are the same two
on int8 operands, with exact int32 results. `conv1d_depthwise_gfid` and
`conv1d_depthwise_reference` are the 1-D depthwise mode (the SSM short
convs): shifted fp32 accumulation, and the library's grouped conv.

Layouts follow the JAX package at every public function: activations NHWC,
conv weights HWIO, FC weights (n, m).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant


def _check_conv(x: torch.Tensor, w: torch.Tensor, groups: int) -> None:
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(
            f"expected NHWC x and HWIO w, got {tuple(x.shape)} {tuple(w.shape)}")
    if x.shape[3] // groups != w.shape[2] or x.shape[3] % groups \
            or w.shape[3] % groups:
        raise ValueError(
            f"groups mismatch: C_in={x.shape[3]}, groups={groups}, "
            f"w={tuple(w.shape)}")


def conv2d_gfid(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                pad: int = 0, groups: int = 1) -> torch.Tensor:
    """2-D convolution as H_f*W_f shifted GEMM accumulations (valid conv
    after symmetric zero padding `pad`).

    x: (B, H_in, W_in, C_in) NHWC; w: (H_f, W_f, C_in // groups, C_out)
    HWIO. Returns (B, H_out, W_out, C_out) in x.dtype, accumulated in fp32
    (a product of two bf16 values is exact in fp32, so on bf16 operands this
    is the reference's `preferred_element_type=float32` sum up to order).
    Band (j, i) of the GFID matrix contributes X[:, zS+j, tS+i, :] @ W[j, i]
    to every output pixel (z, t).
    """
    _check_conv(x, w, groups)
    h_f, w_f, cg, c_out = w.shape
    if pad:
        x = F.pad(x, (0, 0, pad, pad, pad, pad))
    b, h_in, w_in, _ = x.shape
    h_out = (h_in - h_f) // stride + 1
    w_out = (w_in - w_f) // stride + 1
    og = c_out // groups
    shards = []
    for g in range(groups):
        xg = x[..., g * cg:(g + 1) * cg].float()
        acc = x.new_zeros((b, h_out, w_out, og), dtype=torch.float32)
        for j in range(h_f):
            for i in range(w_f):
                xs = xg[:, j:j + (h_out - 1) * stride + 1:stride,
                        i:i + (w_out - 1) * stride + 1:stride, :]
                acc = acc + xs @ w[j, i, :, g * og:(g + 1) * og].float()
        shards.append(acc)
    out = torch.cat(shards, dim=-1) if groups > 1 else shards[0]
    return out.to(x.dtype)


def conv2d_gfid_int8(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
                     pad: int = 0, groups: int = 1) -> torch.Tensor:
    """int8 shifted-GEMM convolution with exact int32 accumulation: the
    band-by-band lowering of `conv2d_gfid`, each per-tap contraction over
    C_in through `quant.int8_matmul_i32`. The int8 zero pad is exact.
    Returns int32 (B, H_out, W_out, C_out); the caller dequantizes."""
    _check_conv(xq, wq, groups)
    h_f, w_f, cg, c_out = wq.shape
    if pad:
        xq = F.pad(xq, (0, 0, pad, pad, pad, pad))
    b, h_in, w_in, _ = xq.shape
    h_out = (h_in - h_f) // stride + 1
    w_out = (w_in - w_f) // stride + 1
    og = c_out // groups
    shards = []
    for g in range(groups):
        xg = xq[..., g * cg:(g + 1) * cg]
        acc = torch.zeros((b, h_out, w_out, og), dtype=torch.int32,
                          device=xq.device)
        for j in range(h_f):
            for i in range(w_f):
                xs = xg[:, j:j + (h_out - 1) * stride + 1:stride,
                        i:i + (w_out - 1) * stride + 1:stride, :]
                acc = acc + quant.int8_matmul_i32(
                    xs, wq[j, i, :, g * og:(g + 1) * og])
        shards.append(acc)
    return torch.cat(shards, dim=-1) if groups > 1 else shards[0]


def conv2d_reference_int8(xq: torch.Tensor, wq: torch.Tensor,
                          stride: int = 1, pad: int = 0,
                          groups: int = 1) -> torch.Tensor:
    """The library's direct convolution on int8 operands, exact: PyTorch has
    no int8 conv, so it runs in float64, where every sum of int8 products
    of these layers is an exact integer (far below 2**53; fp32 would not do:
    3x3x256 products can pass 2**24). Returns int32 (B, H_out, W_out,
    C_out); the caller dequantizes."""
    _check_conv(xq, wq, groups)
    out = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   wq.permute(3, 2, 0, 1).double(),
                   stride=stride, padding=pad, groups=groups)
    return out.permute(0, 2, 3, 1).to(torch.int32).contiguous()


def conv1d_lpad(w_f: int, causal: bool) -> int:
    """Zero rows before the sequence of a W_f-tap conv: W_f - 1 (causal) or
    (W_f - 1) // 2 (centred; the other W_f - 1 - lpad come after it)."""
    return w_f - 1 if causal else (w_f - 1) // 2


def pad_seq(x: torch.Tensor, w_f: int, causal: bool) -> torch.Tensor:
    """Zero-pad the sequence axis of x (B, L, D) for a W_f-tap conv."""
    lpad = conv1d_lpad(w_f, causal)
    return F.pad(x, (0, 0, lpad, w_f - 1 - lpad))


def conv1d_shifted_sum(x: torch.Tensor, w: torch.Tensor, *,
                       causal: bool = True) -> torch.Tensor:
    """The GFID 1-D lowering for any W_f: `acc = acc + x_shifted * w[i]`
    over the taps in ascending order, from an fp32 accumulator of zeros.
    x: (B, L, D); w: (W_f, D). Returns fp32 (B, L, D)."""
    l = x.shape[1]
    xp = pad_seq(x, w.shape[0], causal)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w.shape[0]):
        acc = acc + xp[:, i:i + l].float() * w[i].float()
    return acc


def conv1d_depthwise_reference(x: torch.Tensor, w: torch.Tensor, *,
                               causal: bool = True) -> torch.Tensor:
    """The library's depthwise 1-D conv (`F.conv1d`, groups = D, TF32 off),
    in fp32, cast back to x.dtype. x: (B, L, D); w: (W_f, D)."""
    xp = pad_seq(x.float(), w.shape[0], causal)
    cudnn = torch.backends.cudnn
    allow_tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        out = F.conv1d(xp.permute(0, 2, 1), w.float().T[:, None, :],
                       groups=x.shape[2])
    finally:
        cudnn.allow_tf32 = allow_tf32
    return out.permute(0, 2, 1).to(x.dtype)


def conv1d_depthwise_gfid(x: torch.Tensor, w: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """Depthwise 1-D convolution via GFID shifted accumulation: the 1-D
    mode of the engine (paper Table 1 with C_in = 1 per channel), as
    `repro.core.gfid.conv1d_depthwise_gfid`.

    x: (B, L, D); w: (W_f, D) taps. `causal` left-pads W_f - 1 zeros
    (decode-consistent); else the pad is centred. Returns (B, L, D) in
    x.dtype (`conv1d_shifted_sum`, cast back). Past 8 taps (hubert's
    128-tap positional conv) it runs the library's conv, as the reference
    does."""
    if w.shape[0] > 8:
        return conv1d_depthwise_reference(x, w, causal=causal)
    return conv1d_shifted_sum(x, w, causal=causal).to(x.dtype)


def fc_gfid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """FC mode of the engine (paper §4.1.6): x (..., n) @ w (n, m), the
    degenerate W_f = 1, S = 1 mode, accumulated in fp32 and returned in
    x.dtype."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def conv2d_reference(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                     pad: int = 0, groups: int = 1) -> torch.Tensor:
    """The library's direct convolution at the NHWC/HWIO surface, in x's
    dtype, accumulated in fp32: bf16 operands are widened first (their
    products are exact in fp32), as the reference's direct conv on bf16
    accumulates in fp32.

    TF32 is switched off for the call: cuDNN would otherwise round fp32
    operands to TF32 on the card, about three decimal digits."""
    _check_conv(x, w, groups)
    cudnn = torch.backends.cudnn
    allow_tf32 = cudnn.allow_tf32
    cudnn.allow_tf32 = False
    try:
        out = F.conv2d(x.float().permute(0, 3, 1, 2),
                       w.float().permute(3, 2, 0, 1),
                       stride=stride, padding=pad, groups=groups)
    finally:
        cudnn.allow_tf32 = allow_tf32
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()
