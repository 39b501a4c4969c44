"""Library oracles for the kernels: the library's own convolution and
matrix product, the ground truth the kernel tests hold the GFID paths
against."""
from __future__ import annotations

import torch

from repro_torch.core import gfid


def conv2d_ref(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
               pad: int = 0, groups: int = 1) -> torch.Tensor:
    """NHWC x HWIO -> NHWC, fp32 (the library's direct conv, TF32 off)."""
    return gfid.conv2d_reference(x, w, stride, pad, groups)


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def conv1d_depthwise_ref(x: torch.Tensor, w: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """(B, L, D) x (W_f, D) depthwise 1-D conv (the library's grouped
    conv, TF32 off)."""
    return gfid.conv1d_depthwise_reference(x, w, causal=causal)
