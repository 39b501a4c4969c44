"""Launch glue between the engine's backends and the CUDA kernel wrappers.

The counterpart of `repro.kernels.ops`: what the kernels do not take is
shaped here. Padding and groups need nothing — the conv kernel masks its
loads at the border and carries the group index in its launch grid, so a
grouped conv is one launch, as the reference's `vmap` folds groups into
one grid. The matmul flattens the leading dims of x into rows.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gfid_conv as _conv
from repro_torch.kernels import gfid_matmul as _matmul


def _contig(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def gfid_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                pad: int = 0, groups: int = 1,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """NHWC x HWIO conv through the engine's conv mode (one launch)."""
    return _conv.gfid_conv2d_nhwc(x.contiguous(), w.contiguous(),
                                  stride=stride, pad=pad, groups=groups,
                                  bias=_contig(bias), act=act)


def gfid_matmul(x: torch.Tensor, w: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """(..., K) @ (K, N) through the FC mode."""
    lead = x.shape[:-1]
    out = _matmul.gfid_matmul(x.reshape(-1, x.shape[-1]).contiguous(),
                              w.contiguous(), bias=_contig(bias), act=act)
    return out.reshape(*lead, w.shape[-1])
