"""Launch glue between the engine's backends and the CUDA kernel wrappers.

The counterpart of `repro.kernels.ops`: what the kernels do not take is
shaped here. Padding and groups need nothing — the conv kernels mask their
loads at the border and carry the group index in their launch grid, so a
grouped conv is one launch, as the reference's `vmap` folds groups into
one grid. The matmul flattens the leading dims of x into rows.

`precision="int8"` quantizes both operands with the shared rule of
`core.quant` (plain torch ops, as the reference quantizes outside its
Pallas kernels; bf16 inputs widened to fp32) and runs the int8 kernel,
whose epilogue dequantizes in fp32 (a bf16 bias widened, exactly, to the
kernel's fp32 bias); `out_dtype` is then a cast of that fp32 store, the
reference's `.astype`, so no int8 kernel has a bf16 store. The
conv quantizes before any padding, so the scales never see the zero pad;
its per-example `sx` covers every group and its per-output-channel `sw`
runs across the groups.

fp32 and bf16 operands run the same wrappers, which launch the kernel's
fp32 or bf16 entry and return `out_dtype`: the reference's fp32 kernel
output cast to the caller's dtype (`repro.kernels.ops`). The bf16 entry
stores bf16 itself, in the same launch.

Attention keeps the reference's layout, q (B, Sq, H, D) and k, v
(B, Skv, KV, D); the kernel reads the GQA kv head as an index, so the
reference's `jnp.repeat` of the kv heads has no counterpart here.

Stacked-expert GEMMs (G, ..., K) @ (G, K, N) flatten x's middle dims into
rows and run the matmul's grouped launch: one launch for every group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.kernels import conv1d as _conv1d
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gfid_conv as _conv
from repro_torch.kernels import gfid_matmul as _matmul
from repro_torch.kernels import paged as _paged


def _contig(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.contiguous()


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.float().contiguous()


def _check_precision(precision: str) -> None:
    if precision not in ("fp32", "int8"):
        raise ValueError(f"unknown precision {precision!r}; expected 'fp32' "
                         "or 'int8'")


def gfid_conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                pad: int = 0, groups: int = 1,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                precision: str = "fp32",
                out_dtype: Optional[torch.dtype] = None,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """NHWC x HWIO conv through the engine's conv mode (one launch), in
    `out_dtype` (default: the kernel's fp32), on the block tile `tile` of
    the precision's entry where one is given (a tuned tile), else on its
    plan's."""
    _check_precision(precision)
    x, w = x.contiguous(), w.contiguous()
    if precision == "fp32":
        return _conv.gfid_conv2d_nhwc(x, w, stride=stride, pad=pad,
                                      groups=groups, bias=_contig(bias),
                                      act=act, out_dtype=out_dtype, tile=tile)
    xq, wq, sx, sw = quant.quantize_conv_operands(x, w)
    out = _conv.gfid_conv2d_nhwc_int8(
        xq, wq, sx.reshape(x.shape[0], 1), sw.reshape(1, w.shape[3]),
        stride=stride, pad=pad, groups=groups, bias=_f32(bias), act=act,
        tile=tile)
    return out if out_dtype is None else out.to(out_dtype)


def gfid_matmul(x: torch.Tensor, w: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                precision: str = "fp32",
                out_dtype: Optional[torch.dtype] = None,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """(..., K) @ (K, N) through the FC mode, in `out_dtype` (default: the
    kernel's fp32), on the block tile `tile` of the precision's entry where
    one is given (a tuned tile), else on its plan's."""
    _check_precision(precision)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if precision == "fp32":
        out = _matmul.gfid_matmul(x2, w.contiguous(), bias=_contig(bias),
                                  act=act, out_dtype=out_dtype, tile=tile)
        return out.reshape(*lead, w.shape[-1])
    xq, wq, sx, sw = quant.quantize_matmul_operands(x2, w)
    out = _matmul.gfid_matmul_int8(xq, wq.contiguous(), sx, sw,
                                   bias=_f32(bias), act=act, tile=tile)
    out = out if out_dtype is None else out.to(out_dtype)
    return out.reshape(*lead, w.shape[-1])


def gfid_matmul_grouped(x: torch.Tensor, w: torch.Tensor, *,
                        bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None,
                        precision: str = "fp32",
                        out_dtype: Optional[torch.dtype] = None
                        ) -> torch.Tensor:
    """(G, ..., K) @ (G, K, N) -> (G, ..., N) through the FC mode, every
    group in one launch, in `out_dtype` (default: the kernel's fp32). fp32
    only: the int8 contract covers canonical GEMMs alone
    (`plan.supports_int8`), as in the reference."""
    if precision != "fp32":
        raise ValueError(f"precision {precision!r}: the grouped GEMM runs "
                         "fp32 or bf16 operands; int8 covers canonical GEMMs "
                         "only")
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]).contiguous()
    out = _matmul.gfid_matmul(x3, w.contiguous(), bias=_contig(bias), act=act,
                              out_dtype=out_dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


def gfid_conv1d_depthwise(x: torch.Tensor, w: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """Depthwise 1-D conv (B, L, D) x (W_f, D) -> fp32 (B, L, D), causal or
    centred (one launch; the pad is masked in the kernel)."""
    return _conv1d.gfid_conv1d_depthwise(x.contiguous(), w.contiguous(),
                                         causal=causal)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Paged-KV block gather: pool (num_blocks, block_size, *feature) by an
    int32 block table (B, blocks_per_req) -> (B, blocks_per_req *
    block_size, *feature), a bitwise copy (one launch)."""
    return _paged.paged_gather(pool.contiguous(),
                               table.to(torch.int32).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Skv, KV, D), GQA heads read in place ->
    (B, Sq, H, D) in q's dtype (one launch)."""
    return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal, scale=scale)
