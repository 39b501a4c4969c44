"""GFID convolution: the hand-written kernels that port the Pallas kernel
`repro.kernels.gfid_conv.gfid_conv2d_nhwc` (`csrc/gfid_conv.cu`, entry
`gfid_conv2d_nhwc_f32`, for fp32 operands as an implicit GEMM on the CUDA
cores; `csrc/gfid_conv_bf16.cu`, entry `gfid_conv2d_nhwc_bf16`, for bf16
operands as an implicit GEMM on the tensor cores; both with an fp32
accumulator, both behind the wrapper `gfid_conv2d_nhwc`, each launched with
a block tile and a split of K from its plan, `f32_plan` or `bf16_plan`) and
`csrc/gfid_conv_int8.cu` (int8 operands as an implicit GEMM on the int8
tensor cores, exact int32 accumulator, fused dequant, launched with a block
tile and a split of K from `int8_plan`; the port of
`gfid_conv2d_nhwc_int8`), each with its plain PyTorch version.

Unlike the Pallas kernels, which take an already padded input and one
group, the CUDA kernels take `pad` (a bounds mask on their loads) and
`groups` (an axis of the launch grid), so a padded, grouped conv with its
bias and activation is one launch.

Each wrapper launches its CUDA kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_conv2d_nhwc` launches the fp32 or the bf16 entry
by the operands' dtype; `gfid_conv2d_nhwc.launches`,
`gfid_conv2d_nhwc_bf16.launches` and `gfid_conv2d_nhwc_int8.launches`
count each kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import gfid
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (ACT_CODES, apply_epilogue,
                                         check_act, dequant_epilogue)

# (output pixels, K chunk, C_out) of the fp32 kernel's widest block tile:
# kPixTile, kBK, kCoutTile in csrc/gfid_conv.cu (the engine plan's tiling).
TILE = (128, 8, 128)
# csrc/gfid_conv.cu's block tiles (output pixels, C_out of a group),
# most work a block first: the first whose blocks fill the card, else the
# last. K is split where one image's blocks do not fill the card, for about
# two blocks an SM, each split at least F32_MIN_SPLIT chunks of F32_BK deep:
# the split comes from the image's geometry, never from the batch, so an
# image's sums run in one order at every batch. Where the batch's blocks
# fill the card, each block runs every split and adds them in split order
# (a fold). The wide tile is taken only where it wastes no columns (og a
# multiple of 128) or where x is gathered element by element (cg % 4 != 0)
# and more columns share each gather (AlexNet's conv1).
F32_TILES = ((128, 128), (64, 64), (32, 64))
F32_BK = TILE[1]
F32_MIN_SPLIT = 8
# (output pixels, K chunk in bytes, C_out) of the widest block tile of
# csrc/gfid_conv_int8.cu: kPixTile, kKc, kCoutTile (K = H_f * W_f * C_in /
# groups; the engine plan's tiling).
TILE_INT8 = (128, 64, 128)
# csrc/gfid_conv_int8.cu's block tiles (output pixels, C_out of a group),
# most work a block first: the first whose blocks fill the card, else the
# last. The wide tile is taken only where x is gathered byte by byte
# (cg % 16 != 0) and a group has more than 64 columns, so that more columns
# share each gather (AlexNet's conv1 at batch 32); where x goes by 16-byte
# copies, 64-column tiles keep more blocks in flight. Where the blocks
# still do not fill the card, K is split for about two blocks an SM, at
# most INT8_MAX_SPLIT splits (the tile's splits are one thread block
# cluster whose blocks add them), each at least INT8_MIN_SPLIT chunks of
# INT8_BK bytes.
INT8_TILES = ((128, 128), (64, 64), (32, 64))
INT8_BK = TILE_INT8[1]
INT8_MIN_SPLIT = 3
INT8_MAX_SPLIT = 4
# csrc/gfid_conv_bf16.cu's block tiles (output pixels, C_out of a group),
# most work a block first: the first whose blocks fill the card, else the
# last; K split as for the fp32 conv, from one image's geometry (at least
# BF16_MIN_SPLIT chunks a split). The wide tile is taken only where it
# wastes no columns (og a multiple of 128) or where the A tile is gathered
# element by element (cg % 8 != 0) and more columns share each gather
# (AlexNet's conv1 at batch 32), and never for a split: beside its ring a
# fold's running sums would leave one block an SM.
BF16_TILES = ((128, 128), (64, 64), (32, 64))
BF16_MIN_SPLIT = 8
# Of the rules above, "the first tile whose blocks fill the card" and "the
# wide tile only where it wastes no columns or shares a gather" choose for
# speed alone: a tuned tile (`tile=`) may be any tile of the set, and the
# tuner orders them by its own score. "Never the wide bf16 tile for a
# split" guards a resource (the fold's running sums beside its ring): a
# filter, which `tiles_for` keeps. The split of K of the fp32 and bf16
# convs stays one image's plan under the default rule whatever the tile,
# so that a tuned tile changes no bit.


def gfid_conv2d_nhwc_plain(x: torch.Tensor, w: torch.Tensor, *,
                           stride: int = 1, pad: int = 0, groups: int = 1,
                           bias: Optional[torch.Tensor] = None,
                           act: Optional[str] = None,
                           out_dtype: Optional[torch.dtype] = None
                           ) -> torch.Tensor:
    """The plain version, for fp32 or bf16 operands: the GFID shifted-GEMM
    lowering on the operands widened to fp32 (exact), then bias (widened)
    and activation in fp32, then the cast to `out_dtype` (default fp32)."""
    out = apply_epilogue(
        gfid.conv2d_gfid(x.float(), w.float(), stride, pad, groups),
        None if bias is None else bias.float(), act)
    return out if out_dtype is None else out.to(out_dtype)


# x, w, bias, out, ws; B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out,
# stride, pad, groups, bm, bn, splits, chunks_per_split, act, vec_x, vec_w;
# stream.
F32_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 19 + [ctypes.c_void_p]
# x, w, bias, out, ws; bias_bf16, out_bf16, B, H_in, W_in, C_in, H_f, W_f,
# C_out, H_out, W_out, stride, pad, groups, bm, bn, splits,
# chunks_per_split, act, vec_x, vec_w; stream.
BF16_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 21 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("gfid_conv")
    fn = lib.gfid_conv2d_nhwc_f32
    fn.argtypes = F32_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _launcher_bf16():
    lib = build.library("gfid_conv_bf16")
    fn = lib.gfid_conv2d_nhwc_bf16
    fn.argtypes = BF16_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _pick_tile(tiles_: Tuple[Tuple[int, int], ...], pixels: int, og: int,
               groups: int, sms: int) -> Tuple[int, int, int, int]:
    """(bm, bn, column blocks, blocks) of the first tile of `tiles_` whose
    blocks fill the card's `sms` SMs, else of the last."""
    for bm, bn in tiles_:
        col_blocks = groups * -(-og // bn)
        blocks = max(-(-pixels // bm) * col_blocks, 1)
        if blocks >= sms:
            break
    return bm, bn, col_blocks, blocks


def _image_split(tiles_: Tuple[Tuple[int, int], ...], image_pixels: int,
                 k: int, og: int, groups: int, sms: int, min_split: int,
                 chunk: int) -> Tuple[int, int]:
    """(splits, chunks per split) of K from one image's plan: split where
    one image's blocks leave the card idle, for about two blocks an SM."""
    blocks = _pick_tile(tiles_, image_pixels, og, groups, sms)[3]
    want = 1 if blocks >= sms else -(-2 * sms // blocks)
    return build.mma_split(k, want, min_split, chunk)


def _default_tiles(tiles_: Tuple[Tuple[int, int], ...], og: int, cg: int,
                   elems: int) -> Tuple[Tuple[int, int], ...]:
    """The tiles the default rule picks from: the wide one only where it
    wastes no columns (og a multiple of its width) or where x is gathered
    element by element (cg % `elems`) and more columns share each
    gather."""
    return tuple(t for t in tiles_
                 if t[1] == 64 or og % t[1] == 0 or (og > 64 and cg % elems))


def f32_plan(pixels: int, k: int, og: int, groups: int, cg: int,
             x_ptr: int = 0, w_ptr: int = 0, sms: int = 132,
             image_pixels: Optional[int] = None,
             tile: Optional[Tuple[int, int]] = None) -> build.MmaPlan:
    """The launch of `gfid_conv2d_nhwc_f32` for an implicit GEMM of
    `pixels` output rows (B x H_out x W_out), depth k = H_f x W_f x cg and
    og columns a group, on a card of `sms` SMs: the split of K from one
    image of `image_pixels` output rows (H_out x W_out; default `pixels`,
    one image), so that an image's sums run in one order at any batch; the
    tile from F32_TILES at `pixels`; a fold where the batch's blocks fill
    the card; 16-byte copies of x where cg % 4 == 0 and x is 16-byte
    aligned, of w where og % 4 == 0 and w is. `tile`, one of F32_TILES,
    replaces the tile the rule picks at `pixels` (ValueError for another);
    the fold follows from it, the split of K does not."""
    tiles_ = _default_tiles(F32_TILES, og, cg, 4)
    splits, per = _image_split(tiles_, image_pixels or pixels, k, og, groups,
                               sms, F32_MIN_SPLIT, F32_BK)
    if tile is not None:
        tiles_ = (build.check_tile("gfid_conv2d_nhwc", tile, F32_TILES),)
    bm, bn, _, blocks = _pick_tile(tiles_, pixels, og, groups, sms)
    # column blocks fastest, then row tiles; grid z the splits, or 1 (fold)
    grid = (blocks, 1, 1 if blocks >= sms else splits)
    build.check_grid("gfid_conv2d_nhwc", grid)
    return build.MmaPlan(bm, bn, splits, per, cg % 4 == 0 and x_ptr % 16 == 0,
                         og % 4 == 0 and w_ptr % 16 == 0, grid)


def bf16_plan(pixels: int, k: int, og: int, groups: int, cg: int,
              x_ptr: int = 0, w_ptr: int = 0, sms: int = 132,
              image_pixels: Optional[int] = None,
              tile: Optional[Tuple[int, int]] = None) -> build.MmaPlan:
    """The launch of `gfid_conv2d_nhwc_bf16` for an implicit GEMM of
    `pixels` output rows (B x H_out x W_out), depth k = H_f x W_f x cg and
    og columns a group, on a card of `sms` SMs: the split of K from one
    image of `image_pixels` output rows (default `pixels`), the tile from
    BF16_TILES at `pixels` (not the wide one under a split), a fold where
    the batch's blocks fill the card; 16-byte copies of x where cg % 8 == 0
    and x is 16-byte aligned, of w where og % 8 == 0 and w is. `tile`, one
    of BF16_TILES and not the wide one under a split, replaces the tile the
    rule picks at `pixels` (ValueError for another); the fold follows from
    it, the split of K does not."""
    tiles_ = _default_tiles(BF16_TILES, og, cg, 8)
    splits, per = _image_split(tiles_, image_pixels or pixels, k, og, groups,
                               sms, BF16_MIN_SPLIT, build.MMA_BK)
    if tile is not None:
        tiles_ = (build.check_tile("gfid_conv2d_nhwc_bf16", tile,
                                   BF16_TILES),)
    if splits > 1:
        tiles_ = tuple(t for t in tiles_ if t[1] == 64)
        if not tiles_:
            raise ValueError(f"gfid_conv2d_nhwc_bf16: block tile {tile!r} "
                             f"is wide, and K is split {splits} ways")
    bm, bn, col_blocks, blocks = _pick_tile(tiles_, pixels, og, groups, sms)
    grid = (col_blocks, -(-pixels // bm), 1 if blocks >= sms else splits)
    build.check_grid("gfid_conv2d_nhwc_bf16", grid)
    return build.MmaPlan(bm, bn, splits, per, cg % 8 == 0 and x_ptr % 16 == 0,
                         og % 8 == 0 and w_ptr % 16 == 0, grid)


def _check_geometry(x: torch.Tensor, w: torch.Tensor, stride: int,
                    pad: int, groups: int, bias: Optional[torch.Tensor],
                    act: Optional[str]) -> None:
    check_act(act)
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"{tuple(w.shape)}")
    c_in, c_out = x.shape[3], w.shape[3]
    if groups < 1 or c_in % groups or c_out % groups \
            or c_in // groups != w.shape[2]:
        raise ValueError(f"groups mismatch: C_in={c_in}, groups={groups}, "
                         f"w={tuple(w.shape)}")
    if stride < 1 or pad < 0 or x.shape[1] + 2 * pad < w.shape[0] \
            or x.shape[2] + 2 * pad < w.shape[1]:
        raise ValueError(f"invalid stride={stride} / pad={pad} for x "
                         f"{tuple(x.shape)} and filter {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must have shape ({c_out},); "
                         f"got {tuple(bias.shape)}")


def _out_shape(x: torch.Tensor, w: torch.Tensor, stride: int,
               pad: int) -> Tuple[int, int, int, int]:
    h_out = (x.shape[1] + 2 * pad - w.shape[0]) // stride + 1
    w_out = (x.shape[2] + 2 * pad - w.shape[1]) // stride + 1
    return x.shape[0], h_out, w_out, w.shape[3]


def gfid_conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     pad: int = 0, groups: int = 1,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None,
                     out_dtype: Optional[torch.dtype] = None,
                     tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Conv of x (B, H_in, W_in, C_in) NHWC with w (H_f, W_f, C_in/groups,
    C_out) HWIO after symmetric zero padding `pad`. Returns (B, H_out,
    W_out, C_out) in `out_dtype` (default fp32), accumulated in fp32, with
    the optional fused epilogue in fp32: `bias` (C_out,) added to the
    accumulator, then `act` ("relu" | "gelu").

    x and w are both fp32 (entry `gfid_conv2d_nhwc_f32`, counted by
    `gfid_conv2d_nhwc.launches`) or both bf16 (entry
    `gfid_conv2d_nhwc_bf16`, counted by `gfid_conv2d_nhwc_bf16.launches`;
    the bias may be bf16 too, widened). The kernel stores
    `build.stored_dtype`, cast here to any other `out_dtype`.

    `tile` (bm, bn), one of `tiles_for` at these shapes, replaces the block
    tile of the entry's plan (the engine's tuner pins it); the split of K,
    and so every bit of the result, stays the plan's. A tile the entry
    cannot launch raises ValueError. On CPU and `meta` tensors the tile is
    checked, then ignored."""
    _check_geometry(x, w, stride, pad, groups, bias, act)
    is_bf16 = build.check_float_operands("gfid_conv2d_nhwc", x, w, bias)
    store = build.stored_dtype(is_bf16, out_dtype)
    shape = _out_shape(x, w, stride, pad)
    kind = x.device.type
    if tile is not None and kind != "cuda":
        _plan_for(x.dtype, shape, w.shape, groups, tile=tile)
    if kind == "cpu":
        out = gfid_conv2d_nhwc_plain(x, w, stride=stride, pad=pad,
                                     groups=groups, bias=bias, act=act,
                                     out_dtype=store)
    elif kind == "meta":
        out = torch.empty(shape, device="meta", dtype=store)
    elif kind != "cuda":
        raise ValueError(f"gfid_conv2d_nhwc runs on CUDA or CPU tensors, "
                         f"not {kind}")
    else:
        out = torch.empty(shape, device=x.device, dtype=store)
        if out.numel():
            _launch(x, w, bias, out, stride, pad, groups, act, is_bf16, tile)
    return out if out_dtype in (None, store) else out.to(out_dtype)


def _launch(x, w, bias, out, stride, pad, groups, act, is_bf16,
            tile=None) -> None:
    dims = (*x.shape, *w.shape[:2], w.shape[3], *out.shape[1:3], stride, pad,
            groups)
    lib, fn = _launcher_bf16() if is_bf16 else _launcher()
    h_f, w_f, cg, c_out = w.shape
    pixels = out.numel() // c_out
    plan = (bf16_plan if is_bf16 else f32_plan)(
        pixels, h_f * w_f * cg, c_out // groups, groups, cg, x.data_ptr(),
        w.data_ptr(), build.sm_count(x.device.index or 0),
        image_pixels=pixels // x.shape[0], tile=tile)
    ws = build.mma_workspace(plan, pixels, c_out, x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr())
    stores = (int(bias is not None and bias.dtype == torch.bfloat16),
              int(out.dtype == torch.bfloat16)) if is_bf16 else ()
    with torch.cuda.device(x.device):
        err = fn(*ptrs, *stores, *dims, plan.bm, plan.bn, plan.splits,
                 plan.chunks_per_split, ACT_CODES[act], int(plan.vec_x),
                 int(plan.vec_w), torch.cuda.current_stream().cuda_stream)
    name = "gfid_conv2d_nhwc_bf16" if is_bf16 else "gfid_conv2d_nhwc"
    build.check(lib, err, name)
    (gfid_conv2d_nhwc_bf16 if is_bf16 else gfid_conv2d_nhwc).launches += 1


gfid_conv2d_nhwc.launches = 0
gfid_conv2d_nhwc_bf16 = build.Launches("gfid_conv2d_nhwc_bf16")


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def gfid_conv2d_nhwc_int8_plain(xq: torch.Tensor, wq: torch.Tensor,
                                sx: torch.Tensor, sw: torch.Tensor, *,
                                stride: int = 1, pad: int = 0,
                                groups: int = 1,
                                bias: Optional[torch.Tensor] = None,
                                act: Optional[str] = None) -> torch.Tensor:
    """The plain version: the exact int32 GFID lowering
    (`gfid.conv2d_gfid_int8`), then `dequant_epilogue` with scale
    sx[b] * sw[c_out]."""
    acc = gfid.conv2d_gfid_int8(xq, wq, stride, pad, groups)
    scale = sx.reshape(-1, 1, 1, 1) * sw.reshape(1, 1, 1, -1)
    return dequant_epilogue(acc, scale, bias, act)


# xq, wq, sx, sw, bias, out; B, H_in, W_in, C_in, H_f, W_f, C_out, H_out,
# W_out, stride, pad, groups, bm, bn, splits, chunks_per_split, act, vec_x,
# vec_w; stream.
INT8_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 19 + [ctypes.c_void_p]


def int8_plan(pixels: int, k: int, og: int, groups: int, cg: int,
              x_ptr: int = 0, w_ptr: int = 0, sms: int = 132,
              tile: Optional[Tuple[int, int]] = None) -> build.MmaPlan:
    """The launch of `gfid_conv2d_nhwc_int8` for an implicit GEMM of
    `pixels` output rows (B x H_out x W_out), depth k = H_f x W_f x cg bytes
    and og columns a group, on a card of `sms` SMs: the tile from
    INT8_TILES, a split of K (one cluster of up to INT8_MAX_SPLIT blocks a
    tile) where the blocks leave the card idle; 16-byte copies of x where
    cg % 16 == 0 and x is 16-byte aligned, of w where og % 16 == 0 and w
    is. `tile`, one of INT8_TILES, replaces the tile the rule picks
    (ValueError for another); the split of K then follows the tile, as it
    may: integer sums are exact in any order, so no split changes a bit."""
    if tile is not None:
        tile = build.check_tile("gfid_conv2d_nhwc_int8", tile, INT8_TILES)
    bm, bn, splits, per, grid = _int8_tiling(pixels, k, og, groups, cg, sms,
                                             tile)
    return build.MmaPlan(bm, bn, splits, per, cg % 16 == 0 and x_ptr % 16 == 0,
                         og % 16 == 0 and w_ptr % 16 == 0, grid)


@functools.lru_cache(maxsize=1024)
def _int8_tiling(pixels: int, k: int, og: int, groups: int, cg: int,
                 sms: int, tile: Optional[Tuple[int, int]] = None
                 ) -> Tuple[int, int, int, int, Tuple[int, int, int]]:
    """int8_plan's (bm, bn, splits, chunks per split, grid): shapes alone,
    cached (the launch path runs it at every call)."""
    for bm, bn in (tile,) if tile else INT8_TILES:
        if not tile and bn > 64 and not (og > 64 and cg % 16):
            continue
        col_blocks = groups * -(-og // bn)
        tiles = max(-(-pixels // bm) * col_blocks, 1)
        if tiles >= sms:
            break
    want = 1 if tiles >= sms else min(-(-2 * sms // tiles), INT8_MAX_SPLIT)
    splits, per = build.mma_split(k, want, INT8_MIN_SPLIT, INT8_BK)
    grid = (-(-pixels // bm), col_blocks, splits)
    build.check_grid("gfid_conv2d_nhwc_int8", grid)
    return bm, bn, splits, per, grid


@functools.lru_cache(maxsize=None)
def _launcher_int8():
    lib = build.library("gfid_conv_int8")
    fn = lib.gfid_conv2d_nhwc_int8
    fn.argtypes = INT8_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def gfid_conv2d_nhwc_int8(xq: torch.Tensor, wq: torch.Tensor,
                          sx: torch.Tensor, sw: torch.Tensor, *,
                          stride: int = 1, pad: int = 0, groups: int = 1,
                          bias: Optional[torch.Tensor] = None,
                          act: Optional[str] = None,
                          tile: Optional[Tuple[int, int]] = None
                          ) -> torch.Tensor:
    """Conv of xq (B, H_in, W_in, C_in) NHWC int8 with wq (H_f, W_f,
    C_in/groups, C_out) HWIO int8 after symmetric zero padding `pad` (an
    int8 zero, exact). The int32 sums are dequantized with the per-example
    scales `sx` (B, 1) and the per-output-channel scales `sw` (1, C_out),
    with the optional `bias` (C_out,) and `act` ("relu" | "gelu") fused into
    the same epilogue. Returns (B, H_out, W_out, C_out) fp32. `tile`, one
    of INT8_TILES, replaces the plan's block tile (ValueError for another;
    checked, then ignored, on CPU and `meta` tensors)."""
    _check_geometry(xq, wq, stride, pad, groups, bias, act)
    b, h_in, w_in, c_in = xq.shape
    h_f, w_f, cg, c_out = wq.shape
    if tuple(sx.shape) != (b, 1) or tuple(sw.shape) != (1, c_out):
        raise ValueError(f"scales must be sx ({b}, 1) and sw (1, {c_out}); "
                         f"got {tuple(sx.shape)} and {tuple(sw.shape)}")
    build.check_int8_depth("gfid_conv2d_nhwc_int8", h_f * w_f * cg)
    build.check_int8_operands("gfid_conv2d_nhwc_int8", xq, wq, sx, sw, bias)
    h_out = (h_in + 2 * pad - h_f) // stride + 1
    w_out = (w_in + 2 * pad - w_f) // stride + 1
    if tile is not None and not xq.is_cuda:
        _plan_for(torch.int8, (b, h_out, w_out, c_out), wq.shape, groups,
                  tile=tile)
    if xq.is_cuda:
        out = xq.new_empty((b, h_out, w_out, c_out), dtype=torch.float32)
        if out.numel():
            _launch_int8(xq, wq, sx, sw, bias, out, stride, pad, groups, act,
                         tile)
        return out
    kind = xq.device.type
    if kind == "cpu":
        return gfid_conv2d_nhwc_int8_plain(xq, wq, sx, sw, stride=stride,
                                           pad=pad, groups=groups, bias=bias,
                                           act=act)
    if kind == "meta":
        return torch.empty((b, h_out, w_out, c_out), device="meta")
    raise ValueError(f"gfid_conv2d_nhwc_int8 runs on CUDA or CPU tensors, "
                     f"not {kind}")


def _launch_int8(xq, wq, sx, sw, bias, out, stride, pad, groups, act,
                 tile=None) -> None:
    """`gfid_conv2d_nhwc_int8` on CUDA tensors into `out` with its plan, on
    the current stream of xq's device (made current only when it is
    another); raise on a refused launch, count it."""
    b, h_in, w_in, c_in = xq.shape
    h_f, w_f, cg, c_out = wq.shape
    h_out, w_out = out.shape[1], out.shape[2]
    index = xq.get_device()
    x_ptr, w_ptr = xq.data_ptr(), wq.data_ptr()
    plan = int8_plan(b * h_out * w_out, h_f * w_f * cg, c_out // groups,
                     groups, cg, x_ptr, w_ptr, build.sm_count(index), tile)
    lib, fn = _launcher_int8()
    with build.on_device(index):
        err = fn(x_ptr, w_ptr, sx.data_ptr(), sw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, h_in, w_in, c_in, h_f, w_f, c_out, h_out, w_out, stride,
                 pad, groups, plan.bm, plan.bn, plan.splits,
                 plan.chunks_per_split, ACT_CODES[act], int(plan.vec_x),
                 int(plan.vec_w), build.raw_stream(index))
    build.check(lib, err, "gfid_conv2d_nhwc_int8")
    gfid_conv2d_nhwc_int8.launches += 1


gfid_conv2d_nhwc_int8.launches = 0


# ---------------------------------------------------------------------------
# The tiles a tuner may pin
# ---------------------------------------------------------------------------

def _plan_for(dtype: torch.dtype, out_shape, w_shape, groups: int,
              tile: Optional[Tuple[int, int]] = None, sms: int = 132):
    """The plan of the entry that runs operands of `dtype` (fp32, bf16 or
    int8) for a conv of output (B, H_out, W_out, C_out) and filter w (H_f,
    W_f, cg, C_out) at `tile`; ValueError where the entry refuses it."""
    b, h_out, w_out, c_out = out_shape
    h_f, w_f, cg, _ = w_shape
    pixels, k, og = b * h_out * w_out, h_f * w_f * cg, c_out // groups
    if dtype == torch.int8:
        return int8_plan(pixels, k, og, groups, cg, sms=sms, tile=tile)
    plan = bf16_plan if dtype == torch.bfloat16 else f32_plan
    return plan(pixels, k, og, groups, cg, sms=sms,
                image_pixels=h_out * w_out, tile=tile)


def tiles_for(out_shape, w_shape, groups: int = 1,
              dtype: torch.dtype = torch.float32,
              sms: int = 132) -> Tuple[Tuple[int, int], ...]:
    """The block tiles the entry for `dtype` launches for a conv of output
    (B, H_out, W_out, C_out) with filter w (H_f, W_f, C_in / groups, C_out)
    on a card of `sms` SMs: those of its tile set whose plan it accepts
    (the bf16 entry's wide tile not under a split; a grid within CUDA's
    limits), the rule's default among them."""
    out = []
    for t in {torch.int8: INT8_TILES,
              torch.bfloat16: BF16_TILES}.get(dtype, F32_TILES):
        try:
            _plan_for(dtype, out_shape, w_shape, groups, t, sms)
        except ValueError:
            continue
        out.append(t)
    return tuple(out)
