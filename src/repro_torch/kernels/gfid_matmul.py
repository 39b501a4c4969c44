"""FC mode of the multi-mode engine: the hand-written GEMMs that port the
Pallas kernel `repro.kernels.gfid_matmul.gfid_matmul` (`csrc/gfid_matmul.cu`
for fp32 operands on the CUDA cores, `csrc/gfid_matmul_bf16.cu` for bf16
operands on the tensor cores, both with an fp32 accumulator and both behind
the wrapper `gfid_matmul`) and `csrc/gfid_matmul_int8.cu` (int8 operands
on the int8 tensor cores, exact int32 accumulator, fused dequant, launched
with a block tile and a split of K from `int8_mm_plan`; the port of
`gfid_matmul_int8`), each with its plain PyTorch version.

Each wrapper launches its CUDA kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_matmul` launches the fp32 or the bf16 entry by
the operands' dtype; `gfid_matmul.launches`, `gfid_matmul_bf16.launches`
and `gfid_matmul_int8.launches` count each kernel's launches.

`gfid_matmul` also takes stacked operands, x (G, M, K) @ w (G, K, N) ->
(G, M, N): the grouped GEMMs of an MoE layer's experts, one launch of the
same entry with the group on grid y, counted on the entry's counter and on
`gfid_matmul_grouped` or `gfid_matmul_bf16_grouped`. Each group takes the
split of K of a launch of that group alone, so its bits are that launch's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import gfid, quant
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (ACT_CODES, apply_epilogue,
                                         check_act, dequant_epilogue)

# (rows of x, K chunk, columns) of the fp32 kernel's widest block tile:
# kBM, kKT, kBN in csrc/gfid_matmul.cu (the engine plan's tiling).
TILE = (128, 8, 128)
# (rows of x, K chunk in bytes, columns) of the widest block tile of
# csrc/gfid_matmul_int8.cu: kBM, kKT, kBN in that source.
TILE_INT8 = (32, 64, 128)
# csrc/gfid_matmul.cu's block tiles (rows, columns), TILE's first. Up to
# F32_FEW_ROWS rows, the first of 8, 32 or 64 rows that holds M, 64 columns
# wide, or as wide as F32_WIDE_COLUMNS gives where w holds F32_WIDE_BYTES
# or more (a stream of weights that is bound by bytes: long rows read by
# one block keep the memory's pages open); past them the widest tile where
# its blocks fill the card F32_FOLD_WAVES times over, else the 64 x 64 one.
F32_TILES = ((128, 128), (64, 64), (32, 256), (32, 64), (8, 512), (8, 64))
F32_BK = TILE[1]
F32_FEW_ROWS = 64
F32_WIDE_BYTES = 32 << 20
F32_WIDE_COLUMNS = {8: 512, 32: 256}
F32_FOLD_WAVES = 2
# Its split of K, from (K, N) alone so that a row's sums ignore M: splits
# until the column blocks of the few-row tile's width (64, or 512 where w is
# wide) times the splits reach F32_TARGET_BLOCKS of that width (528 blocks
# of 128 threads, or 264 of 256: 512 threads on each of an H100's 132 SMs),
# each split at least F32_MIN_SPLIT chunks of F32_BK deep (so that K = 576,
# smollm's, cuts into F32_MAX_CLUSTER splits). How the splits are added,
# always in split order (F32_MODES, the kernel's `mode`): where the plan's
# blocks fill the card F32_FOLD_WAVES times over without the split (many
# rows), each block runs every split ("fold"); on a few-row tile 64 columns
# wide with at most F32_MAX_CLUSTER splits (a decode step's GEMMs), a
# tile's splits run as one thread block cluster whose first block adds
# them ("cluster": one launch, where the host's time per call matters
# most); else each split writes a workspace that a second kernel adds
# ("split").
F32_TARGET_BLOCKS = {64: 528, 512: 264}
F32_MIN_SPLIT = 9
F32_MAX_CLUSTER = 8
F32_MODES = {"split": 0, "fold": 1, "cluster": 2}
# The tiles the source folds in (its many-row two); it clusters the
# 64-column ones and runs every tile in "split". A tuned tile (`tile=`)
# takes the same rules of mode, limited to those its kernel runs: these are
# filters. The choice of tile by M and the fold's F32_FOLD_WAVES above are
# rules of speed alone, so a tuner may take any tile of F32_TILES.
F32_FOLD_TILES = F32_TILES[:2]
# csrc/gfid_matmul_bf16.cu's block tiles (rows, columns): the first whose
# rows hold M (so that up to M = 64 each weight is read once), else the
# last. On the H100 a larger tile bought nothing at M = 1024 or 15,872: the
# loads from L2 bound the kernel there, not the tile's reuse.
BF16_TILES = ((16, 64), (32, 64), (64, 64))
# Its split of K, from (K, N) alone so that a row's sums ignore M: splits
# until the column blocks times the splits reach BF16_TARGET_BLOCKS (two
# blocks on each of an H100's 132 SMs), each split at least
# BF16_MIN_SPLIT chunks (1024 of K: smollm's K <= 1536 never splits).
BF16_TARGET_BLOCKS = 264
BF16_MIN_SPLIT = 32
# csrc/gfid_matmul_int8.cu's block tiles (rows, columns): 16 rows up to
# M = 16 (batch 1: a stream of weights), else 32 (batch 32: each weight byte
# read once a forward; more rows take more row blocks).
# Where the tiles leave the card idle, K is split for about
# INT8_MM_TARGET_BLOCKS blocks (two an SM of 132), at most INT8_MM_MAX_SPLIT
# splits (a tile's splits are one thread block cluster whose blocks add
# them; the entry's kMaxSplit), each at least INT8_MM_MIN_SPLIT chunks of
# INT8_MM_BK bytes. Integer sums are exact in any order, so the plan may
# follow M.
INT8_MM_TILES = ((16, 128), (32, 128))
INT8_MM_BK = TILE_INT8[1]
INT8_MM_TARGET_BLOCKS = 264
INT8_MM_MIN_SPLIT = 4
INT8_MM_MAX_SPLIT = 8
# The bytes a copy of wq (vec_w): 16 or 8 where N and wq's address allow,
# else 0 (gathered byte by byte).
INT8_MM_W_COPIES = (16, 8)


def gfid_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None,
                      out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version, for fp32 or bf16 operands: the FC mode's GEMM
    (`core.gfid.fc_gfid`) on the operands widened to fp32 (exact), then
    bias (widened) and activation in fp32, then the cast to `out_dtype`
    (default fp32)."""
    if x.ndim == 3:             # grouped: each group's own 2-D product
        return torch.stack([gfid_matmul_plain(xg, wg, bias=bias, act=act,
                                              out_dtype=out_dtype)
                            for xg, wg in zip(x, w)])
    out = apply_epilogue(gfid.fc_gfid(x.float(), w.float()),
                         None if bias is None else bias.float(), act)
    return out if out_dtype is None else out.to(out_dtype)


# The group count and the elements between groups of x and of w.
GROUP_ARGTYPES = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong]
# x, w, bias, out, ws; M, K, N, bm, bn, splits, chunks_per_split, mode, act,
# vec_x, vec_w; groups, stride_x, stride_w; stream.
F32_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + GROUP_ARGTYPES
                + [ctypes.c_void_p])
# x, w, bias, out, ws; bias_bf16, out_bf16, M, K, N, bm, bn, splits,
# chunks_per_split, act, vec_x, vec_w; groups, stride_x, stride_w; stream.
BF16_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + GROUP_ARGTYPES
                 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("gfid_matmul")
    fn = lib.gfid_matmul_f32
    fn.argtypes = F32_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _launcher_bf16():
    lib = build.library("gfid_matmul_bf16")
    fn = lib.gfid_matmul_bf16
    fn.argtypes = BF16_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


class F32Plan(NamedTuple):
    """One launch of `gfid_matmul_f32`: a block tile of `bm` rows x `bn`
    columns, K cut into `splits` runs of `chunks_per_split` chunks of
    F32_BK, added in split order as `mode` says ("split": one split a
    block on grid z, through a workspace when `splits` > 1; "cluster": a
    tile's splits as one cluster; "fold": every split in each block);
    16-byte copies of x and of w where `vec_x` and `vec_w` allow; the
    launch grid."""
    bm: int
    bn: int
    splits: int
    chunks_per_split: int
    mode: str
    vec_x: bool
    vec_w: bool
    grid: Tuple[int, int, int]

    @property
    def workspace(self) -> bool:
        """Whether the launch needs the (splits, M, N) fp32 workspace."""
        return self.splits > 1 and self.mode == "split"


def _vec(width: int, ptr: int, stride: int, elems: int) -> bool:
    """Whether an operand takes 16-byte copies of `elems` values: its row
    width a multiple of them, its base 16-byte aligned, and (stacked) its
    groups a multiple of them apart, so that every group's base is too."""
    return width % elems == 0 and ptr % 16 == 0 and stride % elems == 0


def f32_plan(m: int, k: int, n: int, x_ptr: int = 0, w_ptr: int = 0,
             sms: int = 132, groups: int = 1,
             tile: Optional[Tuple[int, int]] = None) -> F32Plan:
    """The launch of `gfid_matmul_f32` for x (m, k) @ w (k, n), or for
    `groups` such products stacked (x (groups, m, k) and w (groups, k, n),
    contiguous), at those base addresses on a card of `sms` SMs: the split
    of K from (k, n) alone, so that every row's sums run in one order at
    any m and in any group; the tile and the mode from m and from how many
    blocks the groups give the card (the splits are added in split order in
    every mode, so neither changes a bit); 16-byte loads of x where k % 4 ==
    0 and x and every group of it are 16-byte aligned, of w likewise with
    n. The grid's y is groups x row blocks. `tile`, one of F32_TILES,
    replaces the tile the rule picks (ValueError for another); the mode and
    the grid follow from it, the split of K does not."""
    if tile is not None:
        tile = build.check_tile("gfid_matmul", tile, F32_TILES)
    return _f32_plan(m, k, n, _vec(k, x_ptr, m * k, 4),
                     _vec(n, w_ptr, k * n, 4), sms, groups, tile)


@functools.lru_cache(maxsize=4096)
def _f32_plan(m: int, k: int, n: int, vec_x: bool, vec_w: bool,
              sms: int, groups: int = 1,
              tile: Optional[Tuple[int, int]] = None) -> F32Plan:
    wide = 4 * k * n >= F32_WIDE_BYTES
    width = 512 if wide else 64
    splits, per = build.mma_split(
        k, -(-F32_TARGET_BLOCKS[width] // max(-(-n // width), 1)),
        F32_MIN_SPLIT, F32_BK)
    if tile is not None:
        bm, bn = tile
    elif m <= F32_FEW_ROWS:
        bm = next(r for r in (8, 32, 64) if m <= r)
        bn = F32_WIDE_COLUMNS.get(bm, 64) if wide else 64
    else:
        bm, bn = F32_TILES[0]
        if groups * -(-m // bm) * -(-n // bn) < F32_FOLD_WAVES * sms:
            bm, bn = F32_TILES[1]
    grid = (-(-n // bn), groups * -(-m // bm), splits)
    if splits > 1 and m > F32_FEW_ROWS and (bm, bn) in F32_FOLD_TILES \
            and grid[0] * grid[1] >= F32_FOLD_WAVES * sms:
        mode, grid = "fold", grid[:2] + (1,)
    elif m <= F32_FEW_ROWS and bn == 64 and 1 < splits <= F32_MAX_CLUSTER:
        mode = "cluster"
    else:
        mode = "split"
    build.check_grid("gfid_matmul", grid)
    return F32Plan(bm, bn, splits, per, mode, vec_x, vec_w, grid)


def bf16_plan(m: int, k: int, n: int, x_ptr: int = 0,
              w_ptr: int = 0, groups: int = 1,
              tile: Optional[Tuple[int, int]] = None) -> build.MmaPlan:
    """The launch of `gfid_matmul_bf16` for x (m, k) @ w (k, n), or for
    `groups` such products stacked, at those base addresses: BM from m; the
    split of K from (k, n) alone, so that every row's sums run in one order
    at any m and in any group; 16-byte loads of x where k % 8 == 0 and x
    and every group of it are 16-byte aligned, of w likewise with n. The
    grid's y is groups x row blocks. `tile`, one of BF16_TILES, replaces
    the tile that m picks (a rule of speed alone; ValueError for another
    tile); the split of K stays the rule's."""
    if tile is not None:
        tile = build.check_tile("gfid_matmul_bf16", tile, BF16_TILES)
    return _bf16_plan(m, k, n, _vec(k, x_ptr, m * k, 8),
                      _vec(n, w_ptr, k * n, 8), groups, tile)


@functools.lru_cache(maxsize=4096)
def _bf16_plan(m: int, k: int, n: int, vec_x: bool, vec_w: bool,
               groups: int = 1, tile: Optional[Tuple[int, int]] = None
               ) -> build.MmaPlan:
    bm, bn = next((t for t in BF16_TILES if m <= t[0]), BF16_TILES[-1])
    splits, per = build.mma_split(
        k, -(-BF16_TARGET_BLOCKS // max(-(-n // bn), 1)), BF16_MIN_SPLIT)
    if tile is not None:
        bm, bn = tile
    col_blocks = -(-n // bn)
    grid = (col_blocks, groups * -(-m // bm), splits)
    build.check_grid("gfid_matmul_bf16", grid)
    return build.MmaPlan(bm, bn, splits, per, vec_x, vec_w, grid)


def _check_shapes(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor], act: Optional[str]) -> None:
    check_act(act)
    if not ((x.ndim == w.ndim == 2 and x.shape[1] == w.shape[0])
            or (x.ndim == w.ndim == 3 and x.shape[0] == w.shape[0]
                and x.shape[2] == w.shape[1])):
        raise ValueError(f"gfid_matmul takes (M, K) @ (K, N) or (G, M, K) @ "
                         f"(G, K, N); got {tuple(x.shape)} @ {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[-1],):
        raise ValueError(f"bias must have shape ({w.shape[-1]},); "
                         f"got {tuple(bias.shape)}")


def gfid_matmul(x: torch.Tensor, w: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                out_dtype: Optional[torch.dtype] = None,
                tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) -> (M, N) in `out_dtype` (default fp32),
    accumulated in fp32, with the optional fused epilogue in fp32: `bias`
    (N,) added to the accumulator, then `act` ("relu" | "gelu"). Stacked
    operands x (G, M, K) @ w (G, K, N) give (G, M, N), every group's product
    in one launch, the bias shared by the groups.

    x and w are both fp32 (entry `gfid_matmul_f32`, counted by
    `gfid_matmul.launches`) or both bf16 (entry `gfid_matmul_bf16`, counted
    by `gfid_matmul_bf16.launches`; the bias may be bf16 too, widened); a
    grouped launch is counted by `gfid_matmul_grouped` or
    `gfid_matmul_bf16_grouped` too. The kernel stores
    `build.stored_dtype`: bf16 on bf16 operands when asked (the fp32 result
    rounded once to nearest even), else fp32, cast here to any other
    `out_dtype`.

    `tile` (bm, bn), one of `tiles_for` at these shapes, replaces the block
    tile of the entry's plan (the engine's tuner pins it); the split of K,
    and so every bit of the result, stays the plan's. A tile the entry
    cannot launch, or any tile for stacked operands, raises ValueError.
    On CPU and `meta` tensors the tile is checked, then ignored."""
    _check_shapes(x, w, bias, act)
    is_bf16 = build.check_float_operands("gfid_matmul", x, w, bias)
    store = build.stored_dtype(is_bf16, out_dtype)
    shape = x.shape[:-1] + w.shape[-1:]
    if tile is not None:
        if x.ndim == 3:
            raise ValueError("gfid_matmul: the grouped launch takes no tile")
        if not x.is_cuda:
            _plan_for(x.dtype, *x.shape, w.shape[1], tile)
    if x.is_cuda:
        out = _launch(x, w, bias, act, is_bf16, store, tile) \
            if shape.numel() else x.new_empty(shape, dtype=store)
    else:
        kind = x.device.type
        if kind == "cpu":
            out = gfid_matmul_plain(x, w, bias=bias, act=act, out_dtype=store)
        elif kind == "meta":
            out = torch.empty(shape, device="meta", dtype=store)
        else:
            raise ValueError(f"gfid_matmul runs on CUDA or CPU tensors, "
                             f"not {kind}")
    return out if out_dtype is None or out_dtype == store \
        else out.to(out_dtype)


def _launch(x, w, bias, act, is_bf16, store, tile=None) -> torch.Tensor:
    """Allocate the (M, N) or (G, M, N) output in `store` and launch the
    entry of the operands' dtype into it with its plan, on the current
    stream of x's device (made current only when it is another); raise on
    a refused launch, count it, and return the output. A split launch's
    fp32 workspace, (splits, G, M, N), shares the output's allocation (one
    allocation on the host's path, freed with the output); the bf16
    entry's is an allocation of its own."""
    groups = x.shape[0] if x.ndim == 3 else 1
    m, k = x.shape[-2:]
    n = w.shape[-1]
    size = groups * m * n
    index = x.get_device()
    x_ptr, w_ptr = x.data_ptr(), w.data_ptr()
    b_ptr = None if bias is None else bias.data_ptr()
    if is_bf16:
        lib, fn = _launcher_bf16()
        plan = bf16_plan(m, k, n, x_ptr, w_ptr, groups, tile)
        out = x.new_empty(size, dtype=store)
        ws = build.mma_workspace(plan, groups * m, n, out.device)
        args = (x_ptr, w_ptr, b_ptr, out.data_ptr(),
                None if ws is None else ws.data_ptr(),
                int(bias is not None and bias.dtype == torch.bfloat16),
                int(store == torch.bfloat16), m, k, n, plan.bm, plan.bn,
                plan.splits, plan.chunks_per_split, ACT_CODES[act],
                int(plan.vec_x), int(plan.vec_w))
    else:
        lib, fn = _launcher()
        plan = f32_plan(m, k, n, x_ptr, w_ptr, build.sm_count(index), groups,
                        tile)
        if plan.workspace:     # the output, then the splits' partial sums
            out = x.new_empty((plan.splits + 1) * size)[:size]
            ws_ptr = out.data_ptr() + 4 * size
        else:
            out, ws_ptr = x.new_empty(size), None
        args = (x_ptr, w_ptr, b_ptr, out.data_ptr(), ws_ptr, m, k, n, plan.bm,
                plan.bn, plan.splits, plan.chunks_per_split,
                F32_MODES[plan.mode], ACT_CODES[act], int(plan.vec_x),
                int(plan.vec_w))
    with build.on_device(index):
        err = fn(*args, groups, m * k, k * n, build.raw_stream(index))
    build.check(lib, err, "gfid_matmul_bf16" if is_bf16 else "gfid_matmul")
    (gfid_matmul_bf16 if is_bf16 else gfid_matmul).launches += 1
    if x.ndim == 3:
        (gfid_matmul_bf16_grouped if is_bf16
         else gfid_matmul_grouped).launches += 1
    return out.view(x.shape[:-1] + w.shape[-1:])


gfid_matmul.launches = 0
gfid_matmul_bf16 = build.Launches("gfid_matmul_bf16")
# the grouped launches among each entry's
gfid_matmul_grouped = build.Launches("gfid_matmul_grouped")
gfid_matmul_bf16_grouped = build.Launches("gfid_matmul_bf16_grouped")


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def gfid_matmul_int8_plain(xq: torch.Tensor, wq: torch.Tensor,
                           sx: torch.Tensor, sw: torch.Tensor, *,
                           bias: Optional[torch.Tensor] = None,
                           act: Optional[str] = None) -> torch.Tensor:
    """The plain version: the exact int32 product (`quant.int8_matmul_i32`),
    then `dequant_epilogue` with scale sx * sw."""
    return dequant_epilogue(quant.int8_matmul_i32(xq, wq), sx * sw, bias, act)


# xq, wq, sx, sw, bias, out; M, K, N, bm, bn, splits, chunks_per_split, act,
# vec_x, vec_w; stream.
INT8_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher_int8():
    lib = build.library("gfid_matmul_int8")
    fn = lib.gfid_matmul_int8
    fn.argtypes = INT8_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def int8_mm_plan(m: int, k: int, n: int, x_ptr: int = 0, w_ptr: int = 0,
                 sms: int = 132,
                 tile: Optional[Tuple[int, int]] = None) -> build.MmaPlan:
    """The launch of `gfid_matmul_int8` for xq (m, k) @ wq (k, n) at those
    base addresses on a card of `sms` SMs: the tile from INT8_MM_TILES by m,
    a split of K (one cluster of up to INT8_MM_MAX_SPLIT blocks a tile)
    where the tiles leave the card idle; 16-byte copies of xq where
    k % 16 == 0 and xq is 16-byte aligned; `vec_w` the bytes a copy of wq,
    16 or 8 where n and wq's address are multiples of it, else 0 (bytes
    gathered). `tile`, one of INT8_MM_TILES, replaces the tile that m picks
    (ValueError for another); the split of K then follows the tile, as it
    may: integer sums are exact in any order, so no split changes a bit."""
    if tile is not None:
        tile = build.check_tile("gfid_matmul_int8", tile, INT8_MM_TILES)
    bm, bn, splits, per, grid = _int8_mm_tiling(m, k, n, sms, tile)
    vec_w = next((c for c in INT8_MM_W_COPIES
                  if n % c == 0 and w_ptr % c == 0), 0)
    return build.MmaPlan(bm, bn, splits, per, k % 16 == 0 and x_ptr % 16 == 0,
                         vec_w, grid)


@functools.lru_cache(maxsize=1024)
def _int8_mm_tiling(m: int, k: int, n: int, sms: int,
                    tile: Optional[Tuple[int, int]] = None
                    ) -> Tuple[int, int, int, int, Tuple[int, int, int]]:
    """int8_mm_plan's (bm, bn, splits, chunks per split, grid): shapes
    alone, cached (the launch path runs it at every call)."""
    bm, bn = tile or next((t for t in INT8_MM_TILES if m <= t[0]),
                          INT8_MM_TILES[-1])
    tiles = max(-(-m // bm) * -(-n // bn), 1)
    want = 1 if tiles >= sms else min(-(-INT8_MM_TARGET_BLOCKS // tiles),
                                      INT8_MM_MAX_SPLIT)
    splits, per = build.mma_split(k, want, INT8_MM_MIN_SPLIT, INT8_MM_BK)
    grid = (-(-m // bm), -(-n // bn), splits)
    build.check_grid("gfid_matmul_int8", grid)
    return bm, bn, splits, per, grid


def _check_int8(xq, wq, sx, sw, bias, act) -> None:
    check_act(act)
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"gfid_matmul_int8 takes (M, K) @ (K, N); got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    m, n = xq.shape[0], wq.shape[1]
    if tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(f"scales must be sx ({m}, 1) and sw (1, {n}); got "
                         f"{tuple(sx.shape)} and {tuple(sw.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must have shape ({n},); "
                         f"got {tuple(bias.shape)}")
    build.check_int8_depth("gfid_matmul_int8", xq.shape[1])
    build.check_int8_operands("gfid_matmul_int8", xq, wq, sx, sw, bias)


def gfid_matmul_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None,
                     tile: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """xq (M, K) int8 @ wq (K, N) int8 -> (M, N) fp32: the exact int32 sum,
    dequantized with the per-row scales `sx` (M, 1) and per-column scales
    `sw` (1, N), with the optional `bias` (N,) and `act` ("relu" | "gelu")
    fused into the same epilogue. `tile`, one of INT8_MM_TILES, replaces
    the plan's block tile (ValueError for another; checked, then ignored,
    on CPU and `meta` tensors)."""
    _check_int8(xq, wq, sx, sw, bias, act)
    m, n = xq.shape[0], wq.shape[1]
    if tile is not None and not xq.is_cuda:
        int8_mm_plan(m, xq.shape[1], n, tile=tile)
    if xq.is_cuda:
        out = xq.new_empty((m, n), dtype=torch.float32)
        if out.numel():
            _launch_int8(xq, wq, sx, sw, bias, act, out, tile)
        return out
    kind = xq.device.type
    if kind == "cpu":
        return gfid_matmul_int8_plain(xq, wq, sx, sw, bias=bias, act=act)
    if kind == "meta":
        return torch.empty((m, n), device="meta")
    raise ValueError(f"gfid_matmul_int8 runs on CUDA or CPU tensors, "
                     f"not {kind}")


def _launch_int8(xq, wq, sx, sw, bias, act, out, tile=None) -> None:
    """`gfid_matmul_int8` on CUDA tensors into `out` with its plan, on the
    current stream of xq's device (made current only when it is another);
    raise on a refused launch, count it. One launch, nothing allocated
    beside the output."""
    m, k = xq.shape
    n = wq.shape[1]
    index = xq.get_device()
    x_ptr, w_ptr = xq.data_ptr(), wq.data_ptr()
    plan = int8_mm_plan(m, k, n, x_ptr, w_ptr, build.sm_count(index), tile)
    lib, fn = _launcher_int8()
    with build.on_device(index):
        err = fn(x_ptr, w_ptr, sx.data_ptr(), sw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, k, n, plan.bm, plan.bn, plan.splits,
                 plan.chunks_per_split, ACT_CODES[act], int(plan.vec_x),
                 plan.vec_w, build.raw_stream(index))
    build.check(lib, err, "gfid_matmul_int8")
    gfid_matmul_int8.launches += 1


gfid_matmul_int8.launches = 0


# ---------------------------------------------------------------------------
# The tiles a tuner may pin
# ---------------------------------------------------------------------------

def _plan_for(dtype: torch.dtype, m: int, k: int, n: int,
              tile: Optional[Tuple[int, int]] = None, sms: int = 132):
    """The plan of the entry that runs operands of `dtype` (fp32, bf16 or
    int8) for (m, k) @ (k, n) at `tile`; ValueError where the entry refuses
    it."""
    if dtype == torch.int8:
        return int8_mm_plan(m, k, n, sms=sms, tile=tile)
    if dtype == torch.bfloat16:
        return bf16_plan(m, k, n, tile=tile)
    return f32_plan(m, k, n, sms=sms, tile=tile)


def tiles_for(m: int, k: int, n: int, dtype: torch.dtype = torch.float32,
              sms: int = 132) -> Tuple[Tuple[int, int], ...]:
    """The block tiles the entry for `dtype` launches for (m, k) @ (k, n) on
    a card of `sms` SMs: those of its tile set whose plan it accepts (a
    grid within CUDA's limits), the rule's default among them."""
    out = []
    for t in {torch.int8: INT8_MM_TILES,
              torch.bfloat16: BF16_TILES}.get(dtype, F32_TILES):
        try:
            _plan_for(dtype, m, k, n, t, sms)
        except ValueError:
            continue
        out.append(t)
    return tuple(out)
