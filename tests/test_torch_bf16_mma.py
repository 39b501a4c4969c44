"""The launch plans and C interfaces of the port's block-tiled kernels: the
bf16 tensor-core GEMM and conv, and the fp32 implicit-GEMM conv.

`csrc/gfid_matmul_bf16.cu` and `csrc/gfid_conv_bf16.cu` run only on the card
(`python3 chip_smoke.py` holds them against their plain versions there, with
a bitwise row-invariance check of the GEMM). What decides their launches is
Python that runs here: `gfid_matmul.bf16_plan` and `gfid_conv.bf16_plan`
pick the block rows, the split of K and the 16-byte load paths, and
`gfid_conv.f32_plan` does the same for `csrc/gfid_conv.cu`. These tests
hold the plans to the kernels' contracts:

  * the GEMM's K order (chunk depth, split count, chunks a split) is the same
    at every M, so a row's sums ignore the rows beside it (the serving
    scheduler's bitwise tokens rest on it); only the block rows follow M;
  * the 16-byte copies are asked for only where K (or cg) and N (or og) are
    multiples of 8 and the base pointer is 16-byte aligned;
  * every grid fits CUDA's launch limits at the paths' largest shapes;
  * the fp32 conv's plan fills the card or splits K at every conv of
    AlexNet, VGG-16 and ResNet-50 at batch 1 and 32, with 16-byte copies
    where cg (og) is a multiple of 4 on an aligned pointer;
  * every `extern "C"` entry of `csrc/` has the arity and the pointer, int,
    long long or float kinds of the ctypes argtypes its wrapper binds;
  * the fp32 GEMM's plan `gfid_matmul.f32_plan`: its split of K from (K, N)
    alone, so every row's sums run in one order at any M; the few-row
    tiles' column blocks times the splits about 512 threads an SM where K
    is deep enough; only the tile and the way the splits are added (a
    workspace, a cluster, a fold) follow M; 16-byte load flags from K, N
    and alignment. A torch-op emulation of its sum order (one fmaf chain a
    split, splits in order, then the epilogue) is within 1e-5 x max of the
    Pallas `gfid_matmul` in interpret mode and bitwise row-invariant;
  * the fp32 and bf16 branches of `gfid_matmul._launch` and the gather's
    CUDA branch (library and stream faked) pass their plans, workspace and
    arguments in the C signature's order, count each launch and raise on a
    refused one; the lean operand checks still refuse a wrong dtype, a
    non-contiguous operand and operands on two devices;
  * the fp32 flash kernel (`csrc/flash_attention.cu`): a torch-op emulation
    of its algorithm (kv tiles of KV_TILE keys, the tile's row max, one exp
    a score, 16 lanes' partial sums of a row added at the end, P . V) within
    1e-5 of the Pallas kernel in interpret mode at the forward cases of
    tests/test_flash.py and tests/test_kernels.py; KV_TILE and Q_ROWS equal
    to the source's; the source on fp32 FMAs fed by `cp.async` (through the
    shared csrc/smem.cuh) with the accurate `expf`; `f32_launch`'s grid and
    copy flag; its launch arguments, counter and refusal with the library
    faked;
  * the int8 conv on the int8 tensor cores (`csrc/gfid_conv_int8.cu`,
    `csrc/mma_int8.cuh`): the B tile's byte transpose mirrored in numpy
    (the source's `__byte_perm` selectors) bitwise equal to wq's (C_out, K)
    view; the channel-major swizzle conflict-free for `ldmatrix`;
    `int8_plan`'s tile, split (one cluster of at most INT8_MAX_SPLIT, the
    entry's kMaxSplit) and
    grid at AlexNet's five convs at batch 1 and 32 and ragged shapes; the
    wrapper's CUDA branch (library faked) passing its plan in the C
    signature's order, counting, refusing; its lean checks still refusing;
  * the int8 GEMM on the same core (`csrc/gfid_matmul_int8.cu`):
    `int8_mm_plan`'s tile, split (one cluster of at most INT8_MM_MAX_SPLIT)
    and load paths at AlexNet's FC shapes and ragged ones; the source's
    tiles, split cap and the absence of `__dp4a`, workspace, ticket and
    atomic; a numpy mirror of its loader, B transpose and cluster sum
    bitwise equal to the Pallas `gfid_matmul_int8` in interpret mode; the
    wrapper's CUDA branch (one allocation, the C order, counting,
    refusing) and its lean checks.
"""
import ctypes
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jax_quant
from repro.kernels import gfid_matmul as jax_matmul
from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                 gfid_matmul, paged)
from repro_torch.kernels.epilogue import (ACT_CODES, apply_epilogue,
                                         dequant_epilogue)
from repro_torch.models import cnn

jax.config.update("jax_platform_name", "cpu")

# (K, N) of every GEMM the bf16 entry runs on the port's paths: AlexNet's
# fc6-8, smollm-135m's four layer GEMMs and tied unembedding, and the
# ragged shapes `chip_smoke.py` checks.
MM_SHAPES = [(9216, 4096), (4096, 4096), (4096, 1000), (576, 576),
             (576, 192), (576, 1536), (1536, 576), (576, 49152), (300, 70),
             (1000, 33), (257, 129), (4096, 512)]
# Row counts from one row to past a prompt-2048 prefill's 8 x 2048, with
# every tile boundary of gfid_matmul.BF16_TILES and one past it.
MM_ROWS = (1, 2, 7, 8, 13, 15, 16, 17, 31, 32, 33, 40, 63, 64, 65, 127, 128,
           129, 1000, 1024, 8 * 1984, 8 * 2048, 20000)


@pytest.mark.parametrize("k,n", MM_SHAPES)
def test_gemm_k_order_and_split_ignore_m(k, n):
    first = gfid_matmul.bf16_plan(1, k, n)
    n_chunks = -(-k // build.MMA_BK)
    for m in MM_ROWS:
        plan = gfid_matmul.bf16_plan(m, k, n)
        assert (plan.splits, plan.chunks_per_split) == \
            (first.splits, first.chunks_per_split), m
        assert plan.bn == first.bn and plan.grid[0] == first.grid[0] \
            and plan.grid[2] == first.splits
        # only BM follows M: the smallest tile that holds M, else the largest
        rows = [bm for bm, _ in gfid_matmul.BF16_TILES]
        assert plan.bm == min([b for b in rows if b >= m], default=rows[-1])
        assert (plan.grid[1] - 1) * plan.bm < m <= plan.grid[1] * plan.bm
    # the splits cover the chunks, none empty
    assert (first.splits - 1) * first.chunks_per_split < n_chunks \
        <= first.splits * first.chunks_per_split
    assert first.splits == 1 or first.chunks_per_split >= gfid_matmul.BF16_MIN_SPLIT


def test_gemm_splits_where_the_columns_leave_the_card_idle():
    """fc6-8 split K (64 and 16 column blocks for 132 SMs); smollm's
    GEMMs (K <= 1536) never do, so their prefills at M = 15,872 write no
    workspace."""
    for k, n in MM_SHAPES[:3]:
        assert gfid_matmul.bf16_plan(1, k, n).splits > 1
    for k, n in MM_SHAPES[3:8]:
        assert gfid_matmul.bf16_plan(15872, k, n).splits == 1


ALEXNET_CONVS, _ = cnn.analytics_layers("alexnet")


def _conv_plan(spec, batch, sms=132):
    cg = spec.c_in // spec.groups
    return gfid_conv.bf16_plan(batch * spec.h_out * spec.w_out,
                               spec.h_f * spec.w_f * cg,
                               spec.c_out // spec.groups, spec.groups, cg,
                               sms=sms, image_pixels=spec.h_out * spec.w_out)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("spec", ALEXNET_CONVS, ids=lambda s: s.name)
def test_conv_plan_fills_the_card_and_covers_the_gemm(spec, batch):
    sms = 132
    plan = _conv_plan(spec, batch, sms)
    cg = spec.c_in // spec.groups
    og = spec.c_out // spec.groups
    pixels = batch * spec.h_out * spec.w_out
    n_chunks = -(-spec.h_f * spec.w_f * cg // build.MMA_BK)
    assert (plan.bm, plan.bn) in gfid_conv.BF16_TILES
    assert plan.bn == 64 or og > 64
    tiles = spec.groups * -(-og // plan.bn) * -(-pixels // plan.bm)
    assert plan.grid == (spec.groups * -(-og // plan.bn),
                         -(-pixels // plan.bm),
                         1 if tiles >= sms else plan.splits)
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    # the split of K is one image's, at every batch
    one = _conv_plan(spec, 1, sms)
    assert (plan.splits, plan.chunks_per_split) \
        == (one.splits, one.chunks_per_split)
    if tiles >= sms:    # one block a tile, a split folded on a 64-wide tile
        assert plan.splits == 1 or (plan.fold and plan.bn == 64)
    else:       # the smallest tile, and K split unless too shallow to
        assert (plan.bm, plan.bn) == gfid_conv.BF16_TILES[-1]
        assert plan.splits > 1 or n_chunks < 2 * gfid_conv.BF16_MIN_SPLIT
    # at batch 32 every layer fills the card, conv1 (cg = 3, og = 96) unsplit
    # on the wide tile, conv2-5 folding the split they take at batch 1,
    # where conv3-5 (169 pixels) split K
    if batch == 32:
        assert tiles >= sms and (plan.bn == 128) == (spec.name == "conv1")
        assert plan.fold == (spec.name != "conv1")
    elif spec.name in ("conv3", "conv4", "conv5"):
        assert plan.splits > 1


@pytest.mark.parametrize("k,n,vec", [(576, 576, (True, True)),
                                     (300, 70, (False, False)),
                                     (1000, 33, (True, False)),
                                     (257, 128, (False, True))])
def test_gemm_vector_flags_follow_k_and_n(k, n, vec):
    plan = gfid_matmul.bf16_plan(8, k, n)
    assert (plan.vec_x, plan.vec_w) == vec


def _offset_view(shape):
    """A contiguous bf16 view one element past the start of its storage:
    2 bytes off any 16-byte boundary."""
    flat = torch.zeros(1 + int(torch.tensor(shape).prod()), dtype=torch.bfloat16)
    view = flat[1:].view(shape)
    assert view.is_contiguous() and view.storage_offset() == 1
    return view


def test_vector_flags_are_off_for_a_view_with_a_storage_offset():
    x, w = _offset_view((24, 512)), _offset_view((512, 256))
    aligned = torch.zeros((512, 256), dtype=torch.bfloat16)
    assert aligned.data_ptr() % 16 == 0 and x.data_ptr() % 16 == 2
    plan = gfid_matmul.bf16_plan(24, 512, 256, x.data_ptr(), w.data_ptr())
    assert (plan.vec_x, plan.vec_w) == (False, False)
    plan = gfid_matmul.bf16_plan(24, 512, 256, x.data_ptr(), aligned.data_ptr())
    assert (plan.vec_x, plan.vec_w) == (False, True)
    xc = _offset_view((1, 13, 13, 256))
    plan = gfid_conv.bf16_plan(169, 9 * 256, 384, 1, 256, xc.data_ptr(),
                               aligned.data_ptr())
    assert (plan.vec_x, plan.vec_w) == (False, True)


@pytest.mark.parametrize("cg,og,vec", [(3, 96, (False, True)),
                                       (48, 128, (True, True)),
                                       (5, 7, (False, False)),
                                       (64, 20, (True, False))])
def test_conv_vector_flags_follow_the_group_widths(cg, og, vec):
    plan = gfid_conv.bf16_plan(3025, 9 * cg, og, 1, cg)
    assert (plan.vec_x, plan.vec_w) == vec


def test_grids_fit_the_launch_limits_at_the_paths_largest_shapes():
    for k, n in MM_SHAPES:
        grid = gfid_matmul.bf16_plan(20000, k, n).grid
        assert all(g <= lim for g, lim in zip(grid, build.GRID_LIMITS))
    for spec in ALEXNET_CONVS:
        grid = _conv_plan(spec, 32).grid
        assert all(g <= lim for g, lim in zip(grid, build.GRID_LIMITS))
    # past the y limit (65,535 row tiles) the plan raises, no launch
    with pytest.raises(ValueError, match="launch grid"):
        gfid_matmul.bf16_plan(128 * 65535 + 1, 576, 576)
    with pytest.raises(ValueError, match="launch grid"):
        gfid_conv.bf16_plan(128 * 65535 + 1, 27, 64, 1, 3)


# Every conv of the three CNNs the fp32 path runs, by name.
CNN_CONVS = [spec for net in ("alexnet", "vgg16", "resnet50")
             for spec in cnn.analytics_layers(net)[0]]


def _f32_plan(spec, batch, sms=132):
    cg = spec.c_in // spec.groups
    return gfid_conv.f32_plan(batch * spec.h_out * spec.w_out,
                              spec.h_f * spec.w_f * cg,
                              spec.c_out // spec.groups, spec.groups, cg,
                              sms=sms, image_pixels=spec.h_out * spec.w_out)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("spec", CNN_CONVS, ids=lambda s: s.name)
def test_f32_conv_plan_fills_the_card_or_splits_k(spec, batch):
    """At each conv the plan's blocks fill the 132 SMs on the first tile
    that does, or, on the smallest tile, K is split (unless too shallow to);
    the split is one image's at every batch, folded where the blocks fill
    the card; the splits cover K's chunks with none empty; the grid is the
    tile's."""
    sms = 132
    plan = _f32_plan(spec, batch, sms)
    cg = spec.c_in // spec.groups
    og = spec.c_out // spec.groups
    pixels = batch * spec.h_out * spec.w_out
    n_chunks = -(-spec.h_f * spec.w_f * cg // gfid_conv.F32_BK)
    assert (plan.bm, plan.bn) in gfid_conv.F32_TILES
    assert plan.bn == 64 or og > 64
    tiles = spec.groups * -(-og // plan.bn) * -(-pixels // plan.bm)
    assert plan.grid == (tiles, 1, 1 if tiles >= sms else plan.splits)
    assert all(g <= lim for g, lim in zip(plan.grid, build.GRID_LIMITS))
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    assert plan.splits == 1 or plan.chunks_per_split >= gfid_conv.F32_MIN_SPLIT
    one = _f32_plan(spec, 1, sms)
    assert (plan.splits, plan.chunks_per_split) \
        == (one.splits, one.chunks_per_split)
    if tiles >= sms:
        assert plan.splits == 1 or plan.fold
        wider = [t for t in gfid_conv.F32_TILES[:gfid_conv.F32_TILES.index(
            (plan.bm, plan.bn))] if t[1] == 64 or og % t[1] == 0
            or (og > 64 and cg % 4)]
        for bm, bn in wider:   # a wider tile would not have filled the card
            assert spec.groups * -(-og // bn) * -(-pixels // bm) < sms
    else:
        assert (plan.bm, plan.bn) == gfid_conv.F32_TILES[-1]
        assert plan.splits > 1 or n_chunks < 2 * gfid_conv.F32_MIN_SPLIT
        assert tiles * plan.splits >= sms or plan.splits * \
            gfid_conv.F32_MIN_SPLIT > n_chunks - plan.chunks_per_split


def test_f32_conv_plans_reach_every_tile_and_split_on_the_paths():
    """The CNN paths at batch 1 and 32 use every tile, and both one and
    several splits of K: the chip run's coverage check can be met by them."""
    plans = [_f32_plan(spec, batch) for spec in CNN_CONVS for batch in (1, 32)]
    assert {(p.bm, p.bn) for p in plans} == set(gfid_conv.F32_TILES)
    assert {p.splits > 1 for p in plans} == {False, True}
    # AlexNet at batch 1: conv3-5 (169 pixels) split K; at batch 32 conv2-5
    # fold the split they take at batch 1
    alex = {spec.name: spec for spec in ALEXNET_CONVS}
    for name in ("conv3", "conv4", "conv5"):
        assert _f32_plan(alex[name], 1).splits > 1
    assert {spec.name for spec in ALEXNET_CONVS
            if _f32_plan(spec, 32).fold} == {"conv2", "conv3", "conv4",
                                             "conv5"}


@pytest.mark.parametrize("cg,og,vec", [(3, 96, (False, True)),
                                       (48, 128, (True, True)),
                                       (5, 7, (False, False)),
                                       (64, 22, (True, False)),
                                       (6, 20, (False, True))])
def test_f32_conv_vector_flags_follow_the_group_widths(cg, og, vec):
    """16-byte copies of x where cg % 4 == 0, of w where og % 4 == 0 (a
    piece is 4 channels of one tap, or 4 columns of one group)."""
    plan = gfid_conv.f32_plan(3025, 9 * cg, og, 1, cg)
    assert (plan.vec_x, plan.vec_w) == vec


def test_f32_conv_vector_flags_are_off_on_unaligned_pointers():
    aligned = torch.zeros((3, 3, 64, 128))
    assert aligned.data_ptr() % 16 == 0
    flat = torch.zeros(1 + 13 * 13 * 64)
    xc = flat[1:].view(1, 13, 13, 64)
    assert xc.data_ptr() % 16 == 4
    plan = gfid_conv.f32_plan(169, 9 * 64, 128, 1, 64, xc.data_ptr(),
                              aligned.data_ptr())
    assert (plan.vec_x, plan.vec_w) == (False, True)
    plan = gfid_conv.f32_plan(169, 9 * 64, 128, 1, 64, aligned.data_ptr(),
                              xc.data_ptr())
    assert (plan.vec_x, plan.vec_w) == (True, False)


def test_f32_conv_grid_takes_any_batch_up_to_the_x_limit():
    """Row tiles and column blocks share grid x (2**31 - 1 blocks), so a
    VGG-16 conv1_1 at batch 256 (12.8 M output pixels) launches; past the
    limit the plan raises, no launch."""
    plan = gfid_conv.f32_plan(256 * 224 * 224, 27, 64, 1, 3)
    assert plan.grid == (256 * 224 * 224 // plan.bm, 1, 1)
    with pytest.raises(ValueError, match="launch grid"):
        gfid_conv.f32_plan(64 * 2 ** 31, 27, 64, 1, 3)


def test_f32_tiles_match_the_kernel_source():
    """The tiles the fp32 plan chooses are those `with_tile` of
    csrc/gfid_conv.cu instantiates, at the source's K chunk, and the widest
    is the engine plan's tiling (TILE); its FMA loop is the shared SIMT
    machinery of csrc/simt_f32.cuh."""
    src = (build.CSRC / "gfid_conv.cu").read_text()
    assert f"constexpr int kBK = {gfid_conv.F32_BK};" in src
    assert '#include "simt_f32.cuh"' in src
    src += (build.CSRC / "simt_f32.cuh").read_text()
    built = set(re.findall(r"if \(bm == (\w+) && bn == (\w+)\)", src))
    names = {"kPixTile": gfid_conv.TILE[0], "kCoutTile": gfid_conv.TILE[2]}
    assert {(names.get(m) or int(m), names.get(n) or int(n))
            for m, n in built} == set(gfid_conv.F32_TILES)
    assert gfid_conv.F32_TILES[0] == (gfid_conv.TILE[0], gfid_conv.TILE[2])
    assert '#include "split_k.cuh"' in src and "splitk::launch<T>(" in src
    assert "fmaf(" in src and "mma.sync" not in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_launch_passes_its_plan(monkeypatch, dtype):
    """The conv wrapper's CUDA branch (run here on CPU tensors with the
    library and the stream faked) calls the entry of the operands' dtype
    with its plan (`f32_plan` or `bf16_plan`): tile, split, vector flags and
    a workspace exactly when K is split, in the C signature's order."""
    calls = []

    def fake_library(name):
        symbol = {"gfid_conv": "gfid_conv2d_nhwc_f32",
                  "gfid_conv_bf16": "gfid_conv2d_nhwc_bf16"}[name]

        def fn(*args):
            calls.append((symbol, args))
            return 0
        return types.SimpleNamespace(**{symbol: fn})

    class Null:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(gfid_conv, "_launcher", gfid_conv._launcher.__wrapped__)
    monkeypatch.setattr(gfid_conv, "_launcher_bf16",
                        gfid_conv._launcher_bf16.__wrapped__)
    monkeypatch.setattr(torch.cuda, "device", lambda _: Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # AlexNet's conv3 at batch 1: 169 pixels, K = 2304, split on both paths
    x = torch.zeros((1, 13, 13, 256), dtype=dtype)
    w = torch.zeros((3, 3, 256, 384), dtype=dtype)
    out = torch.empty((1, 13, 13, 384))
    bf16 = dtype == torch.bfloat16
    gfid_conv._launch(x, w, None, out, 1, 1, 1, "relu", bf16)
    (symbol, args), = calls
    plan = (gfid_conv.bf16_plan if bf16 else gfid_conv.f32_plan)(
        169, 9 * 256, 384, 1, 256, x.data_ptr(), w.data_ptr())
    argtypes = gfid_conv.BF16_ARGTYPES if bf16 else gfid_conv.F32_ARGTYPES
    assert symbol == ("gfid_conv2d_nhwc_bf16" if bf16 else "gfid_conv2d_nhwc_f32")
    assert len(args) == len(argtypes) and plan.splits > 1
    assert args[:4] == (x.data_ptr(), w.data_ptr(), None, out.data_ptr())
    assert args[4] is not None                      # the split's workspace
    assert args[-8:-1] == (plan.bm, plan.bn, plan.splits,
                           plan.chunks_per_split, 1, int(plan.vec_x),
                           int(plan.vec_w))
    dims = args[7:19] if bf16 else args[5:17]
    assert dims == (1, 13, 13, 256, 3, 3, 384, 13, 13, 1, 1, 1)


@pytest.mark.parametrize("k,want,min_chunks", [(9216, 5, 32), (4096, 17, 32),
                                               (576, 30, 32), (2304, 8, 8),
                                               (0, 4, 8), (33, 100, 1)])
def test_mma_split_covers_k_with_no_empty_split(k, want, min_chunks):
    splits, per = build.mma_split(k, want, min_chunks)
    n = max(-(-k // build.MMA_BK), 1)
    assert 1 <= splits <= max(want, 1) and (splits - 1) * per < n <= splits * per
    assert splits == 1 or per >= min_chunks


def test_mma_workspace_only_for_a_split():
    one = gfid_matmul.bf16_plan(8, 576, 576)
    assert build.mma_workspace(one, 8, 576, torch.device("cpu")) is None
    split = gfid_matmul.bf16_plan(8, 9216, 4096)
    ws = build.mma_workspace(split, 8, 4096, torch.device("cpu"))
    assert ws.shape == (split.splits, 8, 4096) and ws.dtype == torch.float32


def test_tile_constants_match_the_cuda_core():
    """The K chunk and the block tiles the plans choose are those that
    `mma::with_tile` instantiates, and the ring has at least 3 stages."""
    header = (build.CSRC / "mma_bf16.cuh").read_text()
    assert f"constexpr int kBK = {build.MMA_BK};" in header
    stages = int(re.search(r"constexpr int kStages = (\d+);", header).group(1))
    assert stages >= 3
    built = {(int(m), int(n)) for m, n in
             re.findall(r"return f\(Tile<(\d+), (\d+), \d+, \d+>\{\}\);", header)}
    assert built == set(build.MMA_TILES)
    assert set(gfid_matmul.BF16_TILES) <= built
    assert set(gfid_conv.BF16_TILES) <= built
    for name in ("gfid_matmul_bf16", "gfid_conv_bf16"):
        assert name in build.SOURCES
        assert "mma::with_tile(bm, bn," in (build.CSRC / f"{name}.cu").read_text()


def test_bf16_kernels_multiply_on_the_tensor_cores():
    """The bf16 entries run bf16 `mma.sync` fed by `cp.async` and
    `ldmatrix`, with no fp32 FMA loop; the fp32 sources keep no bf16
    entry."""
    header = (build.CSRC / "mma_bf16.cuh").read_text()
    assert '#include "smem.cuh"' in header
    header += (build.CSRC / "smem.cuh").read_text()
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "cp.async.cg.shared.global", "cp.async.wait_group",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16"):
        assert needle in header
    for name in ("gfid_matmul_bf16", "gfid_conv_bf16"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_bf16.cuh"' in source
        assert "fmaf" not in source and "fmaf" not in header
    for name in ("gfid_matmul", "gfid_conv"):
        assert "bf16" not in (build.CSRC / f"{name}.cu").read_text()


def _c_entries():
    """(file, symbol, ctypes kinds) of every `extern "C"` function of csrc/."""
    kinds = []
    for path in sorted(build.CSRC.glob("*.cu*")):
        text = path.read_text()
        for m in re.finditer(r'extern "C" [\w ]+?\*?\s*(\w+)\(([^)]*)\)', text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            kinds.append((path.name, m.group(1), [
                ctypes.c_void_p if "*" in p else
                ctypes.c_longlong if p.startswith("long long") else
                ctypes.c_float if p.startswith("float") else ctypes.c_int
                for p in params]))
    return kinds


# symbol -> (library, the wrapper module's lru-cached launcher, argtypes)
LAUNCHERS = {
    "gfid_matmul_f32": ("gfid_matmul", gfid_matmul._launcher,
                        gfid_matmul.F32_ARGTYPES),
    "gfid_matmul_bf16": ("gfid_matmul_bf16", gfid_matmul._launcher_bf16,
                         gfid_matmul.BF16_ARGTYPES),
    "gfid_matmul_int8": ("gfid_matmul_int8", gfid_matmul._launcher_int8,
                         gfid_matmul.INT8_ARGTYPES),
    "gfid_conv2d_nhwc_f32": ("gfid_conv", gfid_conv._launcher,
                             gfid_conv.F32_ARGTYPES),
    "gfid_conv2d_nhwc_bf16": ("gfid_conv_bf16", gfid_conv._launcher_bf16,
                              gfid_conv.BF16_ARGTYPES),
    "gfid_conv2d_nhwc_int8": ("gfid_conv_int8", gfid_conv._launcher_int8,
                              gfid_conv.INT8_ARGTYPES),
    "paged_gather": ("paged_gather", paged._launcher, paged.ARGTYPES),
    "conv1d_depthwise": ("conv1d_depthwise", conv1d._launcher,
                         conv1d.ARGTYPES),
    "flash_attention": ("flash_attention", flash_attention._launcher,
                        flash_attention.ARGTYPES),
    "flash_attention_bf16": ("flash_attention_bf16",
                             flash_attention._launcher_bf16,
                             flash_attention.BF16_ARGTYPES),
    "repro_cuda_error_string": (None, None, build.ERROR_STRING_ARGTYPES),
}


def test_every_c_entry_has_a_bound_launcher():
    found = {symbol for _, symbol, _ in _c_entries()}
    assert found == set(LAUNCHERS)


@pytest.mark.parametrize("source,symbol,kinds", _c_entries(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_ctypes_signatures_match_the_c_interfaces(monkeypatch, source, symbol,
                                                  kinds):
    """The argtypes each launcher binds (on the GPU only) have the C
    signature's arity and kinds, read from the source here; the launcher
    binds that symbol of that source's library."""
    library, launcher, argtypes = LAUNCHERS[symbol]
    assert argtypes == kinds
    if launcher is None:
        return
    assert source == f"{library}.cu"
    opened = []

    def fake_library(name):
        opened.append(name)
        return types.SimpleNamespace(**{symbol: types.SimpleNamespace()})

    monkeypatch.setattr(build, "library", fake_library)
    _, fn = launcher.__wrapped__()
    assert opened == [library] and fn.argtypes == kinds
    assert fn.restype is ctypes.c_int


F32_TOL = 1e-5

# The fp32 GEMM (`csrc/gfid_matmul.cu`, `gfid_matmul.f32_plan`) and the lean
# launch path of `gfid_matmul` and `paged_gather`.
#
# (K, N) of the fp32 GEMMs on the port's paths: smollm-135m's four layer
# GEMMs and tied unembedding, xlstm-125m's decode GEMMs, AlexNet's fc6-8,
# and ragged shapes.
F32_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576), (576, 49152),
          (768, 3072), (1536, 1536), (1536, 8), (1536, 768), (768, 2048),
          (1024, 768), (768, 50304), (9216, 4096), (4096, 4096), (4096, 1000),
          (300, 70), (1000, 33), (257, 129), (1, 5)]
# From one row to past a prompt-2048 prefill's 8 x 2048, across every tile
# boundary of F32_TILES and F32_FEW_ROWS.
F32_ROWS = (1, 2, 7, 8, 9, 13, 20, 32, 33, 40, 63, 64, 65, 100, 127, 128, 129,
        1000, 1024, 3072, 8 * 1984, 8 * 2048, 20000)


def _f32_chunks(k):
    return max(-(-k // gfid_matmul.F32_BK), 1)


@pytest.mark.parametrize("k,n", F32_SHAPES)
def test_f32_split_and_k_order_ignore_m(k, n):
    first = gfid_matmul.f32_plan(1, k, n)
    for m in F32_ROWS:
        plan = gfid_matmul.f32_plan(m, k, n)
        assert (plan.splits, plan.chunks_per_split) == \
            (first.splits, first.chunks_per_split), m
        # the grid covers the output with the plan's tile, and runs every
        # split on grid z, or folds them all into each block
        assert (plan.grid[0] - 1) * plan.bn < n <= plan.grid[0] * plan.bn
        assert (plan.grid[1] - 1) * plan.bm < m <= plan.grid[1] * plan.bm
        assert plan.grid[2] == (1 if plan.mode == "fold" else plan.splits)
        assert plan.workspace == (plan.splits > 1 and plan.mode == "split")
        # a cluster holds a few-row, 64-column tile's 2 to F32_MAX_CLUSTER
        # splits
        assert (plan.mode == "cluster") == (
            m <= gfid_matmul.F32_FEW_ROWS and plan.bn == 64
            and 1 < plan.splits <= gfid_matmul.F32_MAX_CLUSTER)
    n_chunks = _f32_chunks(k)
    assert (first.splits - 1) * first.chunks_per_split < n_chunks \
        <= first.splits * first.chunks_per_split
    assert first.splits == 1 or \
        first.chunks_per_split >= gfid_matmul.F32_MIN_SPLIT


@pytest.mark.parametrize("k,n", F32_SHAPES)
def test_f32_split_fills_the_card_where_k_allows(k, n):
    """The column blocks of the few-row tiles' width (512 where w holds
    F32_WIDE_BYTES or more, else 64) times the splits reach about
    F32_TARGET_BLOCKS of that width (512 threads on each of 132 SMs; the
    equal cut of K into whole chunks may take up to an eighth off), with no
    split more than that needs, unless K is too shallow for more splits."""
    plan = gfid_matmul.f32_plan(8, k, n)
    width = 512 if 4 * k * n >= gfid_matmul.F32_WIDE_BYTES else 64
    threads = {64: 128, 512: 256}[width]
    target = gfid_matmul.F32_TARGET_BLOCKS[width]
    assert target * threads == 512 * 132
    col_blocks = -(-n // width)
    if plan.splits > 1:
        assert col_blocks * (plan.splits - 1) < target
    most = _f32_chunks(k) // gfid_matmul.F32_MIN_SPLIT
    if most >= -(-target // col_blocks):
        assert 9 * col_blocks * plan.splits >= 8 * target
    else:
        assert plan.splits <= max(most, 1)


def test_f32_tiles_follow_m():
    """Few rows take the first of 8, 32 or 64 rows that holds M, 64 columns
    wide or, where w is wide (AlexNet's fc6), 512 and 256 columns at 8 and
    32 rows; many rows the widest tile where it fills the card twice, else
    64 x 64; a fold only where the tiles fill the card twice and K is
    split; a cluster for few rows on 64 columns up to F32_MAX_CLUSTER
    splits; else a workspace."""
    for m, want, fc6 in ((1, (8, 64), (8, 512)), (8, (8, 64), (8, 512)),
                         (9, (32, 64), (32, 256)), (32, (32, 64), (32, 256)),
                         (33, (64, 64), (64, 64)), (64, (64, 64), (64, 64))):
        plan = gfid_matmul.f32_plan(m, 576, 576)
        assert (plan.bm, plan.bn) == want and plan.mode == "cluster"
        plan = gfid_matmul.f32_plan(m, 9216, 4096)
        assert (plan.bm, plan.bn) == fc6 and plan.mode == "split"
    assert set(gfid_matmul.F32_TILES) == {
        (128, 128), (64, 64), (32, 64), (8, 64),
        *((r, c) for r, c in gfid_matmul.F32_WIDE_COLUMNS.items())}
    wide = gfid_matmul.f32_plan(8 * 1984, 576, 576)
    assert (wide.bm, wide.bn) == gfid_matmul.F32_TILES[0] == \
        (gfid_matmul.TILE[0], gfid_matmul.TILE[2])
    assert wide.mode == "fold" and wide.splits > 1 and wide.grid == (5, 124, 1)
    mid = gfid_matmul.f32_plan(1024, 576, 576)        # 144 tiles of 64 x 64
    assert (mid.bm, mid.bn) == (64, 64) and mid.mode == "split"
    ffn = gfid_matmul.f32_plan(1024, 576, 1536)       # 384 of them: a fold
    assert (ffn.bm, ffn.bn) == (64, 64) and ffn.mode == "fold"
    out = gfid_matmul.f32_plan(1024, 1536, 576)       # 20 splits: a workspace
    assert out.mode == "split" and out.workspace
    assert gfid_matmul.f32_plan(8 * 1984, 576, 49152).mode == "fold"
    # smollm's K = 576 cuts into as many splits as a cluster holds
    assert gfid_matmul.f32_plan(8, 576, 576).splits == \
        gfid_matmul.F32_MAX_CLUSTER


def test_f32_load_flags_follow_alignment():
    for k, n, xp, wp, want in [(576, 576, 256, 512, (True, True)),
                               (576, 576, 260, 512, (False, True)),
                               (576, 576, 256, 516, (True, False)),
                               (300, 70, 0, 0, (True, False)),
                               (257, 129, 0, 0, (False, False)),
                               (1000, 33, 16, 16, (True, False))]:
        plan = gfid_matmul.f32_plan(8, k, n, xp, wp)
        assert (plan.vec_x, plan.vec_w) == want, (k, n, xp, wp)


def test_f32_grid_limit_raises_before_any_launch():
    with pytest.raises(ValueError, match="launch grid"):
        gfid_matmul.f32_plan(128 * 65535 + 1, 576, 576)


def _emulate(x, w, bias, act, plan):
    """The kernel's sum order in torch ops: for each split, one chain over
    its K range in order (each step fmaf, here the exact fp64 product and
    sum rounded to fp32, up to a rare double rounding), starting from zero;
    the splits added in split order; then bias and act in fp32."""
    m, k = x.shape
    xd, wd = x.double(), w.double()
    depth = plan.chunks_per_split * gfid_matmul.F32_BK
    total = None
    for s in range(plan.splits):
        acc = torch.zeros((m, w.shape[1]), dtype=torch.float32)
        for kk in range(s * depth, min(k, (s + 1) * depth)):
            acc = (acc.double() + xd[:, kk:kk + 1] * wd[kk:kk + 1]).float()
        total = acc if total is None else total + acc
    return apply_epilogue(total, bias, act)


# (M, K, N, bias, act): one and several splits, ragged K and N, gelu.
F32_ORDER_CASES = [(1, 300, 70, True, "gelu"), (5, 300, 70, True, "relu"),
               (13, 257, 129, False, None), (3, 1000, 33, True, None),
               (8, 576, 40, False, "relu"), (70, 130, 24, True, "gelu")]


@pytest.mark.parametrize("m,k,n,has_bias,act", F32_ORDER_CASES)
def test_f32_sum_order_matches_the_pallas_kernel(m, k, n, has_bias, act):
    rng = np.random.default_rng(m * 1000 + k)
    x, w, b = (rng.standard_normal(s).astype(np.float32)
               for s in ((m, k), (k, n), (n,)))
    want = np.asarray(jax_matmul.gfid_matmul(
        jnp.asarray(x), jnp.asarray(w),
        bias=jnp.asarray(b) if has_bias else None, act=act, interpret=True))
    plan = gfid_matmul.f32_plan(m, k, n)
    got = _emulate(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b) if has_bias else None, act, plan).numpy()
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


@pytest.mark.parametrize("k,n", [(300, 70), (1000, 33), (576, 24)])
def test_f32_sum_order_is_row_invariant(k, n):
    """One row placed among others at several M comes out bitwise equal to
    the row alone: the plan's order at every M, applied to each row."""
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    row = torch.from_numpy(rng.standard_normal((1, k)).astype(np.float32))
    want = _emulate(row, w, None, None, gfid_matmul.f32_plan(1, k, n))
    for m in (1, 8, 13, 40, 65, 130):
        x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
        at = sorted({0, m - 1, min(5, m - 1)})
        x[at] = row
        got = _emulate(x, w, None, None, gfid_matmul.f32_plan(m, k, n))[at]
        assert torch.equal(got, want.expand_as(got)), m


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _fake_cuda(monkeypatch, calls, err=0):
    """Fake the launchers' libraries, the SM count, the current device and
    the raw stream, so that `_launch` and the gather's CUDA branch run on
    CPU tensors here and record what they would pass to the C entries."""
    def fake_library(name):
        symbol = {"gfid_matmul": "gfid_matmul_f32",
                  "gfid_matmul_bf16": "gfid_matmul_bf16",
                  "paged_gather": "paged_gather"}[name]

        def fn(*args):
            calls.append((symbol, args))
            return err
        return types.SimpleNamespace(
            **{symbol: fn, "repro_cuda_error_string": lambda e: b"refused"})

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "on_device", lambda index: _NullContext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    for mod, name in ((gfid_matmul, "_launcher"), (gfid_matmul, "_launcher_bf16"),
                      (paged, "_launcher")):
        monkeypatch.setattr(mod, name, getattr(mod, name).__wrapped__)


@pytest.mark.parametrize("m,k,n,act,mode", [
    (8, 1536, 576, None, "split"),       # smollm decode w_out: workspace
    (8 * 1984, 576, 576, "relu", "fold"),   # prompt-1984 prefill: folded
    (2048, 64, 8192, "gelu", "one"),     # K = 64: one split
    (8, 576, 576, None, "cluster"),      # smollm decode wq/wo: a cluster
])
def test_f32_launch_passes_its_plan(monkeypatch, m, k, n, act, mode):
    """The fp32 branch of `_launch` calls `gfid_matmul_f32` with its plan
    in the C signature's order: pointers (a workspace exactly when the plan
    needs one, the (splits, M, N) fp32 right after the output in one
    allocation), M, K, N, tile, split, mode, act, load flags, one group
    and its strides, stream."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    x, w = torch.zeros((m, k)), torch.zeros((k, n))
    bias = torch.zeros(n)
    before = gfid_matmul.gfid_matmul.launches
    out = gfid_matmul._launch(x, w, bias, act, False, torch.float32)
    (symbol, args), = calls
    plan = gfid_matmul.f32_plan(m, k, n, x.data_ptr(), w.data_ptr())
    assert symbol == "gfid_matmul_f32"
    assert len(args) == len(gfid_matmul.F32_ARGTYPES)
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32 \
        and out.is_contiguous()
    assert args[:4] == (x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                        out.data_ptr())
    assert (args[4] is not None) == (mode == "split") == plan.workspace
    if plan.workspace:
        assert args[4] == out.data_ptr() + 4 * m * n
        assert out.untyped_storage().nbytes() == 4 * (plan.splits + 1) * m * n
    assert plan.mode == ("split" if mode == "one" else mode)
    assert (plan.splits > 1) == (mode != "one")
    assert args[5:] == (m, k, n, plan.bm, plan.bn, plan.splits,
                        plan.chunks_per_split, gfid_matmul.F32_MODES[plan.mode],
                        ACT_CODES[act],
                        int(plan.vec_x), int(plan.vec_w), 1, m * k, k * n, 7)
    assert gfid_matmul.gfid_matmul.launches == before + 1


def test_bf16_launch_keeps_its_signature(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    x = torch.zeros((8, 576), dtype=torch.bfloat16)
    w = torch.zeros((576, 576), dtype=torch.bfloat16)
    before = gfid_matmul.gfid_matmul_bf16.launches
    out = gfid_matmul._launch(x, w, None, None, True, torch.bfloat16)
    (symbol, args), = calls
    assert out.dtype == torch.bfloat16 and args[3] == out.data_ptr()
    plan = gfid_matmul.bf16_plan(8, 576, 576, x.data_ptr(), w.data_ptr())
    assert symbol == "gfid_matmul_bf16"
    assert len(args) == len(gfid_matmul.BF16_ARGTYPES)
    assert args[5:] == (0, 1, 8, 576, 576, plan.bm, plan.bn, plan.splits,
                        plan.chunks_per_split, 0, int(plan.vec_x),
                        int(plan.vec_w), 1, 8 * 576, 576 * 576, 7)
    assert gfid_matmul.gfid_matmul_bf16.launches == before + 1


def test_refused_launch_raises_and_is_not_counted(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls, err=98)
    x, w = torch.zeros((8, 576)), torch.zeros((576, 576))
    before = gfid_matmul.gfid_matmul.launches
    with pytest.raises(RuntimeError, match="gfid_matmul launch failed: CUDA "
                                           "error 98 \\(refused\\)"):
        gfid_matmul._launch(x, w, None, None, False, torch.float32)
    assert gfid_matmul.gfid_matmul.launches == before
    pool = torch.zeros((4, 2, 8))
    table = torch.tensor([[1, 2]], dtype=torch.int32)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    before = paged.paged_gather.launches
    with pytest.raises(RuntimeError, match="paged_gather launch failed"):
        paged.paged_gather(pool, table)
    assert paged.paged_gather.launches == before


def test_gather_launch_passes_its_unit_and_counts(monkeypatch):
    """The gather's CUDA branch (faked) passes the block's bytes, the pool
    and table geometry and the widest copy unit, on the raw stream, and
    counts the launch."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    pool = torch.zeros((6, 4, 3, 2), dtype=torch.bfloat16)
    table = torch.tensor([[1, 5], [0, 2], [3, 3]], dtype=torch.int32)
    before = paged.paged_gather.launches
    out = paged.paged_gather(pool, table)
    (symbol, args), = calls
    assert symbol == "paged_gather" and len(args) == len(paged.ARGTYPES)
    assert args[0] == pool.data_ptr() and args[1] == table.data_ptr()
    assert args[2] == out.data_ptr() and tuple(out.shape) == (3, 8, 3, 2)
    assert args[3:] == (48, 6, 3, 2, paged.copy_unit(48, pool.data_ptr(),
                                                      out.data_ptr()), 7)
    assert paged.paged_gather.launches == before + 1


@pytest.mark.parametrize("case", ["dtype", "mixed", "contiguous", "device",
                                  "bias_dtype", "bias_device"])
def test_lean_checks_still_refuse(case):
    """The short test that passes good operands lets nothing else through:
    each bad operand reaches `check_operands`, which names it."""
    x, w = torch.zeros((4, 6)), torch.zeros((6, 5))
    bias = torch.zeros(5)
    if case == "dtype":
        x, w = x.double(), w.double()
    elif case == "mixed":
        w = w.to(torch.bfloat16)
    elif case == "contiguous":
        w = torch.zeros((5, 6)).t()
    elif case == "device":
        w = w.to("meta")
    elif case == "bias_dtype":
        bias = bias.to(torch.bfloat16)
    else:
        bias = bias.to("meta")
    error = TypeError if "dtype" in case or case == "mixed" else ValueError
    with pytest.raises(error, match="gfid_matmul"):
        gfid_matmul.gfid_matmul(x, w, bias=bias)
    assert build.check_float_operands("k", x.float(), torch.zeros((6, 5)),
                                      None) is False


@pytest.mark.parametrize("case", ["dtype", "contiguous", "device"])
def test_lean_gather_checks_still_refuse(case):
    pool = torch.zeros((4, 2, 3))
    table = torch.zeros((1, 2), dtype=torch.int32)
    if case == "dtype":
        table = table.long()
    elif case == "contiguous":
        pool = pool.transpose(1, 2)
    else:
        table = table.to("meta")
    with pytest.raises((TypeError, ValueError), match="paged_gather"):
        paged.paged_gather(pool, table)


def test_on_device_switches_only_to_another_device(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda index: entered.append(index) or _NullContext())
    with build.on_device(0):
        pass
    assert entered == []
    with build.on_device(1):
        pass
    assert entered == [1]


# The fp32 flash kernel (`csrc/flash_attention.cu`) and the int8 conv on the
# int8 tensor cores (`csrc/gfid_conv_int8.cu` + `csrc/mma_int8.cuh`).

FLASH_TOL = 1e-5
# (B, S, H, KV, D, causal): the forward cases of tests/test_flash.py (its
# q/k/v shape, causal and not; its ragged lengths at D = 8; its GQA 4/4
# shape) and the cases of tests/test_kernels.py.
FLASH_CASES = [(2, 64, 4, 2, 16, True), (2, 64, 4, 2, 16, False),
               (1, 17, 2, 2, 8, True), (1, 45, 2, 2, 8, True),
               (1, 77, 2, 2, 8, True), (1, 90, 2, 2, 8, True),
               (1, 64, 4, 4, 16, True), (1, 128, 8, 8, 32, True),
               (2, 96, 4, 4, 16, False), (1, 64, 6, 3, 8, True)]


def _emulate_flash(q, k, v, causal):
    """The fp32 kernel's algorithm in torch ops: blocks of Q_ROWS q rows;
    kv tiles of KV_TILE keys in order, the causal ones past the block's
    last row not visited; the tile's scores scaled, masked only on a tile
    that reaches past Skv or past the block's first row; the row max over
    the tile; one exp a score; each of the 16 lanes of a row keeps the sum
    of its keys (key tx + 16 j) rescaled by alpha, and the lanes are added
    at the end; P . V accumulated in fp32."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    q_rows, tile, lanes = flash_attention.Q_ROWS, flash_attention.KV_TILE, 16
    scale = 1.0 / np.sqrt(d)
    qh = q.permute(0, 2, 1, 3)                                   # (B, H, Sq, D)
    kh, vh = (t.repeat_interleave(h // n_kv, dim=2).permute(0, 2, 1, 3)
              for t in (k, v))                                   # (B, H, Skv, D)
    out = torch.empty_like(qh)
    for q0 in range(0, sq, q_rows):
        rows = torch.arange(q0, min(sq, q0 + q_rows))
        kv_end = min(skv, int(rows[-1]) + 1) if causal else skv
        m = torch.full((b, h, len(rows)), flash_attention.NEG_INF)
        l_lanes = torch.zeros((b, h, len(rows), lanes))
        acc = torch.zeros((b, h, len(rows), d))
        for k0 in range(0, kv_end, tile):
            keys = torch.arange(k0, k0 + tile)
            kt = torch.zeros((b, h, tile, d))
            vt = torch.zeros((b, h, tile, d))
            n = min(tile, skv - k0)
            kt[:, :, :n], vt[:, :, :n] = kh[:, :, k0:k0 + n], vh[:, :, k0:k0 + n]
            s = torch.einsum("bhqd,bhkd->bhqk", qh[:, :, rows], kt) * scale
            if k0 + tile > skv or (causal and k0 + tile - 1 > q0):
                bad = keys[None, :] >= skv
                if causal:
                    bad = bad | (keys[None, :] > rows[:, None])
                s = torch.where(bad, torch.tensor(flash_attention.NEG_INF), s)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])                  # one exp a score
            l_lanes = l_lanes * alpha[..., None] \
                + p.reshape(*p.shape[:-1], tile // lanes, lanes).sum(dim=-2)
            acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vt)
            m = m_new
        out[:, :, rows] = acc / torch.clamp(l_lanes.sum(dim=-1), min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3)


@pytest.mark.parametrize("b,s,h,kv,d,causal", FLASH_CASES)
def test_f32_flash_algorithm_matches_the_pallas_kernel(b, s, h, kv, d, causal):
    from repro.kernels import ops as jax_ops
    rng = np.random.default_rng(s * 10 + d)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    want = np.asarray(jax_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                              causal=causal, interpret=True))
    got = _emulate_flash(*map(torch.from_numpy, (q, k, v)), causal)
    assert np.abs(got.numpy() - want).max() <= FLASH_TOL * np.abs(want).max()
    plain = flash_attention.flash_attention_plain(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert (got - plain).abs().max() <= FLASH_TOL * plain.abs().max()


def test_f32_flash_kv_tile_and_rows_match_the_source():
    """KV_TILE (the plain version's tile too) is the kernel's kBK, and
    Q_ROWS, from which `f32_launch` counts the grid, its kBQ."""
    src = (build.CSRC / "flash_attention.cu").read_text()
    assert f"constexpr int kBK = {flash_attention.KV_TILE};" in src
    assert f"constexpr int kBQ = {flash_attention.Q_ROWS};" in src


def test_f32_flash_runs_on_cuda_cores_fed_by_cp_async():
    src = (build.CSRC / "flash_attention.cu").read_text()
    header = (build.CSRC / "smem.cuh").read_text()
    assert '#include "smem.cuh"' in src and "asm" not in src
    assert "cp.async.cg.shared.global" in header and "cp.async.wait_group" in header
    assert "cp_async16(" in src and "cp_async_wait<0>()" in src
    assert "mma" not in src and "__expf(" not in src and "expf(" in src
    assert "fmaf(" in src and "__shfl_xor_sync" in src


@pytest.mark.parametrize("b,sq,h,blocks", [(1, 1984, 9, 558), (4, 1984, 9, 2232),
                                           (1, 1031, 9, 297), (2, 700, 9, 396),
                                           (4, 1000, 9, 1152), (1, 1, 1, 1),
                                           (64, 2048, 9, 36864)])
def test_f32_flash_grid_is_q_tiles_by_heads_by_batch(b, sq, h, blocks):
    """The grid is one axis of q tiles of Q_ROWS rows x heads x batch."""
    plan = flash_attention.f32_launch(b, sq, h, 64, 0, 0, 0)
    assert plan.grid == (blocks, 1, 1)
    assert blocks == -(-sq // flash_attention.Q_ROWS) * h * b


@pytest.mark.parametrize("d,ptrs,vec", [(64, (0, 0, 0), True),
                                        (10, (0, 0, 0), False),
                                        (64, (4, 0, 0), False),
                                        (8, (16, 32, 48), True)])
def test_f32_flash_copies_follow_d_and_alignment(d, ptrs, vec):
    assert flash_attention.f32_launch(1, 100, 4, d, *ptrs).vec is vec


def _byte_perm(x, y, s):
    """CUDA's __byte_perm on uint32 numpy arrays: result byte n is byte
    (s >> 4n) & 7 of the 8 bytes y:x (x the low four)."""
    pair = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x)
    for n in range(4):
        sel = np.uint64((s >> (4 * n)) & 7)
        out |= (((pair >> (sel * np.uint64(8))) & np.uint64(0xFF))
                .astype(np.uint32) << np.uint32(8 * n))
    return out


def _transpose4_mirror(r):
    """`transpose4` of csrc/mma_int8.cuh, its six __byte_perm lines read
    from the source and run on numpy words."""
    src = (build.CSRC / "mma_int8.cuh").read_text()
    body = src[src.index("void transpose4("):]
    body = body[:body.index("}")]
    env = {"r": list(r), "c": [None] * 4}
    for dst, x, y, sel in re.findall(
            r"(\w+(?:\[\d\])?) = __byte_perm\((\w+(?:\[\d\])?), (\w+(?:\[\d\])?), "
            r"(0x[0-9a-fA-F]+)\)", body):
        def val(name):
            m = re.fullmatch(r"(\w+)\[(\d)\]", name)
            return env[m.group(1)][int(m.group(2))] if m else env[name]
        got = _byte_perm(val(x), val(y), int(sel, 16))
        m = re.fullmatch(r"(\w+)\[(\d)\]", dst)
        if m:
            env[m.group(1)][int(m.group(2))] = got
        else:
            env[dst] = got
    return env["c"]


def _b_offset(n, kb):
    """`b_offset` of csrc/mma_int8.cuh: column n, K byte kb of a
    channel-major B buffer (64 bytes a column, 16-byte pieces permuted)."""
    return n * 64 + ((((kb >> 4) ^ (n >> 1) ^ (n >> 3)) & 3) << 4) + (kb & 15)


@pytest.mark.parametrize("bn,threads", [(64, 128), (128, 256)])
def test_int8_b_transpose_is_wq_channel_major(bn, threads):
    """A chunk of wq (64 K rows x bn columns) staged as it lies in memory,
    transposed block by block as `transpose_b` does (the thread slots of
    `b_block`, the source's byte selectors) into a channel-major buffer at
    `b_offset`: read back, it is bitwise wq's (C_out, K) view, and the
    slots cover the chunk once."""
    rng = np.random.default_rng(bn)
    wq = rng.integers(-128, 128, (64, bn), dtype=np.int8)
    rows = wq.view(np.uint8).reshape(64, bn // 4, 4).view("<u4")[..., 0]  # (K, BN/4) words
    buf = np.zeros(bn * 64, np.uint8)
    seen = set()
    for idx in range(16 * (bn // 4)):
        kq, cq = (idx // bn) * 4 + idx % 4, (idx // 4) % (bn // 4)
        seen.add((kq, cq))
        words = [rows[4 * kq + i, cq:cq + 1] for i in range(4)]
        cols = _transpose4_mirror(words)
        for i in range(4):
            off = _b_offset(4 * cq + i, 4 * kq)
            buf[off:off + 4] = cols[i].view(np.uint8)
    assert len(seen) == 16 * (bn // 4)
    back = np.array([[buf[_b_offset(n, kb)] for kb in range(64)]
                     for n in range(bn)], np.uint8).view(np.int8)
    assert np.array_equal(back, wq.T)
    assert 4 * bn // threads * threads == 4 * bn       # every thread the same slots


def test_int8_b_offset_spreads_ldmatrix_and_stores():
    """Each 8 columns of an ldmatrix phase land in 8 different 16-byte bank
    groups; a warp's transposed stores (four lanes four K blocks, eight
    lanes eight column groups) use at least 16 banks."""
    for n0 in range(0, 128, 8):
        for kb in (0, 16, 32, 48):
            assert len({(_b_offset(n0 + r, kb) // 16) % 8 for r in range(8)}) == 8
    for bn in (64, 128):
        for lane0 in range(0, 4 * bn, 32):
            for i in range(4):
                banks = {(_b_offset(4 * ((idx // 4) % (bn // 4)) + i,
                                    4 * ((idx // bn) * 4 + idx % 4)) // 4) % 32
                         for idx in range(lane0, lane0 + 32)}
                assert len(banks) >= 16


def test_int8_tiles_match_the_tensor_core_core():
    """INT8_TILES are the tiles `mma8::with_tile` builds, the K chunk is the
    core's, and a split never has more blocks than a portable cluster."""
    core = (build.CSRC / "mma_int8.cuh").read_text()
    built = {(int(m), int(n)) for n, m in
             re.findall(r"if \(bn == (\d+) && bm == (\d+)\)", core)}
    assert built == set(gfid_conv.INT8_TILES)
    assert f"constexpr int kKc = {gfid_conv.INT8_BK};" in core
    cluster = int(re.search(r"constexpr int kMaxCluster = (\d+);", core).group(1))
    assert gfid_conv.INT8_MAX_SPLIT <= cluster
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in core
    assert '#include "smem.cuh"' in core and "using smem::ldmatrix_x4;" in core
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in (
        build.CSRC / "smem.cuh").read_text()
    source = (build.CSRC / "gfid_conv_int8.cu").read_text()
    assert f"constexpr int kMaxSplit = {gfid_conv.INT8_MAX_SPLIT};" in source
    assert "splits > kMaxSplit) return (int)cudaErrorInvalidValue" in source
    assert '#include "mma_int8.cuh"' in source and "__dp4a(" not in source
    assert "ws" not in re.findall(r"\w+", source[source.index('extern "C"'):])


def _int8_plan(b, h, c_in, k, s, p, g, c_out, x_ptr=0, w_ptr=0):
    h_out = (h + 2 * p - k) // s + 1
    return gfid_conv.int8_plan(b * h_out * h_out, k * k * c_in // g, c_out // g,
                               g, c_in // g, x_ptr, w_ptr)


# (batch, H_in, C_in, k, stride, pad, groups, C_out) -> (bm, bn, splits,
# 16-byte x): AlexNet's five convs at batch 1 and 32, and ragged shapes.
INT8_PLAN_CASES = [
    ((1, 227, 3, 11, 4, 0, 1, 96), (32, 64, 1, False)),
    ((1, 27, 96, 5, 1, 2, 2, 256), (32, 64, 3, True)),
    ((1, 13, 256, 3, 1, 1, 1, 384), (32, 64, 4, True)),
    ((1, 13, 384, 3, 1, 1, 2, 384), (32, 64, 4, True)),
    ((1, 13, 384, 3, 1, 1, 2, 256), (32, 64, 4, True)),
    ((32, 227, 3, 11, 4, 0, 1, 96), (128, 128, 1, False)),
    ((32, 27, 96, 5, 1, 2, 2, 256), (64, 64, 1, True)),
    ((32, 13, 256, 3, 1, 1, 1, 384), (64, 64, 1, True)),
    ((32, 13, 384, 3, 1, 1, 2, 384), (64, 64, 1, True)),
    ((32, 13, 384, 3, 1, 1, 2, 256), (64, 64, 1, True)),
    ((2, 31, 3, 11, 4, 2, 1, 20), (32, 64, 2, False)),
    ((1, 20, 12, 5, 1, 2, 2, 70), (32, 64, 1, False)),
    ((2, 13, 5, 3, 2, 1, 1, 7), (32, 64, 1, False)),
    ((1, 9, 32, 3, 1, 1, 2, 32), (32, 64, 1, True)),
]


@pytest.mark.parametrize("shape,want", INT8_PLAN_CASES)
def test_int8_conv_plan_fills_the_card_or_splits_k(shape, want):
    """The tile, split and x load path of each shape; K split into at most
    INT8_MAX_SPLIT non-empty runs, only on the last tile and only where its
    blocks leave the card idle; the grid (row tiles, column blocks x
    groups, splits) within CUDA's limits."""
    b, h, c_in, k, s, p, g, c_out = shape
    plan = _int8_plan(*shape)
    assert (plan.bm, plan.bn, plan.splits, plan.vec_x) == want
    h_out = (h + 2 * p - k) // s + 1
    pixels, og = b * h_out * h_out, c_out // g
    n_chunks = -(-(k * k * c_in // g) // gfid_conv.INT8_BK)
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    assert plan.splits <= gfid_conv.INT8_MAX_SPLIT
    tiles = -(-pixels // plan.bm) * g * -(-og // plan.bn)
    assert plan.grid == (-(-pixels // plan.bm), g * -(-og // plan.bn), plan.splits)
    if plan.splits > 1:
        assert (plan.bm, plan.bn) == gfid_conv.INT8_TILES[-1] and tiles < 132
    assert all(x <= lim for x, lim in zip(plan.grid, build.GRID_LIMITS))
    assert plan.vec_w == (og % 16 == 0)


def test_int8_conv_load_flags_follow_alignment():
    args = (32 * 27 * 27, 1200, 128, 2, 48)
    assert gfid_conv.int8_plan(*args, 16, 16).vec_x
    assert not gfid_conv.int8_plan(*args, 8, 16).vec_x
    assert not gfid_conv.int8_plan(*args, 16, 4).vec_w
    with pytest.raises(ValueError, match="launch grid"):
        gfid_conv.int8_plan(32 * 65536, 64, 64 * 70000, 1, 64)


def _int8_conv_args(b=1, h=13, c_in=32, k=3, g=2, c_out=64, bias=True):
    rng = np.random.default_rng(c_out)
    xq = torch.from_numpy(rng.integers(-127, 128, (b, h, h, c_in), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, c_in // g, c_out),
                                       dtype=np.int8))
    sx, sw = torch.rand(b, 1) + 0.5, torch.rand(1, c_out) + 0.5
    return xq, wq, sx, sw, (torch.randn(c_out) if bias else None)


@pytest.mark.parametrize("act,bias", [("relu", True), (None, False)])
def test_int8_conv_launch_passes_its_plan(monkeypatch, act, bias):
    """The CUDA branch of `gfid_conv2d_nhwc_int8` (library, SM count,
    device context and stream faked; run here on CPU tensors) calls the C
    entry once with its plan in the signature's order: pointers (no
    workspace), geometry, tile, split, act, load flags, stream; it counts
    the launch and returns the allocated output."""
    calls = []

    def fake_library(name):
        assert name == "gfid_conv_int8"

        def fn(*args):
            calls.append(args)
            return 0
        return types.SimpleNamespace(gfid_conv2d_nhwc_int8=fn,
                                     repro_cuda_error_string=lambda e: b"refused")

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "on_device", lambda index: _NullContext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    monkeypatch.setattr(gfid_conv, "_launcher_int8",
                        gfid_conv._launcher_int8.__wrapped__)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    xq, wq, sx, sw, b = _int8_conv_args(bias=bias)
    before = gfid_conv.gfid_conv2d_nhwc_int8.launches
    out = gfid_conv.gfid_conv2d_nhwc_int8(xq, wq, sx, sw, pad=1, groups=2,
                                          bias=b, act=act)
    (args,) = calls
    assert len(args) == len(gfid_conv.INT8_ARGTYPES)
    assert tuple(out.shape) == (1, 13, 13, 64) and out.dtype == torch.float32
    assert args[:6] == (xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                        sw.data_ptr(), None if b is None else b.data_ptr(),
                        out.data_ptr())
    plan = gfid_conv.int8_plan(169, 144, 32, 2, 16, xq.data_ptr(), wq.data_ptr())
    assert args[6:] == (1, 13, 13, 32, 3, 3, 64, 13, 13, 1, 1, 2, plan.bm,
                        plan.bn, plan.splits, plan.chunks_per_split,
                        ACT_CODES[act], int(plan.vec_x), int(plan.vec_w), 7)
    assert gfid_conv.gfid_conv2d_nhwc_int8.launches == before + 1


def test_int8_conv_refused_launch_raises_and_is_not_counted(monkeypatch):
    monkeypatch.setattr(build, "library", lambda name: types.SimpleNamespace(
        gfid_conv2d_nhwc_int8=lambda *a: 98,
        repro_cuda_error_string=lambda e: b"refused"))
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "on_device", lambda index: _NullContext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    monkeypatch.setattr(gfid_conv, "_launcher_int8",
                        gfid_conv._launcher_int8.__wrapped__)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    before = gfid_conv.gfid_conv2d_nhwc_int8.launches
    with pytest.raises(RuntimeError, match="gfid_conv2d_nhwc_int8 launch "
                                           "failed: CUDA error 98"):
        gfid_conv.gfid_conv2d_nhwc_int8(*_int8_conv_args()[:4], pad=1, groups=2)
    assert gfid_conv.gfid_conv2d_nhwc_int8.launches == before


@pytest.mark.parametrize("case", ["dtype", "scale_dtype", "contiguous",
                                  "device", "bias_dtype"])
def test_int8_conv_lean_checks_still_refuse(case):
    xq, wq, sx, sw, b = _int8_conv_args()
    if case == "dtype":
        wq = wq.to(torch.int16)
    elif case == "scale_dtype":
        sx = sx.double()
    elif case == "contiguous":
        xq = xq.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "device":
        sw = sw.to("meta")
    else:
        b = b.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError), match="gfid_conv2d_nhwc_int8"):
        gfid_conv.gfid_conv2d_nhwc_int8(xq, wq, sx, sw, pad=1, groups=2, bias=b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launch_passes_its_plan_and_raises_when_refused(monkeypatch,
                                                              dtype):
    """`flash_attention._launch` (library, device and stream faked) passes
    either entry its copy flag after the causal flag; a refused launch
    raises and is not counted."""
    calls, err = [], [0]

    def fake_library(name):
        def fn(*args):
            calls.append((name, args))
            return err[0]
        return types.SimpleNamespace(**{name: fn},
                                     repro_cuda_error_string=lambda e: b"refused")

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(flash_attention, "_launcher",
                        flash_attention._launcher.__wrapped__)
    monkeypatch.setattr(flash_attention, "_launcher_bf16",
                        flash_attention._launcher_bf16.__wrapped__)
    monkeypatch.setattr(torch.cuda, "device", lambda _: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    q = torch.zeros((4, 1000, 9, 64), dtype=dtype)
    k = torch.zeros((4, 1000, 3, 64), dtype=dtype)
    out = torch.empty_like(q)
    counter = flash_attention.flash_attention if dtype == torch.float32 \
        else flash_attention.flash_attention_bf16
    before = counter.launches
    flash_attention._launch(q, k, k, out, True, None)
    (name, args), = calls
    assert args[4:12] == (4, 1000, 1000, 9, 3, 64, pytest.approx(0.125), 1)
    is32 = dtype == torch.float32
    plan = (flash_attention.f32_launch if is32 else flash_attention.bf16_launch)(
        4, 1000, 9, 64, *args[:3])
    assert name == ("flash_attention" if is32 else "flash_attention_bf16")
    assert args[12:] == (int(plan.vec), 7)
    assert counter.launches == before + 1
    err[0] = 98
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 98"):
        flash_attention._launch(q, k, k, out, True, None)
    assert counter.launches == before + 1


# The int8 GEMM on the int8 tensor cores (`csrc/gfid_matmul_int8.cu` through
# `csrc/mma_int8.cuh`, `gfid_matmul.int8_mm_plan`) and its lean launch path.

# (M, K, N) -> (bm, bn, splits, 16-byte x, bytes a copy of w): AlexNet's
# fc6-8 at batch 1 and 32, the tile boundaries at M = 16 and 17, and the
# ragged shapes chip_smoke.py checks.
INT8_MM_PLAN_CASES = [
    ((1, 9216, 4096), (16, 128, 8, True, 16)),
    ((1, 4096, 4096), (16, 128, 8, True, 16)),
    ((1, 4096, 1000), (16, 128, 8, True, 8)),
    ((32, 9216, 4096), (32, 128, 8, True, 16)),
    ((32, 4096, 4096), (32, 128, 8, True, 16)),
    ((32, 4096, 1000), (32, 128, 8, True, 8)),
    ((16, 1024, 4096), (16, 128, 4, True, 16)),
    ((17, 1024, 4096), (32, 128, 4, True, 16)),
    ((3, 1025, 1000), (16, 128, 4, False, 8)),
    ((5, 300, 70), (16, 128, 1, False, 0)),
    ((17, 257, 129), (32, 128, 1, False, 0)),
    ((1, 1000, 33), (16, 128, 4, False, 0)),
    ((4, 1028, 100), (16, 128, 4, False, 0)),
    ((600, 256, 4096), (32, 128, 1, True, 16)),
    ((300, 512, 4096), (32, 128, 1, True, 16)),
    ((20000, 4096, 4096), (32, 128, 1, True, 16)),
]


@pytest.mark.parametrize("shape,want", INT8_MM_PLAN_CASES)
def test_int8_mm_plan_fills_the_card_or_splits_k(shape, want):
    """The tile (the first of INT8_MM_TILES whose rows hold M, else the
    last), the split and the load paths of each shape; K cut into at most
    INT8_MM_MAX_SPLIT (a portable cluster) non-empty runs of at least
    INT8_MM_MIN_SPLIT chunks, only where the tiles leave the card idle, and
    then as far as the cluster and K allow towards INT8_MM_TARGET_BLOCKS;
    the grid (row tiles, column tiles, splits) within CUDA's limits."""
    m, k, n = shape
    plan = gfid_matmul.int8_mm_plan(m, k, n)
    assert (plan.bm, plan.bn, plan.splits, plan.vec_x, plan.vec_w) == want
    rows = [bm for bm, _ in gfid_matmul.INT8_MM_TILES]
    assert plan.bm == min([r for r in rows if r >= m], default=rows[-1])
    n_chunks = -(-k // gfid_matmul.INT8_MM_BK)
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    assert plan.splits <= gfid_matmul.INT8_MM_MAX_SPLIT
    assert plan.splits == 1 or plan.chunks_per_split >= gfid_matmul.INT8_MM_MIN_SPLIT
    tiles = -(-m // plan.bm) * -(-n // plan.bn)
    assert plan.grid == (-(-m // plan.bm), -(-n // plan.bn), plan.splits)
    if tiles >= 132:
        assert plan.splits == 1
    else:
        blocks = tiles * plan.splits
        assert blocks >= gfid_matmul.INT8_MM_TARGET_BLOCKS \
            or plan.splits == gfid_matmul.INT8_MM_MAX_SPLIT \
            or n_chunks // gfid_matmul.INT8_MM_MIN_SPLIT < plan.splits + 1
    assert all(g <= lim for g, lim in zip(plan.grid, build.GRID_LIMITS))


def test_int8_mm_plan_fills_the_card_at_fc6_and_fc7():
    """fc6 and fc7 (32 column tiles) make 256 blocks at batch 1 and 32,
    about two an SM, each keeping 2 chunks of 64 x 128 bytes of w in flight:
    4 MB in flight over the card."""
    for m in (1, 32):
        for k in (9216, 4096):
            plan = gfid_matmul.int8_mm_plan(m, k, 4096)
            blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
            assert blocks == 256 and blocks * 2 * 64 * plan.bn == 4 << 20


def test_int8_mm_load_flags_follow_alignment():
    args = (32, 4096, 4096)
    assert gfid_matmul.int8_mm_plan(*args, 16, 16).vec_x
    assert not gfid_matmul.int8_mm_plan(*args, 1, 16).vec_x
    assert not gfid_matmul.int8_mm_plan(32, 4100, 4096, 16, 16).vec_x
    assert gfid_matmul.int8_mm_plan(*args, 16, 8).vec_w == 8
    assert gfid_matmul.int8_mm_plan(*args, 16, 4).vec_w == 0
    assert gfid_matmul.int8_mm_plan(32, 4096, 1000, 16, 16).vec_w == 8
    assert gfid_matmul.int8_mm_plan(32, 4096, 1004, 16, 16).vec_w == 0
    with pytest.raises(ValueError, match="launch grid"):
        gfid_matmul.int8_mm_plan(16, 64, 128 * 70000)


def test_int8_mm_tiles_and_split_match_the_source():
    """INT8_MM_TILES are the tiles the GEMM's `with_mm_tile` builds, each a
    tile of the int8 core; INT8_MM_MAX_SPLIT is the entry's kMaxSplit, at
    most a portable cluster; the source multiplies on the int8 tensor cores
    through the core with no `__dp4a`, no workspace, no ticket and no atomic,
    and copies w by 16 or 8 bytes."""
    source = (build.CSRC / "gfid_matmul_int8.cu").read_text()
    built = [(int(m), int(n)) for n, m in
             re.findall(r"if \(bn == (\w+) && bm == (\w+)\)", source.replace(
                 "kBN", str(gfid_matmul.TILE_INT8[2])).replace(
                 "kBM", str(gfid_matmul.TILE_INT8[0])))]
    assert built == list(gfid_matmul.INT8_MM_TILES)
    assert gfid_matmul.INT8_MM_TILES[-1] == gfid_matmul.TILE_INT8[::2]
    assert f"constexpr int kMaxSplit = {gfid_matmul.INT8_MM_MAX_SPLIT};" in source
    core = (build.CSRC / "mma_int8.cuh").read_text()
    cluster = int(re.search(r"constexpr int kMaxCluster = (\d+);", core).group(1))
    assert gfid_matmul.INT8_MM_MAX_SPLIT <= cluster
    assert f"constexpr int kKT = {gfid_matmul.INT8_MM_BK};" in source
    assert f"constexpr int kKc = {gfid_matmul.INT8_MM_BK};" in core
    assert '#include "mma_int8.cuh"' in source
    for needle in ("mma8::mainloop<T>(", "mma8::cluster_sum<T>(",
                   "mma8::launch<T, true>", "smem::cp_async8(", "mma8::cp_async16("):
        assert needle in source
    code = re.sub(r"//[^\n]*", "", source)
    for banned in ("__dp4a", "atomicAdd", "tickets", "ws", "__threadfence"):
        assert banned not in re.findall(r"\w+", code), banned
    assert "cp.async.ca.shared.global [%0], [%1], 8, %2;" in (
        build.CSRC / "smem.cuh").read_text()
    assert gfid_matmul.INT8_MM_W_COPIES == (16, 8)


def _mm8_mirror(xq, wq, sx, sw, bias, act, plan):
    """The kernel's arithmetic in numpy, block by block of `plan`: the
    loader's A chunk (bm rows x 64 K bytes, zeros past M and K) and B chunk
    (64 K rows x bn columns of wq as it lies, zeros past K and N); the B
    chunk's words transposed by `transpose4` (the source's selectors) at the
    slots of `b_block` into a channel-major buffer at `b_offset`, read back
    by column; a chunk's products summed in int32; the splits of a tile
    added (the cluster's blocks each add a share of the slots: integers, so
    any order); then the dequant epilogue (sx * sw, bias, act)."""
    xq, wq = np.asarray(xq, np.int8), np.asarray(wq, np.int8)
    m, k = xq.shape
    n = wq.shape[1]
    bm, bn, kc = plan.bm, plan.bn, gfid_matmul.INT8_MM_BK
    n_chunks = -(-k // kc)
    idx = np.arange(16 * (bn // 4))
    kq, cq = (idx // bn) * 4 + idx % 4, (idx // 4) % (bn // 4)
    acc = np.zeros((m, n), np.int64)
    for i0 in range(0, m, bm):
        for n0 in range(0, n, bn):
            parts = []
            for z in range(plan.splits):
                part = np.zeros((bm, bn), np.int64)
                for chunk in range(z * plan.chunks_per_split,
                                   min(n_chunks, (z + 1) * plan.chunks_per_split)):
                    k0 = chunk * kc
                    a = np.zeros((bm, kc), np.int8)
                    blk = xq[i0:i0 + bm, k0:k0 + kc]
                    a[:blk.shape[0], :blk.shape[1]] = blk
                    b = np.zeros((kc, bn), np.int8)
                    blk = wq[k0:k0 + kc, n0:n0 + bn]
                    b[:blk.shape[0], :blk.shape[1]] = blk
                    words = b.view(np.uint8).reshape(kc, bn // 4, 4).view("<u4")[..., 0]
                    cols = _transpose4_mirror([words[4 * kq + i, cq] for i in range(4)])
                    buf = np.zeros(bn * kc, np.uint8)
                    for i in range(4):
                        off = _b_offset(4 * cq + i, 4 * kq)
                        for e in range(4):
                            buf[off + e] = (cols[i] >> np.uint32(8 * e)) & np.uint32(0xFF)
                    nn, kb = np.meshgrid(np.arange(bn), np.arange(kc), indexing="ij")
                    bt = buf[_b_offset(nn, kb)].view(np.int8)        # (bn, kc)
                    prod = a.astype(np.int64) @ bt.T.astype(np.int64)
                    assert np.abs(prod).max(initial=0) < 2 ** 31
                    part += prod
                parts.append(part)
            total = parts[0]
            for other in parts[1:]:                 # the cluster's sum: any order
                total = total + other
            assert np.abs(total).max(initial=0) < 2 ** 31
            rows, cols_ = min(bm, m - i0), min(bn, n - n0)
            acc[i0:i0 + rows, n0:n0 + cols_] = total[:rows, :cols_]
    return dequant_epilogue(torch.from_numpy(acc.astype(np.int32)),
                            torch.from_numpy(np.array(sx)) * torch.from_numpy(np.array(sw)),
                            None if bias is None else torch.from_numpy(bias), act)


# (M, K, N, bias, act): the 16-row tile with K split across 4 (M = 1, K not
# a multiple of 16), the 32-row tile in one split with two column tiles,
# two row blocks of it with K split in 2, gelu, and a tile boundary.
MM8_MIRROR_CASES = [
    (1, 1025, 70, True, "relu"),
    (17, 257, 129, False, None),
    (40, 600, 130, True, "relu"),
    (4, 300, 33, True, "gelu"),
    (16, 512, 256, False, None),
]


@pytest.mark.parametrize("m,k,n,has_bias,act", MM8_MIRROR_CASES)
def test_int8_mm_mirror_is_bitwise_the_pallas_kernel(m, k, n, has_bias, act):
    """The mirror of the kernel's loader, B transpose and split sum, at the
    plan `int8_mm_plan` picks (132 SMs), is bitwise equal to the JAX
    `gfid_matmul_int8` run in interpret mode for act None and relu, within
    1e-6 of max for gelu (tanh differs by about an ulp between the
    libraries), and bitwise equal to the port's plain version always."""
    rng = np.random.default_rng(m * 7 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if has_bias else None
    xq, wq, sx, sw = jax_quant.quantize_matmul_operands(jnp.asarray(x), jnp.asarray(w))
    plan = gfid_matmul.int8_mm_plan(m, k, n)
    got = _mm8_mirror(xq, wq, sx, sw, b, act, plan)
    want = np.asarray(jax_matmul.gfid_matmul_int8(
        xq, wq, sx, sw, bias=None if b is None else jnp.asarray(b), act=act,
        interpret=True))
    if act == "gelu":
        assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    t = [torch.from_numpy(np.array(a)) for a in (xq, wq, sx, sw)]
    plain = gfid_matmul.gfid_matmul_int8_plain(
        *t, bias=None if b is None else torch.from_numpy(b), act=act)
    assert torch.equal(got, plain)


def _mm8_args(m=3, k=40, n=24, bias=True):
    rng = np.random.default_rng(n)
    xq = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    sx, sw = torch.rand(m, 1) + 0.5, torch.rand(1, n) + 0.5
    return xq, wq, sx, sw, (torch.randn(n) if bias else None)


def _fake_int8_cuda(monkeypatch, calls, err=0):
    """Fake the int8 GEMM's library, the SM count, the device context and
    the raw stream, and make every tensor claim to be on CUDA, so that the
    wrapper's CUDA branch runs on CPU tensors here."""
    def fake_library(name):
        assert name == "gfid_matmul_int8"

        def fn(*args):
            calls.append(args)
            return err
        return types.SimpleNamespace(gfid_matmul_int8=fn,
                                     repro_cuda_error_string=lambda e: b"refused")

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "on_device", lambda index: _NullContext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    monkeypatch.setattr(gfid_matmul, "_launcher_int8",
                        gfid_matmul._launcher_int8.__wrapped__)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


def _count_allocations(monkeypatch):
    """Record every tensor the wrapper allocates through torch.empty,
    torch.zeros, Tensor.new_empty or Tensor.new_zeros."""
    made = []
    for owner, name in ((torch, "empty"), (torch, "zeros"),
                        (torch.Tensor, "new_empty"), (torch.Tensor, "new_zeros")):
        real = getattr(owner, name)

        def wrapped(*a, _real=real, _name=name, **kw):
            made.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(owner, name, wrapped)
    return made


@pytest.mark.parametrize("m,k,n,act,bias", [(3, 40, 24, "relu", True),
                                            (1, 1025, 70, None, False),
                                            (40, 600, 130, "gelu", True)])
def test_int8_mm_launch_passes_its_plan(monkeypatch, m, k, n, act, bias):
    """The CUDA branch of `gfid_matmul_int8` calls the C entry once with its
    plan in the signature's order (pointers with no workspace, shapes,
    tile, split, act, load flags, stream), allocates nothing but the
    output, and counts the launch."""
    calls = []
    xq, wq, sx, sw, b = _mm8_args(m, k, n, bias)
    _fake_int8_cuda(monkeypatch, calls)
    made = _count_allocations(monkeypatch)
    before = gfid_matmul.gfid_matmul_int8.launches
    out = gfid_matmul.gfid_matmul_int8(xq, wq, sx, sw, bias=b, act=act)
    assert made == ["new_empty"]
    (args,) = calls
    assert len(args) == len(gfid_matmul.INT8_ARGTYPES)
    assert tuple(out.shape) == (m, n) and out.dtype == torch.float32
    assert args[:6] == (xq.data_ptr(), wq.data_ptr(), sx.data_ptr(),
                        sw.data_ptr(), None if b is None else b.data_ptr(),
                        out.data_ptr())
    plan = gfid_matmul.int8_mm_plan(m, k, n, xq.data_ptr(), wq.data_ptr())
    assert args[6:] == (m, k, n, plan.bm, plan.bn, plan.splits,
                        plan.chunks_per_split, ACT_CODES[act], int(plan.vec_x),
                        plan.vec_w, 7)
    assert gfid_matmul.gfid_matmul_int8.launches == before + 1


def test_int8_mm_refused_launch_raises_and_is_not_counted(monkeypatch):
    _fake_int8_cuda(monkeypatch, [], err=98)
    before = gfid_matmul.gfid_matmul_int8.launches
    with pytest.raises(RuntimeError, match="gfid_matmul_int8 launch failed: "
                                           "CUDA error 98 \\(refused\\)"):
        gfid_matmul.gfid_matmul_int8(*_mm8_args()[:4])
    assert gfid_matmul.gfid_matmul_int8.launches == before


@pytest.mark.parametrize("case", ["dtype", "scale_dtype", "contiguous",
                                  "device", "bias_dtype", "bias_device"])
def test_int8_mm_lean_checks_still_refuse(case):
    xq, wq, sx, sw, b = _mm8_args()
    if case == "dtype":
        xq = xq.to(torch.int16)
    elif case == "scale_dtype":
        sw = sw.double()
    elif case == "contiguous":
        wq = wq.t().contiguous().t()
    elif case == "device":
        sx = sx.to("meta")
    elif case == "bias_dtype":
        b = b.to(torch.bfloat16)
    else:
        b = b.to("meta")
    with pytest.raises((TypeError, ValueError), match="gfid_matmul_int8"):
        gfid_matmul.gfid_matmul_int8(xq, wq, sx, sw, bias=b)
    build.check_int8_operands("gfid_matmul_int8", *_mm8_args())
