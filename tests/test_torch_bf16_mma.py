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
    long long or float kinds of the ctypes argtypes its wrapper binds.
"""
import ctypes
import re
import types

import pytest
import torch

from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                 gfid_matmul, paged)
from repro_torch.models import cnn

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
                               sms=sms)


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
    assert plan.grid == (spec.groups * -(-og // plan.bn),
                         -(-pixels // plan.bm), plan.splits)
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    tiles = plan.grid[0] * plan.grid[1]
    if tiles >= sms:
        assert plan.splits == 1
    else:       # the smallest tile, and K split unless too shallow to
        assert (plan.bm, plan.bn) == gfid_conv.BF16_TILES[-1]
        assert plan.splits > 1 or n_chunks < 2 * gfid_conv.BF16_MIN_SPLIT
    # at batch 32 every layer fills the card unsplit, conv1 (cg = 3, og = 96)
    # and conv2 (og = 128) with the wide tile; at batch 1 conv3-5 (169
    # pixels) split K
    if batch == 32:
        wide = spec.name in ("conv1", "conv2")
        assert plan.splits == 1 and (plan.bn == 128) == wide
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
                              sms=sms)


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("spec", CNN_CONVS, ids=lambda s: s.name)
def test_f32_conv_plan_fills_the_card_or_splits_k(spec, batch):
    """At each conv the plan's blocks fill the 132 SMs on the first tile
    that does, or, on the smallest tile, K is split (unless too shallow to);
    the splits cover K's chunks with none empty; the grid is the tile's."""
    sms = 132
    plan = _f32_plan(spec, batch, sms)
    cg = spec.c_in // spec.groups
    og = spec.c_out // spec.groups
    pixels = batch * spec.h_out * spec.w_out
    n_chunks = -(-spec.h_f * spec.w_f * cg // gfid_conv.F32_BK)
    assert (plan.bm, plan.bn) in gfid_conv.F32_TILES
    assert plan.bn == 64 or og > 64
    tiles = spec.groups * -(-og // plan.bn) * -(-pixels // plan.bm)
    assert plan.grid == (tiles, 1, plan.splits)
    assert all(g <= lim for g, lim in zip(plan.grid, build.GRID_LIMITS))
    assert (plan.splits - 1) * plan.chunks_per_split < n_chunks \
        <= plan.splits * plan.chunks_per_split
    assert plan.splits == 1 or plan.chunks_per_split >= gfid_conv.F32_MIN_SPLIT
    if tiles >= sms:
        assert plan.splits == 1
        wider = [t for t in gfid_conv.F32_TILES[:gfid_conv.F32_TILES.index(
            (plan.bm, plan.bn))] if t[1] == 64 or og > 64]
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
    # AlexNet at batch 1: conv3-5 (169 pixels) split K; at batch 32 nothing does
    alex = {spec.name: spec for spec in ALEXNET_CONVS}
    for name in ("conv3", "conv4", "conv5"):
        assert _f32_plan(alex[name], 1).splits > 1
    assert all(_f32_plan(spec, 32).splits == 1 for spec in ALEXNET_CONVS)


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
    is the engine plan's tiling (TILE)."""
    src = (build.CSRC / "gfid_conv.cu").read_text()
    assert f"constexpr int kBK = {gfid_conv.F32_BK};" in src
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
