"""The port's analytic layer against the JAX package: the compiled Table-4
rows equal the goldens bit for bit, and `network_cost`, the per-op plans
and `parse_einsum` equal the reference's for the same inputs."""
import dataclasses
import json
import re
import struct
from pathlib import Path

import jax
import pytest

from repro import engine as jax_engine
from repro.core import analytics as jax_analytics
from repro.engine import plan as jax_plan
from repro.models import cnn as jax_cnn
from repro_torch import engine as TE
from repro_torch.core import analytics as t_analytics
from repro_torch.engine import plan as t_plan
from repro_torch.kernels import gfid_conv, gfid_matmul
from repro_torch.models import cnn as t_cnn

jax.config.update("jax_platform_name", "cpu")

GOLDENS = Path(__file__).parent / "goldens"
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
NETS = ("alexnet", "vgg16", "resnet50")


def _bits(v):
    """Exact float64 bit pattern (floats that merely compare close differ)."""
    if isinstance(v, float):
        return struct.pack("<d", v)
    return v


def _analytic(plan):
    return (plan.kind, dataclasses.astuple(plan.mode), plan.cycles,
            plan.ma_words, plan.macs,
            plan.note)


@pytest.mark.parametrize("net", NETS)
def test_compiled_cost_matches_golden_bit_for_bit(net):
    want = json.loads((GOLDENS / f"table4_{net}.json").read_text())
    got = TE.compile(t_cnn.program(net)).cost
    assert set(got) == set(want)
    for key in want:
        assert _bits(got[key]) == _bits(want[key]), (net, key, got[key])


@pytest.mark.parametrize("net", NETS)
def test_compiled_cost_under_int8_matches_golden_bit_for_bit(net):
    """The Table-4 row is the paper's analytic model: it does not move with
    the execution precision."""
    want = json.loads((GOLDENS / f"table4_{net}.json").read_text())
    compiled = TE.compile(t_cnn.program(net),
                          TE.EngineConfig(precision="int8"))
    assert set(compiled.precisions()) == {"int8"}
    got = compiled.cost
    assert set(got) == set(want)
    for key in want:
        assert _bits(got[key]) == _bits(want[key]), (net, key, got[key])


@pytest.mark.parametrize("main_path_only", [True, False])
@pytest.mark.parametrize("net", NETS)
def test_network_cost_matches_reference(net, main_path_only):
    t_convs, t_fcs = t_cnn.analytics_layers(net, main_path_only)
    j_convs, j_fcs = jax_cnn.analytics_layers(net, main_path_only)
    assert [dataclasses.astuple(c) for c in t_convs] == \
        [dataclasses.astuple(c) for c in j_convs]
    assert [dataclasses.astuple(f) for f in t_fcs] == \
        [dataclasses.astuple(f) for f in j_fcs]
    got = t_analytics.network_cost(net, t_convs, t_fcs)
    want = jax_analytics.network_cost(net, j_convs, j_fcs)
    for g, w in zip(got.conv + got.fc, want.conv + want.fc):
        assert (g.cycles, g.ma_total_words, g.macs) == \
            (w.cycles, w.ma_total_words, w.macs)
    for prop in ("conv_cycles", "fc_cycles", "conv_latency_s", "fc_latency_s",
                 "conv_ma_bytes", "fc_ma_bytes", "conv_perf_efficiency",
                 "fc_perf_efficiency", "conv_throughput_gops",
                 "fc_throughput_gops"):
        assert _bits(getattr(got, prop)) == _bits(getattr(want, prop)), prop


@pytest.mark.parametrize("net", NETS)
def test_plan_network_matches_reference_per_op(net):
    got = TE.plan_network(t_cnn.program(net), TE.EngineConfig())
    want = jax_engine.plan_network(jax_cnn.program(net),
                                   jax_engine.EngineConfig())
    assert [_analytic(p) for p in got.plans] == \
        [_analytic(p) for p in want.plans]
    assert (got.total_macs, got.conv_ma_words, got.fc_ma_words) == \
        (want.total_macs, want.conv_ma_words, want.fc_ma_words)


@pytest.mark.parametrize("net", NETS)
def test_exec_ma_words_match_reference_under_int8(net):
    got = TE.plan_network(t_cnn.program(net),
                          TE.EngineConfig(precision="int8"))
    want = jax_engine.plan_network(jax_cnn.program(net),
                                   jax_engine.EngineConfig(precision="int8"))
    assert [p.precision for p in got.plans] == \
        [p.precision for p in want.plans]
    assert (got.exec_ma_words, got.conv_exec_ma_words,
            got.fc_exec_ma_words) == (want.exec_ma_words,
                                      want.conv_exec_ma_words,
                                      want.fc_exec_ma_words)
    fp32 = TE.plan_network(t_cnn.program(net), TE.EngineConfig())
    assert fp32.exec_ma_words == fp32.conv_ma_words + fp32.fc_ma_words
    assert got.exec_ma_words < fp32.exec_ma_words
    assert (got.conv_ma_words, got.fc_ma_words) == \
        (fp32.conv_ma_words, fp32.fc_ma_words)


def test_with_precision_swaps_the_kernel_tiling():
    conv = t_plan.plan_conv2d((1, 13, 13, 256), (3, 3, 256, 384), 1, 1, 1,
                              "cuda")
    dense = t_plan.plan_einsum("...n,nm->...m", (1, 9216), (9216, 4096),
                               "cuda")
    for plan, op, fp32_tile, int8_tile in (
            (conv, TE.OpSpec("conv2d", (1, 13, 13, 256), (3, 3, 256, 384),
                             pad=1), gfid_conv.TILE, gfid_conv.TILE_INT8),
            (dense, TE.OpSpec("dense", (1, 9216), (9216, 4096),
                              spec="...n,nm->...m"),
             gfid_matmul.TILE, gfid_matmul.TILE_INT8)):
        int8 = t_plan.with_precision(plan, op, "int8")
        assert (plan.tiling, int8.tiling) == (fp32_tile, int8_tile)
        assert _analytic(int8) == _analytic(plan)
        assert t_plan.with_precision(int8, op, "fp32") == plan


@pytest.mark.parametrize("x_shape,w_shape,stride,pad,groups", [
    ((1, 227, 227, 3), (11, 11, 3, 96), 4, 0, 1),
    ((2, 27, 27, 96), (5, 5, 48, 256), 1, 2, 2),
    ((1, 13, 13, 384), (3, 3, 192, 384), 1, 1, 2),
    ((3, 224, 224, 3), (7, 7, 3, 64), 2, 3, 1),
    ((1, 56, 56, 256), (1, 1, 256, 128), 2, 0, 1),
    ((4, 9, 17, 5), (2, 2, 5, 7), 1, 0, 1),
])
def test_plan_conv2d_matches_reference(x_shape, w_shape, stride, pad, groups):
    got = t_plan.plan_conv2d(x_shape, w_shape, stride, pad, groups, "cuda")
    want = jax_plan.plan_conv2d(x_shape, w_shape, stride, pad, groups,
                                "pallas")
    assert _analytic(got) == _analytic(want)
    assert got.tiling == gfid_conv.TILE


@pytest.mark.parametrize("spec,x_shape,w_shape", [
    ("...n,nm->...m", (1, 9216), (9216, 4096)),
    ("...n,nm->...m", (2, 3, 32), (32, 16)),
    ("bn,nm->bm", (32, 4096), (4096, 1000)),
    ("ecd,edf->ecf", (4, 8, 16), (4, 16, 32)),
    ("bsd,hd->bsh", (2, 5, 8), (6, 8)),
    ("bd,df->fb", (3, 7), (7, 5)),
])
def test_plan_einsum_matches_reference(spec, x_shape, w_shape):
    got = t_plan.plan_einsum(spec, x_shape, w_shape, "cuda")
    want = jax_plan.plan_einsum(spec, x_shape, w_shape, "pallas")
    assert _analytic(got) == _analytic(want)
    assert got.tiling == gfid_matmul.TILE
    t_st = t_plan.parse_einsum(spec, len(x_shape), len(w_shape))
    j_st = jax_plan.parse_einsum(spec, len(x_shape), len(w_shape))
    assert dataclasses.astuple(t_st) == dataclasses.astuple(j_st)
    assert t_plan.canonical_gemm(t_st, len(w_shape)) == \
        jax_plan.canonical_gemm(j_st, len(w_shape))


@pytest.mark.parametrize("spec,x_ndim,w_ndim", [
    ("bn,nm", 2, 2),                 # no explicit output
    ("bn,nm,mk->bk", 2, 2),          # three operands
    ("bnn,nm->bm", 3, 2),            # repeated label (a diagonal)
    ("bn,nm->bz", 2, 2),             # output label missing from inputs
    ("bnk,nm->bm", 3, 2),            # k summed within one operand
    ("bn,nm->bm", 3, 2),             # rank mismatch
    ("...abc,nm->...m", 2, 2),       # rank too small for the ellipsis
])
def test_parse_einsum_rejections_match_reference(spec, x_ndim, w_ndim):
    with pytest.raises(ValueError):
        jax_plan.parse_einsum(spec, x_ndim, w_ndim)
    with pytest.raises(ValueError):
        t_plan.parse_einsum(spec, x_ndim, w_ndim)


@pytest.mark.parametrize("path,tile", [
    ("gfid_conv.cu", (("kPixTile", "kCinTile", "kCoutTile"), gfid_conv.TILE)),
    ("gfid_matmul.cu", (("kBM", "kKT", "kBN"), gfid_matmul.TILE)),
    ("gfid_conv_int8.cu", (("kPixTile", "kKc", "kCoutTile"),
                           gfid_conv.TILE_INT8)),
    ("gfid_matmul_int8.cu", (("kBM", "kKT", "kBN"), gfid_matmul.TILE_INT8)),
])
def test_plan_tiling_matches_kernel_source(path, tile):
    names, values = tile
    src = (CSRC / path).read_text()
    for name, value in zip(names, values):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m is not None and int(m.group(1)) == value, name
