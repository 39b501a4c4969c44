"""The port's int8 path on the CPU against the JAX package: `core/quant`,
`dequant_epilogue` and the engine's precision contract.

Inputs are made with numpy from a seed and go through both packages.
Tolerance: none — quantization, exact int32 sums and the pinned dequant
order give the same fp32 bits in both (`assert_array_equal`), except for
the gelu activation, whose tanh differs between the libraries by about an
ulp: there max|port - jax| <= 1e-6 * (|jax| + max|jax|).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.core import quant as jax_quant
from repro.kernels import epilogue as jax_epilogue
from repro_torch import engine as TE
from repro_torch.core import quant
from repro_torch.kernels import epilogue

jax.config.update("jax_platform_name", "cpu")

GELU_RTOL = 1e-6


def _normal(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# core/quant
# ---------------------------------------------------------------------------

def test_round_half_away_matches_reference():
    x = np.concatenate([
        np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.0, -0.0,
                  np.nextafter(np.float32(0.5), np.float32(0)),
                  126.5, -126.5], np.float32),
        _normal(0, 1000, scale=50.0)])
    got = quant.round_half_away(torch.from_numpy(x))
    _same(got, jax_quant.round_half_away(jnp.asarray(x)))
    np.testing.assert_array_equal(got[:6].numpy(),
                                  [1, 2, 3, -1, -2, -3])


@pytest.mark.parametrize("fmt_name", ["ACT_FORMAT", "WEIGHT_FORMAT"])
def test_quantize_midpoints_and_saturation_match_reference(fmt_name):
    fmt_t, fmt_j = getattr(quant, fmt_name), getattr(jax_quant, fmt_name)
    lsb = 1.0 / fmt_t.scale
    k = np.arange(-6, 6, dtype=np.float32)
    x = np.concatenate([(k + 0.5) * lsb,            # every grid midpoint
                        np.array([1e6, -1e6, 0.375], np.float32),
                        _normal(1, 500, scale=3.0)]).astype(np.float32)
    got = quant.quantize(torch.from_numpy(x), fmt_t)
    _same(got, jax_quant.quantize(jnp.asarray(x), fmt_j))
    if fmt_name == "ACT_FORMAT":                    # Q13.2: 0.375 -> 0.5
        assert got[-501].item() == 0.5
    assert got[12].item() == fmt_t.max_int / fmt_t.scale
    assert got[13].item() == fmt_t.min_int / fmt_t.scale
    np.testing.assert_allclose(
        quant.quantization_snr_db(torch.from_numpy(x), fmt_t).item(),
        float(jax_quant.quantization_snr_db(jnp.asarray(x), fmt_j)),
        rtol=1e-5)


def test_int8_grid_rounding_and_clip():
    x = np.array([0.25, -0.25, 63.75, 1000.0, -1000.0], np.float32)
    got = quant.quantize_int8(torch.from_numpy(x), torch.tensor(0.5))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), [1, -1, 127, 127, -127])
    _same(got, jax_quant.quantize_int8(jnp.asarray(x), jnp.float32(0.5)))


def test_all_zero_slices_get_unit_scale():
    x = np.zeros((4, 8), np.float32)
    x[1] = _normal(2, 8)
    s = quant.symmetric_scale(torch.from_numpy(x), axis=-1)
    np.testing.assert_array_equal(s.numpy()[[0, 2, 3]], np.ones((3, 1)))
    _same(s, jax_quant.symmetric_scale(jnp.asarray(x), axis=-1))
    q = quant.quantize_int8(torch.from_numpy(x), s)
    assert not q[[0, 2, 3]].any()


@pytest.mark.parametrize("axis", [None, -1, 0, (1, 2, 3)])
def test_symmetric_scale_matches_reference(axis):
    x = _normal(3, 2, 5, 7, 3, scale=4.0)
    _same(quant.symmetric_scale(torch.from_numpy(x), axis=axis),
          jax_quant.symmetric_scale(jnp.asarray(x), axis=axis))


def test_inv_qmax_is_the_fp32_reciprocal():
    assert quant._INV_QMAX.dtype == torch.float32
    assert quant._INV_QMAX.item() == float(jax_quant._INV_QMAX)


def test_quantize_conv_operands_match_reference():
    x = _normal(4, 3, 9, 11, 6, scale=2.0)
    w = _normal(5, 3, 3, 3, 10, scale=0.3)
    got = quant.quantize_conv_operands(torch.from_numpy(x),
                                       torch.from_numpy(w))
    want = jax_quant.quantize_conv_operands(jnp.asarray(x), jnp.asarray(w))
    for g, wnt in zip(got, want):
        _same(g, wnt)


def test_quantize_matmul_operands_match_reference():
    x = _normal(6, 2, 5, 40, scale=3.0)
    w = _normal(7, 40, 33, scale=0.1)
    got = quant.quantize_matmul_operands(torch.from_numpy(x),
                                         torch.from_numpy(w))
    want = jax_quant.quantize_matmul_operands(jnp.asarray(x), jnp.asarray(w))
    for g, wnt in zip(got, want):
        _same(g, wnt)


@pytest.mark.parametrize("k", [1023, 1024, 1025, 2049])
def test_int8_matmul_i32_exact_across_the_chunk_edge(k):
    rng = np.random.default_rng(k)
    xq = rng.integers(-127, 128, (3, k), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, 5), dtype=np.int8)
    xq[0], wq[:, 0] = 127, 127          # the largest sum: 127**2 * K
    got = quant.int8_matmul_i32(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    exact = xq.astype(np.int64) @ wq.astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), exact)
    _same(got, jax_quant.int8_matmul_i32(jnp.asarray(xq), jnp.asarray(wq)))


def test_row_scales_are_batch_invariant():
    x = _normal(8, 6, 64, scale=5.0)
    w = _normal(9, 64, 16)
    batched = quant.quantize_matmul_operands(torch.from_numpy(x),
                                             torch.from_numpy(w))
    for i in range(x.shape[0]):
        solo = quant.quantize_matmul_operands(torch.from_numpy(x[i:i + 1]),
                                              torch.from_numpy(w))
        assert torch.equal(solo[0], batched[0][i:i + 1])
        assert torch.equal(solo[2], batched[2][i:i + 1])


# ---------------------------------------------------------------------------
# dequant_epilogue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", [None, "relu", "gelu"])
@pytest.mark.parametrize("has_bias", [False, True])
def test_dequant_epilogue_matches_reference(act, has_bias):
    rng = np.random.default_rng(10)
    acc = rng.integers(-150_000_000, 150_000_000, (6, 9), dtype=np.int32)
    scale = ((np.abs(_normal(11, 6, 1)) + 0.1)
             * (np.abs(_normal(12, 1, 9)) + 0.1) * 1e-6).astype(np.float32)
    bias = _normal(13, 9) if has_bias else None
    got = epilogue.dequant_epilogue(
        torch.from_numpy(acc), torch.from_numpy(scale),
        None if bias is None else torch.from_numpy(bias), act)
    want = jax_epilogue.dequant_epilogue(
        jnp.asarray(acc), jnp.asarray(scale),
        None if bias is None else jnp.asarray(bias), act)
    if act == "gelu":
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GELU_RTOL,
                                   atol=GELU_RTOL * np.abs(want).max())
    else:
        _same(got, want)


# ---------------------------------------------------------------------------
# The engine's precision contract
# ---------------------------------------------------------------------------

def _jax_int8(fn):
    with jax_engine.using_config(jax_engine.EngineConfig(backend="xla",
                                                         precision="int8")):
        return np.asarray(fn())


@pytest.mark.parametrize("bias,act", [(False, None), (True, "relu")])
def test_dense_int8_backends_bitwise_equal_to_reference(bias, act):
    x, w, b = _normal(14, 2, 3, 70), _normal(15, 70, 24), _normal(16, 24)
    bt = torch.from_numpy(b) if bias else None
    want = _jax_int8(lambda: jax_engine.dense(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b) if bias else None,
        act=act))
    for backend in ("cuda", "torch", "ref"):
        with TE.using_config(TE.EngineConfig(backend=backend,
                                             precision="int8")):
            got = TE.dense(torch.from_numpy(x), torch.from_numpy(w),
                           bias=bt, act=act)
        _same(got, want)


@pytest.mark.parametrize("stride,pad,groups,c_in", [
    (1, 1, 1, 4), (4, 2, 1, 3), (1, 2, 2, 6), (2, 0, 2, 8)])
def test_conv2d_int8_backends_bitwise_equal_to_reference(stride, pad,
                                                         groups, c_in):
    x = _normal(17, 2, 13, 12, c_in, scale=2.0)
    w = _normal(18, 5, 5, c_in // groups, 10, scale=0.2)
    b = _normal(19, 10)
    want = _jax_int8(lambda: jax_engine.conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=stride, pad=pad,
        groups=groups, bias=jnp.asarray(b), act="relu"))
    for backend in ("cuda", "torch", "ref"):
        with TE.using_config(TE.EngineConfig(backend=backend,
                                             precision="int8")):
            got = TE.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                            stride=stride, pad=pad, groups=groups,
                            bias=torch.from_numpy(b), act="relu")
        _same(got, want)


def test_explicit_precision_wins_over_config():
    x, w = torch.from_numpy(_normal(20, 4, 32)), torch.from_numpy(
        _normal(21, 32, 16))
    with TE.using_config(TE.EngineConfig(precision="fp32")):
        got = TE.matmul(x, w, precision="int8")
    with TE.using_config(TE.EngineConfig(precision="int8")):
        ambient = TE.matmul(x, w)
        fp32 = TE.matmul(x, w, precision="fp32")
    assert torch.equal(got, ambient)
    assert torch.equal(fp32, TE.matmul(x, w))
    assert not torch.equal(got, fp32)


def test_unknown_precision_raises():
    x, w = torch.ones(4, 32), torch.ones(32, 16)
    with pytest.raises(ValueError, match="unknown precision"):
        TE.matmul(x, w, precision="int4")
    with pytest.raises(ValueError, match="unknown precision"):
        TE.EngineConfig(precision="int4")


def test_explicit_int8_on_an_uncovered_op_raises():
    x, w = torch.ones(3, 4, 8), torch.ones(3, 8, 5)
    with pytest.raises(ValueError, match="int8 contract"):
        TE.einsum("ecd,edf->ecf", x, w, precision="int8")


def test_config_int8_keeps_an_uncovered_op_fp32():
    x, w = torch.from_numpy(_normal(22, 3, 4, 8)), torch.from_numpy(
        _normal(23, 3, 8, 5))
    with TE.using_config(TE.EngineConfig(backend="torch", precision="int8")):
        got = TE.einsum("ecd,edf->ecf", x, w)
    with TE.using_config(TE.EngineConfig(backend="torch")):
        want = TE.einsum("ecd,edf->ecf", x, w)
    assert torch.equal(got, want)


@pytest.mark.parametrize("op", [
    ("conv2d", (1, 8, 8, 4), (3, 3, 4, 8), ""),
    ("dense", (4, 32), (32, 16), "...n,nm->...m"),
    ("dense", (3, 4, 8), (3, 8, 5), "ecd,edf->ecf"),
    ("dense", (3, 7), (5, 7), "bd,fd->bf"),
    ("dense", (3, 7), (7, 5), "bd,df->fb"),
])
def test_supports_int8_and_with_precision_match_reference(op):
    kind, xs, ws, spec = op
    t_op = TE.OpSpec(kind, xs, ws, spec=spec)
    j_op = jax_engine.OpSpec(kind, xs, ws, spec=spec)
    assert TE.supports_int8(t_op) == jax_engine.supports_int8(j_op)
    t_plan = TE.with_precision(TE.plan_op(t_op, "cuda"), t_op, "int8")
    j_plan = jax_engine.with_precision(jax_engine.plan_op(j_op, "pallas"),
                                       j_op, "int8")
    assert t_plan.precision == j_plan.precision
    assert t_plan.exec_ma_words == j_plan.exec_ma_words
    assert t_plan.ma_words == j_plan.ma_words
    assert TE.with_precision(t_plan, t_op, "fp32") == TE.plan_op(t_op, "cuda")


def test_compile_pins_int8_and_matches_eager():
    def fn(p, x):
        y = TE.conv2d(x, p["w1"], stride=2, pad=1, bias=p["b1"], act="relu")
        y = y.reshape(y.shape[0], -1)
        z = TE.einsum("ecd,edf->ecf", y.reshape(2, 1, -1),
                      p["w3"].reshape(1, -1, 3).expand(2, -1, -1))
        return TE.matmul(y, p["w2"], act="relu"), z

    params = {"w1": torch.from_numpy(_normal(24, 3, 3, 3, 6)),
              "b1": torch.from_numpy(_normal(25, 6)),
              "w2": torch.from_numpy(_normal(26, 4 * 4 * 6, 5)),
              "w3": torch.from_numpy(_normal(27, 4 * 4 * 6, 3))}
    x = torch.from_numpy(_normal(28, 2, 8, 8, 3))
    prog = TE.Program("p", (), fn=fn, in_avals=(
        {k: v.to("meta") for k, v in params.items()}, x.to("meta")))
    # "torch": the "cuda" backend runs no batched-weight einsum
    cfg = TE.EngineConfig(backend="torch", precision="int8")
    compiled = TE.compile(prog, cfg)
    assert compiled.precisions() == ("int8", "fp32", "int8")
    with TE.using_config(cfg):
        eager = fn(params, x)
    for got, want in zip(compiled.apply(params, x), eager):
        assert torch.equal(got, want)
