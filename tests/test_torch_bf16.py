"""The port's bf16 operand path on the CPU against the JAX package.

The GEMM and conv kernels take bf16 x and w, accumulate in fp32 and store
fp32 or bf16 from an fp32 epilogue; on a CPU tensor each wrapper runs its
plain version, which the Pallas kernels (interpret mode, bf16 inputs) are
held against here. The engine ops follow the API contract of the
reference's "xla" backend on all three of the port's backends: `dense` and
`conv2d` accumulate in fp32, `einsum` and `proj` natively; `dense` returns
fp32 on bf16 operands, `conv2d`, `einsum`, `proj` and `matmul` bf16.

Tolerances, each with its reason:
  * an fp32 result: max|port - jax| <= 1e-5 * max|jax| (products of bf16
    values are exact in fp32; only the order of the fp32 sums differs);
  * a bf16 result: every element within one bf16 step of the reference's
    element (the step at the larger of the two magnitudes; 1e-5 * max|jax|
    where that is larger, for elements near zero): two fp32 sums a few
    ulps apart can round to neighbouring bf16 values;
  * AlexNet in bf16 at full width: logits within 2e-2 * max|logits| of
    JAX's `program(dtype=bfloat16)` on "xla" (measured here 3.9e-3 on
    "torch" and "ref", 5.9e-3 on "cuda": eight layers each rounding its
    bf16 activations, the kernels once where "xla" rounds before and after
    the bias), and SNR >= 28 dB against the fp32 forward from the same
    weights (measured here 45.5 dB).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs.base import reduced as jax_reduced
from repro.kernels import gfid_conv as jax_conv
from repro.kernels import gfid_matmul as jax_matmul
from repro.kernels import ops as jax_ops
from repro.models import cnn as jax_cnn
from repro.models import transformer as JT
from repro_torch import engine as TE
from repro_torch.configs.base import reduced
from repro_torch.core import quant
from repro_torch.kernels import gfid_conv, gfid_matmul, ops, ref
from repro_torch.models import cnn as t_cnn
from repro_torch.models import layers
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
CNN_TOL = 2e-2
SNR_FLOOR_DB = 28.0
BF16 = torch.bfloat16
BACKENDS = ("cuda", "torch", "ref")


def _bf16_arrays(seed, *shapes, scale=1.0):
    """numpy fp32 arrays of bf16-representable values (rounded to nearest
    even), so both packages get the same bf16 operands."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal(s) * scale).astype(
        np.float32)).to(BF16).float().numpy() for s in shapes]


def _t(a, dtype=BF16):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.bfloat16):
    return jnp.asarray(a).astype(dtype)


def _np32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(jnp.asarray(a).astype(jnp.float32))


def close_fp32(got, want, tol=TOL):
    got, want = _np32(got), _np32(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def bf16_step(a):
    """The spacing of bf16 values at |a| (fp32 array): 2**(e - 7) for
    |a| in [2**e, 2**(e + 1))."""
    a = np.abs(a).astype(np.float32)
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7).astype(np.float32)


def close_bf16(got, want, bias=None):
    """Every element within one bf16 step of the reference's element. With
    a `bias` the reference rounds the sums to bf16 before adding it (its
    "xla" conv), the kernels once after: the step is then taken at the
    sums' magnitude, at most |result| + |bias|."""
    assert got.dtype == BF16
    g, w = _np32(got), _np32(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    mag = np.maximum(np.abs(g), np.abs(w))
    if bias is not None:
        mag = mag + np.abs(_np32(bias))
    limit = np.maximum(bf16_step(mag), TOL * np.abs(w).max())
    assert (np.abs(g - w) <= limit).all(), np.abs(g - w).max()


# ---------------------------------------------------------------------------
# Kernels: the plain bf16 versions against the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

# (M, K, N, bias, act): M = 1, M not a multiple of 8, ragged K and N, gelu
MATMUL_CASES = [
    (1, 64, 48, False, None),
    (1, 300, 130, True, "relu"),
    (5, 96, 130, True, "relu"),
    (10, 33, 17, True, "gelu"),
    (13, 128, 256, False, "relu"),
    (8, 512, 40, True, None),
    (3, 1, 5, False, "gelu"),
]


@pytest.mark.parametrize("m,k,n,has_bias,act", MATMUL_CASES)
def test_bf16_matmul_plain_matches_pallas(m, k, n, has_bias, act):
    """Both stores: fp32 against the Pallas kernel's fp32 output, bf16
    against the reference's launch glue, which casts it to x's dtype."""
    x, w, b = _bf16_arrays(m * 1000 + n, (m, k), (k, n), (n,))
    jb = _j(b) if has_bias else None
    want32 = jax_matmul.gfid_matmul(_j(x), _j(w), bias=jb, act=act,
                                    interpret=True)
    want16 = jax_ops.gfid_matmul(_j(x), _j(w), bias=jb, act=act,
                                 interpret=True)
    assert want32.dtype == jnp.float32 and want16.dtype == jnp.bfloat16
    tb = _t(b) if has_bias else None
    got32 = gfid_matmul.gfid_matmul(_t(x), _t(w), bias=tb, act=act)
    got16 = gfid_matmul.gfid_matmul(_t(x), _t(w), bias=tb, act=act,
                                    out_dtype=BF16)
    assert got32.dtype == torch.float32
    close_fp32(got32, want32)
    close_bf16(got16, want16)


# (B, H, W, C_in, C_out, k, stride, pad, groups, bias, act); the first is
# tests/test_kernels.py's bf16 case
CONV_CASES = [
    (1, 12, 12, 4, 8, 3, 1, 1, 1, False, None),
    (1, 12, 12, 4, 8, 3, 1, 1, 1, True, "relu"),
    (2, 13, 11, 6, 10, 3, 2, 1, 2, True, "gelu"),     # stride 2, groups 2
    (1, 23, 23, 3, 5, 11, 4, 0, 1, False, None),      # AlexNet conv1 mode
    (1, 9, 9, 8, 16, 5, 1, 2, 2, True, "relu"),       # AlexNet conv2 mode
    (2, 8, 8, 5, 7, 1, 1, 0, 1, True, None),          # ragged 1x1
]


@pytest.mark.parametrize("b,h,w_,c_in,c_out,k,s,pad,groups,has_bias,act",
                         CONV_CASES)
def test_bf16_conv_plain_matches_pallas(b, h, w_, c_in, c_out, k, s, pad,
                                        groups, has_bias, act):
    """bf16 store against the reference's glue (`ops.gfid_conv2d`, pad,
    groups and the cast to x's dtype); fp32 store against the Pallas
    kernel itself on the padded input (one group)."""
    x, w, bias = _bf16_arrays(h * 100 + k, (b, h, w_, c_in),
                              (k, k, c_in // groups, c_out), (c_out,))
    jb = _j(bias) if has_bias else None
    want16 = jax_ops.gfid_conv2d(_j(x), _j(w), stride=s, pad=pad,
                                 groups=groups, bias=jb, act=act,
                                 interpret=True)
    assert want16.dtype == jnp.bfloat16
    tb = _t(bias) if has_bias else None
    kw = dict(stride=s, pad=pad, groups=groups, bias=tb, act=act)
    got16 = gfid_conv.gfid_conv2d_nhwc(_t(x), _t(w), out_dtype=BF16, **kw)
    close_bf16(got16, want16)
    got32 = gfid_conv.gfid_conv2d_nhwc(_t(x), _t(w), **kw)
    assert got32.dtype == torch.float32
    if groups == 1:
        xp = jnp.pad(_j(x), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        want32 = jax_conv.gfid_conv2d_nhwc(xp, _j(w), stride=s, bias=jb,
                                           act=act, interpret=True)
        assert want32.dtype == jnp.float32
        close_fp32(got32, want32)
    else:
        close_fp32(got32, gfid_conv.gfid_conv2d_nhwc(
            _t(x, torch.float32), _t(w, torch.float32), **dict(
                kw, bias=None if tb is None else tb.float())))


def test_library_versions_take_bf16():
    """`kernels/ref.py` in bf16: fp32 sums, cast to x's dtype, as the
    reference's `matmul_ref` and `conv2d_ref`."""
    x, w = _bf16_arrays(3, (4, 40), (40, 24))
    got = ref.matmul_ref(_t(x), _t(w))
    assert got.dtype == BF16
    close_bf16(got, jax_ops.gfid_matmul(_j(x), _j(w), interpret=True))
    x, w = _bf16_arrays(4, (1, 12, 12, 4), (3, 3, 4, 8))
    got = ref.conv2d_ref(_t(x), _t(w), 1, 1)
    assert got.dtype == BF16
    close_bf16(got, jax_ops.gfid_conv2d(_j(x), _j(w), stride=1, pad=1,
                                        interpret=True))


# ---------------------------------------------------------------------------
# Wrapper branches
# ---------------------------------------------------------------------------

def _launches():
    return (gfid_matmul.gfid_matmul.launches,
            gfid_matmul.gfid_matmul_bf16.launches,
            gfid_conv.gfid_conv2d_nhwc.launches,
            gfid_conv.gfid_conv2d_nhwc_bf16.launches)


@pytest.mark.parametrize("out_dtype", [None, torch.float32, BF16])
def test_bf16_wrappers_meta_branch_returns_the_stored_dtype(out_dtype):
    """Capture and replay agree on dtypes: the `meta` branch allocates what
    the kernel would store (fp32 unless bf16 is asked for), and neither
    the CPU nor the `meta` branch counts a launch."""
    want = out_dtype or torch.float32
    before = _launches()
    mm = gfid_matmul.gfid_matmul(torch.empty((5, 7), dtype=BF16,
                                             device="meta"),
                                 torch.empty((7, 3), dtype=BF16,
                                             device="meta"),
                                 out_dtype=out_dtype)
    assert mm.device.type == "meta" and mm.dtype == want
    assert tuple(mm.shape) == (5, 3)
    cv = gfid_conv.gfid_conv2d_nhwc(
        torch.empty((2, 9, 9, 4), dtype=BF16, device="meta"),
        torch.empty((3, 3, 2, 6), dtype=BF16, device="meta"), stride=2,
        pad=1, groups=2, out_dtype=out_dtype)
    assert cv.dtype == want and tuple(cv.shape) == (2, 5, 5, 6)
    cpu = gfid_conv.gfid_conv2d_nhwc(
        torch.ones((1, 4, 4, 2), dtype=BF16), torch.ones((1, 1, 2, 3),
                                                         dtype=BF16),
        bias=torch.ones(3), out_dtype=out_dtype)
    assert cpu.dtype == want and bool((cpu == 3).all())
    assert _launches() == before


@pytest.mark.parametrize("x_dtype,w_dtype,kw", [
    (torch.float32, BF16, {}),                     # mixed operands
    (BF16, torch.float32, {}),
    (torch.float16, torch.float16, {}),            # fp16 is not taken
    (BF16, BF16, {"bias": torch.zeros(3, dtype=torch.float16)}),
    (torch.float32, torch.float32, {"bias": torch.zeros(3, dtype=BF16)}),
])
def test_bf16_wrappers_refuse_other_dtypes(x_dtype, w_dtype, kw):
    x, w = torch.ones((2, 4), dtype=x_dtype), torch.ones((4, 3),
                                                         dtype=w_dtype)
    with pytest.raises(TypeError):
        gfid_matmul.gfid_matmul(x, w, **kw)
    xc = torch.ones((1, 3, 3, 4), dtype=x_dtype)
    wc = torch.ones((1, 1, 4, 3), dtype=w_dtype)
    with pytest.raises(TypeError):
        gfid_conv.gfid_conv2d_nhwc(xc, wc, **kw)


@pytest.mark.parametrize("dtype,out_dtype", [
    (BF16, torch.float16), (torch.float32, BF16),
    (torch.float32, torch.float16)])
def test_float_wrappers_cast_other_out_dtypes(dtype, out_dtype):
    """An `out_dtype` the kernel does not store is its fp32 store, cast:
    the same on the CPU and `meta` branches, so "cuda", "torch" and "ref"
    return it alike."""
    x, w, b = _bf16_arrays(31, (5, 24), (24, 6), (6,))
    xc, wc, bc = _bf16_arrays(32, (1, 5, 5, 4), (3, 3, 2, 6), (6,))
    for wrapper, plain, args, kw in (
            (gfid_matmul.gfid_matmul, gfid_matmul.gfid_matmul_plain,
             (_t(x, dtype), _t(w, dtype)), dict(bias=_t(b, torch.float32))),
            (gfid_conv.gfid_conv2d_nhwc, gfid_conv.gfid_conv2d_nhwc_plain,
             (_t(xc, dtype), _t(wc, dtype)),
             dict(bias=_t(bc, torch.float32), pad=1, groups=2))):
        got = wrapper(*args, act="relu", out_dtype=out_dtype, **kw)
        want = plain(*args, act="relu", **kw).to(out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)
        meta = wrapper(*(a.to("meta") for a in args), act="relu",
                       out_dtype=out_dtype,
                       **{k: v.to("meta") if torch.is_tensor(v) else v
                          for k, v in kw.items()})
        assert meta.dtype == out_dtype and meta.shape == got.shape
    for backend in BACKENDS:
        with TE.using_config(TE.EngineConfig(backend=backend)):
            out = TE.einsum("sn,nm->sm", _t(x, dtype), _t(w, dtype),
                            out_dtype=out_dtype)
        assert out.dtype == out_dtype, backend


def test_ops_store_the_asked_dtype_and_refuse_int8_on_bf16():
    x, w, b = _bf16_arrays(9, (2, 3, 32), (32, 16), (16,))
    out = ops.gfid_matmul(_t(x), _t(w), bias=_t(b), act="relu",
                          out_dtype=BF16)
    assert out.dtype == BF16 and tuple(out.shape) == (2, 3, 16)
    close_bf16(out, jax_ops.gfid_matmul(_j(x), _j(w), bias=_j(b),
                                        act="relu", interpret=True))
    # fp32 operands asked for bf16: the fp32 kernel's result, cast
    out32 = ops.gfid_matmul(_t(x, torch.float32), _t(w, torch.float32),
                            out_dtype=BF16)
    assert out32.dtype == BF16
    # int8 on bf16 inputs (refused before it was ported): quantized from
    # the inputs widened, dequantized in fp32, cast to bf16, bitwise the
    # reference's "xla" int8
    with jax_engine.using_config(jax_engine.EngineConfig(precision="int8")):
        want = jax_engine.dense(_j(x), _j(w), bias=_j(b), act="relu")
    got = TE.dense(_t(x), _t(w), bias=_t(b), act="relu", precision="int8")
    assert got.dtype == BF16 and str(want.dtype) == "bfloat16"
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    xc = np.ones((1, 4, 4, 2), np.float32)
    wc = np.ones((1, 1, 2, 3), np.float32)
    out = TE.conv2d(_t(xc), _t(wc), precision="int8")
    assert out.dtype == BF16 and tuple(out.shape) == (1, 4, 4, 3)


# ---------------------------------------------------------------------------
# Engine ops: the dtypes and values of JAX "xla"
# ---------------------------------------------------------------------------

def _op_cases():
    x, w, b = _bf16_arrays(21, (3, 5, 64), (64, 48), (48,))
    xc, wc, bc = _bf16_arrays(22, (2, 10, 10, 6), (3, 3, 3, 8), (8,))
    return [
        ("dense", lambda E, a: E.dense(a(x), a(w))),
        ("dense bias relu", lambda E, a: E.dense(a(x), a(w), bias=a(b),
                                                 act="relu")),
        ("dense native", lambda E, a: E.dense(a(x), a(w), accum_dtype=None)),
        ("dense out bf16", lambda E, a: E.dense(a(x), a(w),
                                                out_dtype=a.dtype)),
        ("einsum", lambda E, a: E.einsum("bsn,nm->bsm", a(x), a(w))),
        ("einsum fp32", lambda E, a: E.einsum("bsn,nm->bsm", a(x), a(w),
                                              accum_dtype=a.f32)),
        ("einsum tied", lambda E, a: E.einsum("bsd,vd->bsv", a(x), a(w.T),
                                              accum_dtype=a.f32)),
        ("proj", lambda E, a: E.proj(a(x), a(w))),
        ("matmul", lambda E, a: E.matmul(a(x[0]), a(w), bias=a(b),
                                         act="relu")),
        ("conv2d", lambda E, a: E.conv2d(a(xc), a(wc), stride=1, pad=1,
                                         groups=2, bias=a(bc), act="relu")),
    ], bc


class _Jax:
    dtype, f32 = jnp.bfloat16, jnp.float32

    def __call__(self, arr):
        return _j(np.ascontiguousarray(arr))


class _Torch:
    dtype, f32 = BF16, torch.float32

    def __call__(self, arr):
        return _t(np.ascontiguousarray(arr))


OP_NAMES = [name for name, _ in _op_cases()[0]]
XLA_DTYPES = {"dense": "float32", "dense bias relu": "float32",
              "dense native": "bfloat16", "dense out bf16": "bfloat16",
              "einsum": "bfloat16", "einsum fp32": "float32",
              "einsum tied": "float32", "proj": "bfloat16",
              "matmul": "bfloat16", "conv2d": "bfloat16"}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", OP_NAMES)
def test_engine_ops_on_bf16_follow_jax_xla(backend, name):
    cases, conv_bias = _op_cases()
    fn = dict(cases)[name]
    want = fn(jax_engine, _Jax())
    assert str(want.dtype) == XLA_DTYPES[name]      # the reference's contract
    with TE.using_config(TE.EngineConfig(backend=backend)):
        got = fn(TE, _Torch())
    assert str(got.dtype).replace("torch.", "") == XLA_DTYPES[name]
    if got.dtype == torch.float32:
        close_fp32(got, want)
    else:
        close_bf16(got, want, conv_bias if name == "conv2d" else None)


@pytest.mark.parametrize("arg", [torch.bfloat16, torch.float16, "float32"])
def test_accum_dtype_takes_none_or_fp32(arg):
    x = torch.ones((2, 4), dtype=BF16)
    with pytest.raises(ValueError, match="accum_dtype"):
        TE.dense(x, x.T, accum_dtype=arg)


def test_reference_pallas_drops_accum_dtype():
    """A reference fault the port is not held to (ROADMAP section 3): on
    bf16 operands the reference's "pallas" backend returns bf16 from
    `dense` and from an fp32-accumulated `einsum`, where "xla" and "ref"
    return fp32, as its API documents. The reference is run only."""
    x, w = _bf16_arrays(31, (3, 256), (256, 128))
    xj, wj = _j(x), _j(w)
    pallas = jax_engine.EngineConfig(backend="pallas", interpret=True)
    for cfg, want in ((jax_engine.EngineConfig(), jnp.float32),
                      (jax_engine.EngineConfig(backend="ref"), jnp.float32),
                      (pallas, jnp.bfloat16)):
        with jax_engine.using_config(cfg):
            assert jax_engine.dense(xj, wj).dtype == want
            assert jax_engine.einsum("bn,nm->bm", xj, wj,
                                     accum_dtype=jnp.float32).dtype == want


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_params_from_jax_carries_a_bf16_tree_bit_exactly():
    """The reference's default `init_params(cfg, key)` (the config's bf16)
    crosses bit for bit; fp32 and int32 leaves keep their dtypes."""
    jcfg = jax_reduced("smollm_135m")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    j_leaves = jax.tree_util.tree_leaves(jp)
    t_leaves = layers.tree_leaves(tp)
    assert len(j_leaves) == len(t_leaves)
    for a, b in zip(j_leaves, t_leaves):
        assert a.dtype == jnp.bfloat16 and b.dtype == BF16
        assert tuple(b.shape) == a.shape
        np.testing.assert_array_equal(b.view(torch.int16).numpy(),
                                      np.asarray(a).view(np.int16))
    mixed = layers.params_from_jax({"a": np.arange(3, dtype=np.int32),
                                    "b": {"c": np.ones(2, np.float32)}},
                                   "cpu")
    assert mixed["a"].dtype == torch.int32
    assert mixed["b"]["c"].dtype == torch.float32


def test_init_params_defaults_to_the_config_dtype():
    """The dense family takes `cfg.param_dtype` (bf16), as the reference;
    the xLSTM stays fp32, and asking it for bf16 raises."""
    smollm, xlstm = reduced("smollm_135m"), reduced("xlstm_125m")
    p = T.init_params(smollm, seed=0, device="cpu")
    assert {a.dtype for a in layers.tree_leaves(p)} == {BF16}
    f32 = T.init_params(smollm, seed=0, device="cpu", dtype=torch.float32)
    assert torch.equal(f32["embed"].to(BF16), p["embed"])
    assert {a.dtype for a in layers.tree_leaves(T.param_shapes(smollm))} \
        == {BF16}
    assert {a.dtype for a in layers.tree_leaves(T.param_shapes(xlstm))} \
        == {torch.float32}
    with pytest.raises(NotImplementedError, match="item 10"):
        T.init_params(xlstm, seed=0, device="cpu", dtype=BF16)


# ---------------------------------------------------------------------------
# The CNN path in bf16
# ---------------------------------------------------------------------------

def _alexnet_bf16():
    """He-normal weights and small biases, rounded to bf16, and an input."""
    rng = np.random.default_rng(2)

    def normal(shape, scale):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(BF16).float().numpy()

    params = {"conv": {}, "fc": {}}
    for cd in jax_cnn.ALEXNET_CONVS:
        cg = cd.c_in // cd.groups
        params["conv"][cd.name] = {
            "w": normal((cd.k, cd.k, cg, cd.c_out),
                        (2.0 / (cd.k * cd.k * cg)) ** 0.5),
            "b": normal((cd.c_out,), 0.05)}
    for fd in jax_cnn.ALEXNET_FCS:
        params["fc"][fd.name] = {"w": normal((fd.n, fd.m), (2.0 / fd.n) ** 0.5),
                                 "b": normal((fd.m,), 0.05)}
    return params, normal((1, 227, 227, 3), 1.0)


@pytest.fixture(scope="module")
def alexnet_bf16():
    """The weights, input and JAX's bf16 logits on "xla" (jitted: the same
    ops as eager, which the reference pins, in less time)."""
    params, x = _alexnet_bf16()
    jparams = jax.tree_util.tree_map(_j, params)
    fwd = jax.jit(lambda p, v: jax_engine.compile(
        jax_cnn.program("alexnet", dtype=jnp.bfloat16)).apply(p, v))
    want = fwd(jparams, _j(x))
    assert want.dtype == jnp.bfloat16
    return params, x, want


@pytest.mark.parametrize("backend", BACKENDS)
def test_alexnet_bf16_full_width_matches_jax(alexnet_bf16, backend):
    params, x, want = alexnet_bf16
    tparams = layers.tree_map(_t, params)
    compiled = TE.compile(t_cnn.program("alexnet", dtype=BF16),
                          TE.EngineConfig(backend=backend))
    assert compiled.backends() == (backend,) * 8
    got = compiled.apply(tparams, _t(x))
    assert got.dtype == BF16 and tuple(got.shape) == (1, 1000)
    close_fp32(got, want, CNN_TOL)
    if backend == "cuda":
        f32 = TE.compile(t_cnn.program("alexnet"),
                         TE.EngineConfig(backend="cuda")).apply(
            layers.tree_map(lambda a: torch.from_numpy(a), params),
            torch.from_numpy(x))
        assert quant.snr_db(f32, got).item() >= SNR_FLOOR_DB


def test_alexnet_bf16_program_plans_as_fp32_and_refuses_int8():
    """Dtype does not enter the analytics: the bf16 program's Table-4 row
    is the golden; its stand-ins are bf16; under int8 (refused before int8
    on bf16 inputs was ported) it compiles with every op int8 and the same
    Table-4 row."""
    import json
    from pathlib import Path
    golden = json.loads((Path(__file__).parent / "goldens"
                         / "table4_alexnet.json").read_text())
    prog = t_cnn.program("alexnet", dtype=BF16)
    assert TE.compile(prog).cost == golden
    stand_ins = layers.tree_leaves(prog.in_avals[0]) + [prog.in_avals[1]]
    assert {a.dtype for a in stand_ins} == {BF16}
    params = t_cnn.init_cnn("alexnet", seed=0, device="cpu", dtype=BF16)
    assert {a.dtype for a in layers.tree_leaves(params)} == {BF16}
    int8 = TE.compile(prog, TE.EngineConfig(precision="int8"))
    assert int8.precisions() == ("int8",) * 8 and int8.cost == golden


# ---------------------------------------------------------------------------
# The ambient accumulator (`EngineConfig.accum`): the dtypes and values of
# JAX "xla"
# ---------------------------------------------------------------------------

ACCUMS = (None, "native", "float32", "bfloat16")


def _accum_cases():
    x, w, b = _bf16_arrays(41, (3, 5, 64), (64, 48), (48,))
    xc, wc = _bf16_arrays(42, (2, 6, 6, 4), (3, 3, 4, 8))
    return [
        ("dense", lambda E, a: E.dense(a(x), a(w))),
        ("dense bias", lambda E, a: E.dense(a(x), a(w), bias=a(b))),
        ("einsum", lambda E, a: E.einsum("bsn,nm->bsm", a(x), a(w))),
        ("proj", lambda E, a: E.proj(a(x), a(w))),
        ("matmul", lambda E, a: E.matmul(a(x[0]), a(w))),
        ("conv2d", lambda E, a: E.conv2d(a(xc), a(wc), pad=1)),
    ]


class _Cast:
    """An operand maker in one dtype, for either package."""

    def __init__(self, make, dtype):
        self.make, self.dtype = make, dtype

    def __call__(self, arr):
        return self.make(np.ascontiguousarray(arr), self.dtype)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_config_accum_resolves_as_jax_xla(accum, dtype):
    """Each op's result dtype under the config's `accum` is the reference's
    "xla" one on fp32 and bf16 inputs on both backends, and the values of
    "torch" (the "xla" lowering) agree; on "cuda" an accumulator the
    kernels cannot honour raises by name, and the port's conv sums in fp32
    whatever `accum` asks for."""
    jcfg = jax_engine.EngineConfig(accum=accum)
    jmk = _Cast(_j, getattr(jnp, dtype))
    tmk = _Cast(_t, getattr(torch, dtype))
    for name, fn in _accum_cases():
        with jax_engine.using_config(jcfg):
            want = fn(jax_engine, jmk)
        narrow = accum == "bfloat16"
        for backend in ("torch", "cuda"):
            with TE.using_config(TE.EngineConfig(backend=backend,
                                                 accum=accum)):
                refuses = narrow and (name == "conv2d" or (
                    backend == "cuda" and name not in ("proj", "matmul")))
                if refuses:
                    with pytest.raises(ValueError, match="accum"):
                        fn(TE, tmk)
                    continue
                got = fn(TE, tmk)
            assert str(got.dtype)[6:] == str(want.dtype), (name, backend)
            if backend == "cuda":
                continue
            if got.dtype == BF16:
                close_bf16(got, want)
            else:
                close_fp32(got, want)


def test_config_accum_is_validated_as_the_reference():
    for accum in ("float16", "int8", "float64"):
        TE.EngineConfig(accum=accum)
        jax_engine.EngineConfig(accum=accum)
    for bad in ("nope", "fp32"):
        with pytest.raises(ValueError, match="accum"):
            TE.EngineConfig(accum=bad)
        with pytest.raises(ValueError, match="accum"):
            jax_engine.EngineConfig(accum=bad)


# ---------------------------------------------------------------------------
# int8 on bf16 inputs: bitwise the reference's "xla" int8
# ---------------------------------------------------------------------------

def _int8_cases():
    x, w, b = _bf16_arrays(51, (3, 5, 64), (64, 48), (48,))
    xc, wc, bc = _bf16_arrays(52, (2, 9, 9, 8), (3, 3, 4, 16), (16,))
    return [
        ("dense bias relu", lambda E, a: E.dense(a(x), a(w), bias=a(b),
                                                 act="relu")),
        ("dense out fp32", lambda E, a: E.dense(a(x), a(w),
                                                out_dtype=a.f32)),
        ("einsum tied", lambda E, a: E.einsum("bsd,vd->bsv", a(x), a(w.T))),
        ("matmul", lambda E, a: E.matmul(a(x[0]), a(w), bias=a(b))),
        ("proj", lambda E, a: E.proj(a(x), a(w))),
        ("conv2d", lambda E, a: E.conv2d(a(xc), a(wc), stride=2, pad=1,
                                         groups=2, bias=a(bc), act="relu")),
        ("conv2d plain", lambda E, a: E.conv2d(a(xc), a(wc[..., :8]),
                                               groups=2)),
    ]


INT8_NAMES = [name for name, _ in _int8_cases()]


def _same_bits(got, want):
    want = np.asarray(want)
    assert str(got.dtype)[6:] == str(want.dtype)
    if got.dtype == BF16:
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", INT8_NAMES)
def test_int8_ops_on_bf16_bitwise_equal_to_jax_xla(backend, name):
    """Quantized from bf16 widened to fp32, exact int32 sums, the fp32
    dequant epilogue, then one cast to bf16: the reference's "xla" int8 run
    eagerly, bit for bit, on every backend."""
    fn = dict(_int8_cases())[name]
    with jax_engine.using_config(jax_engine.EngineConfig(precision="int8")):
        want = fn(jax_engine, _Jax())
    with TE.using_config(TE.EngineConfig(backend=backend, precision="int8")):
        got = fn(TE, _Torch())
    _same_bits(got, want)


def _tiny_net(mod):
    """2 convs (the second grouped and strided) + 2 FCs at 32x32x3."""
    convs = (mod.ConvDef("a", 3, 8, 3, stride=1, pad=1, pool=2),
             mod.ConvDef("b", 8, 12, 3, stride=2, pad=1, groups=2))
    fcs = (mod.FCDef("fc1", 8 * 8 * 12, 32), mod.FCDef("fc2", 32, 10,
                                                        relu=False))
    return mod.CNNDef("tiny", (32, 32, 3), convs, fcs, "plain")


def _bf16_cnn_params(convs, fcs, seed):
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        a = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(a).to(BF16).float().numpy()

    params = {"conv": {}, "fc": {}}
    for cd in convs:
        cg = cd.c_in // cd.groups
        params["conv"][cd.name] = {
            "w": normal((cd.k, cd.k, cg, cd.c_out),
                        (2.0 / (cd.k * cd.k * cg)) ** 0.5),
            "b": normal((cd.c_out,), 0.05)}
    for fd in fcs:
        params["fc"][fd.name] = {"w": normal((fd.n, fd.m), (2.0 / fd.n) ** 0.5),
                                 "b": normal((fd.m,), 0.05)}
    return params


@pytest.mark.parametrize("backend", BACKENDS)
def test_tiny_cnn_int8_on_bf16_bitwise_equal_to_jax(backend):
    net_j, net_t = _tiny_net(jax_cnn), _tiny_net(t_cnn)
    params = _bf16_cnn_params(net_j.convs, net_j.fcs, 53)
    x = _bf16_arrays(54, (2, 32, 32, 3))[0]
    with jax_engine.using_config(jax_engine.EngineConfig(precision="int8")):
        want = jax_cnn._forward(net_j, jax.tree_util.tree_map(_j, params),
                                _j(x))
    with TE.using_config(TE.EngineConfig(backend=backend, precision="int8")), \
            torch.no_grad():
        got = t_cnn._forward(net_t, layers.tree_map(_t, params), _t(x))
    _same_bits(got, want)


def test_alexnet_bf16_int8_full_width_bitwise_equal_to_jax():
    """AlexNet with bf16 parameters under int8: every op int8 on "cuda",
    the logits bitwise the reference's "xla" int8 (jitted with excess
    precision off: the reference as its code reads)."""
    params, x = _alexnet_bf16()
    cfg = jax_engine.EngineConfig(precision="int8")
    fwd = jax.jit(lambda p, v: jax_engine.compile(
        jax_cnn.program("alexnet", dtype=jnp.bfloat16), cfg).apply(p, v),
        compiler_options={"xla_allow_excess_precision": False})
    want = fwd(jax.tree_util.tree_map(_j, params), _j(x))
    compiled = TE.compile(t_cnn.program("alexnet", dtype=BF16),
                          TE.EngineConfig(backend="cuda", precision="int8"))
    assert compiled.backends() == ("cuda",) * 8
    assert compiled.precisions() == ("int8",) * 8
    got = compiled.apply(layers.tree_map(_t, params), _t(x))
    _same_bits(got, want)
