"""The port's kernel modules on the CPU against the Pallas kernels.

On a CPU tensor each wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode through the reference's own launch
glue (`repro.kernels.ops`), as tests/test_kernels.py does. The CUDA kernels
themselves run only on a GPU: `chip_smoke.py` holds them against these
plain versions there.

Tolerance: max|port - pallas| <= 1e-5 * max|pallas| for fp32. Both sides
accumulate in fp32, in different orders. The int8 kernels' plain versions
are bitwise equal to the Pallas int8 kernels for act None and relu (exact
int32 sums, the same dequant order); for gelu, whose tanh differs by about
an ulp between the libraries, max|port - pallas| <= 1e-6 * max|pallas|.
"""
import ctypes
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jax_quant
from repro.kernels import gfid_matmul as jax_matmul
from repro.kernels import ops as jax_ops
from repro_torch.core import gfid
from repro_torch.kernels import (build, epilogue, gfid_conv, gfid_matmul, ops,
                                 ref)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
GELU_TOL = 1e-6


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


# (M, K, N, bias, act): M=1, M not a multiple of 8, ragged K/N, gelu.
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
def test_gfid_matmul_matches_pallas(m, k, n, has_bias, act):
    x, w, b = _arrays(m * 1000 + n, (m, k), (k, n), (n,))
    bias = b if has_bias else None
    want = jax_ops.gfid_matmul(jnp.asarray(x), jnp.asarray(w),
                               bias=None if bias is None else jnp.asarray(b),
                               act=act, interpret=True)
    got = gfid_matmul.gfid_matmul(
        torch.from_numpy(x), torch.from_numpy(w),
        bias=None if bias is None else torch.from_numpy(b), act=act)
    _close(got, want)


def test_ops_matmul_flattens_leading_dims():
    x, w, b = _arrays(7, (2, 3, 32), (32, 16), (16,))
    want = jax_ops.gfid_matmul(jnp.asarray(x), jnp.asarray(w),
                               bias=jnp.asarray(b), act="relu", interpret=True)
    got = ops.gfid_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          bias=torch.from_numpy(b), act="relu")
    _close(got, want)


# (B, H, W, C_in, C_out, k, stride, pad, groups, bias, act)
CONV_CASES = [
    (1, 12, 12, 4, 8, 3, 1, 1, 1, True, "relu"),
    (2, 13, 11, 6, 10, 3, 2, 1, 2, True, "gelu"),     # stride 2, groups 2
    (1, 23, 23, 3, 5, 11, 4, 0, 1, False, None),      # AlexNet conv1 mode
    (1, 9, 9, 8, 16, 5, 1, 2, 2, True, "relu"),       # AlexNet conv2 mode
    (2, 8, 8, 5, 7, 1, 1, 0, 1, True, None),          # ragged 1x1
    (1, 10, 10, 6, 4, 7, 2, 3, 1, False, "relu"),     # ResNet conv1 mode
    (1, 8, 9, 4, 6, 1, 2, 0, 1, True, "gelu"),        # W_f <= S
]


@pytest.mark.parametrize("b,h,w_,c_in,c_out,k,s,pad,groups,has_bias,act",
                         CONV_CASES)
def test_gfid_conv2d_nhwc_matches_pallas(b, h, w_, c_in, c_out, k, s, pad,
                                         groups, has_bias, act):
    x, w, bias = _arrays(h * 100 + k, (b, h, w_, c_in),
                         (k, k, c_in // groups, c_out), (c_out,))
    want = jax_ops.gfid_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=s, pad=pad, groups=groups,
        bias=jnp.asarray(bias) if has_bias else None, act=act, interpret=True)
    got = gfid_conv.gfid_conv2d_nhwc(
        torch.from_numpy(x), torch.from_numpy(w), stride=s, pad=pad,
        groups=groups, bias=torch.from_numpy(bias) if has_bias else None,
        act=act)
    _close(got, want)


@pytest.mark.parametrize("k,s,pad,groups", [(3, 1, 1, 1), (5, 1, 2, 2),
                                            (11, 4, 0, 1)])
def test_conv_paths_match_library_conv(k, s, pad, groups):
    """The GFID shifted-GEMM (plain version and ops glue) against the
    library's direct convolution, at the NHWC/HWIO surface."""
    x, w = _arrays(k, (2, 23, 23, 8), (k, k, 8 // groups, 16))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    want = ref.conv2d_ref(xt, wt, s, pad, groups)
    got = ops.gfid_conv2d(xt, wt, stride=s, pad=pad, groups=groups)
    _close(got, want)


def test_matmul_path_matches_library_matmul():
    x, w = _arrays(11, (2, 3, 40), (40, 24))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _close(ops.gfid_matmul(xt, wt), ref.matmul_ref(xt, wt))


def test_cpu_and_meta_paths_count_no_launch():
    x, w = torch.ones(2, 8, 8, 4), torch.ones(3, 3, 2, 6)
    before = (gfid_conv.gfid_conv2d_nhwc.launches,
              gfid_matmul.gfid_matmul.launches)
    gfid_conv.gfid_conv2d_nhwc(x, w, pad=1, groups=2)
    meta = gfid_conv.gfid_conv2d_nhwc(x.to("meta"), w.to("meta"), stride=2,
                                      pad=1, groups=2, act="relu")
    assert meta.device.type == "meta" and tuple(meta.shape) == (2, 4, 4, 6)
    mm = gfid_matmul.gfid_matmul(torch.ones(3, 5, device="meta"),
                                 torch.ones(5, 7, device="meta"))
    assert mm.device.type == "meta" and tuple(mm.shape) == (3, 7)
    gfid_matmul.gfid_matmul(torch.ones(3, 5), torch.ones(5, 7))
    assert (gfid_conv.gfid_conv2d_nhwc.launches,
            gfid_matmul.gfid_matmul.launches) == before


@pytest.mark.parametrize("bad", [
    dict(x=torch.ones(3, 5, dtype=torch.float64)),      # not fp32
    dict(x=torch.ones(5, 3).T),                         # not contiguous
    dict(bias=torch.ones(6)),                           # wrong bias shape
    dict(act="tanh"),                                   # unknown activation
    dict(w=torch.ones(4, 7)),                           # K mismatch
])
def test_gfid_matmul_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(x=torch.ones(3, 5), w=torch.ones(5, 7), bias=None, act=None)
    kw.update(bad)
    with pytest.raises((TypeError, ValueError)):
        gfid_matmul.gfid_matmul(kw.pop("x"), kw.pop("w"), **kw)


@pytest.mark.parametrize("bad", [
    dict(groups=3),                                     # C_in not divisible
    dict(w=torch.ones(3, 3, 4, 6)),                     # C_in/groups mismatch
    dict(bias=torch.ones(5)),                           # wrong bias shape
    dict(x=torch.ones(1, 8, 8, 4, dtype=torch.float16)),  # not fp32
    dict(stride=0),
    dict(x=torch.ones(1, 1, 8, 4), pad=0),               # filter taller than x
    dict(act="swish"),
])
def test_gfid_conv2d_nhwc_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(x=torch.ones(1, 8, 8, 4), w=torch.ones(3, 3, 2, 6), stride=1,
              pad=1, groups=2, bias=None, act=None)
    kw.update(bad)
    with pytest.raises((TypeError, ValueError)):
        gfid_conv.gfid_conv2d_nhwc(kw.pop("x"), kw.pop("w"), **kw)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_build_library_path_follows_the_source():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"{name}-") and path.suffix == ".so"
        assert build.library_path(name) == path


@pytest.mark.parametrize("edited", ["gfid_conv.cu", "epilogue.cuh"])
def test_build_library_path_follows_sources_and_headers(monkeypatch, tmp_path,
                                                        edited):
    """Editing a kernel source or a shared header gives a new library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("gfid_conv")
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    assert build.library_path("gfid_conv") != before


@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_act_codes_match_the_cuda_epilogue(act):
    header = (build.CSRC / "epilogue.cuh").read_text()
    assert f"if (act == {epilogue.ACT_CODES[act]})" in header
    for name in build.SOURCES:
        source = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "epilogue.cuh"' in source
        assert "apply_act(float" not in source


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def _same_or_gelu_close(got, want, act):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if act == "gelu":
        assert np.abs(got - want).max() <= GELU_TOL * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)


# (M, K, N, bias, act): M = 1, ragged M, K past the 1024 fp32 chunk and not
# a multiple of 4, N not a multiple of the 64-column tile or of 4.
MATMUL_INT8_CASES = [
    (1, 64, 48, False, None),
    (1, 1025, 70, True, "relu"),
    (5, 1100, 70, False, "relu"),
    (9, 2049, 130, True, None),
    (3, 37, 17, True, "relu"),
    (4, 300, 33, True, "gelu"),
]


@pytest.mark.parametrize("m,k,n,has_bias,act", MATMUL_INT8_CASES)
def test_gfid_matmul_int8_matches_pallas(m, k, n, has_bias, act):
    x, w, b = _arrays(m * 1000 + k, (m, k), (k, n), (n,))
    xq, wq, sx, sw = jax_quant.quantize_matmul_operands(jnp.asarray(x),
                                                        jnp.asarray(w))
    want = jax_matmul.gfid_matmul_int8(
        xq, wq, sx, sw, bias=jnp.asarray(b) if has_bias else None, act=act,
        interpret=True)
    t = [torch.from_numpy(np.array(a)) for a in (xq, wq, sx, sw)]
    got = gfid_matmul.gfid_matmul_int8(
        *t, bias=torch.from_numpy(b) if has_bias else None, act=act)
    _same_or_gelu_close(got, want, act)


def test_ops_matmul_int8_flattens_and_quantizes_per_row():
    x, w, b = _arrays(8, (2, 3, 40), (40, 16), (16,))
    want = jax_ops.gfid_matmul(jnp.asarray(x), jnp.asarray(w),
                               bias=jnp.asarray(b), act="relu",
                               interpret=True, precision="int8")
    got = ops.gfid_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          bias=torch.from_numpy(b), act="relu",
                          precision="int8")
    _same_or_gelu_close(got, want, "relu")


# (B, H, W, C_in, C_out, k, stride, pad, groups, bias, act)
CONV_INT8_CASES = [
    (1, 23, 23, 3, 5, 11, 4, 0, 1, True, "relu"),     # AlexNet conv1 mode
    (1, 9, 9, 8, 16, 5, 1, 2, 2, True, "relu"),       # AlexNet conv2 mode
    (2, 7, 7, 6, 8, 3, 1, 1, 2, False, None),         # conv4/5 mode, no bias
    (1, 12, 10, 3, 6, 3, 1, 1, 1, False, "relu"),     # C_in = 3, pad 1
    (2, 13, 11, 6, 10, 3, 2, 1, 2, True, "gelu"),     # stride 2, gelu
]


@pytest.mark.parametrize("b,h,w_,c_in,c_out,k,s,pad,groups,has_bias,act",
                         CONV_INT8_CASES)
def test_gfid_conv2d_nhwc_int8_matches_pallas(b, h, w_, c_in, c_out, k, s,
                                              pad, groups, has_bias, act):
    x, w, bias = _arrays(h * 100 + k + 7, (b, h, w_, c_in),
                         (k, k, c_in // groups, c_out), (c_out,))
    want = jax_ops.gfid_conv2d(
        jnp.asarray(x), jnp.asarray(w), stride=s, pad=pad, groups=groups,
        bias=jnp.asarray(bias) if has_bias else None, act=act,
        interpret=True, precision="int8")
    got = ops.gfid_conv2d(
        torch.from_numpy(x), torch.from_numpy(w), stride=s, pad=pad,
        groups=groups, bias=torch.from_numpy(bias) if has_bias else None,
        act=act, precision="int8")
    _same_or_gelu_close(got, want, act)


def test_int8_kernels_plain_versions_agree_with_the_library_conv():
    """The int8 GFID lowering against the library's (float64) conv: exact
    integers, so equal, at a depth where fp32 sums would not be exact."""
    rng = np.random.default_rng(3)
    xq = torch.from_numpy(rng.integers(-127, 128, (1, 6, 6, 512),
                                       dtype=np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, 256, 8),
                                       dtype=np.int8))
    xq[..., :256], wq[..., 0] = 127, 127       # sums past 2**24
    got = gfid.conv2d_gfid_int8(xq, wq, 1, 1, 2)
    assert got.dtype == torch.int32 and got.abs().max() > 2 ** 24
    assert torch.equal(got, gfid.conv2d_reference_int8(xq, wq, 1, 1, 2))


def test_int8_cpu_and_meta_paths_count_no_launch():
    xq = torch.ones(2, 8, 8, 4, dtype=torch.int8)
    wq = torch.ones(3, 3, 2, 6, dtype=torch.int8)
    sx, sw = torch.ones(2, 1), torch.ones(1, 6)
    before = (gfid_conv.gfid_conv2d_nhwc_int8.launches,
              gfid_matmul.gfid_matmul_int8.launches)
    gfid_conv.gfid_conv2d_nhwc_int8(xq, wq, sx, sw, pad=1, groups=2)
    meta = gfid_conv.gfid_conv2d_nhwc_int8(
        xq.to("meta"), wq.to("meta"), sx.to("meta"), sw.to("meta"),
        stride=2, pad=1, groups=2, act="relu")
    assert meta.device.type == "meta" and tuple(meta.shape) == (2, 4, 4, 6)
    args = (torch.ones(3, 5, dtype=torch.int8),
            torch.ones(5, 7, dtype=torch.int8), torch.ones(3, 1),
            torch.ones(1, 7))
    mm = gfid_matmul.gfid_matmul_int8(*(a.to("meta") for a in args))
    assert mm.device.type == "meta" and tuple(mm.shape) == (3, 7)
    gfid_matmul.gfid_matmul_int8(*args)
    assert (gfid_conv.gfid_conv2d_nhwc_int8.launches,
            gfid_matmul.gfid_matmul_int8.launches) == before


def test_launchers_reject_operands_of_the_wrong_dtype():
    """Each launcher checks each operand's dtype against what it reads,
    before any launch: an int8 launcher takes no fp32 xq, the fp32
    launchers no int8 x, and the scales and bias stay fp32."""
    i8 = torch.int8
    xq, wq = torch.ones(3, 5, dtype=i8), torch.ones(5, 7, dtype=i8)
    sx, sw = torch.ones(3, 1), torch.ones(1, 7)
    with pytest.raises(TypeError, match="xq must be torch.int8"):
        gfid_matmul.gfid_matmul_int8(xq.float(), wq, sx, sw)
    with pytest.raises(TypeError, match="sw must be torch.float32"):
        gfid_matmul.gfid_matmul_int8(xq, wq, sx, sw.double())
    with pytest.raises(TypeError, match="bias must be torch.float32"):
        gfid_matmul.gfid_matmul_int8(xq, wq, sx, sw,
                                     bias=torch.ones(7, dtype=i8))
    with pytest.raises(TypeError, match="x must be torch.float32"):
        gfid_matmul.gfid_matmul(xq, torch.ones(5, 7))
    cx, cw = torch.ones(1, 8, 8, 4, dtype=i8), torch.ones(3, 3, 4, 6,
                                                         dtype=i8)
    with pytest.raises(TypeError, match="wq must be torch.int8"):
        gfid_conv.gfid_conv2d_nhwc_int8(cx, cw.float(), torch.ones(1, 1),
                                        torch.ones(1, 6))
    with pytest.raises(TypeError, match="x must be torch.float32"):
        gfid_conv.gfid_conv2d_nhwc(cx, cw.float())


@pytest.mark.parametrize("bad", [
    dict(sx=torch.ones(3)),                         # scales not (M, 1)
    dict(sw=torch.ones(7, 1)),                      # scales not (1, N)
    dict(wq=torch.ones(4, 7, dtype=torch.int8)),    # K mismatch
    dict(act="tanh"),
    dict(xq=torch.ones(1, build.INT8_MAX_K + 1, dtype=torch.int8),
         wq=torch.ones(build.INT8_MAX_K + 1, 7, dtype=torch.int8),
         sx=torch.ones(1, 1)),                      # int32 could overflow
])
def test_gfid_matmul_int8_rejects_what_the_kernel_does_not_take(bad):
    kw = dict(xq=torch.ones(3, 5, dtype=torch.int8),
              wq=torch.ones(5, 7, dtype=torch.int8), sx=torch.ones(3, 1),
              sw=torch.ones(1, 7), bias=None, act=None)
    kw.update(bad)
    with pytest.raises((TypeError, ValueError)):
        gfid_matmul.gfid_matmul_int8(kw.pop("xq"), kw.pop("wq"),
                                     kw.pop("sx"), kw.pop("sw"), **kw)


@pytest.mark.parametrize("name,symbol,argtypes", [
    ("gfid_matmul_int8", "gfid_matmul_int8", gfid_matmul.INT8_ARGTYPES),
    ("gfid_conv_int8", "gfid_conv2d_nhwc_int8", gfid_conv.INT8_ARGTYPES),
])
def test_int8_ctypes_signatures_match_the_c_interfaces(name, symbol,
                                                       argtypes):
    """The ctypes argument lists (bound only on a GPU) follow the C
    signatures, read from the sources here: a pointer for each pointer, an
    int for each int."""
    src = (build.CSRC / f"{name}.cu").read_text()
    sig = src[src.index(f'extern "C" int {symbol}('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert argtypes == want


def test_int8_sources_end_in_the_shared_dequant_epilogue():
    header = (build.CSRC / "epilogue.cuh").read_text()
    assert "__fadd_rn(y, __fdiv_rn(bias[col], scale))" in header
    assert "__fmul_rn(y, scale)" in header
    for name in ("gfid_matmul_int8", "gfid_conv_int8"):
        source = (build.CSRC / f"{name}.cu").read_text()
        assert "dequant_epilogue(" in source and "__fmul_rn(sx[" in source
