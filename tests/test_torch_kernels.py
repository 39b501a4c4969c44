"""The port's kernel modules on the CPU against the Pallas kernels.

On a CPU tensor each wrapper runs its plain PyTorch version; the JAX side
runs the Pallas kernel in interpret mode through the reference's own launch
glue (`repro.kernels.ops`), as tests/test_kernels.py does. The CUDA kernels
themselves run only on a GPU: `chip_smoke.py` holds them against these
plain versions there.

Tolerance: max|port - pallas| <= 1e-5 * max|pallas|. Both sides accumulate
in fp32, in different orders.
"""
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import (build, epilogue, gfid_conv, gfid_matmul, ops,
                                 ref)

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5


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
