"""The port's 1-D depthwise conv mode on the CPU against the JAX package.

  * `gfid_conv1d_depthwise_plain` (what the kernel wrapper runs for CPU
    tensors) is bitwise equal to `repro.core.gfid.conv1d_depthwise_gfid`
    (the reference's "xla" lowering) for W_f <= 8: both sum the taps in
    ascending order into an fp32 accumulator of zeros, each product and
    sum rounded on its own;
  * it agrees with the reference's Pallas kernel run in interpret mode
    within 2e-5 absolute (measured up to 9.5e-7 at 4 taps and 3.8e-6 at
    128 taps on unit normals, outputs up to about 22: the interpreted
    kernel's sums round differently);
  * `engine.conv1d_depthwise` on "cuda" (a CPU tensor runs the plain
    version), "torch" and "ref" against the reference's engine;
  * `plan_conv1d_depthwise` equals the reference's plan field by field;
  * a `conv1d_dw` op is captured into programs and replayed strictly.

The CUDA kernel itself (`csrc/conv1d_depthwise.cu`) runs only on the card;
`chip_smoke.py` holds it there against this plain version, bitwise.
Inputs are made with numpy from a seed and handed to both packages.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.core import gfid as jax_gfid
from repro.kernels import conv1d as jax_conv1d
from repro_torch import engine as TE
from repro_torch.core import gfid
from repro_torch.engine import api
from repro_torch.kernels import build, conv1d, ops, ref

jax.config.update("jax_platform_name", "cpu")

PALLAS_ATOL = 2e-5


def _inputs(shape, w_f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((w_f, shape[2])).astype(np.float32)
    return x, w


# The cases of tests/test_gfid.py::test_conv1d_depthwise (batch 2, L in
# 4..32, D in {4, 8}, W_f in {2, 4, 7}, both modes) at fixed draws.
GFID_CASES = [(l, d, w_f, causal) for w_f in (2, 4, 7)
              for causal in (True, False)
              for l, d in ((4, 4), (17, 8), (32, 8))]


@pytest.mark.parametrize("l,d,w_f,causal", GFID_CASES)
def test_plain_is_bitwise_the_reference_gfid_lowering(l, d, w_f, causal):
    x, w = _inputs((2, l, d), w_f, seed=l * 31 + w_f)
    want = np.asarray(jax_gfid.conv1d_depthwise_gfid(
        jnp.asarray(x), jnp.asarray(w), causal=causal))
    got = conv1d.gfid_conv1d_depthwise_plain(torch.from_numpy(x),
                                             torch.from_numpy(w),
                                             causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# The cases of tests/test_kernels.py::TestConv1dDepthwise.
@pytest.mark.parametrize("w_f,causal", [(4, True), (4, False), (128, False),
                                        (2, True)])
def test_plain_matches_the_pallas_kernel_in_interpret_mode(w_f, causal):
    x, w = _inputs((2, 40, 8), w_f, seed=w_f)
    want = np.asarray(jax_conv1d.gfid_conv1d_depthwise(
        jnp.asarray(x), jnp.asarray(w), causal=causal, interpret=True))
    got = conv1d.gfid_conv1d_depthwise(torch.from_numpy(x),
                                       torch.from_numpy(w), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PALLAS_ATOL)


def test_plain_matches_the_library_conv():
    x, w = _inputs((3, 37, 100), 5, seed=3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    for causal in (True, False):
        np.testing.assert_allclose(
            conv1d.gfid_conv1d_depthwise_plain(xt, wt, causal=causal),
            ref.conv1d_depthwise_ref(xt, wt, causal=causal),
            rtol=1e-5, atol=1e-5)


def test_bf16_operands_are_read_exactly():
    x, w = _inputs((2, 9, 6), 4, seed=5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    got = conv1d.gfid_conv1d_depthwise(xb, wb)
    assert got.dtype == torch.float32
    assert torch.equal(got, conv1d.gfid_conv1d_depthwise(xb.float(),
                                                         wb.float()))


@pytest.mark.parametrize("w_f,causal", [(4, True), (128, False)])
def test_engine_op_on_every_backend(w_f, causal):
    """The reference's engine case (tests/test_engine_api.py), plus the
    128-tap centred conv: "cuda" (a CPU tensor: the plain version) and
    "torch" are bitwise the reference's "xla" up to 8 taps; "ref" and the
    128-tap case agree within 1e-5."""
    x, w = _inputs((2, 17, 6), w_f, seed=w_f + 1)
    with jax_engine.using_config(jax_engine.EngineConfig(backend="xla")):
        want = np.asarray(jax_engine.conv1d_depthwise(
            jnp.asarray(x), jnp.asarray(w), causal=causal))
    outs = {}
    for backend in ("cuda", "torch", "ref"):
        with TE.using_backend(backend):
            outs[backend] = TE.conv1d_depthwise(
                torch.from_numpy(x), torch.from_numpy(w), causal=causal)
        assert outs[backend].dtype == torch.float32
        np.testing.assert_allclose(outs[backend].numpy(), want, rtol=1e-5,
                                   atol=1e-5)
    if w_f <= 8:
        np.testing.assert_array_equal(outs["cuda"].numpy(), want)
        np.testing.assert_array_equal(outs["torch"].numpy(), want)


def test_engine_op_casts_back_and_records_its_plan():
    x, w = _inputs((1, 12, 16), 4, seed=7)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    with TE.tracking() as led:
        y = TE.conv1d_depthwise(xb, torch.from_numpy(w))
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    (rec,) = led.records
    assert rec.kind == "conv1d_dw"
    want = jax_engine.plan_conv1d_depthwise((1, 12, 16), (4, 16), "xla")
    assert (rec.cost_cycles, rec.macs) == (want.cycles, want.macs)


PLAN_CASES = [((2, 64, 32), (128, 32)), ((1, 243, 1536), (4, 1536)),
              ((1, 243, 768), (4, 768)), ((3, 37, 100), (4, 100)),
              ((2, 17, 6), (2, 6)), ((2, 17, 6), (7, 6)),
              ((1, 9, 8), (11, 8)), ((1, 9, 8), (12, 8))]


@pytest.mark.parametrize("xs,ws", PLAN_CASES)
def test_plan_equals_the_reference(xs, ws):
    p = TE.plan_conv1d_depthwise(xs, ws, "cuda")
    j = jax_engine.plan_conv1d_depthwise(xs, ws, "pallas")
    assert p.kind == j.kind == "conv1d_dw"
    assert (p.mode.w_f, p.mode.s, p.mode.n_eff, p.mode.p_eff) == \
        (j.mode.w_f, j.mode.s, j.mode.n_eff, j.mode.p_eff)
    assert (p.cycles, p.ma_words, p.macs) == (j.cycles, j.ma_words, j.macs)
    assert p.tiling == conv1d.TILE and p.precision == "fp32"
    op = TE.OpSpec("conv1d_dw", xs, ws, causal=False)
    assert TE.plan_op(op, "cuda") == p
    assert not TE.supports_int8(op)


def test_capture_and_strict_replay():
    def fn(x, w, m):
        return TE.dense(TE.conv1d_depthwise(x, w), m)

    avals = (torch.empty((1, 10, 8), device="meta"),
             torch.empty((4, 8), device="meta"),
             torch.empty((8, 5), device="meta"))
    prog = TE.trace_program(fn, *avals, name="conv-then-dense")
    assert [(op.kind, op.x_shape, op.w_shape, op.causal)
            for op in prog.ops] == [("conv1d_dw", (1, 10, 8), (4, 8), True),
                                    ("dense", (1, 10, 8), (8, 5), True)]
    net = TE.compile(prog, TE.EngineConfig(backend="cuda"))
    assert net.backends() == ("cuda", "cuda")
    assert net.plan.conv_plans[0].kind == "conv1d_dw"
    assert net.plan.conv_cycles == net.plan.conv_plans[0].cycles > 0
    rng = np.random.default_rng(9)
    args = tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 for s in ((1, 10, 8), (4, 8), (8, 5)))
    eager = fn(*args)
    assert torch.equal(net.apply(*args), eager)
    with pytest.raises(RuntimeError, match="mismatch"), \
            api.replaying(net.exec_pairs):
        # a centred conv where a causal one was captured
        TE.conv1d_depthwise(args[0], args[1], causal=False)


def test_meta_allocates_and_bad_operands_raise():
    out = conv1d.gfid_conv1d_depthwise(torch.empty((2, 5, 3), device="meta"),
                                       torch.empty((4, 3), device="meta"))
    assert out.device.type == "meta" and out.dtype == torch.float32
    assert out.shape == (2, 5, 3)
    with pytest.raises(ValueError):
        conv1d.gfid_conv1d_depthwise(torch.zeros(5, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        conv1d.gfid_conv1d_depthwise(torch.zeros(1, 5, 3), torch.zeros(4, 2))
    with pytest.raises(TypeError):
        conv1d.gfid_conv1d_depthwise(torch.zeros(1, 5, 3, dtype=torch.int32),
                                     torch.zeros(4, 3))
    with pytest.raises(ValueError):
        conv1d.gfid_conv1d_depthwise(torch.zeros(1, 5, 6)[..., ::2],
                                     torch.zeros(4, 3))
    # the ops glue makes its operands contiguous
    x = torch.randn(1, 5, 6)[..., ::2]
    w = torch.randn(4, 3)
    assert torch.equal(ops.gfid_conv1d_depthwise(x, w),
                       conv1d.gfid_conv1d_depthwise_plain(x, w))


def test_ctypes_signature_and_block_match_the_source():
    """The ctypes argument list (bound only on a GPU) follows the C
    signature, and the plan's tiling the kernel's block, both read from the
    source here."""
    src = (build.CSRC / "conv1d_depthwise.cu").read_text()
    sig = src[src.index('extern "C" int conv1d_depthwise('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")

    def ctype(p):
        if "*" in p:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in p else ctypes.c_int

    assert conv1d.ARGTYPES == [ctype(p) for p in params]
    assert "conv1d_depthwise" in build.SOURCES
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert conv1d.TILE == (1, 1, threads)
    assert "__fmul_rn" in src and "__fadd_rn" in src


@pytest.mark.parametrize("w_f,causal,lpad", [(4, True, 3), (4, False, 1),
                                             (5, False, 2), (128, False, 63),
                                             (1, True, 0)])
def test_pad_rule(w_f, causal, lpad):
    assert gfid.conv1d_lpad(w_f, causal) == lpad
    x = torch.ones(1, 3, 2)
    xp = gfid.pad_seq(x, w_f, causal)
    assert xp.shape == (1, 3 + w_f - 1, 2)
    assert torch.equal(xp[:, lpad:lpad + 3], x)
