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
`chip_smoke.py` holds it there against this plain version, bitwise. Here:

  * a torch-op mirror of its tile walk (tiles of TILE positions, the
    tile's rows with their halo in registers and a window of W_f rows
    sliding down them up to REG_TAPS taps, or the rows staged TAP_CHUNK
    taps at a time) is bitwise equal to the plain version and within 2e-5
    of the Pallas kernel in interpret mode;
  * `launch_plan`: the grid (tiles of L x B, tiles of D, 1) with at least
    132 blocks at the xLSTM prefill's convs, any B, the path by W_f, vector loads by
    D and alignment;
  * the wrapper's CUDA branch (library, device and stream faked) passes
    its plan in the C signature's order, allocates only the output, counts,
    and raises on a refused launch; the operand check still refuses.

Inputs are made with numpy from a seed and handed to both packages.
"""
import contextlib
import ctypes
import re
import types

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
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kT", "kC", "kRegTaps", "kTapChunk")}
    assert conv1d.TILE == (1, const["kT"], const["kC"])
    assert (conv1d.REG_TAPS, conv1d.TAP_CHUNK) == (const["kRegTaps"],
                                                   const["kTapChunk"])
    assert "constexpr int kThreads = kC / 4;" in src
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


def _walk(x, w, causal):
    """The kernel's tile walk in torch ops (every channel at once: the
    channel tiles and the load width change no value): for each sequence
    and tile of TILE[1] positions, W_f <= REG_TAPS through the register
    tile (rows[u] holds row t0 - lpad - (REG_TAPS - W_f) + u, the rows
    below REG_TAPS - W_f never loaded; output t0 + j sums rows[j + s] x
    tap s - (REG_TAPS - W_f)), else the rows staged TAP_CHUNK taps at a
    time with a tile's sums carried across the pieces; zeros outside the
    sequence; each product and sum rounded on its own, taps in ascending
    order from 0.0."""
    b, l, d = x.shape
    w_f = w.shape[0]
    kt, k_reg, chunk = conv1d.TILE[1], conv1d.REG_TAPS, conv1d.TAP_CHUNK
    lpad = gfid.conv1d_lpad(w_f, causal)
    xf, wf = x.float(), w.float()
    zero = torch.zeros(d)
    out = torch.full((b, l, d), float("nan"))

    def row(bi, r):
        return xf[bi, r] if 0 <= r < l else zero

    for bi in range(b):
        for t0 in range(0, l, kt):
            if w_f <= k_reg:
                skip = k_reg - w_f
                rows = [row(bi, t0 - lpad - skip + u) if u >= skip else None
                        for u in range(kt + k_reg - 1)]
                for j in range(min(kt, l - t0)):
                    acc = zero
                    for s in range(skip, k_reg):
                        acc = acc + rows[j + s] * wf[s - skip]
                    out[bi, t0 + j] = acc
            else:
                acc = [zero] * kt
                for i0 in range(0, w_f, chunk):
                    n = min(chunk, w_f - i0)
                    tile = [row(bi, t0 - lpad + i0 + r) for r in range(kt + n - 1)]
                    for i in range(n):
                        acc = [acc[j] + tile[j + i] * wf[i0 + i] for j in range(kt)]
                for j in range(min(kt, l - t0)):
                    out[bi, t0 + j] = acc[j]
    return out


# (B, L, D, W_f, causal): the register window at 1 to REG_TAPS taps in both
# modes, L shorter than a tile, than the taps and ragged past a tile; the
# staged path just past REG_TAPS, at two pieces of TAP_CHUNK and at 128
# centred taps (hubert's).
WALK_CASES = [(2, 40, 8, 4, True), (2, 40, 8, 4, False), (1, 33, 6, 1, True),
              (2, 17, 5, 2, False), (1, 5, 3, 7, True), (3, 37, 10, 8, False),
              (1, 50, 4, 8, True), (2, 40, 8, 9, False), (1, 45, 3, 40, True),
              (2, 40, 8, 128, False)]


@pytest.mark.parametrize("b,l,d,w_f,causal", WALK_CASES)
def test_tile_walk_is_bitwise_the_plain_version(b, l, d, w_f, causal):
    x, w = _inputs((b, l, d), w_f, seed=b * 100 + l + w_f)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = _walk(xt, wt, causal)
    assert torch.equal(got, conv1d.gfid_conv1d_depthwise_plain(xt, wt, causal=causal))
    xb, wb = xt.to(torch.bfloat16), wt.to(torch.bfloat16)
    assert torch.equal(_walk(xb, wb, causal),
                       conv1d.gfid_conv1d_depthwise_plain(xb, wb, causal=causal))


@pytest.mark.parametrize("w_f,causal", [(4, True), (8, False), (9, True),
                                        (128, False)])
def test_tile_walk_matches_the_pallas_kernel_in_interpret_mode(w_f, causal):
    x, w = _inputs((2, 40, 8), w_f, seed=w_f + 50)
    want = np.asarray(jax_conv1d.gfid_conv1d_depthwise(
        jnp.asarray(x), jnp.asarray(w), causal=causal, interpret=True))
    got = _walk(torch.from_numpy(x), torch.from_numpy(w), causal)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PALLAS_ATOL)


# (B, L, D, W_f, causal, x address) -> (lpad, staged, vec, grid)
LAUNCH_PLAN_CASES = [
    ((1, 384, 1536, 4, True, 0), (3, False, True, (48, 12, 1))),
    ((1, 384, 768, 4, True, 0), (3, False, True, (48, 6, 1))),
    ((1, 243, 1536, 4, True, 0), (3, False, True, (31, 12, 1))),
    ((3, 37, 100, 5, False, 0), (2, False, True, (15, 1, 1))),
    ((2, 21, 30, 4, True, 0), (3, False, False, (6, 1, 1))),
    ((2, 21, 32, 4, True, 4), (3, False, False, (6, 1, 1))),
    ((2, 64, 1280, 128, False, 0), (63, True, True, (16, 10, 1))),
    ((1, 9, 8, 9, True, 0), (8, True, True, (2, 1, 1))),
]


@pytest.mark.parametrize("args,want", LAUNCH_PLAN_CASES)
def test_launch_plan_path_vectors_and_grid(args, want):
    plan = conv1d.launch_plan(*args)
    assert tuple(plan) == want
    b, l, d = args[:3]
    if (l, d) in ((384, 768), (384, 1536)):
        assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 132
    assert conv1d.launch_plan(70000, 16, 128, 4, True).grid == (140000, 1, 1)
    with pytest.raises(ValueError, match="launch grid"):
        conv1d.launch_plan(1, 16, 65536 * 128, 4, True)


def _fake_conv1d_cuda(monkeypatch, calls, err=0):
    def fake_library(name):
        assert name == "conv1d_depthwise"

        def fn(*args):
            calls.append(args)
            return err
        return types.SimpleNamespace(conv1d_depthwise=fn,
                                     repro_cuda_error_string=lambda e: b"refused")

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "on_device", lambda index: contextlib.nullcontext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    monkeypatch.setattr(conv1d, "_launcher", conv1d._launcher.__wrapped__)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))


@pytest.mark.parametrize("w_f,causal,dtypes", [
    (4, True, (torch.float32, torch.float32)),
    (128, False, (torch.bfloat16, torch.float32)),
    (3, False, (torch.float32, torch.bfloat16))])
def test_launch_passes_its_plan(monkeypatch, w_f, causal, dtypes):
    """The CUDA branch calls the C entry once with its plan in the
    signature's order (pointers, shape, taps, lpad, operand dtypes, vector
    flag, stream), allocates nothing but the output, and counts the
    launch."""
    calls, made = [], []
    x = torch.randn(2, 21, 32).to(dtypes[0])
    w = torch.randn(w_f, 32).to(dtypes[1])
    _fake_conv1d_cuda(monkeypatch, calls)
    real = torch.Tensor.new_empty
    monkeypatch.setattr(torch.Tensor, "new_empty",
                        lambda t, *a, **kw: made.append("new_empty") or real(t, *a, **kw))
    for name in ("empty", "zeros"):
        monkeypatch.setattr(torch, name, lambda *a, _n=name, **kw: made.append(_n))
    before = conv1d.gfid_conv1d_depthwise.launches
    out = conv1d.gfid_conv1d_depthwise(x, w, causal=causal)
    assert made == ["new_empty"]
    assert out.dtype == torch.float32 and out.shape == x.shape
    (args,) = calls
    assert len(args) == len(conv1d.ARGTYPES)
    plan = conv1d.launch_plan(2, 21, 32, w_f, causal, x.data_ptr())
    assert args == (x.data_ptr(), w.data_ptr(), out.data_ptr(), 2, 21, 32,
                    w_f, plan.lpad, int(dtypes[0] == torch.bfloat16),
                    int(dtypes[1] == torch.bfloat16), int(plan.vec), 7)
    assert conv1d.gfid_conv1d_depthwise.launches == before + 1


def test_refused_launch_raises_and_is_not_counted(monkeypatch):
    _fake_conv1d_cuda(monkeypatch, [], err=98)
    before = conv1d.gfid_conv1d_depthwise.launches
    with pytest.raises(RuntimeError, match="gfid_conv1d_depthwise launch "
                                           "failed: CUDA error 98"):
        conv1d.gfid_conv1d_depthwise(torch.zeros(1, 5, 8), torch.zeros(4, 8))
    assert conv1d.gfid_conv1d_depthwise.launches == before


@pytest.mark.parametrize("case", ["x_dtype", "w_dtype", "contiguous",
                                  "device", "shape"])
def test_lean_checks_still_refuse(case):
    x, w = torch.zeros(1, 5, 6), torch.zeros(4, 6)
    if case == "x_dtype":
        x = x.double()
    elif case == "w_dtype":
        w = w.to(torch.float16)
    elif case == "contiguous":
        x = torch.zeros(1, 6, 5).transpose(1, 2)
    elif case == "device":
        w = w.to("meta")
    else:
        w = torch.zeros(4, 5)
    with pytest.raises((TypeError, ValueError), match="gfid_conv1d_depthwise"):
        conv1d._check(x, w)
    with pytest.raises((TypeError, ValueError), match="gfid_conv1d_depthwise"):
        conv1d.gfid_conv1d_depthwise(x, w)
    conv1d._check(torch.zeros(1, 5, 6), torch.zeros(4, 6))
