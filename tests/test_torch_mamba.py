"""The port's Mamba block (`models/ssm.py`) and jamba-1.5-large's hybrid
stack on the CPU against the JAX package.

On the reduced jamba15_large config (d_model 64, Mamba x 4, attention at
offset 4, Mamba x 3; d_inner 128, d_state 8, MoE of 4 experts top-2 on the
odd layers) with the reference's parameters carried across by
`params_from_jax`, and inputs made with numpy from a seed:

  * `mamba_forward` on fp32 parameters within 1e-5 x max|reference| at L =
    1, 3, 7 and 300 (chunk 256: one chunk, then two with a padded tail)
    and at L = 37 with chunk 16 (a padded last chunk); its state's `h`
    within 1e-5 and `conv` bitwise. The scan's association order is not
    the reference's (a Hillis-Steele doubling against `associative_scan`),
    so it is held within a tolerance, not bitwise;
  * five `mamba_decode` steps within 1e-5, each from its own state;
  * bf16 parameters: the block's output within one bf16 step of
    max|reference| (measured: bitwise at L = 7, 0.26 of a step at 300),
    `h` within 1e-5, `conv` bitwise. The port computes `jax.nn.silu` and
    `jax.nn.softplus` with XLA's CPU rounding points, each op rounded to
    bf16 (held bitwise here);
  * a decode row's bits equal at 1 and at 8 rows (`row_align` = 8);
  * the reduced model's prefill logits and fp32 state within 1e-5 and
    three decode steps from the reference's state within 1e-5, its bf16
    conv tails within one bf16 rounding step; the attention layer takes
    no rope;
  * the full config's parameter shapes and count equal the reference's:
    398,556,143,616.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import attention as jax_attn
from repro.models import layers as jax_layers
from repro.models import ssm as jax_ssm
from repro.models import transformer as JT
from repro_torch import engine as TE
from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      get_config, reduced)
from repro_torch.models import attention as attn
from repro_torch.models import layers, ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves, tree_map

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5          # max|port - reference| / max|reference|
BF16_STEP = 2.0 ** -7
MAX_LEN = 32
MAMBA_LAYER, ATTN_LAYER = "0", "4"


@pytest.fixture(scope="module")
def jcfg():
    return jax_reduced("jamba15_large")


@pytest.fixture(scope="module")
def cfg():
    return reduced("jamba15_large")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def params(jparams):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _f32(a):
    if isinstance(a, torch.Tensor):
        return np.asarray(a.float().numpy(), np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _close(got, want, what="", tol=TOL):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e}"


def _same_bits(got, want, what=""):
    np.testing.assert_array_equal(_f32(got), _f32(want), what)


def _check_state(got, want):
    assert sorted(got) == sorted(want) == ["conv", "h"]
    _same_bits(got["conv"], want["conv"], "conv")
    assert got["conv"].dtype == torch.bfloat16
    assert got["h"].dtype == torch.float32
    _close(got["h"], want["h"], "h")


def _layer(jparams, params, j=MAMBA_LAYER, kind="mamba", dtype=None):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["groups"][j][kind])
    p = tree_map(lambda a: a[0], params["groups"][j][kind])
    if dtype is not None:
        jp = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), jp)
        p = tree_map(lambda a: a.to(torch.bfloat16), p)
    return jp, p


def _torch_tree(tree):
    """A JAX state tree as torch tensors of the same dtypes (bf16 leaves
    through fp32, exactly)."""
    def leaf(v):
        t = torch.from_numpy(np.array(v.astype(jnp.float32)))
        return t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    return tree_map(leaf, dict(tree))


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


# ---------------------------------------------------------------------------
# the Mamba block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("length,chunk", [(1, 256), (3, 256), (7, 256),
                                          (300, 256), (37, 16)])
def test_mamba_forward_matches_the_reference(jcfg, cfg, jparams, params,
                                             length, chunk):
    jp, p = _layer(jparams, params)
    x = _x(cfg, (2, length), length)
    jo, js = jax_ssm.mamba_forward(jcfg, jp, jnp.asarray(x), chunk=chunk,
                                   return_state=True)
    o = ssm.mamba_forward(cfg, p, torch.from_numpy(x), chunk=chunk)
    assert o.dtype == torch.float32
    _close(o, jo, "out")
    if length < cfg.ssm.d_conv - 1:
        # the reference's tail is shorter than its decode state's window
        assert js["conv"].shape[1] == length
        with pytest.raises(ValueError, match="d_conv - 1 = 3"):
            ssm.mamba_forward(cfg, p, torch.from_numpy(x), chunk=chunk,
                              return_state=True)
        return
    o2, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x), chunk=chunk,
                               return_state=True)
    assert torch.equal(o, o2)
    _check_state(st, js)


def test_the_padded_chunk_leaves_the_last_real_state():
    """`_ssm_scan_chunked` against a token-by-token recurrence in float64
    at L = 37 in chunks of 16 (a tail of 5 rows and 11 padded): y within
    1e-5 and h_fin the 37th row's state, whatever the chunk."""
    rng = np.random.default_rng(3)
    b, l, di, ds = 2, 37, 6, 4
    x, dt = rng.standard_normal((b, l, di)), rng.uniform(0.01, 1, (b, l, di))
    bi, ci = rng.standard_normal((b, l, ds)), rng.standard_normal((b, l, ds))
    a = -np.exp(rng.standard_normal((di, ds)))
    h, ys = np.zeros((b, di, ds)), []
    for t in range(l):
        h = np.exp(dt[:, t, :, None] * a) * h \
            + (dt[:, t] * x[:, t])[..., None] * bi[:, t, None, :]
        ys.append((h * ci[:, t, None, :]).sum(-1))
    want_y = np.stack(ys, 1)
    args = [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, bi, ci, a)]
    for chunk in (16, 37, 256):
        y, h_fin = ssm._ssm_scan_chunked(*args, chunk=chunk)
        assert tuple(y.shape) == (b, l, di) and tuple(h_fin.shape) == (b, di,
                                                                       ds)
        _close(y, want_y, f"y at chunk {chunk}")
        _close(h_fin, h, f"h at chunk {chunk}")


def test_mamba_decode_five_steps_match_the_reference(jcfg, cfg, jparams,
                                                     params):
    jp, p = _layer(jparams, params, "6")
    x = _x(cfg, (2, 9), 11)
    _, js = jax_ssm.mamba_forward(jcfg, jp, jnp.asarray(x), return_state=True,
                                  state_dtype=jnp.float32)
    _, st = ssm.mamba_forward(cfg, p, torch.from_numpy(x), return_state=True,
                              state_dtype=torch.float32)
    rng = np.random.default_rng(12)
    for k in range(5):
        xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jo, js = jax_ssm.mamba_decode(jcfg, jp, jnp.asarray(xd), js)
        o, st = ssm.mamba_decode(cfg, p, torch.from_numpy(xd), st)
        assert tuple(o.shape) == (2, 1, cfg.d_model)
        _close(o, jo, f"step {k}")
        _close(st["h"], js["h"], f"h at step {k}")
        _close(st["conv"], js["conv"], f"conv at step {k}")


def test_init_state_equals_the_reference(jcfg, cfg):
    want, got = jax_ssm.mamba_init_state(jcfg, 3), ssm.mamba_init_state(
        cfg, 3, device="cpu")
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()


@pytest.mark.parametrize("length", [7, 300])
def test_bf16_parameters_within_a_bf16_step(jcfg, cfg, jparams, params,
                                            length):
    """bf16 weights and input: the output within one bf16 step of
    max|reference| (the scan sums in another order, and a near tie of a
    bf16 rounding may fall the other way), h within 1e-5, the conv tail
    bitwise; one decode step likewise."""
    jp, p = _layer(jparams, params, dtype="bf16")
    x = _x(cfg, (2, length), 20 + length)
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(
        torch.bfloat16)
    jo, js = jax_ssm.mamba_forward(jcfg, jp, jx, return_state=True)
    o, st = ssm.mamba_forward(cfg, p, tx, return_state=True)
    assert o.dtype == torch.bfloat16
    _close(o, jo, "out", BF16_STEP)
    _check_state(st, js)
    xd = _x(cfg, (2, 1), 5)
    o, st = ssm.mamba_decode(cfg, p, torch.from_numpy(xd).to(torch.bfloat16),
                             _torch_tree(js))
    jo, js = jax_ssm.mamba_decode(jcfg, jp, jnp.asarray(xd).astype(
        jnp.bfloat16), js)
    _close(o, jo, "decode out", BF16_STEP)
    _check_state(st, js)


def test_silu_and_softplus_round_as_the_reference():
    """bf16: bitwise `jax.nn.silu` and `jax.nn.softplus` (each op rounded
    to bf16, as XLA's CPU compiler computes them); fp32 within 1e-6."""
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32) * 6
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        tx, jx = torch.from_numpy(x).to(dt), jnp.asarray(x).astype(jdt)
        for mine, ref in ((ssm._silu, jax.nn.silu),
                          (ssm._softplus, jax.nn.softplus)):
            got, want = mine(tx), ref(jx)
            assert got.dtype == dt
            if dt == torch.bfloat16:
                _same_bits(got, want, ref.__name__)
            else:
                np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                           atol=1e-6)
    # no threshold: softplus(x) is not x itself at large x in bf16
    big = torch.tensor([30.0, 100.0], dtype=torch.bfloat16)
    _same_bits(ssm._softplus(big), jax.nn.softplus(jnp.asarray(
        [30.0, 100.0], jnp.bfloat16)))


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_decode_row_bits_do_not_depend_on_the_batch(cfg, params, backend):
    """Two decode steps of one row alone give, bit for bit, the logits and
    state of row 0 in an 8-row batch (the scheduler's bucket under
    `row_align` = 8; `greedy_generate` decodes one row): the Mamba state's
    contraction and the norms sum in a fixed order."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 6)))
    with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)), \
            torch.no_grad():
        _, st8 = T.prefill(cfg, params, {"tokens": toks}, MAX_LEN)
        st1 = {"groups": tree_map(lambda a: a[:, :1].clone(), st8["groups"]),
               "rem": {}}
        for k in range(2):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)))
            pos = torch.full((8,), 6 + k)
            l8, st8 = T.decode_step(cfg, params, st8, nxt, pos)
            l1, st1 = T.decode_step(cfg, params, st1, nxt[:1], pos[:1])
            assert torch.equal(l1, l8[:1]), k
        for a1, a8 in zip(tree_leaves(st1["groups"]),
                          tree_leaves(st8["groups"]), strict=True):
            assert torch.equal(a1, a8[:, :1])


# ---------------------------------------------------------------------------
# the hybrid stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_model_prefill_state_and_decode_match_the_reference(
        jcfg, cfg, jparams, params, state_dtype):
    """Prefill logits and the decode state (the attention layer's k/v and
    the Mamba layers' conv tails and fp32 h), then (fp32 state) three
    decode steps, each from the reference's state. With the bf16 state a
    near tie may round a cached value the other way; the served tokens are
    held in tests/test_torch_hybrid_serve.py."""
    jdt, tdt = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    jl, jst = JT.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                         MAX_LEN, state_dtype=jdt)
    tl, tst = T.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                        MAX_LEN, state_dtype=tdt)
    _close(tl, jl, "prefill logits")
    assert sorted(tst["groups"][MAMBA_LAYER]) == ["conv", "h"]
    assert sorted(tst["groups"][ATTN_LAYER]) == ["k", "v"]
    for got, want in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst),
                         strict=True):
        assert tuple(got.shape) == want.shape
        if got.dtype == torch.bfloat16:
            g, w = _f32(got), _f32(want)
            assert np.all(np.abs(g - w) <= BF16_STEP * np.abs(w)), "bf16"
        else:
            _close(got, want, "state")
    if state_dtype == "bfloat16":
        return
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jparams, st, tk,
                                                     ps))
    for k in range(3):
        tk = rng.integers(0, cfg.vocab_size, (2, 1))
        td, _ = T.decode_step(cfg, params, _torch_tree(jst),
                              torch.from_numpy(tk), 9 + k)
        jd, jst = step(jst, jnp.asarray(tk, jnp.int32), 9 + k)
        _close(td, jd, f"decode step {k}")


def test_attention_layer_takes_no_rope(jcfg, cfg, jparams, params):
    """jamba's attention layer (use_rope False) against the reference, and
    its output the same bits at any positions."""
    jp, p = _layer(jparams, params, ATTN_LAYER, "attn")
    x = _x(cfg, (2, 12), 9)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    jo, _ = jax_attn.attention_forward(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(pos), GLOBAL_ATTN)
    o, _ = attn.attention_forward(cfg, p, torch.from_numpy(x),
                                  torch.from_numpy(pos.copy()), GLOBAL_ATTN)
    _close(o, jo, "attention")
    moved, _ = attn.attention_forward(cfg, p, torch.from_numpy(x),
                                      torch.from_numpy(pos + 1000),
                                      GLOBAL_ATTN)
    assert torch.equal(o, moved)


def test_full_config_shapes_and_count_equal_the_reference():
    """jamba-1.5-large-398b at full width and depth, on `meta`: every
    leaf's shape, the 398,556,143,616 parameters; bf16 by default (the
    config's param_dtype); the alias resolves."""
    full = get_config("jamba-1.5-large-398b")
    assert full == get_config("jamba15_large")
    jfull = jax_get_config("jamba15_large")
    assert {f.name: getattr(full, f.name) for f in dataclasses.fields(full)
            if f.name not in ("moe", "ssm")} == \
        {f.name: getattr(jfull, f.name) for f in dataclasses.fields(jfull)
         if f.name not in ("moe", "ssm")}
    assert dataclasses.asdict(full.moe) == dataclasses.asdict(jfull.moe)
    assert dataclasses.asdict(full.ssm) == dataclasses.asdict(jfull.ssm)
    shapes = T.param_shapes(full)
    jdefs = JT.model_defs(jfull)
    assert jax.tree_util.tree_map(lambda d: tuple(d.shape), jdefs,
                                  is_leaf=lambda d: hasattr(d, "axes")) == \
        tree_map(lambda a: tuple(a.shape), shapes)
    n = layers.count_params(T.model_defs(full))
    assert n == jax_layers.count_params(jdefs) == 398_556_143_616
    assert {a.dtype for a in tree_leaves(shapes)} == {torch.bfloat16}
    mamba = shapes["groups"]["0"]["mamba"]
    assert tuple(mamba["w_in"].shape) == (9, 8192, 32768)
    assert tuple(mamba["w_x"].shape) == (9, 16384, 512 + 2 * 16)
    assert tuple(shapes["groups"]["1"]["moe"]["w_in"].shape) == (
        9, 16, 8192, 24576)
    st = T.init_decode_state(full, 2, 256, device="meta")
    assert tuple(st["groups"]["0"]["h"].shape) == (9, 2, 16384, 16)
    assert st["groups"]["0"]["h"].dtype == torch.float32
    assert tuple(st["groups"]["0"]["conv"].shape) == (9, 2, 3, 16384)
    assert tuple(st["groups"]["4"]["k"].shape) == (9, 2, 256, 8, 128)


@pytest.mark.parametrize("kind", [LOCAL_ATTN, CROSS_ATTN])
def test_a_hybrid_with_local_or_cross_layers_raises(cfg, kind):
    bad = dataclasses.replace(cfg, pattern=cfg.pattern[:4] + (kind,)
                              + cfg.pattern[5:], window_size=8)
    with pytest.raises(NotImplementedError, match="item 10"):
        T.param_shapes(bad)
