"""The port's xLSTM blocks (`models/ssm.py`) and the xLSTM model on the CPU
against the JAX package.

On the reduced xlstm_125m config (d_model 64, 4 heads, the mLSTM x 5 +
sLSTM pattern) with the reference's fp32 parameters carried across by
`params_from_jax`, and inputs made with numpy from a seed:

  * `mlstm_forward` (one chunk, and chunk 4 on L = 10: three chunks and a
    pad of 2), `slstm_forward` and both decode steps agree with the
    reference within 1e-5 x max|reference| (fp32 sums in other orders;
    measured about 4e-7), their fp32 states likewise, and the bf16 conv
    tails bitwise;
  * the full model's prefill logits, its fp32 decode state and (with an
    fp32 state) three decode steps, each from the reference's state, agree
    within 1e-5 x max|reference|
    (measured about 1.3e-6); its bf16 conv tails within one bf16 rounding
    step (deeper layers' inputs differ in the last fp32 bits, so a near tie
    may round the other way);
  * a state is taken only from a prompt of at least d_conv - 1 = 3 tokens:
    the reference's scheduler fails on a shorter one, the port raises
    `ValueError`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jax_reduced
from repro.models import ssm as jax_ssm
from repro.models import transformer as JT
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import ssm
from repro_torch.models import transformer as T
from repro_torch.models.layers import row_sum, tree_leaves, tree_map
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5          # max|port - reference| / max|reference|
MAX_LEN = 32


@pytest.fixture(scope="module")
def jcfg():
    return jax_reduced("xlstm_125m")


@pytest.fixture(scope="module")
def cfg():
    return reduced("xlstm_125m")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def params(jparams):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def _close(got, want, what=""):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: {err:.3e}"


def _same_bits(got, want, what=""):
    assert got.dtype == torch.bfloat16, what
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), what)


def _within_a_bf16_step(got, want, what=""):
    """bf16 values rounded from fp32 inputs that agree within TOL: each
    within one bf16 rounding step (2**-7 of its magnitude) of the
    reference's; a near tie may round either way."""
    got = got.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), what


def _check_state(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "conv":
            _same_bits(got[k], want[k], k)
        else:
            assert got[k].dtype == torch.float32
            _close(got[k], want[k], k)


def _layer(jparams, params, j, kind):
    return (jax.tree_util.tree_map(lambda a: a[0], jparams["groups"][j][kind]),
            tree_map(lambda a: a[0], params["groups"][j][kind]))


def _torch_tree(tree):
    """A JAX state tree as torch tensors of the same dtypes (bf16 leaves
    through fp32, exactly)."""
    def leaf(v):
        t = torch.from_numpy(np.array(v.astype(jnp.float32)))
        return t.to(torch.bfloat16) if v.dtype == jnp.bfloat16 else t
    return tree_map(leaf, dict(tree))


@pytest.mark.parametrize("chunk", [256, 4])
def test_mlstm_forward_and_decode(jcfg, cfg, jparams, params, chunk):
    jp, p = _layer(jparams, params, "0", "mlstm")
    rng = np.random.default_rng(chunk)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jo, js = jax_ssm.mlstm_forward(jcfg, jp, jnp.asarray(x), chunk=chunk,
                                   return_state=True)
    o, st = ssm.mlstm_forward(cfg, p, torch.from_numpy(x), chunk=chunk,
                              return_state=True)
    _close(o, jo, "out")
    _check_state(st, js)
    _close(ssm.mlstm_forward(cfg, p, torch.from_numpy(x), chunk=chunk), jo,
           "out without state")
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, js = jax_ssm.mlstm_decode(jcfg, jp, jnp.asarray(xd), js)
    o, st = ssm.mlstm_decode(cfg, p, torch.from_numpy(xd), _torch_tree(
        jax_ssm.mlstm_forward(jcfg, jp, jnp.asarray(x), chunk=chunk,
                              return_state=True)[1]))
    _close(o, jo, "decode out")
    _check_state(st, js)


def test_slstm_forward_and_decode(jcfg, cfg, jparams, params):
    jp, p = _layer(jparams, params, "5", "slstm")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    jo, js0 = jax_ssm.slstm_forward(jcfg, jp, jnp.asarray(x),
                                    return_state=True)
    o, st = ssm.slstm_forward(cfg, p, torch.from_numpy(x), return_state=True)
    _close(o, jo, "out")
    _check_state(st, js0)
    xd = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jo, js = jax_ssm.slstm_decode(jcfg, jp, jnp.asarray(xd), js0)
    o, st = ssm.slstm_decode(cfg, p, torch.from_numpy(xd),
                             _torch_tree(js0))
    _close(o, jo, "decode out")
    _check_state(st, js)


def test_init_states_equal_the_reference(jcfg, cfg):
    for kind, jinit, init in (
            ("mlstm", jax_ssm.mlstm_init_state, ssm.mlstm_init_state),
            ("slstm", jax_ssm.slstm_init_state, ssm.slstm_init_state)):
        want, got = jinit(jcfg, 3), init(cfg, 3, device="cpu")
        assert sorted(got) == sorted(want), kind
        for k in got:
            np.testing.assert_array_equal(
                got[k].float().numpy(),
                np.asarray(want[k].astype(jnp.float32)), f"{kind} {k}")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_model_prefill_state_and_decode_match_the_reference(
        jcfg, cfg, jparams, params, state_dtype):
    """Prefill logits and the decode state, then (fp32 state) three decode
    steps, each from the reference's state. With the default bf16 state a
    decode step rounds its new conv input to bf16, where a near tie may
    round either way and move the logits by more than the arithmetic
    does; the served tokens are held against the reference in
    tests/test_torch_ssm_serve.py."""
    jdt, tdt = getattr(jnp, state_dtype), getattr(torch, state_dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 9))
    jl, jst = JT.prefill(jcfg, jparams, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)},
                         MAX_LEN, state_dtype=jdt)
    tl, tst = T.prefill(cfg, params, {"tokens": torch.from_numpy(toks)},
                        MAX_LEN, state_dtype=tdt)
    _close(tl, jl, "prefill logits")
    # both trees flatten in sorted key order
    for got, want in zip(tree_leaves(tst), jax.tree_util.tree_leaves(jst),
                         strict=True):
        if got.dtype == torch.bfloat16:
            _within_a_bf16_step(got, want, "conv tail")
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


def test_full_width_model_on_meta():
    """xlstm_125m at full width: about 156 M parameters (10 mLSTM blocks of
    about 10.6 M, 2 sLSTM blocks of about 5.3 M, the 38.6 M embedding),
    and a decode state of conv tails and fp32 memory only."""
    full = get_config("xlstm_125m")
    shapes = T.param_shapes(full)
    n = sum(p.numel() for p in tree_leaves(shapes))
    assert n == 155_659_088
    mlstm = sum(p[0].numel() for p in tree_leaves(shapes["groups"]["0"]))
    slstm = sum(p[0].numel() for p in tree_leaves(shapes["groups"]["5"]))
    assert (mlstm, slstm) == (10_639_112, 5_316_864)
    st = T.init_decode_state(full, 1, 512, device="meta")
    c = st["groups"]["0"]["c"]
    assert tuple(c.shape) == (2, 1, 4, 384, 384) and c.dtype == torch.float32
    assert tuple(st["groups"]["5"]["conv"].shape) == (2, 1, 3, 768)


def test_mamba_and_other_families_still_raise():
    """Mamba runs in the SSM and hybrid families; a hybrid's LOCAL or CROSS
    layers, and an SSM config without its SSM dims, still raise."""
    import dataclasses
    from repro_torch.configs.base import CROSS_ATTN, LOCAL_ATTN, MAMBA
    jamba = reduced("jamba15_large")
    for kind in (LOCAL_ATTN, CROSS_ATTN):
        cfg = dataclasses.replace(
            jamba, pattern=(MAMBA,) * 4 + (kind,) + (MAMBA,) * 3,
            window_size=8)
        with pytest.raises(NotImplementedError, match="hybrid family"):
            T.param_shapes(cfg)
    with pytest.raises(NotImplementedError, match="item 10"):
        T.param_shapes(dataclasses.replace(reduced("xlstm_125m"), ssm=None))


def test_prompt_shorter_than_the_conv_window_raises_in_both(
        jcfg, cfg, jparams, params):
    prompt = [5, 7]                         # d_conv - 1 = 3 tokens needed
    s = JaxScheduler(jcfg, jparams, max_len=MAX_LEN, num_blocks=8,
                     block_size=8, max_batch=2)
    s.submit(prompt, 2)
    with pytest.raises(Exception, match="shape|broadcast"):
        s.run()                             # the reference's fault
    ts = ContinuousScheduler(cfg, params, max_len=MAX_LEN, num_blocks=8,
                             block_size=8, max_batch=2)
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        ts.submit(prompt, 2)
    ts.submit(prompt + [1], 2)              # 3 tokens serve
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        with TE.using_config(TE.EngineConfig(row_align=8)):
            T.prefill(cfg, params, {"tokens": torch.tensor([prompt])},
                      MAX_LEN)
    # a forward that takes no decode state runs any length
    assert T.forward(cfg, params, {"tokens": torch.tensor([prompt])}).shape \
        == (1, 2, cfg.d_model)


@pytest.mark.parametrize("n", [1, 3, 7, 64, 192, 384, 576, 768])
def test_row_sum_is_a_sum_whose_row_bits_ignore_the_batch(n):
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal((8, 5, n)).astype(np.float32))
    got = row_sum(x)
    assert got.shape == (8, 5, 1)
    np.testing.assert_allclose(got.numpy(), x.double().sum(-1, keepdim=True)
                               .numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(row_sum(x[:1]), got[:1])
    assert torch.equal(row_sum(x[:, 2:3]), got[:, 2:3])


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_decode_row_bits_do_not_depend_on_the_batch(cfg, params, backend):
    """Two decode steps of one row alone give, bit for bit, the logits and
    state of row 0 in an 8-row batch: `greedy_generate` decodes one request
    at one row, the scheduler in its 8-row bucket."""
    rng = np.random.default_rng(4)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 6)))
    with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)), \
            torch.no_grad():
        _, st8 = T.prefill(cfg, params, {"tokens": toks}, MAX_LEN)
        st1 = {"groups": tree_map(lambda a: a[:, :1].clone(), st8["groups"]),
               "rem": tree_map(lambda a: a[:1].clone(), st8["rem"])}
        for k in range(2):
            nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)))
            l8, st8 = T.decode_step(cfg, params, st8, nxt, 6 + k)
            l1, st1 = T.decode_step(cfg, params, st1, nxt[:1], 6 + k)
            assert torch.equal(l1, l8[:1]), k
        for a1, a8 in zip(tree_leaves(st1["groups"]),
                          tree_leaves(st8["groups"]), strict=True):
            assert torch.equal(a1, a8[:, :1])
