"""The port's dense transformer on the CPU against the JAX package.

The reduced smollm-135m config, with the JAX package's fp32 parameters
carried across by `params_from_jax` and bf16 decode state (the serving
default). The port runs its default "cuda" backend on CPU tensors (each
kernel wrapper's plain version) and the "torch" backend.

Tolerances: logits within 1e-5 x max|logits| of JAX — both sides sum in
fp32, in other orders, through 4 layers. The bf16 cache is bitwise equal:
the fp32 keys and values agree to far below half a bf16 step, and both
sides round to nearest even.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import layers
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("cuda", "torch")


@pytest.fixture(scope="module")
def cfgs():
    return reduced("smollm_135m"), jax_reduced("smollm_135m")


@pytest.fixture(scope="module")
def params(cfgs):
    """JAX's fp32 parameters (from its own seed) and the port's copy."""
    jp = JT.init_params(cfgs[1], jax.random.PRNGKey(0), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return tp, jp


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_full_width_param_shapes_equal_the_reference():
    t = T.param_shapes(get_config("smollm_135m"), torch.float32)
    j = JT.param_shapes(jax_get_config("smollm_135m"))
    t_leaves = layers.tree_leaves(t)
    j_leaves = jax.tree_util.tree_leaves(j)
    assert [tuple(a.shape) for a in t_leaves] == [a.shape for a in j_leaves]
    assert all(a.device.type == "meta" and a.dtype == torch.float32
               for a in t_leaves)
    n = layers.count_params(T.model_defs(get_config("smollm_135m")))
    assert n == jax_layers.count_params(
        JT.model_defs(jax_get_config("smollm_135m"))) == 134_515_008
    assert tuple(t["groups"]["0"]["attn"]["wq"].shape) == (30, 576, 576)
    assert tuple(t["embed"].shape) == (49152, 576)


def test_init_params_draws_from_its_seed(cfgs):
    a = T.init_params(cfgs[0], seed=3, device="cpu", dtype=torch.float32)
    b = T.init_params(cfgs[0], seed=3, device="cpu", dtype=torch.float32)
    c = T.init_params(cfgs[0], seed=4, device="cpu", dtype=torch.float32)
    for x, y, z in zip(*map(layers.tree_leaves, (a, b, c))):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    with pytest.raises(NotImplementedError, match="item 10"):
        get_config("deepseek_v3_671b")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(1, 5), (2, 9)])
def test_prefill_matches_the_reference(cfgs, params, backend, b, s):
    cfg, jcfg = cfgs
    tp, jp = params
    toks = _prompts(cfg, b, s)
    j_logits, j_state = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   32)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_logits, t_state = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
            toks)}, 32)
    _close(t_logits, j_logits)
    for leaf in ("k", "v"):
        got = t_state["groups"]["0"][leaf]
        want = j_state["groups"]["0"][leaf]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        _close(got, want.astype(jnp.float32))
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_teacher_forced_matches_the_reference(cfgs, params, backend):
    """Prefill 2 rows, then 6 decode steps at per-row positions (row 1 one
    slot ahead of row 0), both fed JAX's greedy tokens."""
    cfg, jcfg = cfgs
    tp, jp = params
    toks = _prompts(cfg, 2, 6, seed=1)
    j_logits, j_state = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   32)
    conf = TE.EngineConfig(backend=backend, row_align=8)
    with TE.using_config(conf):
        t_logits, t_state = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
            toks)}, 32)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk, ps))
    for i in range(6):
        pos = np.asarray([6 + i, 7 + i], np.int32)
        j_logits, j_state = step(j_state, jnp.asarray(tok), jnp.asarray(pos))
        with TE.using_config(conf):
            t_logits, t_state = T.decode_step(
                cfg, tp, t_state, torch.from_numpy(tok), torch.from_numpy(pos))
        assert tuple(t_logits.shape) == (2, 1, cfg.vocab_size)
        _close(t_logits, j_logits)
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(
            np.int32)[:, None]
    for leaf in ("k", "v"):
        np.testing.assert_array_equal(_bits(t_state["groups"]["0"][leaf]),
                                      _bits(j_state["groups"]["0"][leaf]))


def test_scalar_and_vector_positions_are_the_same_arithmetic(cfgs, params):
    cfg, _ = cfgs
    tp, _ = params
    toks = torch.from_numpy(_prompts(cfg, 3, 4, seed=2))
    _, st_a = T.prefill(cfg, tp, {"tokens": toks}, 16)
    _, st_b = T.prefill(cfg, tp, {"tokens": toks}, 16)
    nxt = toks[:, :1]
    la, st_a = T.decode_step(cfg, tp, st_a, nxt, 4)
    lb, st_b = T.decode_step(cfg, tp, st_b, nxt,
                             torch.full((3,), 4, dtype=torch.int32))
    assert torch.equal(la, lb)
    assert torch.equal(st_a["groups"]["0"]["k"], st_b["groups"]["0"]["k"])


def test_row_align_makes_decode_rows_independent_of_the_batch(cfgs, params):
    """Under row_align=8 a row's decode logits are bitwise the same alone
    and beside 10 other rows (its GEMMs padded to 8 and 16 rows)."""
    cfg, _ = cfgs
    tp, _ = params
    toks = torch.from_numpy(_prompts(cfg, 11, 5, seed=4))
    with TE.using_config(TE.EngineConfig(row_align=8)):
        _, st = T.prefill(cfg, tp, {"tokens": toks}, 16)
        _, st1 = T.prefill(cfg, tp, {"tokens": toks[9:10]}, 16)
        pos = torch.arange(5, 16)[:11].to(torch.int32)
        l_all, _ = T.decode_step(cfg, tp, st, toks[:, :1], pos)
        l_one, _ = T.decode_step(cfg, tp, st1, toks[9:10, :1], pos[9:10])
    assert torch.equal(l_all[9], l_one[0])


def test_unported_parts_raise_naming_the_roadmap(cfgs, params):
    """MLA still raises; a 1025-token prefill, which raised before the
    chunked attention was ported, now runs, and so do local layers, which
    raised before the window was ported."""
    import dataclasses
    from repro_torch.configs.base import MLAConfig
    cfg, _ = cfgs
    tp, _ = params
    long = torch.zeros((1, 1025), dtype=torch.int32)
    logits, _ = T.prefill(cfg, tp, {"tokens": long}, 2048)
    assert tuple(logits.shape) == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    local = T.model_defs(dataclasses.replace(cfg, pattern=("local",)))
    assert set(local["groups"]["0"]["attn"]) == {"wq", "wk", "wv", "wo"}
    with pytest.raises(NotImplementedError, match="item 10"):
        T.model_defs(dataclasses.replace(cfg, mla=MLAConfig()))


@pytest.mark.parametrize("bad", [0, -8, "8", 2.0])
def test_row_align_is_validated(bad):
    with pytest.raises(ValueError, match="row_align"):
        TE.EngineConfig(row_align=bad)


def test_row_align_pads_gemm_rows_and_slices_them_back():
    """Under row_align=8 a (3, 1, 5) dense op runs as 8 rows: the plan
    and the ledger keep the op's own shape, the result is sliced back to 3
    rows, within 1e-6 of the unpadded op (the row count may change the
    library's summation order)."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 1, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32))
    plain = TE.dense(x, w)
    with TE.using_config(TE.EngineConfig(row_align=8)), \
            TE.tracking() as led:
        padded = TE.dense(x, w)
        prog = TE.trace_program(TE.proj, x.to("meta"), w.to("meta"))
    assert tuple(padded.shape) == (3, 1, 7)
    _close(padded, plain.numpy(), tol=1e-6)
    assert led.records[0].plan.macs == 3 * 5 * 7
    assert prog.ops[0].x_shape == (3, 1, 5)
