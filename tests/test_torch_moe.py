"""The port's MoE layer and its grouped GEMM on the CPU, against the JAX
package.

Reduced granite-moe-1b (4 layers, 8 experts, top-2) with the JAX package's
parameters carried across by `params_from_jax`, inputs from numpy seeds.
The port runs its default "cuda" backend on CPU tensors (each kernel
wrapper's plain version: the grouped GEMM loops the 2-D one over the
groups) and the "torch" backend.

Tolerances: router weights within 1e-6; the MoE block, the aux loss and
the logits within 1e-5 x max|out| of JAX (fp32 sums in other orders). A
token whose k-th and (k+1)-th router probabilities lie within 1e-5 may
take another expert on either side; such tokens are counted, not avoided.
"""
import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import layers as jax_layers
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.engine.plan import grouped_gemm, parse_einsum
from repro_torch.kernels import build, gfid_matmul
from repro_torch.models import layers
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
GAP = 1e-5          # a router near tie: k-th less (k+1)-th probability
BACKENDS = ("cuda", "torch")
DTYPES = {"fp32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
EXPERT_SPECS = ("ecd,edf->ecf", "ecf,efd->ecd")


@pytest.fixture(scope="module")
def cfgs():
    return reduced("granite_moe_1b"), jax_reduced("granite_moe_1b")


@pytest.fixture(scope="module")
def params(cfgs):
    """JAX's fp32 parameters (from its own seed) and the port's copy."""
    jp = JT.init_params(cfgs[1], jax.random.PRNGKey(0), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return tp, jp


def _layer(tp, jp, i=0, dtype="fp32"):
    """Layer i's MoE parameters on both sides, in `dtype`."""
    t_dt, j_dt = DTYPES[dtype]
    return ({k: v[i].to(t_dt) for k, v in tp["groups"]["0"]["moe"].items()},
            {k: v[i].astype(j_dt) for k, v in jp["groups"]["0"]["moe"].items()})


def _x(cfg, shape, seed, dtype="fp32"):
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return (torch.from_numpy(x).to(DTYPES[dtype][0]),
            jnp.asarray(x).astype(DTYPES[dtype][1]))


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


# ---------------------------------------------------------------------------
# configs and the model's trees
# ---------------------------------------------------------------------------

def test_configs_load_as_the_reference_defines_them():
    for name in ("granite_moe_1b", "granite-moe-1b-a400m"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        assert dataclasses.asdict(reduced(name)) == dataclasses.asdict(
            jax_reduced(name))


def test_full_width_param_shapes_equal_the_reference():
    t = T.param_shapes(get_config("granite_moe_1b"), torch.float32)
    j = JT.param_shapes(jax_get_config("granite_moe_1b"))
    assert [tuple(a.shape) for a in layers.tree_leaves(t)] \
        == [a.shape for a in jax.tree_util.tree_leaves(j)]
    n = layers.count_params(T.model_defs(get_config("granite_moe_1b")))
    assert n == jax_layers.count_params(
        JT.model_defs(jax_get_config("granite_moe_1b")))
    assert 1.3e9 < n < 1.4e9
    assert tuple(t["groups"]["0"]["moe"]["w_in"].shape) == (24, 32, 1024, 512)
    assert tuple(t["groups"]["0"]["moe"]["w_out"].shape) == (24, 32, 512, 1024)


def test_params_from_jax_carries_the_expert_stacks(cfgs, params):
    tp, jp = params
    for key in ("router", "w_in", "w_gate", "w_out"):
        got, want = tp["groups"]["0"]["moe"][key], jp["groups"]["0"]["moe"][key]
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_draws_expert_weights_at_their_fan_in(cfgs):
    cfg, _ = cfgs
    p = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    moe = p["groups"]["0"]["moe"]
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    assert abs(moe["w_in"].std().item() * d ** 0.5 - 1) < 0.05
    assert abs(moe["w_out"].std().item() * f ** 0.5 - 1) < 0.05
    assert abs(moe["router"].std().item() / 0.02 - 1) < 0.1


def test_unported_moe_parts_raise_naming_the_roadmap(cfgs, params):
    cfg, _ = cfgs
    tp, _ = params
    p, _ = _layer(tp, params[1])
    x, _ = _x(cfg, (1, 3), 0)
    with pytest.raises(NotImplementedError, match="item 11"):
        M.moe_forward(cfg, p, x, mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        T.param_shapes(dataclasses.replace(cfg, moe=None))
    with pytest.raises(NotImplementedError, match="item 10"):
        get_config("deepseek_v3_671b")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed,tokens", [(0, 16), (1, 64), (2, 200)])
def test_router_probs_match_the_reference(cfgs, params, backend, seed,
                                          tokens):
    cfg, jcfg = cfgs
    p, jpl = _layer(*params, i=seed % cfg.n_groups)
    x, jx = _x(cfg, (tokens,), seed)
    jw, ji, jprobs = JM.router_probs(jcfg, jpl, jx)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        w, i, probs = M.router_probs(cfg, p, x)
    k = cfg.moe.n_active
    assert w.dtype == probs.dtype == torch.float32 and i.shape == (tokens, k)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)
    top = np.sort(np.asarray(jprobs), -1)[:, ::-1]
    clear = top[:, k - 1] - top[:, k] > GAP
    print(f"{int((~clear).sum())} of {tokens} tokens within {GAP} of a tie")
    np.testing.assert_array_equal(i.numpy()[clear], np.asarray(ji)[clear])


def test_a_zero_router_picks_the_first_experts_as_jax_top_k(cfgs, params):
    """Uniform probabilities: experts 0..k-1 in order, equal weights, on
    both sides (ties go to the lower index)."""
    cfg, jcfg = cfgs
    p, jpl = _layer(*params)
    p = dict(p, router=torch.zeros_like(p["router"]))
    jpl = dict(jpl, router=jnp.zeros_like(jpl["router"]))
    x, jx = _x(cfg, (5,), 3)
    w, i, _ = M.router_probs(cfg, p, x)
    jw, ji, _ = JM.router_probs(jcfg, jpl, jx)
    k = cfg.moe.n_active
    want = np.tile(np.arange(k), (5, 1))
    np.testing.assert_array_equal(np.asarray(ji), want)
    np.testing.assert_array_equal(i.numpy(), want)
    np.testing.assert_allclose(w.numpy(), np.full((5, k), 1 / k), atol=1e-7)


def test_ties_keep_the_lower_index_at_full_width():
    """32 experts top-8 with ties inside and across the cut (logits of a
    few integer values): the stable sort keeps index order among equals,
    as `jax.lax.top_k`."""
    cfg = get_config("granite_moe_1b")
    jcfg = jax_get_config("granite_moe_1b")
    router = np.zeros((cfg.d_model, 32), np.float32)
    router[:32] = np.eye(32)
    x = np.zeros((64, cfg.d_model), np.float32)
    x[:, :32] = np.random.default_rng(5).integers(0, 4, (64, 32))
    _, i, _ = M.router_probs(cfg, {"router": torch.from_numpy(router)},
                             torch.from_numpy(x))
    _, ji, _ = JM.router_probs(jcfg, {"router": jnp.asarray(router)},
                               jnp.asarray(x))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_load_balance_loss_matches_the_reference(cfgs, params, dtype,
                                                 backend):
    cfg, jcfg = cfgs
    p, jpl = _layer(*params, i=1, dtype=dtype)
    x, jx = _x(cfg, (40,), 6, dtype)
    jw, ji, jprobs = JM.router_probs(jcfg, jpl, jx)
    want = JM.load_balance_loss(jprobs, ji, jcfg.moe.n_experts)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        _, i, probs = M.router_probs(cfg, p, x)
    got = M.load_balance_loss(probs, i, cfg.moe.n_experts)
    assert got.shape == () and got.dtype == torch.float32
    _close(got, want)
    # the same on the reference's own routing
    again = M.load_balance_loss(torch.from_numpy(np.array(jprobs)),
                                torch.from_numpy(np.array(ji)).long(),
                                cfg.moe.n_experts)
    _close(again, want)


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(1, 1), (2, 7), (3, 24)])
def test_moe_forward_dense_matches_the_reference(cfgs, params, dtype,
                                                 backend, b, s):
    cfg, jcfg = cfgs
    p, jpl = _layer(*params, i=b % cfg.n_groups, dtype=dtype)
    x, jx = _x(cfg, (b, s), 7 + b, dtype)
    jy, jaux = JM.moe_forward_dense(jcfg, jpl, jx)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        y, aux = M.moe_forward_dense(cfg, p, x)
        y2, aux2 = M.moe_forward(cfg, p, x)
    assert y.dtype == x.dtype and tuple(y.shape) == (b, s, cfg.d_model)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    _close(y, jy)
    _close(aux, jaux)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_a_token_alone_is_bitwise_the_token_among_eight(cfgs, params, dtype,
                                                        backend):
    """Under row_align=8 each of 8 tokens through the MoE block alone gives
    the bits it gets beside the other 7: the router's GEMM pads to 8 rows,
    the grouped GEMMs pad their rows to 8, and the softmax, top-k and
    combine sum in orders fixed by E."""
    cfg, _ = cfgs
    p, _ = _layer(*params, i=2, dtype=dtype)
    x, _ = _x(cfg, (8, 1), 9, dtype)
    with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)):
        y8, _ = M.moe_forward_dense(cfg, p, x)
        for i in range(8):
            y1, _ = M.moe_forward_dense(cfg, p, x[i:i + 1])
            assert torch.equal(y1[0], y8[i]), i


def test_the_combine_sums_experts_in_a_fixed_order(cfgs):
    """`row_sum` over the expert axis: each token's sum has the same bits
    whatever tokens share the tensor."""
    ye = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (8, 9, 5)).astype(np.float32))
    full = layers.row_sum(ye, dim=0)
    assert tuple(full.shape) == (1, 9, 5)
    np.testing.assert_allclose(full[0].numpy(), ye.sum(0).numpy(), rtol=1e-5,
                               atol=1e-6)
    for t in (0, 4, 8):
        assert torch.equal(layers.row_sum(ye[:, t:t + 1], dim=0)[0, 0],
                           full[0, t])
    assert torch.equal(layers.row_sum(ye.transpose(0, 2)),
                       layers.row_sum(ye, dim=0).transpose(0, 2))


def test_shared_experts_match_the_reference(cfgs):
    """A config with shared experts (the reference's `n_shared`): the shared
    gated FFN added to the routed output, on both sides."""
    cfg, jcfg = cfgs
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_shared=2))
    jcfg = dataclasses.replace(jcfg,
                               moe=dataclasses.replace(jcfg.moe, n_shared=2))
    jp = JT.init_params(jcfg, jax.random.PRNGKey(3), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    p, jpl = _layer(tp, jp)
    assert set(p) == set(M.moe_defs(cfg))
    x, jx = _x(cfg, (2, 5), 11)
    jy, _ = JM.moe_forward_dense(jcfg, jpl, jx)
    y, _ = M.moe_forward_dense(cfg, p, x)
    _close(y, jy)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(1, 5), (2, 9)])
def test_forward_with_aux_matches_the_reference(cfgs, params, backend, b, s):
    cfg, jcfg = cfgs
    tp, jp = params
    toks = np.random.default_rng(b + s).integers(0, cfg.vocab_size, (b, s))
    jh, jaux = JT.forward(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    with TE.using_config(TE.EngineConfig(backend=backend)):
        h, aux = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)},
                           return_aux=True)
        h2 = T.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    assert torch.equal(h, h2)
    _close(h, jh)
    _close(aux, jaux)
    _close(T.logits_fn(cfg, tp, h), JT.logits_fn(jcfg, jp, jh))


def test_forward_aux_is_zero_without_moe():
    cfg = reduced("smollm_135m")
    p = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    _, aux = T.forward(cfg, p, {"tokens": torch.zeros((1, 3), dtype=torch.int64)},
                       return_aux=True)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(1, 5), (2, 9)])
def test_prefill_matches_the_reference(cfgs, params, backend, b, s):
    cfg, jcfg = cfgs
    tp, jp = params
    toks = np.random.default_rng(s).integers(0, cfg.vocab_size, (b, s))
    jl, jst = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks, jnp.int32)},
                         32)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        tl, tst = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 32)
    _close(tl, jl)
    # the bf16 cache: each element within one bf16 rounding (its fp32 source
    # sums in other orders past the first MoE layer)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            tst["groups"]["0"][leaf].float().numpy(),
            np.asarray(jst["groups"]["0"][leaf].astype(jnp.float32)),
            rtol=2.0 ** -7, atol=1e-30)


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_teacher_forced_matches_the_reference(cfgs, params, backend):
    """Prefill 2 rows, then 5 decode steps at per-row positions, both fed
    JAX's greedy tokens, on an fp32 cache (a bf16 one can round a key or
    value to the other neighbour on one side: `test_prefill_...`)."""
    cfg, jcfg = cfgs
    tp, jp = params
    toks = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    jl, jst = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32,
                         state_dtype=jnp.float32)
    conf = TE.EngineConfig(backend=backend, row_align=8)
    with TE.using_config(conf):
        tl, tst = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 32,
                            state_dtype=torch.float32)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)[:, None]
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk, ps))
    for i in range(5):
        pos = np.asarray([6 + i, 7 + i], np.int32)
        jl, jst = step(jst, jnp.asarray(tok), jnp.asarray(pos))
        with TE.using_config(conf):
            tl, tst = T.decode_step(cfg, tp, tst, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        _close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1)).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# the grouped GEMM: dispatch, plain version, plans, the launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,x_nd,w_nd,want", [
    ("ecd,edf->ecf", 3, 3, True),
    ("ecf,efd->ecd", 3, 3, True),
    ("ecd,efd->ecf", 3, 3, True),        # w per group (N, K): transposed
    ("ebcd,edf->ebcf", 4, 3, True),      # two row labels, flattened
    ("...n,nm->...m", 3, 2, False),      # canonical, not grouped
    ("ecd,edf->cef", 3, 3, False),       # group not leading in out
    ("ced,edf->ecf", 3, 3, False),       # group not leading in x
    ("ecd,def->ecf", 3, 3, False),       # group not leading in w
    ("becd,bedf->becf", 4, 4, False),    # two group labels
    ("ecd,ed->ec", 3, 2, False),         # 2-D weights
    ("ecdg,edgf->ecf", 4, 4, False),     # two contractions
])
def test_grouped_gemm_holds_for_the_expert_specs_only(spec, x_nd, w_nd, want):
    assert grouped_gemm(parse_einsum(spec, x_nd, w_nd), w_nd) is want


@pytest.mark.parametrize("spec,x_shape,w_shape", [
    ("ecd,edf->ecf", (4, 6, 8), (4, 8, 5)),
    ("ecf,efd->ecd", (3, 1, 16), (3, 16, 9)),
    ("ecd,efd->ecf", (2, 5, 8), (2, 7, 8)),
    ("ebcd,edf->ebcf", (3, 2, 4, 8), (3, 8, 6)),
])
@pytest.mark.parametrize("row_align", [None, 8])
def test_grouped_einsum_on_cuda_matches_torch(spec, x_shape, w_shape,
                                              row_align):
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(w_shape).astype(np.float32))
    want = torch.einsum(spec, x.double(), w.double())
    for backend in BACKENDS:
        with TE.using_config(TE.EngineConfig(backend=backend,
                                             row_align=row_align)):
            got = TE.einsum(spec, x, w, accum_dtype=torch.float32)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("spec,x_shape,w_shape", [
    ("becd,bedf->becf", (2, 3, 4, 8), (2, 3, 8, 5)),
    ("ecdg,edgf->ecf", (3, 2, 4, 2), (3, 4, 2, 6)),
])
def test_other_batched_weight_specs_still_raise_on_cuda(spec, x_shape,
                                                        w_shape):
    x, w = torch.ones(x_shape), torch.ones(w_shape)
    with TE.using_config(TE.EngineConfig(backend="cuda")), \
            pytest.raises(NotImplementedError, match="item 10"):
        TE.einsum(spec, x, w)
    with TE.using_config(TE.EngineConfig(backend="torch")):
        assert TE.einsum(spec, x, w).shape == torch.einsum(spec, x, w).shape


def test_auto_policy_keeps_the_expert_gemms_on_the_fallback():
    for spec in EXPERT_SPECS:
        op = TE.OpSpec("dense", (32, 8, 1024), (32, 1024, 512), spec=spec)
        assert TE.auto_backend(op, "torch") == "torch"
        assert not TE.supports_int8(op)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,m,k,n", [(3, 5, 72, 40), (4, 1, 16, 9),
                                     (2, 17, 33, 64)])
def test_grouped_plain_is_bitwise_the_groups_plain_calls(dtype, g, m, k, n):
    rng = np.random.default_rng(g * m)
    x = torch.from_numpy(rng.standard_normal((g, m, k)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((g, k, n)).astype(
        np.float32)).to(dtype)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    for kw in ({}, dict(bias=bias, act="relu"), dict(out_dtype=dtype)):
        got = gfid_matmul.gfid_matmul(x, w, **kw)
        apart = torch.stack([gfid_matmul.gfid_matmul(x[i], w[i], **kw)
                             for i in range(g)])
        assert got.shape == (g, m, n) and torch.equal(got, apart)
        meta = gfid_matmul.gfid_matmul(
            x.to("meta"), w.to("meta"),
            **{k: v.to("meta") if k == "bias" else v for k, v in kw.items()})
        assert meta.shape == (g, m, n) and meta.dtype == got.dtype


@pytest.mark.parametrize("x_shape,w_shape", [
    ((2, 3, 4), (3, 4, 5)), ((2, 3, 4), (2, 5, 5)), ((2, 3, 4), (4, 5)),
    ((3, 4), (2, 4, 5)),
])
def test_grouped_shapes_are_checked(x_shape, w_shape):
    with pytest.raises(ValueError, match="gfid_matmul takes"):
        gfid_matmul.gfid_matmul(torch.ones(x_shape), torch.ones(w_shape))


@pytest.mark.parametrize("m,k,n", [(8, 1024, 512), (8, 512, 1024),
                                   (1, 1024, 512), (1024, 1024, 512),
                                   (256, 512, 1024), (1100, 1024, 512),
                                   (5, 72, 40)])
def test_grouped_plans_keep_one_groups_split(m, k, n):
    """A grouped plan takes the split of K of one group's (so every group's
    bits are its 2-D launch's); the grid's y is groups x row blocks; the
    mode may fold where the groups fill the card, which adds the splits in
    the same order."""
    for groups in (1, 3, 32):
        f = gfid_matmul.f32_plan(m, k, n, groups=groups)
        one = gfid_matmul.f32_plan(m, k, n)
        assert (f.splits, f.chunks_per_split) == (one.splits,
                                                  one.chunks_per_split)
        assert f.grid[1] == groups * -(-m // f.bm)
        if m <= gfid_matmul.F32_FEW_ROWS:
            assert f == one._replace(grid=f.grid)
        b = gfid_matmul.bf16_plan(m, k, n, groups=groups)
        one = gfid_matmul.bf16_plan(m, k, n)
        assert b == one._replace(grid=(one.grid[0], groups * one.grid[1],
                                       one.grid[2]))
    # granite's decode: w_in splits through the workspace, w_out as a
    # cluster; its 1,024-token prefill folds where one group alone splits
    assert gfid_matmul.f32_plan(8, 1024, 512, groups=32).mode == "split"
    assert gfid_matmul.f32_plan(8, 512, 1024, groups=32).mode == "cluster"
    assert gfid_matmul.f32_plan(1024, 1024, 512, groups=32).mode == "fold"
    assert gfid_matmul.f32_plan(1024, 1024, 512).mode == "split"


def test_grouped_plans_refuse_a_grid_past_cudas_limit():
    with pytest.raises(ValueError, match="exceeds"):
        gfid_matmul.f32_plan(8, 64, 64, groups=65536)
    with pytest.raises(ValueError, match="exceeds"):
        gfid_matmul.bf16_plan(256, 64, 64, groups=20000)
    assert gfid_matmul.bf16_plan(16, 64, 64, groups=65535).grid[1] == 65535


@pytest.mark.parametrize("m,k,stride_ok", [(5, 72, True), (3, 6, False),
                                           (1, 4, True)])
def test_grouped_16_byte_loads_need_every_group_aligned(m, k, stride_ok):
    """K % 4 == 0 keeps every fp32 group 16-byte aligned (its stride m * k
    a multiple of 4); bf16 needs K % 8 and a stride of a multiple of 8."""
    f = gfid_matmul.f32_plan(m, k, 64, 0, 0, groups=4)
    assert f.vec_x == (k % 4 == 0 and stride_ok)
    assert gfid_matmul._vec(k, 0, m * k, 8) == (k % 8 == 0
                                                and m * k % 8 == 0)
    assert not gfid_matmul._vec(8, 0, 12, 8)       # row fits, group does not
    assert not gfid_matmul._vec(8, 8, 16, 8)       # base unaligned


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _fake_cuda(monkeypatch, calls):
    def fake_library(name):
        symbol = {"gfid_matmul": "gfid_matmul_f32",
                  "gfid_matmul_bf16": "gfid_matmul_bf16"}[name]

        def fn(*args):
            calls.append((symbol, args))
            return 0
        return types.SimpleNamespace(
            **{symbol: fn, "repro_cuda_error_string": lambda e: b"refused"})

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(build, "sm_count", lambda index: 132)
    monkeypatch.setattr(build, "on_device", lambda index: _NullContext())
    monkeypatch.setattr(build, "raw_stream", lambda index: 7)
    for name in ("_launcher", "_launcher_bf16"):
        monkeypatch.setattr(gfid_matmul, name,
                            getattr(gfid_matmul, name).__wrapped__)


@pytest.mark.parametrize("g,m,k,n,mode", [
    (32, 8, 1024, 512, "split"),         # granite decode w_in: workspace
    (32, 8, 512, 1024, "cluster"),       # granite decode w_out
    (32, 1024, 1024, 512, "fold"),       # a 1,024-token prefill's w_in
    (3, 5, 72, 40, "split"),             # one split
])
def test_f32_grouped_launch_passes_groups_and_strides(monkeypatch, g, m, k,
                                                      n, mode):
    """One call of `gfid_matmul_f32` for every group: the grouped plan,
    the (splits, G, M, N) workspace after the (G, M, N) output in one
    allocation, the group count and strides before the stream, counted on
    the entry's counter and the grouped one."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    x, w = torch.zeros((g, m, k)), torch.zeros((g, k, n))
    before = (gfid_matmul.gfid_matmul.launches,
              gfid_matmul.gfid_matmul_grouped.launches,
              gfid_matmul.gfid_matmul_bf16_grouped.launches)
    out = gfid_matmul._launch(x, w, None, None, False, torch.float32)
    (symbol, args), = calls
    plan = gfid_matmul.f32_plan(m, k, n, x.data_ptr(), w.data_ptr(), 132, g)
    assert symbol == "gfid_matmul_f32" and plan.mode == mode
    assert len(args) == len(gfid_matmul.F32_ARGTYPES)
    assert tuple(out.shape) == (g, m, n) and out.is_contiguous()
    assert args[3] == out.data_ptr()
    if plan.workspace:
        assert args[4] == out.data_ptr() + 4 * g * m * n
        assert out.untyped_storage().nbytes() == 4 * (plan.splits + 1) * g * m * n
    else:
        assert args[4] is None
    assert args[5:] == (m, k, n, plan.bm, plan.bn, plan.splits,
                        plan.chunks_per_split, gfid_matmul.F32_MODES[plan.mode],
                        0, int(plan.vec_x), int(plan.vec_w), g, m * k, k * n, 7)
    assert (gfid_matmul.gfid_matmul.launches,
            gfid_matmul.gfid_matmul_grouped.launches,
            gfid_matmul.gfid_matmul_bf16_grouped.launches) == (
        before[0] + 1, before[1] + 1, before[2])


def test_bf16_grouped_launch_passes_groups_and_strides(monkeypatch):
    calls = []
    _fake_cuda(monkeypatch, calls)
    x = torch.zeros((32, 8, 1024), dtype=torch.bfloat16)
    w = torch.zeros((32, 1024, 512), dtype=torch.bfloat16)
    before = (gfid_matmul.gfid_matmul_bf16.launches,
              gfid_matmul.gfid_matmul_bf16_grouped.launches)
    out = gfid_matmul._launch(x, w, None, None, True, torch.float32)
    (symbol, args), = calls
    plan = gfid_matmul.bf16_plan(8, 1024, 512, x.data_ptr(), w.data_ptr(), 32)
    assert symbol == "gfid_matmul_bf16" and out.shape == (32, 8, 512)
    assert args[5:] == (0, 0, 8, 1024, 512, plan.bm, plan.bn, plan.splits,
                        plan.chunks_per_split, 0, int(plan.vec_x),
                        int(plan.vec_w), 32, 8 * 1024, 1024 * 512, 7)
    assert plan.grid[1] == 32
    assert (gfid_matmul.gfid_matmul_bf16.launches,
            gfid_matmul.gfid_matmul_bf16_grouped.launches) == (
        before[0] + 1, before[1] + 1)


def test_an_expert_einsum_on_cuda_is_one_launch(monkeypatch):
    """`engine.einsum` on the expert specs under the default config: one
    launch of the grouped GEMM, no library product."""
    calls = []
    _fake_cuda(monkeypatch, calls)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    monkeypatch.setattr(torch.Tensor, "get_device", lambda t: 0)
    monkeypatch.setattr(torch, "bmm", None)
    monkeypatch.setattr(torch, "einsum", None)
    x = torch.zeros((32, 8, 1024))
    for spec, w in (("ecd,edf->ecf", torch.zeros((32, 1024, 512))),
                    ("ecf,efd->ecd", torch.zeros((32, 1024, 1024)))):
        calls.clear()
        TE.einsum(spec, x, w, accum_dtype=torch.float32)
        assert [symbol for symbol, _ in calls] == ["gfid_matmul_f32"]
        assert calls[0][1][-4] == 32


def test_entries_take_groups_and_strides_before_the_stream():
    for name, argtypes in (("gfid_matmul.cu", gfid_matmul.F32_ARGTYPES),
                           ("gfid_matmul_bf16.cu", gfid_matmul.BF16_ARGTYPES)):
        source = (build.CSRC / name).read_text()
        assert "int groups, long long stride_x" in source
        assert "long long stride_w, void* stream" in source
        assert "blockIdx.y / row_blocks" in source
        assert argtypes[-4:] == [ctypes.c_int, ctypes.c_longlong,
                                 ctypes.c_longlong, ctypes.c_void_p]
