"""The port's VLM (llama-3.2-vision) on the CPU against the JAX package.

The reduced config (5 layers: 4 self-attention layers and one gated cross
layer at index 3, 17 image tokens) with the JAX package's parameters
carried across by `params_from_jax`. The config initialises every cross
gate to 0, so an image could not move a token; the parameters here set
the gate to GATE in the JAX tree before the carry, so that the cross path
counts. Inputs come from numpy seeds. The port runs its default "cuda"
backend on CPU tensors (each kernel wrapper's plain version) and "torch".

Tolerances: in fp32, the cross forward and decode, the logits and the
chunked attention within 1e-5 x max|out| of JAX (fp32 sums in other
orders); the bf16 decode state, the image caches included, within one bf16
step of each element (the two fp32 sums, equal to about 1e-7, can round
to neighbouring bf16 values; measured: one element in a thousand). With
the config's bf16 parameters, those of tests/test_torch_bf16_serve.py:
within 1e-5 of the reference jitted with `xla_allow_excess_precision` off
and the state bitwise, within 2e-2 of its default jit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.kernels import ops as jax_ops
from repro.models import attention as JA
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro.models.flash import flash_attention_jnp
from repro.serve import engine as JSE
from repro_torch import engine as TE
from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      get_config, reduced)
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as LS
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
LOGITS_TOL = 2e-2
BACKENDS = ("cuda", "torch")
GATE = 0.7
MAX_LEN = 32
CROSS = "3"             # the cross layer's place in the group
exact_jit = functools.partial(
    jax.jit, compiler_options={"xla_allow_excess_precision": False})


@pytest.fixture(scope="module")
def cfgs():
    return reduced("llama32_vision_11b"), jax_reduced("llama32_vision_11b")


def _gated(jp, gate=GATE):
    """The JAX tree with every cross gate set to `gate`."""
    jp = jax.tree_util.tree_map(lambda a: a, jp)
    g = jp["groups"][CROSS]["attn"]["gate"]
    jp["groups"][CROSS]["attn"]["gate"] = jnp.full(g.shape, gate, g.dtype)
    return jp


def _carry(jp):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def params(cfgs):
    """JAX's fp32 parameters (its own seed, the gate set to GATE) and the
    port's copy."""
    jp = _gated(JT.init_params(cfgs[1], jax.random.PRNGKey(0), jnp.float32))
    return _carry(jp), jp


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, err


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def _inputs(cfg, b, s, seed=0, dtype=np.float32):
    """Tokens (B, S) and image embeddings (B, n_img, d_model), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = (0.1 * rng.standard_normal((b, cfg.n_img_tokens, cfg.d_model))
           ).astype(np.float32)
    return toks, img


def _batches(toks, img, j_dtype=jnp.float32, t_dtype=torch.float32):
    return ({"tokens": jnp.asarray(toks),
             "image_embeds": jnp.asarray(img).astype(j_dtype)},
            {"tokens": torch.from_numpy(toks),
             "image_embeds": torch.from_numpy(img).to(t_dtype)})


def _state_close(t_state, j_state):
    """Every state leaf bf16, each element within one bf16 step (at the
    larger magnitude of the pair) of the reference's."""
    for j, leaves in j_state["groups"].items():
        for leaf, want in leaves.items():
            got = t_state["groups"][j][leaf]
            assert tuple(got.shape) == want.shape, (j, leaf)
            assert got.dtype == torch.bfloat16, (j, leaf)
            g = got.float().numpy()
            w = np.asarray(want.astype(jnp.float32))
            mag = np.maximum(np.abs(g), np.abs(w))
            step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
            assert (np.abs(g - w) <= step).all(), (j, leaf)


def _state_bitwise(t_state, j_state):
    for j, leaves in j_state["groups"].items():
        for leaf, want in leaves.items():
            got = t_state["groups"][j][leaf]
            assert tuple(got.shape) == want.shape, (j, leaf)
            assert got.dtype == torch.bfloat16, (j, leaf)
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{j}/{leaf}")


# ---------------------------------------------------------------------------
# configs, parameter trees, refusals
# ---------------------------------------------------------------------------

def test_configs_load_as_the_reference_defines_them():
    for name in ("llama32_vision_11b", "llama-3.2-vision-11b"):
        assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
            jax_get_config(name))
        assert dataclasses.asdict(reduced(name)) == dataclasses.asdict(
            jax_reduced(name))
    cfg = get_config("llama-3.2-vision-11b")
    assert cfg.layer_kinds.count(CROSS_ATTN) == 8
    assert [i for i, k in enumerate(cfg.layer_kinds) if k == CROSS_ATTN] \
        == list(range(3, 40, 5))


def test_full_width_param_shapes_equal_the_reference():
    cfg = get_config("llama32_vision_11b")
    t = T.param_shapes(cfg)
    j = JT.param_shapes(jax_get_config("llama32_vision_11b"))
    assert [tuple(a.shape) for a in layers.tree_leaves(t)] \
        == [a.shape for a in jax.tree_util.tree_leaves(j)]
    assert {a.dtype for a in layers.tree_leaves(t)} == {torch.bfloat16}
    n = layers.count_params(T.model_defs(cfg))
    assert n == jax_layers.count_params(
        JT.model_defs(jax_get_config("llama32_vision_11b")))
    assert 9.7e9 < n < 9.8e9
    cross = t["groups"][CROSS]["attn"]
    assert tuple(cross["gate"].shape) == (8, 1)
    assert tuple(cross["k_norm_cross"].shape) == (8, 128)
    assert tuple(cross["wk"].shape) == (8, 4096, 1024)
    assert tuple(t["lm_head"].shape) == (4096, 128256)


def test_params_from_jax_carries_the_cross_leaves(params):
    tp, jp = params
    for key in ("wq", "wk", "wv", "wo", "gate", "k_norm_cross"):
        got = tp["groups"][CROSS]["attn"][key]
        want = jp["groups"][CROSS]["attn"][key]
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tp["groups"][CROSS]["attn"]["gate"][0, 0]) == \
        pytest.approx(GATE)
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jp["lm_head"]))


def test_init_params_gate_zero_norms_one_bf16(cfgs):
    p = T.init_params(cfgs[0], seed=0, device="cpu")
    cross = p["groups"][CROSS]["attn"]
    assert {a.dtype for a in layers.tree_leaves(p)} == {torch.bfloat16}
    assert torch.equal(cross["gate"], torch.zeros(1, 1, dtype=torch.bfloat16))
    assert torch.equal(cross["k_norm_cross"],
                       torch.ones(1, 16, dtype=torch.bfloat16))
    assert "gate" not in p["groups"]["0"]["attn"]


def test_refusals_name_their_roadmap_items(cfgs, params):
    from repro_torch.configs.base import MLAConfig
    cfg = cfgs[0]
    TA.check_supported(cfg, LOCAL_ATTN)          # ported: no refusal
    with pytest.raises(NotImplementedError, match="item 10"):
        TA.check_supported(dataclasses.replace(cfg, mla=MLAConfig()),
                           LOCAL_ATTN)
    for bad in (dict(d_frontend=32), dict(is_encoder=True)):
        with pytest.raises(NotImplementedError, match="item 10"):
            T.check_supported(dataclasses.replace(cfg, **bad))
    with pytest.raises(NotImplementedError, match="item 10"):
        T.check_supported(dataclasses.replace(cfg, n_img_tokens=0))
    with pytest.raises(NotImplementedError, match="item 10"):
        T.check_supported(dataclasses.replace(cfg, family="dense"))
    q = torch.zeros(1, 4, 4, 16)
    with TE.using_config(TE.EngineConfig(backend="cuda")):
        got = TF.flash_attention(q, q[:, :, :2], q[:, :, :2], causal=False,
                                 softcap_val=50.0)
        assert torch.equal(got, torch.zeros_like(q))  # the softcap is ported
        with pytest.raises(NotImplementedError, match="item 10"):
            TA.check_supported(dataclasses.replace(cfg, mla=MLAConfig()),
                               CROSS_ATTN)
    toks, _ = _inputs(cfg, 1, 5)
    with pytest.raises(ValueError, match="image_embeds"):
        T.prefill(cfg, params[0], {"tokens": torch.from_numpy(toks)}, 16)
    with pytest.raises(NotImplementedError, match="tokens only"):
        ContinuousScheduler(cfg, params[0], max_len=16, num_blocks=8)
    with pytest.raises(ValueError, match="img_embeds"):
        TA.attention_forward(cfg, {k: v[0] for k, v in
                                   params[0]["groups"][CROSS]["attn"].items()},
                             torch.zeros(1, 3, cfg.d_model),
                             torch.arange(3)[None], CROSS_ATTN)


# ---------------------------------------------------------------------------
# the cross layer and the chunked attention at Sq != Skv
# ---------------------------------------------------------------------------

def _cross_params(params):
    tp, jp = params
    return ({k: v[0] for k, v in tp["groups"][CROSS]["attn"].items()},
            {k: v[0] for k, v in jp["groups"][CROSS]["attn"].items()})


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("use_chunked", [False, True])
@pytest.mark.parametrize("b,s", [(1, 5), (2, 40)])
def test_cross_attention_forward_matches_the_reference(cfgs, params, backend,
                                                       use_chunked, b, s):
    """q from x, k and v from the 17 image embeddings, no rope, no mask;
    dense and chunked; the output scaled by tanh(gate), no kv returned."""
    cfg, jcfg = cfgs
    tp, jp = _cross_params(params)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    _, img = _inputs(cfg, b, 1, seed=s)
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    j_out, j_kv = JA.attention_forward(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos), CROSS_ATTN,
        img_embeds=jnp.asarray(img), use_chunked=use_chunked)
    before = FA.flash_attention.launches
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_out, t_kv = TA.attention_forward(
            cfg, tp, torch.from_numpy(x), torch.from_numpy(pos), CROSS_ATTN,
            img_embeds=torch.from_numpy(img), use_chunked=use_chunked)
    assert FA.flash_attention.launches == before      # CPU: no launch
    assert t_kv is None and j_kv is None
    _close(t_out, j_out)


@pytest.mark.parametrize("sq,skv", [(9, 17), (40, 24), (3, 70)])
def test_chunked_attention_at_sq_ne_skv(sq, skv):
    """Non-causal, Sq != Skv: `models/flash.py` on "torch" within 1e-5 of
    `flash_attention_jnp`, with chunks smaller than both lengths; the
    kernel's plain version within 1e-5 of the Pallas kernel in interpret
    mode."""
    rng = np.random.default_rng(sq * skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = flash_attention_jnp(*map(jnp.asarray, (q, k, v)), causal=False,
                               q_chunk=8, kv_chunk=16)
    with TE.using_config(TE.EngineConfig(backend="torch")):
        got = TF.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=False, q_chunk=8, kv_chunk=16)
    _close(got, want)
    pallas = jax_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                     causal=False, interpret=True)
    _close(FA.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                    causal=False), pallas)
    with TE.using_config(TE.EngineConfig(backend="cuda")):
        got = TF.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=False)
    _close(got, pallas)


def test_kernel_launch_plans_take_sq_alone():
    """Neither launch plan reads Skv: the grids follow q's tiles."""
    for skv in (17, 1601):
        assert FA.bf16_launch(4, 1100, 32, 128, 0, 0, 0).grid == (
            18 * 32, 4, 1)
        assert FA.f32_launch(4, 1100, 32, 128, 0, 0, 0).grid == (
            35 * 32 * 4, 1, 1)
        q = torch.empty(4, 1100, 32, 128, device="meta")
        kv = torch.empty(4, skv, 8, 128, device="meta")
        assert FA.flash_attention(q, kv, kv, causal=False).shape == q.shape


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_attention_decode_matches_the_reference(cfgs, params, backend):
    """Dense non-causal attention over the cached image k/v; the cache is
    returned unchanged."""
    cfg, jcfg = cfgs
    tp, jp = _cross_params(params)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((3, cfg.n_img_tokens, cfg.n_kv_heads,
                                   cfg.head_dim)).astype(np.float32)
              for _ in range(2))
    jcache = {"k": jnp.asarray(ck).astype(jnp.bfloat16),
              "v": jnp.asarray(cv).astype(jnp.bfloat16)}
    tcache = {"k": torch.from_numpy(ck).bfloat16(),
              "v": torch.from_numpy(cv).bfloat16()}
    kept = {k: v.clone() for k, v in tcache.items()}
    j_out, j_cache = JA.attention_decode(jcfg, jp, jnp.asarray(x), jcache,
                                         jnp.int32(7), CROSS_ATTN)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_out, t_cache = TA.attention_decode(cfg, tp, torch.from_numpy(x),
                                             tcache, torch.tensor(7),
                                             CROSS_ATTN)
    _close(t_out, j_out)
    assert t_cache is tcache
    for leaf in ("k", "v"):
        assert torch.equal(t_cache[leaf], kept[leaf])
        np.testing.assert_array_equal(_bits(t_cache[leaf]),
                                      _bits(j_cache[leaf]))


# ---------------------------------------------------------------------------
# the model: prefill, decode, state, tokens
# ---------------------------------------------------------------------------

def test_decode_state_shapes_carry_the_image_cache(cfgs):
    cfg, jcfg = cfgs
    t = SE.decode_state_shapes(cfg, 3, MAX_LEN)
    j = JSE.decode_state_shapes(jcfg, 3, MAX_LEN)
    assert [tuple(a.shape) for a in layers.tree_leaves(t)] \
        == [a.shape for a in jax.tree_util.tree_leaves(j)]
    assert tuple(t["groups"][CROSS]["k"].shape) == (
        1, 3, cfg.n_img_tokens, cfg.n_kv_heads, cfg.head_dim)
    full = SE.decode_state_shapes(get_config("llama32_vision_11b"), 4, 1124)
    assert tuple(full["groups"][CROSS]["v"].shape) == (8, 4, 1601, 8, 128)
    assert tuple(full["groups"]["0"]["k"].shape) == (8, 4, 1124, 8, 128)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("b,s", [(1, 5), (2, 9)])
def test_prefill_and_decode_match_the_reference(cfgs, params, backend, b, s):
    """Prefill logits and the whole decode state (the cross cache too),
    then two decode steps' logits and state."""
    cfg, jcfg = cfgs
    tp, jp = params
    jb, tb = _batches(*_inputs(cfg, b, s, seed=b * s))
    j_logits, j_state = JT.prefill(jcfg, jp, jb, MAX_LEN)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_logits, t_state = T.prefill(cfg, tp, tb, MAX_LEN)
    _close(t_logits, j_logits)
    _state_close(t_state, j_state)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    for i in range(2):
        j_logits, j_state = JT.decode_step(jcfg, jp, j_state,
                                           jnp.asarray(tok), jnp.int32(s + i))
        with TE.using_config(TE.EngineConfig(backend=backend)):
            t_logits, t_state = T.decode_step(cfg, tp, t_state,
                                              torch.from_numpy(tok), s + i)
        _close(t_logits, j_logits)
        _state_close(t_state, j_state)
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(
            np.int32)[:, None]


def test_forward_matches_the_reference(cfgs, params):
    cfg, jcfg = cfgs
    jb, tb = _batches(*_inputs(cfg, 2, 7, seed=4))
    j_hidden, _ = JT.forward(jcfg, params[1], jb)
    _close(T.forward(cfg, params[0], tb), j_hidden)


@pytest.mark.parametrize("backend", BACKENDS)
def test_greedy_generate_tokens_equal_the_reference(cfgs, params, backend):
    cfg, jcfg = cfgs
    tp, jp = params
    jb, tb = _batches(*_inputs(cfg, 2, 6, seed=8))
    want = np.asarray(JSE.greedy_generate(jcfg, jp, jb, 6, MAX_LEN))
    with TE.using_config(TE.EngineConfig(backend=backend)):
        got = SE.greedy_generate(cfg, tp, tb, 6, MAX_LEN)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_images_beside_fp32_parameters_are_widened(cfgs, params,
                                                        backend):
    """bf16 image embeddings beside fp32 parameters: the reference's
    products promote them to fp32; the port widens them (exactly) and
    matches, on "cuda" too, whose kernels take one dtype."""
    cfg, jcfg = cfgs
    jb, tb = _batches(*_inputs(cfg, 2, 5, seed=14), jnp.bfloat16,
                      torch.bfloat16)
    j_logits, _ = JT.prefill(jcfg, params[1], jb, MAX_LEN)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_logits, _ = T.prefill(cfg, params[0], tb, MAX_LEN)
    _close(t_logits, j_logits)


def test_zero_gate_images_do_not_move_the_logits(cfgs, params):
    """At the config's gate of 0, two different images give bitwise equal
    logits and self-attention state; at GATE they differ."""
    cfg, _ = cfgs
    toks, img = _inputs(cfg, 2, 6, seed=9)
    other = np.random.default_rng(10).standard_normal(img.shape).astype(
        np.float32)
    zero = _carry(_gated(params[1], 0.0))
    for tree, equal in ((zero, True), (params[0], False)):
        out = [T.prefill(cfg, tree, {"tokens": torch.from_numpy(toks),
                                     "image_embeds": torch.from_numpy(im)},
                         MAX_LEN) for im in (img, other)]
        assert torch.equal(out[0][0], out[1][0]) == equal
        assert torch.equal(out[0][1]["groups"]["4"]["k"],
                           out[1][1]["groups"]["4"]["k"]) == equal
        assert not torch.equal(out[0][1]["groups"][CROSS]["k"],
                               out[1][1]["groups"][CROSS]["k"])


# ---------------------------------------------------------------------------
# programs: the captured op lists, full-width counts, launch/serve.py
# ---------------------------------------------------------------------------

def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec)
            for op in ops]


def _repeat_groups(ops, n_groups, n_body):
    return ops[:n_body] * n_groups + ops[n_body:]


def _two_groups(cfg):
    return dataclasses.replace(cfg, n_layers=10)


@pytest.mark.parametrize("b,s", [(1, 6), (3, 9)])
def test_op_lists_repeat_the_reference_group(cfgs, b, s):
    """A two-group variant: the port's prefill and decode programs record
    the reference's one traced group twice, then the unembedding; a cross
    layer's prefill projects the image twice (wk, wv in the attention, then
    again for the cache), its decode only wq and wo."""
    cfg, jcfg = map(_two_groups, cfgs)
    n_img, d = cfg.n_img_tokens, cfg.d_model
    max_len = s + 4

    def t_batch():
        return {"tokens": torch.empty(b, s, dtype=torch.int32, device="meta"),
                "image_embeds": torch.empty(b, n_img, d, device="meta")}

    def j_batch():
        return {"tokens": jax.ShapeDtypeStruct((b, s), jnp.int32),
                "image_embeds": jax.ShapeDtypeStruct((b, n_img, d),
                                                     jnp.float32)}

    tp = TE.trace_program(lambda p, bt: T.prefill(cfg, p, bt, max_len),
                          T.param_shapes(cfg, torch.float32), t_batch())
    jp = JE.trace_program(lambda p, bt: JT.prefill(jcfg, p, bt, max_len),
                          JT.param_shapes(jcfg), j_batch())
    body = 4 * 7 + 9
    assert len(jp.ops) == body + 1 and len(tp.ops) == 2 * body + 1
    assert _op_keys(tp.ops) == _repeat_groups(_op_keys(jp.ops), 2, body)
    cross = _op_keys(tp.ops)[21:30]
    assert [k[1][-2] for k in cross[:4]] == [s, n_img, n_img, s]
    assert [k[1][-2] for k in cross[4:6]] == [n_img, n_img]

    td = SE.decode_program(cfg, b, max_len, param_dtype=torch.float32)
    jd = JSE.decode_program(jcfg, b, max_len)
    body = 4 * 7 + 5
    assert len(td.ops) == 2 * body + 1
    assert _op_keys(td.ops) == _repeat_groups(_op_keys(jd.ops), 2, body)


def test_full_width_programs_count_the_launches():
    """llama-3.2-vision-11b at full width, captured on `meta`: a decode
    step records 32 x 7 + 8 x 5 + 1 = 265 GEMMs, a 1,100-token prefill 32 x
    7 + 8 x 9 + 1 = 297, the untied lm_head (4096, 128256) the last of
    each."""
    cfg = get_config("llama32_vision_11b")
    dec = SE.decode_program(cfg, 4, 1124)
    assert [op.kind for op in dec.ops] == ["dense"] * 265
    batch = {"tokens": torch.empty(4, 1100, dtype=torch.int32),
             "image_embeds": torch.empty(4, 1601, 4096,
                                         dtype=torch.bfloat16)}
    pre = LS.prefill_program(cfg, batch, 1124, torch.bfloat16)
    assert [op.kind for op in pre.ops] == ["dense"] * 297
    for prog in (dec, pre):
        assert tuple(prog.ops[-1].w_shape) == (4096, 128256)
    kv = [op for op in pre.ops if tuple(op.x_shape)[-2:] == (1601, 4096)]
    assert len(kv) == 8 * 4


@pytest.mark.parametrize("arch", ["smollm-135m", "xlstm-125m",
                                  "granite-moe-1b",
                                  "llama-3.2-vision-11b"])
def test_launch_serve_main_matches_greedy_generate(arch, capsys):
    """`main(--reduced --device cpu)` for every ported LM config: its
    tokens equal `greedy_generate` on the same parameters and inputs, and
    it prints what the reference prints."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "5", "--gen", "4", "--seed", "3"]
    got = LS.main(argv)
    cfg = reduced(arch)
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = LS.make_batch(cfg, 2, 5, 3, "cpu")
    assert batch["tokens"].dtype == torch.int32
    if cfg.n_img_tokens:
        assert batch["image_embeds"].dtype == torch.bfloat16
    with TE.using_config(TE.EngineConfig(backend="cuda")):
        want = SE.greedy_generate(cfg, params, batch, 4, 5 + 4 + 8)
    assert tuple(got.shape) == (2, 4) and torch.equal(got, want)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={cfg.name} batch=2 prompt=5 gen=4"
    assert out[1].startswith("prefill: ")
    assert out[2].startswith("decode:  ") and out[3] == "sample generations:"


def test_launch_serve_refuses_a_missing_gpu(monkeypatch):
    """The default device is the GPU; without one `main` raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        LS.main(["--arch", "smollm-135m", "--reduced"])


def test_launch_serve_records_each_step(cfgs):
    cfg = cfgs[0]
    params = T.init_params(cfg, seed=1, device="cpu")
    batch = LS.make_batch(cfg, 2, 4, 1, "cpu")
    record = []
    toks, t_pre, t_dec = LS.generate(cfg, params, batch, 3, record=record)
    assert len(record) == 3 and t_pre > 0 and t_dec > 0
    assert all(r.dtype == torch.float32 and tuple(r.shape) == (2, 512)
               for r in record)
    assert torch.equal(torch.stack([r.argmax(-1) for r in record], 1), toks)


# ---------------------------------------------------------------------------
# the config's bf16 parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_prefill_and_decode_within_the_bf16_limits(cfgs, backend):
    """The reference's default bf16 parameters (gate set to GATE) and bf16
    images: logits within 1e-5 of the exact-jitted reference and 2e-2 of
    its default jit, the bf16 state bitwise."""
    cfg, jcfg = cfgs
    jp = _gated(JT.init_params(jcfg, jax.random.PRNGKey(0)))
    assert {str(a.dtype) for a in jax.tree_util.tree_leaves(jp)} \
        == {"bfloat16"}
    tp = _carry(jp)
    jb, tb = _batches(*_inputs(cfg, 2, 7, seed=12), jnp.bfloat16,
                      torch.bfloat16)

    def jprefill(p, bt):
        return JT.prefill(jcfg, p, bt, MAX_LEN)

    j_logits, j_state = exact_jit(jprefill)(jp, jb)
    j_default, _ = jax.jit(jprefill)(jp, jb)
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_logits, t_state = T.prefill(cfg, tp, tb, MAX_LEN)
    _close(t_logits, j_logits)
    _close(t_logits, j_default, LOGITS_TOL)
    _state_bitwise(t_state, j_state)
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    j_logits, j_state = exact_jit(lambda p, st, t: JT.decode_step(
        jcfg, p, st, t, jnp.int32(7)))(jp, j_state, jnp.asarray(tok))
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_logits, t_state = T.decode_step(cfg, tp, t_state,
                                          torch.from_numpy(tok), 7)
    _close(t_logits, j_logits)
    _state_bitwise(t_state, j_state)

