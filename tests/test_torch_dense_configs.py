"""The reference's last two dense configs on the port, against the JAX
package: gemma3-27b (five local layers of window 1,024 at rope theta 1e4,
then a global one at 1e6, ten times over, then two local remainder
layers; qk-norm, softcap-free) and qwen3-32b (64 global layers, GQA groups
of 8 query heads, qk-norm, an untied lm_head).

On the CPU, with the reduced configs and the reference's fp32 parameters
carried across by `params_from_jax`, on both of the port's backends:

  * every config field equals the reference's; the full-width parameter
    shapes and counts on `meta` equal JAX's `param_shapes`;
  * `attention_forward` on local and global layers, dense and chunked,
    and `chunked_attention` at fp32 with GQA, a window, a softcap and a q
    offset, within 1e-5 x max|out| of JAX;
  * prefill logits within 1e-5 of JAX's and the bf16 state within one bf16
    step of each element (the remainder's leaves included);
  * teacher-forced decode logits within 1e-5 on an fp32 state
    (`state_dtype`); on the default bf16 state, the state within one bf16
    step. qk-norm makes a key's fp32 sums meet a bf16 rounding tie more
    often, so one key element in a few thousand rounds the other way, and
    the logits drift from there (about 1e-4 within five steps): on a bf16
    state the logits are not held at 1e-5;
  * a negative control: the global theta on gemma3's local layers breaks
    the match;
  * `PagedLayout` specs equal the reference's, the remainder's included;
    served tokens bitwise across solo, drain and continuous, equal to
    `greedy_generate` and to the JAX `ContinuousScheduler`'s;
  * `launch/serve.py` for both archs, and the full-depth decode and
    prefill programs on `meta`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import attention as JA
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs import base
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.launch import serve as LS
from repro_torch.models import attention as TA
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import PagedLayout
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("cuda", "torch")
ARCHS = ("gemma3-27b", "qwen3-32b")
SERVING = TE.EngineConfig(row_align=8)
# (layers at full depth, their parameters; layers the card serves, theirs)
COUNTS = {"gemma3-27b": (62, 27_009_002_240, 8, 4_712_480_000),
          "qwen3-32b": (64, 32_762_123_264, 4, 3_506_223_104)}
# (b, sq, skv, h, kv, d, causal, window, softcap, q_offset, q_chunk,
# kv_chunk): GQA groups of 1, 2 and 8, windows under and over a chunk,
# softcaps, q offsets at Sq < Skv, ragged chunks of both lengths
CHUNKED_CASES = [
    (1, 37, 37, 2, 2, 16, True, 0, 0.0, 0, 8, 16),
    (2, 40, 40, 8, 1, 16, True, 9, 50.0, 0, 16, 8),
    (1, 21, 70, 4, 2, 8, True, 30, 0.0, 49, 8, 32),
    (1, 30, 55, 16, 2, 16, False, 12, 30.0, 20, 16, 16),
    (2, 50, 50, 8, 2, 16, True, 0, 50.0, 0, 50, 50),
]
# served requests (prompt, steps), two prompt lengths a max_len (each
# length is one compile in either package): at max_len 64 the prompts past
# the reduced window (16) wrap gemma3's rings at prefill, the first while
# decoding
WORK = {64: [((3, 1, 4, 1, 5), 14), ((9, 2, 6) * 7, 6), ((2, 7, 1, 8, 2), 3),
             ((1, 1, 2, 3, 5, 8) * 3 + (1, 1, 2), 8)],
        8: [((3, 1, 4), 5), ((9, 2, 6), 4), ((2, 7, 1, 8, 2), 3)]}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, port config, JAX config, port fp32 parameters, JAX's): the
    reference's fp32 parameters from its own seed, carried across."""
    cfg = base.reduced(request.param)
    jcfg = jax_base.reduced(request.param)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return request.param, cfg, jcfg, tp, jp


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err
    return err


def _bf16_steps(got, want):
    """Each element of bf16 `got` within one bf16 step of bf16 `want` (the
    step at the larger magnitude)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    mag = np.maximum(np.abs(g), np.abs(w))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(g - w) <= step).all(), np.abs(g - w).max()


def _state_close(tstate, jstate, fp32):
    """Every leaf of the decode state, the remainder's too: within 1e-5 of
    JAX's in fp32, within one bf16 step in bf16."""
    t = layers.tree_leaves(tstate)
    j = jax.tree_util.tree_leaves(jstate)
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert a.dtype == (torch.float32 if fp32 else torch.bfloat16)
        if fp32:
            _close(a, b)
        else:
            _bf16_steps(a, b)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies_of_the_reference(arch):
    for load in ("get_config", "reduced"):
        got = getattr(base, load)(arch)
        want = getattr(jax_base, load)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.layer_kinds == want.layer_kinds
        assert got.qk_norm
    assert arch.replace("-", "_") in base.PORTED
    assert base.ALIASES[arch] == jax_base.ALIASES[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes_equal_the_reference(arch):
    """Full depth, and the depth the card serves (gemma3: one group and
    the remainder; qwen3: four layers), leaf by leaf on `meta`."""
    cfg, jcfg = base.get_config(arch), jax_base.get_config(arch)
    full, n_full, cut, n_cut = COUNTS[arch]
    assert cfg.n_layers == full
    for n_layers, total in ((full, n_full), (cut, n_cut)):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        jc = dataclasses.replace(jcfg, n_layers=n_layers)
        t = layers.tree_leaves(T.param_shapes(c))
        j = jax.tree_util.tree_leaves(JT.param_shapes(jc))
        assert [tuple(a.shape) for a in t] == [a.shape for a in j]
        assert {a.device.type for a in t} == {"meta"}
        assert {a.dtype for a in t} == {torch.bfloat16}
        assert layers.count_params(T.model_defs(c)) == \
            jax_layers.count_params(JT.model_defs(jc)) == total
    rem = T.param_shapes(cfg)["rem"]
    assert sorted(rem) == (["0", "1"] if arch == "gemma3-27b" else [])


def test_rope_theta_and_qk_norm_follow_the_reference():
    """gemma3's local layers rotate at theta 1e4, its global ones at 1e6;
    qwen3's every layer at 1e6; both carry a q and a k norm of head_dim."""
    g3, q3 = base.get_config("gemma3-27b"), base.get_config("qwen3-32b")
    assert TA._rope_theta(g3, LOCAL_ATTN) == 10_000.0
    assert TA._rope_theta(g3, GLOBAL_ATTN) == 1_000_000.0
    assert TA._rope_theta(q3, GLOBAL_ATTN) == 1_000_000.0
    assert g3.layer_kinds.count(LOCAL_ATTN) == 52
    assert g3.layer_kinds[5::6][:10] == (GLOBAL_ATTN,) * 10
    for cfg in (g3, q3):
        defs = TA.attention_defs(cfg, cfg.layer_kinds[0])
        assert defs["q_norm"].shape == defs["k_norm"].shape == (128,)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(CHUNKED_CASES)))
def test_chunked_attention_matches_the_reference(case):
    """fp32, within 1e-5 of the reference's `chunked_attention` at the same
    chunks, and of the port's `dense_attention`."""
    b, sq, skv, h, kv, d, causal, window, cap, off, qc, kc = \
        CHUNKED_CASES[case]
    q, k, v = (_rand(s, 10 * case + i) for i, s in enumerate(
        ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))))
    kw = dict(causal=causal, window=window, softcap_val=cap, q_offset=off)
    want = JA.chunked_attention(*map(jnp.asarray, (q, k, v)), q_chunk=qc,
                                kv_chunk=kc, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TA.chunked_attention(tq, tk, tv, q_chunk=qc, kv_chunk=kc, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, sq, h, d)
    _close(got, want)
    _close(got, TA.dense_attention(tq, tk, tv, **kw).numpy())


@pytest.mark.parametrize("s", [12, 1030])
def test_attention_forward_dense_and_chunked(model, s):
    """Layer 0 (local in gemma3, global in qwen3) and gemma3's global
    layer 5: qk-norm, the layer's theta, dense at 12 tokens and chunked at
    1,030, on both backends, within 1e-5 of JAX; k too."""
    arch, cfg, jcfg, tp, jp = model
    x = _rand((1, s, cfg.d_model), 7)
    pos = np.arange(s, dtype=np.int32)[None]
    for j in ("0", "5") if arch == "gemma3-27b" else ("0",):
        kind = cfg.pattern[int(j)]
        jo, (jk, _) = JA.attention_forward(
            jcfg, jax.tree_util.tree_map(lambda a: a[0],
                                         jp["groups"][j]["attn"]),
            jnp.asarray(x), jnp.asarray(pos), kind)
        for backend in BACKENDS:
            with TE.using_backend(backend):
                to, (tk, _) = TA.attention_forward(
                    cfg, {n: a[0] for n, a in tp["groups"][j]["attn"].items()},
                    torch.from_numpy(x), torch.from_numpy(pos), kind)
            _close(to, jo)
            _close(tk, jk)


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [64, 16])
def test_prefill_matches_the_reference(model, max_len):
    """Prompts of 5 and 16 or 20 tokens (past gemma3's reduced window):
    logits within 1e-5, every state leaf (the remainder's rings too)
    within one bf16 step of JAX's, on both backends."""
    arch, cfg, jcfg, tp, jp = model
    for s in (5, 20) if max_len >= 20 else (5, 16):
        toks = _prompts(cfg, 2, s, seed=s)
        jl, js = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len)
        for backend in BACKENDS:
            with TE.using_backend(backend):
                tl, ts = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
                    toks)}, max_len)
            _close(tl, jl)
            _state_close(ts, js, fp32=False)
    if arch == "gemma3-27b":
        assert tuple(ts["rem"]["1"]["k"].shape) == (2, min(max_len, 16), 2,
                                                    16)
        assert ts["rem"]["1"]["k"].abs().sum() > 0


@pytest.mark.parametrize("max_len", [64])
def test_decode_on_an_fp32_state_matches_the_reference(model, max_len):
    """Prefill 3 tokens, then teacher-forced decode at per-row positions up
    to 40 (gemma3's 16-slot rings wrap twice), both packages on an fp32
    state: every step's logits and the final state within 1e-5 of JAX's,
    on both backends."""
    arch, cfg, jcfg, tp, jp = model
    toks = _prompts(cfg, 2, 3, seed=1)
    j_logits, j_state = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   max_len, state_dtype=jnp.float32)
    states = {}
    for backend in BACKENDS:
        with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)):
            states[backend] = T.prefill(
                cfg, tp, {"tokens": torch.from_numpy(toks)}, max_len,
                state_dtype=torch.float32)[1]
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk, ps))
    for p in range(3, 40):
        pos = np.asarray([p, p + 1], np.int32)
        j_logits, j_state = step(j_state, jnp.asarray(tok), jnp.asarray(pos))
        for backend in BACKENDS:
            conf = TE.EngineConfig(backend=backend, row_align=8)
            with TE.using_config(conf):
                t_logits, states[backend] = T.decode_step(
                    cfg, tp, states[backend], torch.from_numpy(tok),
                    torch.from_numpy(pos))
            _close(t_logits, j_logits)
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(
            np.int32)[:, None]
    for st in states.values():
        _state_close(st, j_state, fp32=True)


def test_decode_keeps_the_bf16_state_within_one_step(model):
    """The default bf16 state, teacher-forced for 12 steps from a 5-token
    prefill: every leaf within one bf16 step of JAX's after each step, on
    both backends."""
    arch, cfg, jcfg, tp, jp = model
    toks = _prompts(cfg, 2, 5, seed=2)
    j_logits, j_state = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   32)
    states = {}
    for backend in BACKENDS:
        with TE.using_backend(backend):
            states[backend] = T.prefill(
                cfg, tp, {"tokens": torch.from_numpy(toks)}, 32)[1]
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk, ps))
    for p in range(5, 17):
        j_logits, j_state = step(j_state, jnp.asarray(tok), jnp.int32(p))
        for backend in BACKENDS:
            with TE.using_backend(backend):
                _, states[backend] = T.decode_step(
                    cfg, tp, states[backend], torch.from_numpy(tok), p)
            _state_close(states[backend], j_state, fp32=False)
        tok = np.asarray(jnp.argmax(j_logits[:, -1], -1)).astype(
            np.int32)[:, None]


def test_global_theta_on_local_layers_breaks_the_match():
    """The negative control: gemma3 with its local layers at the global
    theta (`rope_theta_local` unset) leaves JAX's logits by far more than
    the tolerance, so the prefill hold sees the theta."""
    cfg, jcfg = base.reduced("gemma3-27b"), jax_base.reduced("gemma3-27b")
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    toks = _prompts(cfg, 2, 12, seed=3)
    jl, _ = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, 32)
    tl, _ = T.prefill(cfg, tp, {"tokens": torch.from_numpy(toks)}, 32)
    _close(tl, jl)
    wrong = dataclasses.replace(cfg, rope_theta_local=0.0)
    assert TA._rope_theta(wrong, LOCAL_ATTN) == 1_000_000.0
    bad, _ = T.prefill(wrong, tp, {"tokens": torch.from_numpy(toks)}, 32)
    err = np.abs(bad.numpy() - np.asarray(jl)).max() / np.abs(
        np.asarray(jl)).max()
    assert err > 100 * TOL, err


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_paged_layout_specs_equal_the_reference(model):
    """gemma3's rings, the remainder's two among them, are slot stores
    where they do not grow with max_len (64, 16) and paged where they do
    (8); the global leaves are paged, and every qwen3 leaf is."""
    arch, cfg, jcfg, _, _ = model
    for max_len, ring_paged in ((64, False), (16, False), (8, True)):
        got = PagedLayout.build(cfg, max_len=max_len, block_size=8,
                                num_blocks=24)
        want = jax_kv.PagedLayout.build(jcfg, max_len=max_len, block_size=8,
                                        num_blocks=24)
        t = layers.tree_leaves(got.specs)
        j = jax.tree_util.tree_leaves(
            want.specs, is_leaf=lambda x: hasattr(x, "len_ax"))
        assert [dataclasses.astuple(a) for a in t] == \
            [dataclasses.astuple(a) for a in j]
        if arch == "gemma3-27b":
            for leaf in (got.specs["groups"]["0"]["k"],
                         got.specs["rem"]["0"]["v"],
                         got.specs["rem"]["1"]["k"]):
                assert leaf.paged is ring_paged
            assert got.specs["groups"]["5"]["k"].paged
        else:
            assert got.specs["rem"] == {}
            assert all(a.paged for a in t)


@pytest.mark.parametrize("max_len", [64, 8])
def test_tokens_bitwise_across_modes_and_equal_jax(model, max_len):
    """Solo, drain and continuous serve bitwise the same tokens, equal to
    the port's `greedy_generate` and to the JAX `ContinuousScheduler`'s."""
    arch, cfg, jcfg, tp, jp = model
    work = WORK[max_len]
    # one decode bucket: one compile of JAX's decode step (its rows are
    # the same at every bucket; the port's modes run their own buckets)
    js = JaxScheduler(jcfg, jp, max_len=max_len, num_blocks=24, block_size=8,
                      max_batch=4, buckets=(4,))
    jt = [js.submit(list(p), n) for p, n in work]
    js.run()
    want = [t.tokens for t in jt]
    programs = ({}, {})              # compiled once, shared by the modes
    for mode, max_batch in (("solo", 1), ("drain", 4), ("continuous", 4)):
        s = ContinuousScheduler(
            cfg, tp, max_len=max_len, num_blocks=24, block_size=8,
            max_batch=max_batch,
            admission="drain" if mode == "drain" else "continuous")
        s._prefill, s._decode = programs
        tickets = [s.submit(list(p), n) for p, n in work]
        s.run()
        assert [t.status for t in tickets] == ["done"] * len(work)
        assert [t.tokens for t in tickets] == want, mode
    for (prompt, steps), toks in zip(work, want):
        with TE.using_config(SERVING):
            dense = SE.greedy_generate(cfg, tp, {"tokens": torch.tensor(
                [list(prompt)])}, steps, max_len)
        assert dense[0].tolist() == toks


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_serve_runs_the_arch(arch, capsys):
    """`launch/serve.py --arch <arch> --reduced --device cpu`: its tokens
    equal `greedy_generate` on the same weights and inputs."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "18", "--gen", "4", "--seed", "3"]
    got = LS.main(argv)
    cfg = base.reduced(arch)
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = LS.make_batch(cfg, 2, 18, 3, "cpu")
    with TE.using_config(TE.EngineConfig(backend="cuda")):
        want = SE.greedy_generate(cfg, params, batch, 4, 18 + 4 + 8)
    assert tuple(got.shape) == (2, 4) and torch.equal(got, want)
    assert capsys.readouterr().out.startswith(
        f"arch={cfg.name} batch=2 prompt=18 gen=4")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_programs_on_meta(arch):
    """Full width and depth, captured on `meta`: a decode step and a
    prefill record 62 x 7 + 1 = 435 (gemma3) or 64 x 7 + 1 = 449 (qwen3)
    GEMMs, the unembedding the last (gemma3's tied (262144, 5376) table,
    qwen3's (5120, 151936) lm_head); gemma3's remainder rings are 1,024
    slots beside 2,560 global ones."""
    cfg = base.get_config(arch)
    n, max_len, prompt = ((435, 2560, 2500) if arch == "gemma3-27b"
                          else (449, 1152, 1100))
    dec = SE.decode_program(cfg, 8, max_len)
    pre = SE.prefill_program(cfg, 1, prompt, max_len=max_len)
    last = (262144, 5376) if arch == "gemma3-27b" else (5120, 151936)
    for prog in (dec, pre):
        assert [op.kind for op in prog.ops] == ["dense"] * n
        assert tuple(prog.ops[-1].w_shape) == last
    shapes = SE.decode_state_shapes(cfg, 1, max_len)
    if arch == "gemma3-27b":
        assert tuple(shapes["groups"]["0"]["k"].shape) == (10, 1, 1024, 16,
                                                           128)
        assert tuple(shapes["groups"]["5"]["k"].shape) == (10, 1, 2560, 16,
                                                           128)
        for j in ("0", "1"):
            assert tuple(shapes["rem"][j]["v"].shape) == (1, 1024, 16, 128)
    else:
        assert tuple(shapes["groups"]["0"]["k"].shape) == (64, 1, 1152, 8,
                                                           128)
        assert shapes["rem"] == {}
