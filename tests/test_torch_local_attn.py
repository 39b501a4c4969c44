"""Local (sliding-window) attention on the port, against the JAX package.

gemma2-27b alternates sliding-window layers (window 4,096) with global
ones and caps the attention logits at 50. On the CPU:

  * the flash kernels' plain version with a window, a softcap and a query
    offset (the kernels' own tiles, from the band's first one) within 1e-5
    x max|out| of `flash_attention_jnp` and `dense_attention` on fp32
    inputs, and within one bf16 step of them element by element on bf16
    inputs (each output rounds once to bf16 from fp32 sums in other
    orders); the wrapper's CPU, `meta` and refusal branches, and its CUDA
    branch with the library faked (the C argument order, the counters);
  * the reduced gemma2 config with the reference's fp32 parameters
    (`params_from_jax`): `attention_forward` on local layers dense and
    chunked, prefill logits within 1e-5 of JAX and the bf16 state (the
    ring's rolled tail included) within one bf16 step, teacher-forced
    decode across the ring's wrap, `PagedLayout` specs, and served tokens
    bitwise across solo, drain and continuous, equal to `greedy_generate`
    and to the JAX `ContinuousScheduler`'s;
  * the full-width config on `meta`: parameter shapes and counts, and the
    46-layer prefill and decode programs' GEMMs.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.models import attention as JA
from repro.models import layers as jax_layers
from repro.models import transformer as JT
from repro.models.flash import flash_attention_jnp
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs import base
from repro_torch.configs.base import GLOBAL_ATTN, LOCAL_ATTN
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as LS
from repro_torch.models import attention as TA
from repro_torch.models import flash as TF
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import PagedLayout
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("cuda", "torch")
SERVING = TE.EngineConfig(row_align=8)
# (b, sq, skv, h, kv, d, causal, window, softcap, q_offset): a window under
# a kv tile, one that is no multiple of a tile, one >= Skv, q_offset > 0 at
# Sq < Skv (with and without a window), GQA, a window without causal
# masking, and gemma2's softcap on most of them
FLASH_CASES = [
    (1, 100, 100, 2, 1, 16, True, 20, 0.0, 0),
    (1, 300, 300, 4, 2, 32, True, 100, 50.0, 0),
    (2, 70, 70, 2, 2, 8, True, 128, 30.0, 0),
    (1, 40, 170, 4, 2, 16, True, 0, 0.0, 130),
    (1, 40, 170, 4, 2, 16, True, 50, 50.0, 130),
    (1, 129, 129, 8, 2, 16, True, 64, 50.0, 0),
    (1, 50, 90, 2, 1, 16, False, 30, 0.0, 0),
]
# served requests (prompt, steps) for a pool of max_len 64: prompts past the
# reduced window (16) wrap the ring at prefill, the others while decoding
WORK = {64: [((3, 1, 4, 1, 5), 20), ((9, 2, 6) * 7, 12), ((2, 7, 1, 8), 3),
             ((1, 1, 2, 3, 5, 8) * 3, 24)],
        8: [((3, 1, 4), 5), ((9, 2), 4), ((2, 7, 1, 8, 2), 3)]}


@pytest.fixture(scope="module")
def cfgs():
    return base.reduced("gemma2-27b"), jax_base.reduced("gemma2-27b")


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


def _bf16_steps(got, want):
    """Each element of bf16 `got` within one bf16 step of bf16 `want` (the
    step at the larger magnitude)."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    mag = np.maximum(np.abs(g), np.abs(w))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert (np.abs(g - w) <= step).all(), np.abs(g - w).max()


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _prompts(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_config_is_a_copy_of_the_reference():
    for load in ("get_config", "reduced"):
        got = getattr(base, load)("gemma2-27b")
        want = getattr(jax_base, load)("gemma2-27b")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert "gemma2_27b" in base.PORTED
    assert base.get_config("gemma2-27b").layer_kinds[:2] == (LOCAL_ATTN,
                                                            GLOBAL_ATTN)


def test_full_width_param_shapes_equal_the_reference():
    """46 layers (27,227,128,320 parameters) and the 4 that the card
    serves (3,444,650,496), leaf by leaf."""
    cfg, jcfg = base.get_config("gemma2_27b"), jax_base.get_config(
        "gemma2_27b")
    for n_layers, total in ((46, 27_227_128_320), (4, 3_444_650_496)):
        c = dataclasses.replace(cfg, n_layers=n_layers)
        jc = dataclasses.replace(jcfg, n_layers=n_layers)
        t = layers.tree_leaves(T.param_shapes(c))
        j = jax.tree_util.tree_leaves(JT.param_shapes(jc))
        assert [tuple(a.shape) for a in t] == [a.shape for a in j]
        assert {a.dtype for a in t} == {torch.bfloat16}
        assert layers.count_params(T.model_defs(c)) == \
            jax_layers.count_params(JT.model_defs(jc)) == total


def test_params_from_jax_carries_gemma2(cfgs, params):
    """fp32 and bf16 trees cross bit for bit; the (1 + w) norms start at
    zero."""
    tp, jp = params
    for tree, jtree in ((tp, jp), (T.params_from_jax(
            jax.tree_util.tree_map(lambda a: np.asarray(a.astype(
                jnp.bfloat16)), jp), device="cpu"), jp)):
        for a, b in zip(layers.tree_leaves(tree),
                        jax.tree_util.tree_leaves(jtree)):
            want = np.asarray(b.astype(jnp.float32) if a.dtype ==
                              torch.float32 else b.astype(jnp.bfloat16))
            assert tuple(a.shape) == want.shape
            if a.dtype == torch.bfloat16:
                assert np.array_equal(a.view(torch.int16).numpy(),
                                      want.view(np.int16))
            else:
                assert np.array_equal(a.numpy(), want)
    assert not bool(tp["groups"]["0"]["pre_scale"].any())


# ---------------------------------------------------------------------------
# the flash kernels' plain version and wrapper
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_flash_matches_the_jax_attention(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    for i, (b, sq, skv, h, kv, d, causal, window, cap, off) in \
            enumerate(FLASH_CASES):
        q, k, v = (_rand(s, 10 * i + j) for j, s in enumerate(
            ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d))))
        jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
        kw = dict(causal=causal, window=window, softcap_val=cap, q_offset=off)
        wants = (flash_attention_jnp(jq, jk, jv, **kw),
                 JA.dense_attention(jq, jk, jv, **kw))
        tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                      .to(dtype) for a in (jq, jk, jv))
        got = FA.flash_attention_plain(tq, tk, tv, causal=causal,
                                       window=window, softcap=cap,
                                       q_offset=off)
        assert got.dtype == dtype
        for want in wants:
            if dtype == torch.float32:
                _close(got, want)
            else:
                _bf16_steps(got, want)


def test_wrapper_branches_and_refusals():
    """CPU tensors get the plain version (no launch counted), `meta` ones
    an allocation; a shape where some row sees no key raises ValueError,
    on every device."""
    q, k, v = (torch.from_numpy(_rand(s, 3)) for s in
               ((1, 40, 4, 16), (1, 170, 2, 16), (1, 170, 2, 16)))
    counters = (FA.flash_attention, FA.flash_attention_bf16,
                FA.flash_attention_local, FA.flash_attention_bf16_local)
    before = [c.launches for c in counters]
    kw = dict(causal=True, window=50, softcap=50.0, q_offset=130)
    got = FA.flash_attention(q, k, v, **kw)
    assert torch.equal(got, FA.flash_attention_plain(q, k, v, **kw))
    assert [c.launches for c in counters] == before
    meta = FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"), **kw)
    assert meta.device.type == "meta" and meta.shape == q.shape
    for bad in (dict(causal=True, q_offset=-1),
                dict(causal=True, window=8, q_offset=170),
                dict(causal=False, window=5, q_offset=140),
                dict(causal=True, window=-1)):
        for dev in ("cpu", "meta"):
            with pytest.raises(ValueError, match="window|sees"):
                FA.flash_attention(q.to(dev), k.to(dev), v.to(dev), **bad)
    # the last row's band starts at key 169: one key left, still accepted
    FA.flash_attention(q, k, v, causal=False, window=2, q_offset=130)


class _NullContext:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_faked_launch_passes_the_band_and_counts_local(monkeypatch, dtype):
    """`flash_attention`'s CUDA branch (library, device and stream faked):
    window, softcap and q_offset go to the entry of q's dtype after the
    causal flag, in the C signature's order; a launch counts on the
    `_local` counter of its dtype only when 0 < window < Skv."""
    calls = []

    def fake_library(name):
        def fn(*args):
            calls.append((name, args))
            return 0
        return types.SimpleNamespace(**{name: fn},
                                     repro_cuda_error_string=lambda e: b"")

    monkeypatch.setattr(build, "library", fake_library)
    monkeypatch.setattr(FA, "_launcher", FA._launcher.__wrapped__)
    monkeypatch.setattr(FA, "_launcher_bf16", FA._launcher_bf16.__wrapped__)
    monkeypatch.setattr(torch.cuda, "device", lambda _: _NullContext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=7))
    is32 = dtype == torch.float32
    main = FA.flash_attention if is32 else FA.flash_attention_bf16
    local = FA.flash_attention_local if is32 else FA.flash_attention_bf16_local
    other = FA.flash_attention_bf16_local if is32 else FA.flash_attention_local
    q = torch.zeros((1, 4500, 32, 128), dtype=dtype)
    k = torch.zeros((1, 4500, 16, 128), dtype=dtype)
    for window, counted in ((4096, 1), (4500, 0), (0, 0), (512, 1)):
        before = (main.launches, local.launches, other.launches)
        FA._launch(q, k, k, torch.empty_like(q), True, 0.1, window, 50.0, 0)
        name, args = calls[-1]
        assert name == ("flash_attention" if is32 else "flash_attention_bf16")
        assert args[4:15] == (1, 4500, 4500, 32, 16, 128, pytest.approx(0.1),
                              1, window, 50.0, 0)
        assert len(args) == len(FA.ARGTYPES) and args[-1] == 7
        assert (main.launches, local.launches, other.launches) == (
            before[0] + 1, before[1] + counted, before[2])
    FA._launch(q[:, :40], k[:, :170], k[:, :170], torch.empty_like(q[:, :40]),
               True, None, 50, 0.0, 130)
    assert calls[-1][1][4:15] == (1, 40, 170, 32, 16, 128,
                                  pytest.approx(128 ** -0.5), 1, 50, 0.0, 130)


def test_cuda_backend_sends_every_argument_to_the_wrapper():
    """`models/flash.py` on "cuda": the window, the softcap and the q
    offset reach the wrapper (its CPU branch here: the plain version, no
    launch counted), within 1e-5 of the "torch" path's chunks."""
    q, k, v = (torch.from_numpy(_rand(s, 5)) for s in
               ((1, 300, 4, 32), (1, 330, 2, 32), (1, 330, 2, 32)))
    counters = (FA.flash_attention, FA.flash_attention_local)
    before = [c.launches for c in counters]
    kw = dict(causal=True, window=100, softcap_val=50.0, q_offset=30)
    with TE.using_backend("cuda"):
        got = TF.flash_attention(q, k, v, **kw)
    assert [c.launches for c in counters] == before
    assert torch.equal(got, FA.flash_attention_plain(
        q, k, v, causal=True, window=100, softcap=50.0, q_offset=30))
    with TE.using_backend("torch"):
        _close(got, TF.flash_attention(q, k, v, **kw).numpy())


# ---------------------------------------------------------------------------
# the model: attention, prefill, decode across the ring's wrap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [12, 1030])
def test_attention_forward_on_local_layers(cfgs, params, s):
    """A local layer's attention (layer 0) dense at 12 tokens and chunked
    at 1030, on both backends, within 1e-5 of JAX; its kv unchanged."""
    cfg, jcfg = cfgs
    tp, jp = params
    x = _rand((1, s, cfg.d_model), 7)
    pos = np.arange(s, dtype=np.int32)[None]
    jo, (jk, _) = JA.attention_forward(
        jcfg, jax.tree_util.tree_map(lambda a: a[0], jp["groups"]["0"]["attn"]),
        jnp.asarray(x), jnp.asarray(pos), LOCAL_ATTN)
    for backend in BACKENDS:
        with TE.using_backend(backend):
            to, (tk, _) = TA.attention_forward(
                cfg, {n: a[0] for n, a in tp["groups"]["0"]["attn"].items()},
                torch.from_numpy(x), torch.from_numpy(pos), LOCAL_ATTN)
        _close(to, jo)
        _close(tk, jk)


@pytest.mark.parametrize("max_len", [64, 16])
def test_prefill_matches_the_reference(cfgs, params, max_len):
    """Prompts shorter than the ring (5) and longer (20: its tail kept,
    rolled by 20 % 16): logits within 1e-5, every state leaf within one
    bf16 step of JAX's."""
    cfg, jcfg = cfgs
    tp, jp = params
    for s in (5, 20) if max_len >= 20 else (5, 16):
        toks = _prompts(cfg, 2, s, seed=s)
        jl, js = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len)
        for backend in BACKENDS:
            with TE.using_backend(backend):
                tl, ts = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
                    toks)}, max_len)
            _close(tl, jl)
            for j in ("0", "1"):
                for leaf in ("k", "v"):
                    got, want = ts["groups"][j][leaf], js["groups"][j][leaf]
                    assert got.dtype == torch.bfloat16
                    assert tuple(got.shape) == want.shape
                    _bf16_steps(got, want)
        assert ts["groups"]["0"]["k"].shape[2] == min(max_len, 16)


def test_prefill_keeps_the_rings_tail_rolled(cfgs, params):
    """After a 20-token prefill the 16-slot ring holds position p at slot
    p % 16 for p = 4..19: the keys the prefill's own attention computed."""
    cfg, _ = cfgs
    tp, _ = params
    toks = torch.from_numpy(_prompts(cfg, 1, 20, seed=9))
    _, st = T.prefill(cfg, tp, {"tokens": toks}, 64)
    x, positions, _ = T.embed_inputs(cfg, tp, {"tokens": toks})
    p0 = {n: a[0] for n, a in tp["groups"]["0"].items()
          if not isinstance(a, dict)}
    h = T._apply_norm(cfg, p0, "pre", x)
    _, (k, v) = TA.attention_forward(
        cfg, {n: a[0] for n, a in tp["groups"]["0"]["attn"].items()}, h,
        positions, LOCAL_ATTN)
    ring = st["groups"]["0"]
    for p in range(4, 20):
        assert torch.equal(ring["k"][0, 0, p % 16], k[0, p].to(torch.bfloat16))
        assert torch.equal(ring["v"][0, 0, p % 16], v[0, p].to(torch.bfloat16))


@pytest.mark.parametrize("max_len", [64, 16])
def test_decode_across_the_ring_wrap(cfgs, params, max_len):
    """Prefill 3 tokens, then teacher-forced decode at per-row positions up
    to 40 (the ring of 16 wraps twice at max_len 64; at 16 the global
    cache ends at 15): every step's logits within 1e-5 of JAX's, the bf16
    state within one bf16 step, on both backends."""
    cfg, jcfg = cfgs
    tp, jp = params
    toks = _prompts(cfg, 2, 3, seed=1)
    j_logits, j_state = JT.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                   max_len)
    states = {}
    for backend in BACKENDS:
        with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)):
            states[backend] = T.prefill(cfg, tp, {"tokens": torch.from_numpy(
                toks)}, max_len)[1]
    tok = np.asarray(jnp.argmax(j_logits, -1)).astype(np.int32)[:, None]
    step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk, ps))
    for p in range(3, min(max_len - 1, 40)):
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
        for j in ("0", "1"):
            for leaf in ("k", "v"):
                _bf16_steps(st["groups"][j][leaf], j_state["groups"][j][leaf])


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_paged_layout_specs_equal_the_reference(cfgs):
    """The ring is a slot store where it does not grow with max_len (64,
    16) and paged where it does (8 <= window / 2); the global leaves are
    paged."""
    cfg, jcfg = cfgs
    for max_len, ring_paged in ((64, False), (16, False), (8, True)):
        got = PagedLayout.build(cfg, max_len=max_len, block_size=8,
                                num_blocks=24)
        want = jax_kv.PagedLayout.build(jcfg, max_len=max_len, block_size=8,
                                        num_blocks=24)
        t = layers.tree_leaves(got.specs)
        j = jax.tree_util.tree_leaves(
            want.specs, is_leaf=lambda x: hasattr(x, "len_ax"))
        assert [tuple(dataclasses.astuple(a)) for a in t] == \
            [tuple(dataclasses.astuple(a)) for a in j]
        assert got.specs["groups"]["0"]["k"].paged is ring_paged
        assert got.specs["groups"]["1"]["k"].paged


@pytest.mark.parametrize("max_len", [64, 8])
def test_tokens_bitwise_across_modes_and_equal_jax(cfgs, params, max_len):
    """Solo, drain and continuous serve bitwise the same tokens, equal to
    the port's `greedy_generate` and to the JAX `ContinuousScheduler`'s
    (the ring a slot store at max_len 64, paged at 8)."""
    cfg, jcfg = cfgs
    tp, jp = params
    work = WORK[max_len]
    js = JaxScheduler(jcfg, jp, max_len=max_len, num_blocks=24, block_size=8,
                      max_batch=4)
    jt = [js.submit(list(p), n) for p, n in work]
    js.run()
    want = [t.tokens for t in jt]
    for mode, max_batch in (("solo", 1), ("drain", 4), ("continuous", 4)):
        s = ContinuousScheduler(
            cfg, tp, max_len=max_len, num_blocks=24, block_size=8,
            max_batch=max_batch,
            admission="drain" if mode == "drain" else "continuous")
        tickets = [s.submit(list(p), n) for p, n in work]
        s.run()
        assert [t.status for t in tickets] == ["done"] * len(work)
        assert [t.tokens for t in tickets] == want, mode
    for (prompt, steps), toks in zip(work, want):
        with TE.using_config(SERVING):
            dense = SE.greedy_generate(cfg, tp, {"tokens": torch.tensor(
                [list(prompt)])}, steps, max_len)
        assert dense[0].tolist() == toks


def test_launch_serve_runs_gemma2(capsys):
    """`launch/serve.py --arch gemma2-27b --reduced --device cpu`: its
    tokens equal `greedy_generate` on the same weights and inputs."""
    argv = ["--arch", "gemma2-27b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "18", "--gen", "4", "--seed", "3"]
    got = LS.main(argv)
    cfg = base.reduced("gemma2-27b")
    params = T.init_params(cfg, seed=3, device="cpu")
    batch = LS.make_batch(cfg, 2, 18, 3, "cpu")
    with TE.using_config(TE.EngineConfig(backend="cuda")):
        want = SE.greedy_generate(cfg, params, batch, 4, 18 + 4 + 8)
    assert torch.equal(got, want)
    assert capsys.readouterr().out.startswith(f"arch={cfg.name} ")


def test_full_width_programs_on_meta():
    """gemma2-27b at full width and depth, captured on `meta`: a decode
    step and a 4,500-token prefill record 46 x 7 + 1 = 323 GEMMs each, the
    tied unembedding (the (256000, 4608) table) the last."""
    cfg = base.get_config("gemma2_27b")
    dec = SE.decode_program(cfg, 8, 4608)
    pre = SE.prefill_program(cfg, 1, 4500, max_len=4608)
    for prog in (dec, pre):
        assert [op.kind for op in prog.ops] == ["dense"] * 323
        assert tuple(prog.ops[-1].w_shape) == (256000, 4608)
    shapes = SE.decode_state_shapes(cfg, 1, 4608)
    assert tuple(shapes["groups"]["0"]["k"].shape) == (23, 1, 4096, 16, 128)
    assert tuple(shapes["groups"]["1"]["k"].shape) == (23, 1, 4608, 16, 128)
