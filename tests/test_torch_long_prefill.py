"""The port's long-prompt prefill on the CPU against the JAX package.

A prefill over 1024 tokens switches from dense attention to the chunked
flash attention (`models/flash.py`; on the "cuda" backend the flash
kernel, whose CPU branch is its plain version). On the reduced smollm-135m
config (4 layers) with the reference's fp32 parameters carried across by
`params_from_jax`:

  * `attention_forward` at 1030 tokens (the switch) and at a short length
    with `use_chunked=True`, against the reference's;
  * `T.prefill` of a 1030-token prompt: logits, and the bf16 k/v state;
  * three requests with prompts of 1025 and 1100 tokens through the port's
    `ContinuousScheduler`: tokens bitwise equal across solo, drain and
    continuous, and equal to the JAX scheduler's;
  * the prefill programs record the reference's ops (group repeated), and
    a full-width smollm-135m prefill at 1984 tokens captured on `meta`
    records the 211 GEMMs of a short one.

Tolerance: within 1e-5 x max|reference| (fp32 sums in other orders). The
bf16 state is within that plus one bf16 step of the reference's value: a
value whose two fp32 computations straddle a bf16 rounding boundary rounds
to neighbours, and at positions past a thousand the two frameworks' fp32
cos and sin in the rotary embedding differ in the last bit, which moves a
small key by several bf16 steps of its own size (35 of the 65,920 keys of
a 1030-token prompt, layer 0 included, and as many at 1024 tokens on the
dense path). Layer 0's values, which see neither, are bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import GLOBAL_ATTN
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.serve import engine as JSE
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import flash_attention as FA
from repro_torch.models import attention as TA
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import PagedLayout
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
BACKENDS = ("cuda", "torch")
LONG = 1030
MAX_LEN = 1112                  # the longest request (1100 + 7) in blocks of 8
WORK_LENS = ((1025, 5), (1100, 3), (1025, 7))


@pytest.fixture(scope="module")
def cfg():
    return reduced("smollm_135m")


@pytest.fixture(scope="module")
def params(smollm_params):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    smollm_params),
                             device="cpu")


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


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("s,use_chunked", [(LONG, None), (40, True)])
def test_attention_forward_matches_the_reference(cfg, params, smollm_reduced,
                                                 smollm_params, backend, s,
                                                 use_chunked):
    x = np.random.default_rng(s).standard_normal(
        (1, s, cfg.d_model)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                smollm_params["groups"]["0"]["attn"])
    tp = {k: v[0] for k, v in params["groups"]["0"]["attn"].items()}
    j_out, (jk, jv) = JA.attention_forward(
        smollm_reduced, jp, jnp.asarray(x), jnp.asarray(pos), GLOBAL_ATTN,
        use_chunked=use_chunked)
    before = FA.flash_attention.launches
    with TE.using_config(TE.EngineConfig(backend=backend)):
        t_out, (tk, tv) = TA.attention_forward(
            cfg, tp, torch.from_numpy(x), torch.from_numpy(pos), GLOBAL_ATTN,
            use_chunked=use_chunked)
    assert FA.flash_attention.launches == before      # CPU: no launch
    _close(t_out, j_out)
    _close(tk, jk)
    _close(tv, jv)


@pytest.mark.parametrize("backend", BACKENDS)
def test_long_prefill_matches_the_reference(cfg, params, smollm_reduced,
                                            smollm_params, backend):
    toks = _tokens(cfg, 1, LONG, seed=0)
    j_logits, j_state = JT.prefill(smollm_reduced, smollm_params,
                                   {"tokens": jnp.asarray(toks)}, MAX_LEN)
    with TE.using_config(TE.EngineConfig(backend=backend, row_align=8)):
        t_logits, t_state = T.prefill(cfg, params, {"tokens": torch.from_numpy(
            toks)}, MAX_LEN)
    _close(t_logits, j_logits)
    for leaf in ("k", "v"):
        got = t_state["groups"]["0"][leaf]
        want = j_state["groups"]["0"][leaf]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        g = got.float().numpy()
        w = np.asarray(want.astype(jnp.float32))
        step = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        assert (np.abs(g - w) <= TOL * np.abs(w).max() + step).all()
    # layer 0's values see neither rope nor attention: bitwise
    np.testing.assert_array_equal(_bits(t_state["groups"]["0"]["v"][0]),
                                  _bits(j_state["groups"]["0"]["v"][0]))


def _work(cfg):
    return [(_tokens(cfg, 1, n, seed=i)[0].tolist(), steps)
            for i, (n, steps) in enumerate(WORK_LENS)]


@pytest.fixture(scope="module")
def jax_tokens(cfg, smollm_reduced, smollm_params):
    """The JAX scheduler's tokens (its default serving config)."""
    s = JaxScheduler(smollm_reduced, smollm_params, max_len=MAX_LEN,
                     num_blocks=3 * 139 + 1, block_size=8, max_batch=4)
    tickets = [s.submit(p, n) for p, n in _work(cfg)]
    s.run()
    assert all(t.status == "done" for t in tickets)
    return [t.tokens for t in tickets]


@pytest.mark.parametrize("mode,max_batch", [
    ("solo", 1), ("drain", 4), ("continuous", 4)])
def test_long_prompts_served_bitwise_across_modes(cfg, params, jax_tokens,
                                                  mode, max_batch):
    s = ContinuousScheduler(
        cfg, params, max_len=MAX_LEN, num_blocks=3 * 139 + 1, block_size=8,
        max_batch=max_batch, config=TE.EngineConfig(row_align=8),
        admission="drain" if mode == "drain" else "continuous")
    tickets = [s.submit(p, n) for p, n in _work(cfg)]
    s.run()
    assert [t.status for t in tickets] == ["done"] * len(tickets)
    assert all(t.preemptions == 0 for t in tickets)
    assert [t.tokens for t in tickets] == jax_tokens, mode


def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec)
            for op in ops]


def test_long_prefill_program_repeats_the_reference_group(cfg,
                                                        smollm_reduced):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=16)
    jlayout = jax_kv.PagedLayout.build(smollm_reduced, max_len=MAX_LEN,
                                       block_size=8, num_blocks=16)
    t = _op_keys(SE.prefill_ingest_program(cfg, layout, LONG).ops)
    j = _op_keys(JSE.prefill_ingest_program(smollm_reduced, jlayout,
                                            LONG).ops)
    assert len(j) == 7 + 1                        # one group traced
    assert t == j[:7] * cfg.n_groups + j[7:]


def test_full_width_long_prefill_program_on_meta():
    """smollm-135m at full width and depth: a 1984-token prefill program
    records the 211 GEMMs of a 128-token one, at 1984 rows (attention is
    no engine op); capture on `meta` launches nothing."""
    full = get_config("smollm_135m")
    layout = PagedLayout.build(full, max_len=2048, block_size=16,
                               num_blocks=1025)
    before = FA.flash_attention.launches
    with TE.using_config(TE.EngineConfig(backend="cuda", row_align=8)):
        long_ops = SE.prefill_ingest_program(full, layout, 1984).ops
        short_ops = SE.prefill_ingest_program(full, layout, 128).ops
    assert FA.flash_attention.launches == before
    assert len(long_ops) == len(short_ops) == 30 * 7 + 1
    assert {op.kind for op in long_ops} == {"dense"}
    want = [(k, tuple(1984 if d == 128 else d for d in x), w, sp)
            for k, x, w, sp in _op_keys(short_ops)]
    assert _op_keys(long_ops) == want
