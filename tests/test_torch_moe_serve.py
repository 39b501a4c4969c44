"""The port's continuous-batching serving of an MoE model on the CPU,
against the JAX package's `ContinuousScheduler`.

Reduced granite-moe-1b (4 layers, 8 experts, top-2) with the reference's
fp32 parameters carried across by `params_from_jax` and a bf16 paged pool:

  * a request's tokens are bitwise equal solo, in a drained batch and in a
    continuous batch, and equal to the port's dense-cache
    `greedy_generate`, under `EngineConfig(row_align=8)`: the MoE block
    gives a token the same bits in any batch;
  * they equal the JAX scheduler's tokens on the same workload (the `WORK`
    of tests/test_continuous.py); each request is also replayed
    teacher-forced on both packages' dense paths, every step's logits
    within 1e-5 x max|logits|;
  * the serving programs record the reference's ops, the layer group
    repeated `n_groups` times, and at full width 193 GEMMs a pass, 72 of
    them grouped.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.configs.base import reduced as jax_reduced
from repro.models import transformer as JT
from repro.serve import engine as JSE
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import PagedLayout
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

MAX_LEN = 32
TOL = 1e-5
WORK = [((3, 1, 4, 1, 5), 6), ((9, 2, 6), 12), ((2, 7, 1, 8), 3),
        ((1, 1, 2, 3, 5, 8), 8)]
SERVING = TE.EngineConfig(row_align=8)
EXPERT_SPECS = ("ecd,edf->ecf", "ecf,efd->ecd")


@pytest.fixture(scope="module")
def cfgs():
    return reduced("granite_moe_1b"), jax_reduced("granite_moe_1b")


@pytest.fixture(scope="module")
def params(cfgs):
    jp = JT.init_params(cfgs[1], jax.random.PRNGKey(0), jnp.float32)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return tp, jp


@pytest.fixture(scope="module")
def jax_tokens(cfgs, params):
    """The JAX scheduler's tokens on WORK (its default serving config)."""
    s = JaxScheduler(cfgs[1], params[1], max_len=MAX_LEN, num_blocks=24,
                     block_size=8, max_batch=4)
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    assert all(t.status == "done" for t in tickets)
    return [t.tokens for t in tickets]


@pytest.fixture(scope="module")
def dense_ref(cfgs, params):
    cache = {}

    def ref(prompt, steps):
        key = (tuple(prompt), steps)
        if key not in cache:
            with TE.using_config(SERVING):
                out = SE.greedy_generate(
                    cfgs[0], params[0], {"tokens": torch.tensor([list(prompt)])},
                    steps, MAX_LEN)
            cache[key] = out[0].tolist()
        return cache[key]

    return ref


@pytest.mark.parametrize("mode,max_batch", [
    ("solo", 1), ("drain", 4), ("continuous", 4)])
def test_tokens_bitwise_equal_across_modes_and_to_jax(cfgs, params, dense_ref,
                                                      jax_tokens, mode,
                                                      max_batch):
    s = ContinuousScheduler(cfgs[0], params[0], max_len=MAX_LEN,
                            num_blocks=24, block_size=8, max_batch=max_batch,
                            admission="drain" if mode == "drain"
                            else "continuous")
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    for t, (p, n), want in zip(tickets, WORK, jax_tokens):
        assert t.status == "done" and t.preemptions == 0
        assert t.tokens == dense_ref(p, n), (mode, t.rid)
        assert t.tokens == want, (mode, t.rid)
    assert s.stats()["compiled_decode_buckets"] == [8]


@pytest.mark.parametrize("i", range(len(WORK)))
def test_step_logits_match_the_reference(cfgs, params, jax_tokens, i):
    """Request i replayed on both packages' dense paths with an fp32 cache,
    fed the JAX scheduler's tokens: every step's logits within TOL, and
    the JAX tokens the argmax of the port's logits. (With the serving bf16
    cache a key or value whose fp32 sums differ in the last bits, past the
    first MoE layer, can round to the other bf16 neighbour and move that
    step's logits by about 1e-4 of their largest.)"""
    (cfg, jcfg), (tp, jp) = cfgs, params
    prompt, steps = WORK[i]
    toks = jax_tokens[i]
    jconf = jax_engine.EngineConfig(row_align=8)
    with jax_engine.using_config(jconf):
        jl, js = JT.prefill(jcfg, jp, {"tokens": jnp.asarray([prompt],
                                                             jnp.int32)},
                            MAX_LEN, state_dtype=jnp.float32)
        step = jax.jit(lambda st, tk, ps: JT.decode_step(jcfg, jp, st, tk,
                                                         ps))
    with TE.using_config(SERVING):
        tl, ts = T.prefill(cfg, tp, {"tokens": torch.tensor([prompt])},
                           MAX_LEN, state_dtype=torch.float32)
    logits = [(tl[0], jl[0])]
    for k in range(steps - 1):
        tok = [[toks[k]]]
        with jax_engine.using_config(jconf):
            jl, js = step(js, jnp.asarray(tok, jnp.int32),
                          jnp.int32(len(prompt) + k))
        with TE.using_config(SERVING):
            tl, ts = T.decode_step(cfg, tp, ts, torch.tensor(tok),
                                   len(prompt) + k)
        logits.append((tl[0, -1], jl[0, -1]))
    for k, (got, want) in enumerate(logits):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, (k, err)
        assert int(got.argmax()) == toks[k]


def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec)
            for op in ops]


def _repeat_groups(ops, n_groups, n_lead, n_body):
    return (ops[:n_lead] + ops[n_lead:n_lead + n_body] * n_groups
            + ops[n_lead + n_body:])


def _layouts(cfgs):
    return (PagedLayout.build(cfgs[0], max_len=MAX_LEN, block_size=8,
                              num_blocks=16),
            jax_kv.PagedLayout.build(cfgs[1], max_len=MAX_LEN, block_size=8,
                                     num_blocks=16))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_paged_decode_program_repeats_the_reference_group(cfgs, batch):
    """A layer: 4 projections, the router and 3 grouped GEMMs."""
    layout, jlayout = _layouts(cfgs)
    t = _op_keys(SE.paged_decode_program(cfgs[0], layout, batch).ops)
    j = _op_keys(JSE.paged_decode_program(cfgs[1], jlayout, batch).ops)
    assert len(j) == 2 + 8 + 1
    assert [k[3] for k in j[7:10]] == list(EXPERT_SPECS[:1] * 2
                                           + EXPERT_SPECS[1:])
    assert t == _repeat_groups(j, cfgs[0].n_groups, 2, 8)


@pytest.mark.parametrize("seq", [3, 9])
def test_prefill_ingest_program_repeats_the_reference_group(cfgs, seq):
    layout, jlayout = _layouts(cfgs)
    t = _op_keys(SE.prefill_ingest_program(cfgs[0], layout, seq).ops)
    j = _op_keys(JSE.prefill_ingest_program(cfgs[1], jlayout, seq).ops)
    assert t == _repeat_groups(j, cfgs[0].n_groups, 0, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_width_programs_count_the_grouped_gemms(dtype):
    """granite-moe-1b at full width on `meta`: a decode step records 2
    gathers and 24 x (4 + 1 + 3) + 1 = 193 GEMMs, 72 of them grouped over
    32 experts; a prefill the 193 GEMMs. Every op plans onto "cuda"."""
    cfg = get_config("granite_moe_1b")
    layout = PagedLayout.build(cfg, max_len=512, block_size=16,
                               num_blocks=257)
    dec = SE.paged_decode_program(cfg, layout, 8, param_dtype=dtype)
    pre = SE.prefill_ingest_program(cfg, layout, 100, param_dtype=dtype)
    for prog, gathers in ((dec, 2), (pre, 0)):
        kinds = [op.kind for op in prog.ops]
        grouped = [op for op in prog.ops if op.spec in EXPERT_SPECS]
        assert kinds.count("gather") == gathers
        assert len(kinds) - gathers == 193 and len(grouped) == 72
        assert {op.w_shape[0] for op in grouped} == {32}
        plan = TE.plan_network(prog, SERVING)
        assert {p.backend for p in plan.plans} == {"cuda"}
    assert {tuple(op.x_shape) for op in dec.ops
            if op.spec == "ecd,edf->ecf"} == {(32, 8, 1024)}


def test_auto_policy_serves_the_experts_on_the_fallback(cfgs, params,
                                                        dense_ref):
    """Under policy="auto" the grouped GEMMs plan onto the fallback, as the
    reference's auto policy does, and the served tokens stay the same."""
    layout, _ = _layouts(cfgs)
    conf = TE.EngineConfig(backend="torch", row_align=8, policy="auto")
    plan = TE.plan_network(SE.paged_decode_program(cfgs[0], layout, 2), conf)
    assert {p.backend for p, op in zip(plan.plans,
                                       SE.paged_decode_program(
                                           cfgs[0], layout, 2).ops)
            if op.spec in EXPERT_SPECS} == {"torch"}
    s = ContinuousScheduler(cfgs[0], params[0], max_len=MAX_LEN,
                            num_blocks=24, block_size=8, max_batch=4,
                            config=conf)
    t = s.submit([3, 1, 4, 1, 5], 6)
    s.run()
    assert t.status == "done" and len(t.tokens) == 6
