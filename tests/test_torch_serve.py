"""The port's continuous-batching LM serving on the CPU, against the JAX
package's `ContinuousScheduler`.

On the reduced smollm-135m config with the reference's fp32 parameters
(carried across by `params_from_jax`) and a bf16 paged pool:

  * a request's tokens are bitwise equal solo, in a drained batch and in a
    continuous batch, and equal to the port's dense-cache
    `greedy_generate`, under `EngineConfig(row_align=8)`;
  * they equal the JAX scheduler's tokens on the same workload (the
    `WORK` of tests/test_continuous.py). Each request is first replayed
    teacher-forced on the dense path of both packages, and every step's
    logits must agree within 1e-5 x max|logits| (fp32 sums in other
    orders), so a token that differed on a near tie would be told apart
    from a fault;
  * joins, cancellation, deadlines and preemption behave as in the
    reference;
  * the serving programs record the reference's ops with the layer group
    repeated `n_groups` times: the reference traces its scanned layers
    once, the port runs a Python loop over them (ROADMAP section 3).
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.models import transformer as JT
from repro.serve import engine as JSE
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs.base import reduced
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import PagedLayout
from repro_torch.serve.scheduler import (ContinuousScheduler, GenTicket,
                                         latency_percentiles)

jax.config.update("jax_platform_name", "cpu")

MAX_LEN = 32
TOL = 1e-5
WORK = [((3, 1, 4, 1, 5), 6), ((9, 2, 6), 12), ((2, 7, 1, 8), 3),
        ((1, 1, 2, 3, 5, 8), 8)]
SERVING = TE.EngineConfig(row_align=8)


@pytest.fixture(scope="module")
def cfg():
    return reduced("smollm_135m")


@pytest.fixture(scope="module")
def params(smollm_params):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    smollm_params),
                             device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(smollm_reduced, smollm_params):
    """The JAX scheduler's tokens on WORK (its default serving config)."""
    s = JaxScheduler(smollm_reduced, smollm_params, max_len=MAX_LEN,
                     num_blocks=24, block_size=8, max_batch=4)
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    assert all(t.status == "done" for t in tickets)
    return [t.tokens for t in tickets]


@pytest.fixture(scope="module")
def dense_ref(cfg, params):
    """The port's dense-cache greedy generation, memoized."""
    cache = {}

    def ref(prompt, steps):
        key = (tuple(prompt), steps)
        if key not in cache:
            with TE.using_config(SERVING):
                out = SE.greedy_generate(
                    cfg, params, {"tokens": torch.tensor([list(prompt)])},
                    steps, MAX_LEN)
            cache[key] = out[0].tolist()
        return cache[key]

    return ref


def make_sched(cfg, params, **kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 4)
    return ContinuousScheduler(cfg, params, **kw)


# ---------------------------------------------------------------------------
# parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,max_batch", [
    ("solo", 1), ("drain", 4), ("continuous", 4)])
def test_tokens_bitwise_equal_across_modes(cfg, params, dense_ref,
                                           jax_tokens, mode, max_batch):
    s = make_sched(cfg, params, max_batch=max_batch,
                   admission="drain" if mode == "drain" else "continuous")
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    for t, (p, n), want in zip(tickets, WORK, jax_tokens):
        assert t.status == "done" and t.preemptions == 0
        assert t.tokens == dense_ref(p, n), (mode, t.rid)
        assert t.tokens == want, (mode, t.rid)


@pytest.mark.parametrize("i", range(len(WORK)))
def test_step_logits_match_the_reference(cfg, params, smollm_reduced,
                                         smollm_params, jax_tokens, i):
    """Request i replayed on both packages' dense paths, fed the JAX
    scheduler's tokens: every step's logits within TOL, and the JAX
    tokens are the argmax of the port's logits too."""
    prompt, steps = WORK[i]
    toks = jax_tokens[i]
    with jax_engine.using_config(jax_engine.EngineConfig(row_align=8)):
        jl, js = JT.prefill(smollm_reduced, smollm_params,
                            {"tokens": jnp.asarray([prompt], jnp.int32)},
                            MAX_LEN)
    with TE.using_config(SERVING):
        tl, ts = T.prefill(cfg, params, {"tokens": torch.tensor([prompt])},
                           MAX_LEN)
    logits = [(tl[0], jl[0])]
    with jax_engine.using_config(jax_engine.EngineConfig(row_align=8)):
        step = jax.jit(lambda st, tk, ps: JT.decode_step(
            smollm_reduced, smollm_params, st, tk, ps))
    for k in range(steps - 1):
        tok = [[toks[k]]]
        pos = len(prompt) + k
        with jax_engine.using_config(jax_engine.EngineConfig(row_align=8)):
            jl, js = step(js, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        with TE.using_config(SERVING):
            tl, ts = T.decode_step(cfg, params, ts, torch.tensor(tok), pos)
        logits.append((tl[0, -1], jl[0, -1]))
    for k, (got, want) in enumerate(logits):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= TOL, (k, err)
        assert int(got.argmax()) == toks[k]


def test_mid_generation_join_and_finish(cfg, params, dense_ref):
    """B finishes while A decodes, then C joins the running batch
    mid-generation; all three match their dense runs bitwise."""
    s = make_sched(cfg, params)
    a = s.submit([3, 1, 4, 1, 5], 10)
    b = s.submit([2, 7, 1], 3)
    for _ in range(4):
        s.step()
    assert b.status == "done" and a.status == "running"
    c = s.submit([9, 2, 6, 4], 6)
    s.run()
    assert a.tokens == dense_ref((3, 1, 4, 1, 5), 10)
    assert b.tokens == dense_ref((2, 7, 1), 3)
    assert c.tokens == dense_ref((9, 2, 6, 4), 6)
    hist = s.stats()["admitted_per_step"]
    assert hist[0] == 2 and 1 in hist[1:]


def test_single_step_request(cfg, params, dense_ref):
    s = make_sched(cfg, params)
    t = s.submit([5, 4, 3], 1)
    assert s.step() == [t] and t.status == "done"
    assert t.tokens == dense_ref((5, 4, 3), 1)
    assert s.stats()["steps"] == 0
    assert s.pool.snapshot()["live_requests"] == 0


# ---------------------------------------------------------------------------
# lifecycle
# ---------------------------------------------------------------------------

def test_cancel_releases_blocks_immediately(cfg, params, dense_ref):
    s = make_sched(cfg, params)
    a = s.submit([3, 1, 4, 1, 5], 10)
    b = s.submit([2, 7, 1], 10)
    s.step()
    live = s.pool.snapshot()["live_blocks"]
    assert s.cancel(a) and a.status == "cancelled"
    assert s.pool.snapshot()["live_blocks"] < live
    assert not s.cancel(a)
    s.run()
    assert b.tokens == dense_ref((2, 7, 1), 10)
    assert s.stats()["cancelled"] == 1
    q = s.submit([1, 2, 3], 4)
    assert s.cancel(q) and q.status == "cancelled" and s.pending() == 0
    assert s.run() == []


def test_deadline_expires_queued_and_running(cfg, params):
    s = make_sched(cfg, params)
    a = s.submit([3, 1, 4], 10, timeout_s=0.0)
    time.sleep(0.01)
    s.step()
    assert a.status == "expired" and not a.tokens
    b = s.submit([2, 7, 1], 25, timeout_s=5.0)
    s.step()
    assert b.status == "running"
    b.deadline_s = time.perf_counter() - 1.0     # its deadline has passed
    s.step()
    assert b.status == "expired"
    assert s.pool.snapshot()["live_requests"] == 0
    assert s.stats()["expired"] == 2


def test_preemption_under_tiny_pool(cfg, params):
    """4 usable blocks, two requests needing 3 + 2: the youngest is evicted
    when the pool runs dry, re-prefills, and both finish."""
    s = ContinuousScheduler(cfg, params, max_len=24, num_blocks=5,
                            block_size=8, max_batch=2)
    a = s.submit([1, 2, 3, 4, 5, 6, 7], 16)
    b = s.submit([4, 5, 6], 12)
    s.run()
    assert a.status == "done" and len(a.tokens) == 16
    assert b.status == "done" and len(b.tokens) == 12
    st = s.stats()
    assert st["evicted"] >= 1
    assert a.preemptions + b.preemptions == st["evicted"]
    assert st["pool"]["free_low_water"] == 0
    assert st["pool"]["live_blocks"] == 0


def test_submit_validation_and_live_cost_budget(cfg, params):
    s = make_sched(cfg, params)
    with pytest.raises(ValueError, match="exceeds"):
        s.submit([1] * 30, 10)
    with pytest.raises(ValueError, match="empty"):
        s.submit([], 4)
    tiny = ContinuousScheduler(cfg, params, max_len=32, num_blocks=3,
                               block_size=8, max_batch=2)
    with pytest.raises(ValueError, match="blocks"):
        tiny.submit([1] * 20, 10)
    s.max_live_cost_s = 1.5 * s.unit_step_s
    a = s.submit([1, 2, 3], 4)
    b = s.submit([4, 5, 6], 4)
    s.step()
    assert a.status == "running" and b.status == "queued"
    s.run()
    assert a.status == "done" and b.status == "done"
    with pytest.raises(ValueError, match="admission"):
        make_sched(cfg, params, admission="fifo")


# ---------------------------------------------------------------------------
# programs, plans, stats
# ---------------------------------------------------------------------------

def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec)
            for op in ops]


def _repeat_groups(ops, n_groups, n_lead, n_body):
    """The reference's op list with its one traced group body repeated."""
    return (ops[:n_lead] + ops[n_lead:n_lead + n_body] * n_groups
            + ops[n_lead + n_body:])


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_paged_decode_program_repeats_the_reference_group(
        cfg, smollm_reduced, batch):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=16)
    jlayout = jax_kv.PagedLayout.build(smollm_reduced, max_len=MAX_LEN,
                                       block_size=8, num_blocks=16)
    t = _op_keys(SE.paged_decode_program(cfg, layout, batch).ops)
    j = _op_keys(JSE.paged_decode_program(smollm_reduced, jlayout,
                                          batch).ops)
    assert len(j) == 2 + 7 + 1                    # one group traced
    assert t == _repeat_groups(j, cfg.n_groups, 2, 7)
    assert len(t) == 2 + cfg.n_groups * 7 + 1


@pytest.mark.parametrize("seq", [3, 9])
def test_prefill_ingest_program_repeats_the_reference_group(
        cfg, smollm_reduced, seq):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=16)
    jlayout = jax_kv.PagedLayout.build(smollm_reduced, max_len=MAX_LEN,
                                       block_size=8, num_blocks=16)
    t = _op_keys(SE.prefill_ingest_program(cfg, layout, seq).ops)
    j = _op_keys(JSE.prefill_ingest_program(smollm_reduced, jlayout,
                                            seq).ops)
    assert t == _repeat_groups(j, cfg.n_groups, 0, 7)


def test_paged_decode_plan_prices_gather(cfg, smollm_reduced):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=16)
    plan = TE.plan_network(SE.paged_decode_program(cfg, layout, 2), SERVING)
    jlayout = jax_kv.PagedLayout.build(smollm_reduced, max_len=MAX_LEN,
                                       block_size=8, num_blocks=16)
    jplan = jax_engine.plan_network(
        JSE.paged_decode_program(smollm_reduced, jlayout, 2),
        jax_engine.EngineConfig(row_align=8))
    assert plan.gather_plans and plan.gather_cycles == jplan.gather_cycles
    assert plan.gather_latency_s == jplan.gather_latency_s > 0
    assert plan.total_latency_s > plan.fc_latency_s
    # the reference prices one of the n_groups layers
    group_cycles = (jplan.fc_cycles - jplan.fc_plans[-1].cycles)
    assert plan.fc_cycles == (group_cycles * cfg.n_groups
                              + jplan.fc_plans[-1].cycles)


def test_stats_and_snapshot(cfg, params):
    s = make_sched(cfg, params)
    for p, n in WORK:
        s.submit(list(p), n)
    s.run()
    st = s.stats()
    assert st["tokens_out"] == sum(n for _, n in WORK) - len(WORK)
    assert 0.0 < st["decode_fill"] <= 1.0
    assert st["admitted"] == len(WORK)
    assert len(st["admitted_per_step"]) >= st["steps"]
    assert sum(st["admitted_per_step"]) == st["admitted"]
    assert sum(st["evicted_per_step"]) == st["evicted"] == 0
    assert st["compiled_prefill_lens"] == sorted({len(p) for p, _ in WORK})
    # the row_align floor: max_batch 4 <= row_align 8, one decode shape
    assert st["buckets"] == st["compiled_decode_buckets"] == [8]
    assert st["unit_step_s"] > st["unit_step_gather_s"] > 0
    assert st["throughput_tps"] > 0
    pool = st["pool"]
    assert pool["live_blocks"] == 0 and pool["occupancy"] == 0.0
    assert pool["free_low_water"] < pool["num_blocks"] - 1
    assert pool["free_blocks"] == pool["num_blocks"] - 1
    assert pool["free_slots"] == 63


def test_compiled_programs_run_on_the_planned_backend(cfg, params):
    s = make_sched(cfg, params, config=TE.EngineConfig(backend="torch",
                                                       row_align=8))
    s.submit([3, 1, 4], 3)
    s.run()
    dec = s.decode_compiled(1)
    assert set(dec.backends()) == {"torch"}
    assert [op.kind for op, _ in dec.exec_pairs].count("gather") == 2


def test_gen_ticket_latency_and_percentiles():
    t = GenTicket(rid=0, prompt=(1,), steps=1, submit_s=10.0)
    assert t.latency_s != t.latency_s   # NaN while pending
    t.status = "done"
    t.done_s = 10.5
    assert t.latency_s == pytest.approx(0.5)
    u = GenTicket(rid=1, prompt=(1,), steps=1, submit_s=10.0,
                  status="done", done_s=11.0)
    pct = latency_percentiles([t, u])
    assert pct["p50_ms"] == pytest.approx(750.0)
    assert latency_percentiles([]) == {"p50_ms": 0.0, "p95_ms": 0.0,
                                       "p99_ms": 0.0}


@pytest.mark.parametrize("fallback", ["torch", "ref"])
def test_auto_backend_pins_the_full_width_decode_ops(fallback):
    """smollm-135m's full-width paged decode step on `meta` under
    `policy="auto"`: every GEMM (the tied unembedding's included) on
    "cuda", both gathers on the fallback, the Table-4 row unchanged."""
    from repro_torch.configs.base import get_config
    full = get_config("smollm_135m")
    layout = PagedLayout.build(full, max_len=512, block_size=16,
                               num_blocks=257)
    prog = SE.paged_decode_program(full, layout, 8, torch.float32)
    cfg = TE.EngineConfig(backend=fallback, policy="auto", row_align=8)
    net = TE.compile(prog, cfg)
    kinds = [op.kind for op, _ in net.exec_pairs]
    assert kinds.count("gather") == 2 and kinds.count("dense") == 211
    assert net.backends() == tuple(fallback if k == "gather" else "cuda"
                                   for k in kinds)
    assert net.cost == TE.compile(prog, TE.EngineConfig(row_align=8)).cost
