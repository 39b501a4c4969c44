"""Chaos properties of the port's serving stack under seeded fault
schedules, against the JAX package (a port of tests/test_chaos.py; its
`ReplicaSpread` cases are not ported: ROADMAP queue 1, item 11).

On reduced smollm-135m with the reference's fp32 parameters, at seeds 1, 7
and 23:

  1. exactly-once termination: every ticket ends in one terminal status
     (`_mark_terminal` raises `FatalError` on a second);
  2. no leaks: the allocator and the slots are back to fresh, quarantined
     requests scrubbed;
  3. isolation: requests the schedule never touched (no retries, no
     preemptions) produce tokens bitwise equal to the port's clean run and
     to the JAX scheduler's clean run;
  4. with the non-kernel points visited in the same order, each ticket's
     status and retries equal those of the JAX `ContinuousScheduler` under
     the same injector.

Kernel faults: where the chain hops (the gather, "cuda" -> "torch") they
change no token; where it does not (an fp32 GEMM), the fault is a
`TransientError` the scheduler retries, and the retried request's tokens
are bitwise the clean ones too.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import faults as jax_faults
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import Scheduler as JaxStatic
from repro_torch import engine as E
from repro_torch.configs.base import reduced
from repro_torch.models import transformer as T
from repro_torch.serve.faults import FatalError, FaultInjector
from repro_torch.serve.scheduler import ContinuousScheduler, Scheduler

jax.config.update("jax_platform_name", "cpu")

SEEDS = (1, 7, 23)
WORK = [((3, 1, 4, 1, 5), 6), ((9, 2, 6), 12), ((2, 7, 1, 8), 3),
        ((1, 1, 2, 3, 5, 8), 8)]
POOL = dict(max_len=32, num_blocks=24, block_size=8, max_batch=4)
CHAOS = dict(rates={"numerics": 0.08, "pool": 0.15, "latency": 0.05},
             latency_s=0.001, max_fires=3)


@pytest.fixture(scope="module")
def cfg():
    return reduced("smollm_135m")


@pytest.fixture(scope="module")
def params(smollm_params):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    smollm_params),
                             device="cpu")


def make_sched(cfg, params, **kw):
    return ContinuousScheduler(cfg, params, **POOL, **kw)


def pool_fresh_state(s):
    """The allocator and slot facts a run must restore."""
    return (s.pool.allocator.free_blocks,
            sorted(len(tb) for tb in s.pool.allocator.tables.values()),
            len(s.pool._free_slots))


@pytest.fixture(scope="module")
def clean_tokens(cfg, params):
    """The port's fault-free tokens, keyed by rid (= submit order)."""
    s = make_sched(cfg, params)
    tickets = [s.submit(p, n) for p, n in WORK]
    s.run()
    assert all(t.status == "done" for t in tickets)
    return {t.rid: tuple(t.tokens) for t in tickets}


@pytest.fixture(scope="module")
def jax_runs(smollm_reduced, smollm_params):
    """The JAX scheduler's clean tokens, and its tickets under each seed's
    chaos injector (its default config)."""
    def run(inj):
        s = JaxScheduler(smollm_reduced, smollm_params, **POOL, faults=inj)
        tickets = [s.submit(list(p), n) for p, n in WORK]
        s.run()
        return tickets, inj

    clean, _ = run(None)
    assert all(t.status == "done" for t in clean)
    chaos = {seed: run(jax_faults.FaultInjector(seed=seed, **CHAOS))
             for seed in SEEDS}
    return {t.rid: tuple(t.tokens) for t in clean}, chaos


def test_clean_tokens_equal_the_jax_scheduler(clean_tokens, jax_runs):
    assert clean_tokens == jax_runs[0]


class TestChaosProperties:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_termination_leaks_and_isolation(self, cfg, params, clean_tokens,
                                             jax_runs, seed):
        inj = FaultInjector(seed=seed, **CHAOS)
        s = make_sched(cfg, params, faults=inj)
        assert s.guard
        fresh = pool_fresh_state(s)
        tickets = [s.submit(p, n) for p, n in WORK]
        finished = s.run()      # raises FatalError on a double termination

        # 1. exactly-once termination
        assert all(t.status in ("done", "failed") for t in tickets)
        assert sorted(id(t) for t in finished) \
            == sorted(id(t) for t in tickets)
        assert sorted(s._terminated) == sorted(t.rid for t in tickets)
        # 2. no leaks
        assert pool_fresh_state(s) == fresh
        assert s.pool.allocator.free_blocks \
            == s.pool.allocator.num_blocks - 1
        # 3. isolation, against the port's and JAX's clean runs
        untouched = [t for t in tickets if t.status == "done"
                     and t.retries == 0 and t.preemptions == 0]
        assert untouched
        for t in untouched:
            assert tuple(t.tokens) == clean_tokens[t.rid] \
                == jax_runs[0][t.rid]
        for t in tickets:
            if t.status == "done":
                assert len(t.tokens) == t.steps
        # 4. the JAX scheduler under the same injector
        jt, jinj = jax_runs[1][seed]
        ev = [(e.point, e.site, e.visit) for e in inj.events]
        if ev == [(e.point, e.site, e.visit) for e in jinj.events]:
            assert [(t.status, t.retries, t.preemptions) for t in tickets] \
                == [(t.status, t.retries, t.preemptions) for t in jt]
            for a, b in zip(tickets, jt):
                if a.status == "done":
                    assert tuple(a.tokens) == tuple(b.tokens)
        st = s.stats()
        assert st["faults"] == inj.summary() and st["guard"]
        assert st["failed"] == sum(t.status == "failed" for t in tickets)

    @pytest.mark.parametrize("seed", SEEDS)
    def test_kernel_chaos_is_invisible_in_the_tokens(self, cfg, params,
                                                     clean_tokens, seed):
        """Kernel faults under the chain: the gather hops to a bitwise
        backend, a GEMM fault is retried (admission) or the step repeated
        (decode); every finished ticket's tokens are the clean ones."""
        inj = FaultInjector(seed=seed, rates={"kernel": 0.015})
        s = make_sched(cfg, params, faults=inj, guard=False,
                       config=E.EngineConfig(row_align=8, fallback="chain"))
        fresh = pool_fresh_state(s)
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        assert inj.fired["kernel"] > 0
        assert all(t.status in ("done", "failed") for t in tickets)
        assert any(t.status == "done" and t.retries for t in tickets)
        for t in tickets:
            if t.status == "done":
                assert tuple(t.tokens) == clean_tokens[t.rid]
        st = s.stats()
        assert all(src == "cuda" and dst == "torch" and kind == "gather"
                   for kind, src, dst in st["fallbacks"])
        assert pool_fresh_state(s) == fresh

    def test_pinned_faults_hop_and_retry(self, cfg, params, clean_tokens):
        """The first gather visit hops; a GEMM visit of the first prefill's
        first apply cannot hop, so that admission is retried; the tokens
        of every ticket, the retried one's included, are the clean ones."""
        inj = FaultInjector(seed=3, schedule={("kernel", "gather:cuda"): (0,),
                                              ("kernel", "dense:cuda"): (4,)})
        s = make_sched(cfg, params, faults=inj,
                       config=E.EngineConfig(row_align=8, fallback="chain"))
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        assert [t.status for t in tickets] == ["done"] * len(WORK)
        assert [t.retries for t in tickets] == [1, 0, 0, 0]
        for t in tickets:
            assert tuple(t.tokens) == clean_tokens[t.rid]
        st = s.stats()
        assert st["fallbacks"] == [("gather", "cuda", "torch")]
        assert st["retries"] == 1 and st["decode_faults"] == 0
        assert s.decode_compiled(8).backends()[0] == "torch"

    def test_decode_fault_repeats_the_step(self, cfg, params, clean_tokens):
        """A GEMM fault in the decode program's first apply (after the four
        prefills') has no hop: the step writes nothing and runs again."""
        s = make_sched(cfg, params, guard=False)
        per_prefill = sum(op.kind == "dense"
                          for op in s.prefill_compiled(5).program.ops)
        inj = FaultInjector(seed=3, schedule={
            ("kernel", "dense:cuda"): (len(WORK) * per_prefill + 3,)})
        s = make_sched(cfg, params, faults=inj, guard=False)
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        for t in tickets:
            assert t.status == "done"
            assert tuple(t.tokens) == clean_tokens[t.rid]
        assert inj.total_fired == 1
        st = s.stats()
        assert st["decode_faults"] == 1 and st["retries"] == 0

    def test_pool_storm_retries_with_backoff(self, cfg, params,
                                             clean_tokens):
        inj = FaultInjector(seed=3, schedule={("pool", "0"): (0, 1)})
        s = make_sched(cfg, params, faults=inj, guard=False)
        t = s.submit(*WORK[0])
        s.run()
        assert t.status == "done" and t.retries == 2
        assert s.stats()["retries"] == 2
        assert tuple(t.tokens) == clean_tokens[t.rid]

    def test_retry_budget_exhaustion_fails_cleanly(self, cfg, params):
        inj = FaultInjector(seed=3, schedule={
            ("pool", "0"): tuple(range(10))})
        s = make_sched(cfg, params, faults=inj, guard=False, max_retries=2)
        fresh = pool_fresh_state(s)
        t = s.submit(*WORK[0])
        s.run()
        assert t.status == "failed" and "retry budget exhausted" in t.error
        assert pool_fresh_state(s) == fresh

    def test_quarantine_preserves_batchmates(self, cfg, params,
                                             clean_tokens):
        inj = FaultInjector(seed=0, schedule={("numerics", "1"): (2,)})
        s = make_sched(cfg, params, faults=inj)
        fresh = pool_fresh_state(s)
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        by_rid = {t.rid: t for t in tickets}
        assert by_rid[1].status == "failed"
        assert "non-finite" in by_rid[1].error
        for rid, t in by_rid.items():
            if rid != 1:
                assert t.status == "done"
                assert tuple(t.tokens) == clean_tokens[rid]
        assert pool_fresh_state(s) == fresh
        # the quarantined request's blocks were scrubbed to zero
        assert s.stats()["failed"] == 1

    def test_prefill_quarantine(self, cfg, params, clean_tokens):
        inj = FaultInjector(seed=0, schedule={("numerics", "pre:2"): (0,)})
        s = make_sched(cfg, params, faults=inj)
        fresh = pool_fresh_state(s)
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        assert [t.status for t in tickets] == ["done", "done", "failed",
                                               "done"]
        assert "prefill" in tickets[2].error
        for t in tickets:
            if t.status == "done":
                assert tuple(t.tokens) == clean_tokens[t.rid]
        assert pool_fresh_state(s) == fresh

    def test_double_termination_raises_fatal(self, cfg, params):
        s = make_sched(cfg, params)
        t = s.submit(*WORK[0])
        s.run()
        assert t.status == "done"
        with pytest.raises(FatalError, match="terminated twice|re-term"):
            s._mark_terminal(t, "failed")


class TestCleanPathUnchanged:
    def test_no_guard_programs_without_injector(self, cfg, params):
        s = make_sched(cfg, params)
        assert s.guard is False
        t = s.submit(*WORK[0])
        s.run()
        assert t.status == "done"
        for net in list(s._decode.values()) + list(s._prefill.values()):
            assert "-guard" not in net.program.name
        st = s.stats()
        assert st["fallbacks"] == [] and st["faults"] is None
        assert st["latency_spikes"] == 0 and st["decode_faults"] == 0
        assert st["retries"] == 0 and st["failed"] == 0

    def test_guard_opt_in_without_injector(self, cfg, params, clean_tokens):
        s = make_sched(cfg, params, guard=True)
        tickets = [s.submit(p, n) for p, n in WORK]
        s.run()
        for t in tickets:
            assert t.status == "done"
            assert tuple(t.tokens) == clean_tokens[t.rid]
        for net in list(s._decode.values()) + list(s._prefill.values()):
            assert "-guard" in net.program.name


class TestDeadlineCancelRaces:
    """The admission, expiry and cancel interleavings the fault layer must
    not regress."""

    # the toy program's shared factor, on the CPU (batches run on the
    # device of a program's shared arguments)
    K = torch.tensor([2.0])

    @staticmethod
    def _toy_program():
        def fn(x, k):
            return torch.tanh(x) * k

        def avals(b):
            return (torch.empty((b, 4), device="meta"),
                    torch.empty((1,), device="meta"))

        return E.trace_program(
            fn, *avals(1), name="toy", batch_size=1,
            batch_axes=E.infer_batch_axes(avals(1), avals(2)))

    def test_cancel_after_batch_dispatch_is_refused(self):
        s = Scheduler(max_batch=2)
        s.register("net", self._toy_program(), shared_args=(self.K,))
        t = s.submit("net", torch.ones((1, 4)))
        served = s.step()
        assert t in served and t.done
        assert s.cancel(t) is False
        assert t.result is not None and not t.cancelled

    def test_deadline_expiring_between_admission_and_run(self):
        s = Scheduler()
        s.register("net", self._toy_program(), shared_args=(self.K,))
        t = s.submit("net", torch.ones((1, 4)), timeout_s=0.005)
        assert s.pending() == 1
        time.sleep(0.02)
        assert s.step() == []
        assert t.expired and not t.done and s.pending() == 0

    def test_continuous_deadline_expires_between_admit_and_decode(
            self, cfg, params):
        s = make_sched(cfg, params)
        fresh = pool_fresh_state(s)
        t = s.submit((1, 2, 3), 20, timeout_s=0.5)
        s.step()
        assert t.status == "running"
        time.sleep(0.6)
        s.step()
        assert t.status == "expired"
        assert pool_fresh_state(s) == fresh
        assert s._terminated == {t.rid: "expired"}

    def test_cancel_running_during_fault_storm(self, cfg, params):
        inj = FaultInjector(seed=9, rates={"pool": 0.3})
        s = make_sched(cfg, params, faults=inj, guard=False)
        fresh = pool_fresh_state(s)
        t = s.submit((1, 2, 3), 16)
        for _ in range(6):
            s.step()
            if t.status == "running":
                break
        assert s.cancel(t) is True
        assert t.status == "cancelled"
        s.run()
        assert t.status == "cancelled"
        assert pool_fresh_state(s) == fresh

    def test_toy_scheduler_faults_match_the_reference(self):
        """The static scheduler's latency point is visited once a step, as
        the reference's: the same spikes on the same seed."""
        prog = self._toy_program()

        def jprog():
            from repro import engine as JE

            def avals(b):
                return (jax.ShapeDtypeStruct((b, 4), jnp.float32),
                        jax.ShapeDtypeStruct((1,), jnp.float32))
            return JE.trace_program(
                lambda x, k: jnp.tanh(x) * k, *avals(1), name="toy",
                batch_size=1,
                batch_axes=JE.infer_batch_axes(avals(1), avals(2)))

        kw = dict(rates={"latency": 0.4}, latency_s=0.0001)
        port = Scheduler(max_batch=2, faults=FaultInjector(4, **kw))
        ref = JaxStatic(max_batch=2, faults=jax_faults.FaultInjector(4, **kw))
        port.register("net", prog, shared_args=(self.K,))
        ref.register("net", jprog(), shared_args=(jnp.asarray([2.0]),))
        for i in range(9):
            port.submit("net", torch.full((1, 4), float(i)))
            ref.submit("net", jnp.full((1, 4), float(i)))
        port.drain()
        ref.drain()
        a, b = port.stats(), ref.stats()
        assert a["latency_spikes"] == b["latency_spikes"] > 0
        assert a["faults"] == b["faults"]
