"""The port's fault layer against the JAX package: `serve/faults.py`, the
dispatch fallback chain and the kernel-fault hook (a port of
tests/test_faults.py, with the port's narrower chain).

  * `FaultInjector.fire` decisions and `backoff_s` floats are the
    reference's for the same (seed, point, site, visit), over thousands of
    visits, rates and explicit schedules;
  * the chain hops only between backends held bitwise equal here for that
    op kind, precision and activation; a pair it refuses lets the fault
    through; an error that is not the injected `KernelFault` is never
    caught; the clean path records nothing;
  * a compiled program meets the kernel point on its first complete apply
    only and pins a hop into `backends()`; a faulted apply of a serving
    program leaves the pool as it was;
  * the guard programs with zero poison are bitwise the unguarded ones,
    and `Scheduler(faults=)` results bitwise the batch-1 apply.
"""
import jax
import numpy as np
import pytest
import torch

from repro.serve import faults as jax_faults
from repro_torch import engine as E
from repro_torch.configs.base import reduced
from repro_torch.engine import dispatch
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve import faults
from repro_torch.serve.kv_pool import KVBlockPool
from repro_torch.serve.scheduler import Scheduler

jax.config.update("jax_platform_name", "cpu")

SITES = ("", "step", "0", "r0:5", "pre:3", "dense:cuda", "gather:torch")


def _randn(seed, *shape, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# FaultInjector and backoff: the reference's decisions, bit for bit
# ---------------------------------------------------------------------------

class TestInjectorDeterminism:
    def test_same_seed_same_schedule(self):
        def pattern(inj):
            return [inj.fire("numerics", site=f"req:{i % 3}")
                    for i in range(64)]
        a = pattern(faults.FaultInjector(seed=42, rates={"numerics": 0.3}))
        b = pattern(faults.FaultInjector(seed=42, rates={"numerics": 0.3}))
        assert a == b and any(a) and not all(a)

    def test_different_seeds_differ(self):
        def pattern(seed):
            inj = faults.FaultInjector(seed=seed, rates={"pool": 0.5})
            return [inj.fire("pool", site="r0") for _ in range(64)]
        assert pattern(1) != pattern(2)

    def test_visit_counters_are_per_site(self):
        inj = faults.FaultInjector(seed=0, rates={"kernel": 0.5})
        inj.fire("kernel", site="a")
        inj.fire("kernel", site="a")
        inj.fire("kernel", site="b")
        assert inj.visits == {("kernel", "a"): 2, ("kernel", "b"): 1}

    def test_schedule_pins_exact_visits(self):
        inj = faults.FaultInjector(schedule={("kernel", "dense:torch"):
                                             (1, 3)})
        got = [inj.fire("kernel", site="dense:torch") for _ in range(5)]
        assert got == [False, True, False, True, False]
        assert not inj.fire("kernel", site="conv2d:torch")

    def test_max_fires_quiesces(self):
        inj = faults.FaultInjector(rates={"latency": 1.0}, max_fires=2)
        got = [inj.fire("latency") for _ in range(5)]
        assert got == [True, True, False, False, False]
        assert inj.total_fired == 2

    def test_unknown_point_rejected(self):
        inj = faults.FaultInjector()
        with pytest.raises(ValueError, match="unknown fault point"):
            inj.fire("cosmic-ray")
        with pytest.raises(ValueError, match="unknown fault point"):
            faults.FaultInjector(rates={"cosmic-ray": 1.0})
        with pytest.raises(ValueError, match="unknown fault point"):
            faults.FaultInjector(schedule={("cosmic-ray", ""): (0,)})

    def test_latency_returns_spike_or_zero(self):
        inj = faults.FaultInjector(schedule={("latency", "step"): (1,)},
                                   latency_s=0.25)
        assert inj.latency("step") == 0.0
        assert inj.latency("step") == 0.25

    def test_events_record_fired_visits(self):
        inj = faults.FaultInjector(schedule={("pool", "r0:5"): (2,)})
        for _ in range(3):
            inj.fire("pool", site="r0:5")
        assert [(e.point, e.site, e.visit) for e in inj.events] \
            == [("pool", "r0:5", 2)]

    @pytest.mark.parametrize("seed", [0, 1, 7, 23, 2 ** 40 + 3])
    def test_decisions_equal_the_reference(self, seed):
        """Every point, several sites, 400 visits each, at rates and under
        a schedule and a fire cap: the same fires, events and summary."""
        kw = dict(rates={p: r for p, r in zip(
            faults.POINTS, (0.05, 0.3, 0.5, 0.15, 0.9))},
            schedule={("pool", "0"): (0, 1, 7), ("kernel", "step"): ()},
            latency_s=0.003)
        for cap in (None, 40):
            port = faults.FaultInjector(seed, max_fires=cap, **kw)
            ref = jax_faults.FaultInjector(seed, max_fires=cap, **kw)
            for visit in range(400):
                for point in faults.POINTS:
                    for site in SITES:
                        assert port.fire(point, site) \
                            == ref.fire(point, site), (point, site, visit)
            assert [(e.point, e.site, e.visit) for e in port.events] \
                == [(e.point, e.site, e.visit) for e in ref.events]
            assert port.summary() == ref.summary()
            assert port.visits == ref.visits

    def test_u01_equals_the_reference(self):
        for seed in (0, 5, 99):
            for visit in range(0, 5000, 7):
                assert faults._u01(seed, "numerics", "r1", visit) \
                    == jax_faults._u01(seed, "numerics", "r1", visit)


class TestBackoff:
    def test_deterministic_and_capped(self):
        a = [faults.backoff_s(k, base=0.01, cap=0.5, seed=3, token="r1")
             for k in range(1, 12)]
        assert a == [faults.backoff_s(k, base=0.01, cap=0.5, seed=3,
                                      token="r1") for k in range(1, 12)]
        for k, w in enumerate(a, start=1):
            raw = min(0.5, 0.01 * 2 ** (k - 1))
            assert 0.5 * raw <= w < raw

    def test_distinct_tokens_decorrelate(self):
        xs = [faults.backoff_s(3, seed=0, token=f"r{i}") for i in range(8)]
        assert len(set(xs)) == len(xs)

    def test_attempt_zero_is_free(self):
        assert faults.backoff_s(0) == 0.0

    def test_floats_equal_the_reference(self):
        for seed in (0, 3, 23):
            for token in ("", "0", "r1:7"):
                for attempt in range(0, 40):
                    for base, cap in ((0.01, 1.0), (0.002, 0.1)):
                        kw = dict(base=base, cap=cap, seed=seed, token=token)
                        assert faults.backoff_s(attempt, **kw) \
                            == jax_faults.backoff_s(attempt, **kw)


class TestActivation:
    def test_injecting_restores_previous(self):
        assert faults.active() is None
        outer, inner = faults.FaultInjector(seed=1), faults.FaultInjector(2)
        with faults.injecting(outer):
            assert faults.active() is outer
            with faults.injecting(inner):
                assert faults.active() is inner
            assert faults.active() is outer
        assert faults.active() is None

    def test_install_uninstall(self):
        inj = faults.FaultInjector()
        faults.install(inj)
        assert faults.active() is inj
        faults.install(None)
        assert faults.active() is None

    def test_taxonomy(self):
        assert issubclass(faults.KernelFault, faults.TransientError)
        assert issubclass(faults.ReplicaLost, faults.TransientError)
        assert issubclass(faults.FatalError, faults.ServeError)
        assert faults.POINTS == jax_faults.POINTS


# ---------------------------------------------------------------------------
# The fallback chain: bitwise pairs only
# ---------------------------------------------------------------------------

def _ops():
    """(kind, precision, act, taps, fn) cases: fn(backend) runs the op
    eagerly on `backend`."""
    x, w, b = _randn(1, 5, 64), _randn(2, 64, 96), _randn(3, 96)
    xc, wc, bc = _randn(4, 2, 9, 9, 8), _randn(5, 3, 3, 4, 64), _randn(6, 64)
    xd, wd4, wd12 = _randn(7, 2, 11, 32), _randn(8, 4, 32), _randn(9, 12, 32)
    pool = _randn(10, 9, 4, 2, 3).to(torch.bfloat16)
    table = torch.tensor([[3, 1, 0], [8, 8, 2]], dtype=torch.int32)

    def on(backend, fn, **cfg):
        def run():
            with E.using_config(E.EngineConfig(backend=backend, **cfg)):
                return fn()
        return run

    cases = []
    for prec in ("fp32", "int8"):
        for act in (None, "relu", "gelu"):
            cases.append(("dense", prec, act, 0, lambda be, p=prec, a=act: on(
                be, lambda: E.dense(x, w, bias=b, act=a), precision=p)()))
            cases.append(("conv2d", prec, act, 0, lambda be, p=prec, a=act:
                          on(be, lambda: E.conv2d(
                              xc, wc, stride=2, pad=1, groups=2, bias=bc,
                              act=a), precision=p)()))
    cases.append(("dense", "int8", "relu", 0, lambda be: on(
        be, lambda: E.dense(x.to(torch.bfloat16), w.to(torch.bfloat16),
                            act="relu"), precision="int8")()))
    cases.append(("conv1d_dw", "fp32", None, 4, lambda be: on(
        be, lambda: E.conv1d_depthwise(xd, wd4))()))
    cases.append(("conv1d_dw", "fp32", None, 12, lambda be: on(
        be, lambda: E.conv1d_depthwise(xd, wd12, causal=False))()))
    cases.append(("gather", "fp32", None, 0, lambda be: on(
        be, lambda: E.paged_gather(pool, table))()))
    return cases


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 \
        else t.view(torch.int32)


@pytest.mark.parametrize("case", range(len(_ops())))
def test_every_chain_pair_is_bitwise(case):
    """Each hop the chain lists returns the bits of the backend it leaves;
    every (kind, precision, act) the chain refuses on "cuda" is one whose
    pair differs here or on the card."""
    kind, prec, act, taps, fn = _ops()[case]
    for src in E.backend_names():
        chain = dispatch.fallback_chain(src, kind, prec, act, taps)
        want = fn(src)
        for dst in chain:
            got = fn(dst)
            assert got.dtype == want.dtype
            assert torch.equal(_bits(got), _bits(want)), (src, dst)
    cuda = dispatch.fallback_chain("cuda", kind, prec, act, taps)
    hops = kind == "gather" or (prec == "int8" and act != "gelu") \
        or (kind == "conv1d_dw" and taps <= 8)
    assert bool(cuda) == hops
    if kind == "conv1d_dw":
        assert cuda == (("torch",) if taps <= 8 else ())
    elif hops:
        assert cuda == ("torch", "ref")


def test_chain_is_declared():
    assert dispatch.fallback_chain("cuda", "dense") == ()
    assert dispatch.fallback_chain("cuda", "conv2d", "fp32", "relu") == ()
    assert dispatch.fallback_chain("cuda", "dense", "int8", "gelu") == ()
    assert dispatch.fallback_chain("cuda", "dense", "int8", "relu") \
        == ("torch", "ref")
    assert dispatch.fallback_chain("torch", "dense") == ("ref",)
    assert dispatch.fallback_chain("torch", "conv2d") == ()
    assert dispatch.fallback_chain("torch", "conv2d", "int8", "gelu") == ("ref",)
    assert dispatch.fallback_chain("ref", "gather") == ()


class TestDispatchFallback:
    def _xw(self):
        return _randn(11, 8, 64), _randn(12, 64, 32)

    def test_kernel_fault_hops_bitwise_equal(self):
        x, w = self._xw()
        cfg = E.EngineConfig(precision="int8")
        with E.using_config(cfg):
            clean = E.dense(x, w, act="relu")
        inj = faults.FaultInjector(schedule={("kernel", "dense:cuda"): (0,)})
        with E.using_config(cfg.replace(fallback="chain")), \
                faults.injecting(inj), E.tracking() as led:
            out = E.dense(x, w, act="relu")
        assert torch.equal(out, clean)
        assert [(f.kind, f.src, f.dst) for f in led.fallbacks] \
            == [("dense", "cuda", "torch")]
        assert inj.fallbacks == [("dense", "cuda", "torch")]

    def test_fail_stop_without_chain(self):
        x, w = self._xw()
        inj = faults.FaultInjector(schedule={("kernel", "dense:cuda"): (0,)})
        with faults.injecting(inj), pytest.raises(faults.KernelFault):
            E.dense(x, w)

    def test_refused_pair_lets_the_fault_through(self):
        """fp32 dense has no hop from "cuda": under the chain the fault
        still reaches the caller, a `TransientError`."""
        x, w = self._xw()
        inj = faults.FaultInjector(schedule={("kernel", "dense:cuda"): (0,)})
        with E.using_config(E.EngineConfig(fallback="chain")), \
                faults.injecting(inj), E.tracking() as led:
            with pytest.raises(faults.TransientError):
                E.dense(x, w)
        assert led.fallbacks == [] and inj.fallbacks == []
        assert inj.visits == {("kernel", "dense:cuda"): 1}

    def test_chain_exhausted_reraises(self):
        x, w = self._xw()
        inj = faults.FaultInjector(schedule={
            ("kernel", "dense:cuda"): (0,), ("kernel", "dense:torch"): (0,),
            ("kernel", "dense:ref"): (0,)})
        with E.using_config(E.EngineConfig(fallback="chain",
                                           precision="int8")), \
                faults.injecting(inj), pytest.raises(faults.KernelFault):
            E.dense(x, w)
        assert inj.total_fired == 3

    def test_a_real_error_is_never_caught(self, monkeypatch):
        """Only the injected fault is answered: a backend's own error (a
        build or launch failure) propagates under the chain, unrecorded."""
        x, w = self._xw()
        cuda = dispatch.get_backend("cuda")

        def broken(*a, **k):
            raise RuntimeError("launch failed")

        monkeypatch.setitem(dispatch._REGISTRY, "cuda",
                            dispatch.EngineBackend(
                                "cuda", cuda.conv2d, broken, cuda.gather,
                                cuda.conv1d_depthwise))
        inj = faults.FaultInjector()
        with E.using_config(E.EngineConfig(fallback="chain",
                                           precision="int8")), \
                faults.injecting(inj), E.tracking() as led:
            with pytest.raises(RuntimeError, match="launch failed"):
                E.dense(x, w)
        assert led.fallbacks == [] and inj.fallbacks == []

    def test_clean_path_records_nothing(self):
        x, w = self._xw()
        with E.using_config(E.EngineConfig(fallback="chain")), \
                E.tracking() as led:
            E.dense(x, w)
        assert led.fallbacks == []

    def test_eager_ops_meet_the_point_on_every_call(self):
        x, w = self._xw()
        inj = faults.FaultInjector()
        with faults.injecting(inj):
            for _ in range(3):
                E.dense(x, w)
        assert inj.visits == {("kernel", "dense:cuda"): 3}

    def test_fallback_config_validated(self):
        with pytest.raises(ValueError, match="fallback"):
            E.EngineConfig(fallback="retry")


def _tiny_cnn_program(dtype=torch.float32):
    def fn(p, x):
        h = E.conv2d(x, p["c1"], stride=2, pad=1, bias=p["b1"], act="relu")
        h = E.conv2d(h, p["c2"], pad=1, groups=2, bias=p["b2"], act="relu")
        return E.dense(h.reshape(h.shape[0], -1), p["fc"], bias=p["bf"])

    def avals(b):
        meta = dict(device="meta", dtype=dtype)
        return ({"c1": torch.empty(3, 3, 3, 64, **meta),
                 "b1": torch.empty(64, **meta),
                 "c2": torch.empty(3, 3, 32, 64, **meta),
                 "b2": torch.empty(64, **meta),
                 "fc": torch.empty(4 * 4 * 64, 96, **meta),
                 "bf": torch.empty(96, **meta)},
                torch.empty(b, 8, 8, 3, **meta))
    return E.trace_program(fn, *avals(1), name="tiny", batch_size=1,
                           batch_axes=E.infer_batch_axes(avals(1), avals(2)))


def _tiny_params(dtype=torch.float32):
    shapes = {"c1": (3, 3, 3, 64), "b1": (64,), "c2": (3, 3, 32, 64),
              "b2": (64,), "fc": (4 * 4 * 64, 96), "bf": (96,)}
    return {k: _randn(20 + i, *s, dtype=dtype) * 0.2
            for i, (k, s) in enumerate(shapes.items())}


class TestCompiledHook:
    def test_point_met_once_and_the_hop_pinned(self):
        prog, params = _tiny_cnn_program(), _tiny_params()
        cfg = E.EngineConfig(precision="int8", fallback="chain")
        x = _randn(30, 1, 8, 8, 3)
        clean = E.compile(prog, cfg).apply(params, x)
        net = E.compile(prog, cfg)
        assert net.backends() == ("cuda",) * 3 and net.hooked
        inj = faults.FaultInjector(schedule={("kernel", "conv2d:cuda"): (1,)})
        with faults.injecting(inj), E.tracking() as led:
            first = net.apply(params, x)
            visits = dict(inj.visits)
            again = net.apply(params, x)
        assert visits == {("kernel", "conv2d:cuda"): 2,
                          ("kernel", "conv2d:torch"): 1,
                          ("kernel", "dense:cuda"): 1}
        assert inj.visits == visits            # replays call no hook
        assert net.backends() == ("cuda", "torch", "cuda")
        assert not net.hooked
        assert [(f.kind, f.src, f.dst) for f in led.fallbacks] \
            == [("conv2d", "cuda", "torch")]
        assert torch.equal(first, clean) and torch.equal(again, clean)

    def test_a_faulted_apply_stays_hooked(self):
        prog, params = _tiny_cnn_program(), _tiny_params()
        net = E.compile(prog, E.EngineConfig(fallback="chain"))
        x = _randn(31, 1, 8, 8, 3)
        inj = faults.FaultInjector(schedule={("kernel", "dense:cuda"): (0,)})
        with faults.injecting(inj):
            with pytest.raises(faults.KernelFault):
                net.apply(params, x)
            assert net.hooked and net.backends() == ("cuda",) * 3
            out = net.apply(params, x)     # the next visit does not fire
        assert not net.hooked
        assert torch.equal(out, E.compile(prog).apply(params, x))


# ---------------------------------------------------------------------------
# Serving programs: a faulted apply leaves the pool; guard variants
# ---------------------------------------------------------------------------

MAX_LEN = 32


@pytest.fixture(scope="module")
def lm():
    cfg = reduced("smollm_135m")
    params = T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    pool = KVBlockPool(cfg, max_len=MAX_LEN, block_size=8, num_blocks=12,
                       device="cpu")
    for rid, seq in ((0, 5), (1, 9)):
        pool.register(rid)
        pool.ensure(rid, seq)
    # fill the pool with finite values, as serving leaves it
    gen = torch.Generator().manual_seed(0)
    for a in E.program.tree_leaves(pool.arrays):
        a.copy_(torch.randn(a.shape, generator=gen).to(a.dtype))
    return cfg, params, pool


def _decode_args(cfg, params, pool, bucket=8):
    rids = [0, 1]
    toks = torch.tensor([[3], [7]] + [[0]] * (bucket - 2), dtype=torch.int32)
    pos = torch.tensor([5, 9] + [0] * (bucket - 2), dtype=torch.int32)
    return (params, pool.arrays, pool.table_rows(rids, bucket),
            pool.slot_rows(rids, bucket), toks, pos)


def _prefill_args(cfg, params, pool):
    return (params, pool.arrays,
            torch.tensor(pool.allocator.tables[1], dtype=torch.int32),
            torch.tensor(pool._slot_of[1], dtype=torch.int32),
            torch.tensor([[1, 2, 3, 4, 5, 6, 7, 8, 9]], dtype=torch.int32))


def _snapshot(pool):
    return [a.clone() for a in E.program.tree_leaves(pool.arrays)]


def _restore(pool, snap):
    for a, b in zip(E.program.tree_leaves(pool.arrays), snap):
        a.copy_(b)


@pytest.mark.parametrize("which", ["decode", "prefill"])
@pytest.mark.parametrize("visit", [0, 5, -1])
def test_a_faulted_apply_leaves_the_pool_as_it_was(lm, which, visit):
    """A kernel fault at the first, a middle or the last dense op of a
    serving program's first apply raises before its pool write, the
    program's last op: the pool is bitwise unchanged."""
    cfg, params, pool = lm
    if which == "decode":
        prog = SE.paged_decode_program(cfg, pool.layout, 8, guard=True)
        args = _decode_args(cfg, params, pool) + (torch.zeros(8),)
    else:
        prog = SE.prefill_ingest_program(cfg, pool.layout, 9, guard=True)
        args = _prefill_args(cfg, params, pool) + (torch.tensor(0.0),)
    n_dense = sum(op.kind == "dense" for op in prog.ops)
    net = E.compile(prog, E.EngineConfig(row_align=8, fallback="chain"))
    snap = _snapshot(pool)
    inj = faults.FaultInjector(schedule={
        ("kernel", "dense:cuda"): (visit % n_dense,)})
    with faults.injecting(inj), pytest.raises(faults.TransientError):
        net.apply(*args)
    for a, b in zip(E.program.tree_leaves(pool.arrays), snap):
        assert torch.equal(a, b)
    assert inj.total_fired == 1


@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_guard_programs_are_the_unguarded_ones_at_zero_poison(lm, which):
    cfg, params, pool = lm
    conf = E.EngineConfig(row_align=8)
    if which == "decode":
        make = lambda g: SE.paged_decode_program(cfg, pool.layout, 8,  # noqa
                                                 guard=g)
        args, zero = _decode_args(cfg, params, pool), torch.zeros(8)
        nan = torch.tensor([0.0, float("nan")] + [0.0] * 6)
    else:
        make = lambda g: SE.prefill_ingest_program(  # noqa
            cfg, pool.layout, 9, guard=g)
        args, zero = _prefill_args(cfg, params, pool), torch.tensor(0.0)
        nan = torch.tensor(float("nan"))
    plain, guarded = make(False), make(True)
    assert guarded.name == plain.name + "-guard"
    assert guarded.ops == plain.ops
    snap = _snapshot(pool)
    tok, _ = E.compile(plain, conf).apply(*args)
    after = _snapshot(pool)
    _restore(pool, snap)
    gnet = E.compile(guarded, conf)
    gtok, ok, _ = gnet.apply(*args, zero)
    assert torch.equal(gtok, tok) and bool(ok.all())
    for a, b in zip(E.program.tree_leaves(pool.arrays), after):
        assert torch.equal(a, b)
    _restore(pool, snap)
    ptok, pok, _ = gnet.apply(*args, nan)
    # the pool takes the clean step's finite state even when poisoned
    for a, b in zip(E.program.tree_leaves(pool.arrays), after):
        assert torch.equal(a, b)
    _restore(pool, snap)
    if which == "decode":
        assert pok.tolist() == [True, False] + [True] * 6
        assert ptok[0] == tok[0] and torch.equal(ptok[2:], tok[2:])
    else:
        assert not bool(pok)


# ---------------------------------------------------------------------------
# Scheduler(faults=): results bitwise, the hop pinned, spikes counted
# ---------------------------------------------------------------------------

def test_static_scheduler_under_faults_is_bitwise():
    prog, params = _tiny_cnn_program(), _tiny_params()
    cfg = E.EngineConfig(row_align=8, precision="int8", fallback="chain")
    one = E.compile(prog, cfg)
    xs = [_randn(40 + i, 1, 8, 8, 3) for i in range(6)]
    solo = [one.apply(params, x) for x in xs]
    inj = faults.FaultInjector(
        seed=5, rates={"latency": 1.0}, latency_s=0.0005,
        schedule={("kernel", "conv2d:cuda"): (3,)})
    sched = Scheduler(config=cfg, max_batch=4, faults=inj)
    sched.register("tiny", prog, shared_args=(params,))
    tickets = [sched.submit("tiny", x) for x in xs]
    sched.drain()
    for t, want in zip(tickets, solo):
        assert t.done and torch.equal(t.result, want)
    st = sched.stats()
    # 6 requests ride buckets 4 and 2; the 4th conv2d:cuda visit is the
    # second conv of bucket 2's first apply
    assert st["fallbacks"] == [("conv2d", "cuda", "torch")]
    assert sched.compiled("tiny", 4).backends() == ("cuda",) * 3
    assert sched.compiled("tiny", 2).backends() == ("cuda", "torch", "cuda")
    assert st["latency_spikes"] == inj.fired["latency"] > 0
    assert st["faults"] == inj.summary()
