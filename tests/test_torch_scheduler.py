"""The port's static `Scheduler` and its re-batchable programs on the CPU,
against the JAX package.

Weights and inputs are made with numpy from a seed and moved into both
packages. The port runs its default "cuda" backend on CPU tensors, i.e.
each kernel wrapper's plain version.

  * `infer_batch_axes`, `Program.with_batch` (op lists, `table4_row()`) and
    the dense serving programs (`prefill_program`, `decode_program`) equal
    the reference's; the port's programs repeat the reference's one traced
    layer group `n_groups` times (ROADMAP section 3);
  * for one submit sequence, the port's scheduling decisions (each
    ticket's bucket, fill and row, the service order), its `stats()`
    counters, plan latencies and plan MACs, and its admission refusals are
    exactly the JAX `Scheduler`'s, under "spf" and "fifo";
  * its results are bitwise equal to the port's batch-1
    `CompiledNet.apply` of the same request (the reference's parity cases
    of tests/test_scheduler.py, bucket 16 beyond `row_align` included),
    within 1e-5 x max of the JAX scheduler's in fp32 and bitwise equal to
    them under int8;
  * `gfid_conv.f32_plan` and `bf16_plan` take one split of K at every
    batch, so that the card's convs give an image one result in any bucket.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.models import cnn as jax_cnn
from repro.serve import engine as JSE
from repro.serve import scheduler as JSCH
from repro_torch import engine as TE
from repro_torch.configs.base import reduced
from repro_torch.kernels import gfid_conv
from repro_torch.models import cnn as t_cnn
from repro_torch.models import transformer as T
from repro_torch.serve import engine as SE
from repro_torch.serve import scheduler as SCH

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-5
SERVING = TE.EngineConfig(row_align=8)
JSERVING = JE.EngineConfig(row_align=8)
MAX_LEN = 32


# ---------------------------------------------------------------------------
# programs in both packages
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mlp_programs(d_in=16, d_h=32, d_out=10, name="mlp"):
    """The reference's tiny two-layer MLP program (tests/test_scheduler.py)
    in both packages: (JAX program, port program)."""
    def jfn(w, x):
        return JE.dense(jax.nn.relu(JE.dense(x, w["w1"])), w["w2"])

    def javals(b):
        return ({"w1": jax.ShapeDtypeStruct((d_in, d_h), jnp.float32),
                 "w2": jax.ShapeDtypeStruct((d_h, d_out), jnp.float32)},
                jax.ShapeDtypeStruct((b, d_in), jnp.float32))

    def tfn(w, x):
        return TE.dense(torch.relu(TE.dense(x, w["w1"])), w["w2"])

    def tavals(b):
        return ({"w1": _meta(d_in, d_h), "w2": _meta(d_h, d_out)},
                _meta(b, d_in))

    return (JE.trace_program(jfn, *javals(1), name=name, batch_size=1,
                             batch_axes=JE.infer_batch_axes(javals(1),
                                                            javals(2))),
            TE.trace_program(tfn, *tavals(1), name=name, batch_size=1,
                             batch_axes=TE.infer_batch_axes(tavals(1),
                                                            tavals(2))))


def _mlp_weights(d_in=16, d_h=32, d_out=10, seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": rng.standard_normal((d_in, d_h)).astype(np.float32),
            "w2": rng.standard_normal((d_h, d_out)).astype(np.float32)}


def _tiny(mod):
    """2 convs (the second grouped and strided) + 2 FCs at 32x32x3, as in
    tests/test_torch_cnn.py."""
    convs = (mod.ConvDef("a", 3, 8, 3, stride=1, pad=1, pool=2),
             mod.ConvDef("b", 8, 12, 3, stride=2, pad=1, groups=2))
    fcs = (mod.FCDef("fc1", 8 * 8 * 12, 32), mod.FCDef("fc2", 32, 10,
                                                        relu=False))
    return mod.CNNDef("tiny", (32, 32, 3), convs, fcs, "plain")


def _tiny_weights(seed=0):
    net = _tiny(jax_cnn)
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"conv": {}, "fc": {}}
    for cd in net.convs:
        cg = cd.c_in // cd.groups
        params["conv"][cd.name] = {
            "w": normal((cd.k, cd.k, cg, cd.c_out),
                        (2.0 / (cd.k * cd.k * cg)) ** 0.5),
            "b": normal((cd.c_out,), 0.05)}
    for fd in net.fcs:
        params["fc"][fd.name] = {"w": normal((fd.n, fd.m), (2.0 / fd.n) ** 0.5),
                                 "b": normal((fd.m,), 0.05)}
    return params


def _tiny_programs():
    """The tiny CNN's forward, traced in both packages with batch
    metadata: (JAX program, port program)."""
    w = _tiny_weights()
    jw = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), w)
    tw = jax.tree_util.tree_map(lambda a: _meta(*a.shape), w)

    def jx(b):
        return jax.ShapeDtypeStruct((b, 32, 32, 3), jnp.float32)

    jfn = functools.partial(jax_cnn._forward, _tiny(jax_cnn))
    tfn = functools.partial(t_cnn._forward, _tiny(t_cnn))
    return (JE.trace_program(jfn, jw, jx(1), name="tiny", batch_size=1,
                             batch_axes=JE.infer_batch_axes((jw, jx(1)),
                                                            (jw, jx(2)))),
            TE.trace_program(tfn, tw, _meta(1, 32, 32, 3), name="tiny",
                             batch_size=1,
                             batch_axes=TE.infer_batch_axes(
                                 (tw, _meta(1, 32, 32, 3)),
                                 (tw, _meta(2, 32, 32, 3)))))


def _both(tree):
    """A numpy tree as (JAX arrays, CPU tensors)."""
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(torch.from_numpy, tree))


def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec,
             op.stride, op.pad, op.groups) for op in ops]


def _repeat_groups(ops, n_groups, n_lead, n_body):
    """The reference's op list with its one traced group body repeated."""
    return (ops[:n_lead] + ops[n_lead:n_lead + n_body] * n_groups
            + ops[n_lead + n_body:])


@pytest.fixture(scope="module")
def cfg():
    return reduced("smollm_135m")


@pytest.fixture(scope="module")
def lm(smollm_params):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    smollm_params),
                             device="cpu")


# ---------------------------------------------------------------------------
# infer_batch_axes, with_batch, the serving programs
# ---------------------------------------------------------------------------

def _cnn_avals(b):
    w = _tiny_weights()
    return ((jax.tree_util.tree_map(
                lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), w),
             jax.ShapeDtypeStruct((b, 32, 32, 3), jnp.float32)),
            (jax.tree_util.tree_map(lambda a: _meta(*a.shape), w),
             _meta(b, 32, 32, 3)))


def _mlp_avals(b):
    return (({"w": jax.ShapeDtypeStruct((16, 4), jnp.float32)},
             jax.ShapeDtypeStruct((b, 16), jnp.float32),
             jax.ShapeDtypeStruct((), jnp.int32)),
            ({"w": _meta(16, 4)}, _meta(b, 16), _meta(dtype=torch.int32)))


@pytest.mark.parametrize("avals", [_cnn_avals, _mlp_avals],
                         ids=["cnn", "mlp"])
def test_infer_batch_axes_matches_reference(avals):
    (j1, t1), (j2, t2) = avals(1), avals(3)
    want = JE.infer_batch_axes(j1, j2)
    got = TE.infer_batch_axes(t1, t2)
    assert got == want


def test_infer_batch_axes_on_the_decode_state_matches_reference(
        cfg, smollm_reduced):
    want = JE.infer_batch_axes(
        (JSE.decode_state_shapes(smollm_reduced, 1, MAX_LEN),),
        (JSE.decode_state_shapes(smollm_reduced, 2, MAX_LEN),))
    got = TE.infer_batch_axes((SE.decode_state_shapes(cfg, 1, MAX_LEN),),
                              (SE.decode_state_shapes(cfg, 2, MAX_LEN),))
    assert got == want
    # the grouped layers carry the batch on axis 1, behind the group axis
    assert got[0]["groups"]["0"] == {"k": 1, "v": 1}


@pytest.mark.parametrize("a,b,match", [
    ((2, 3), (2, 3, 1), "rank changed with batch"),
    ((2, 3), (4, 5), "ambiguous batch axis"),
])
def test_infer_batch_axes_refuses_like_reference(a, b, match):
    with pytest.raises(ValueError, match=match) as jerr:
        JE.infer_batch_axes((jax.ShapeDtypeStruct(a, jnp.float32),),
                            (jax.ShapeDtypeStruct(b, jnp.float32),))
    with pytest.raises(ValueError, match=match) as terr:
        TE.infer_batch_axes((_meta(*a),), (_meta(*b),))
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("batch", [1, 2, 8, 32])
@pytest.mark.parametrize("net", ["alexnet", "vgg16", "resnet50"])
def test_with_batch_ops_and_table4_match_reference(net, batch):
    jp = jax_cnn.program(net).with_batch(batch)
    tp = t_cnn.program(net).with_batch(batch)
    assert tp.batch_size == jp.batch_size == batch
    assert _op_keys(tp.ops) == _op_keys(jp.ops)
    assert tuple(tp.in_avals[1].shape) == tuple(jp.in_avals[1].shape)
    assert TE.plan_network(tp, SERVING).table4_row() \
        == JE.plan_network(jp, JSERVING).table4_row()
    # the same as a program built at that batch, not traced again
    assert _op_keys(tp.ops) == _op_keys(t_cnn.program(net, batch=batch).ops)


def test_with_batch_refuses_a_program_without_batch_metadata():
    prog = TE.Program("bare", t_cnn.program("alexnet").ops)
    with pytest.raises(ValueError, match="no batch metadata"):
        prog.with_batch(2)
    with pytest.raises(ValueError, match="batch must be >= 1"):
        t_cnn.program("alexnet").with_batch(0)
    with pytest.raises(ValueError, match="together"):
        TE.trace_program(lambda x: x, _meta(1, 4), batch_size=1)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("logits_only", [False, True])
def test_prefill_program_repeats_the_reference_group(cfg, smollm_reduced,
                                                     batch, logits_only):
    tp = SE.prefill_program(cfg, batch, 9, MAX_LEN, logits_only=logits_only)
    jp = JSE.prefill_program(smollm_reduced, batch, 9, MAX_LEN,
                             logits_only=logits_only)
    assert tp.name == jp.name
    assert _op_keys(tp.ops) == _repeat_groups(_op_keys(jp.ops),
                                              cfg.n_groups, 0, 7)
    assert tp.batch_axes == jp.batch_axes[:1] + ({"tokens": 0},)
    assert _op_keys(tp.with_batch(4).ops) == _repeat_groups(
        _op_keys(jp.with_batch(4).ops), cfg.n_groups, 0, 7)


@pytest.mark.parametrize("batch", [1, 4])
def test_decode_program_repeats_the_reference_group(cfg, smollm_reduced,
                                                    batch):
    tp = SE.decode_program(cfg, batch, MAX_LEN)
    jp = JSE.decode_program(smollm_reduced, batch, MAX_LEN)
    assert tp.name == jp.name
    assert _op_keys(tp.ops) == _repeat_groups(_op_keys(jp.ops),
                                              cfg.n_groups, 0, 7)
    assert len(tp.ops) == cfg.n_groups * 7 + 1
    assert tp.batch_axes[1:] == jp.batch_axes[1:]
    assert _op_keys(tp.with_batch(8).ops) == _repeat_groups(
        _op_keys(jp.with_batch(8).ops), cfg.n_groups, 0, 7)


# ---------------------------------------------------------------------------
# scheduling decisions, stats and admission against the JAX Scheduler
# ---------------------------------------------------------------------------

# (program, seed of its input) in submit order: the tiny CNN, a big and a
# small MLP, interleaved, with runs longer than max_batch
_SEQUENCE = [("tiny", 0), ("big", 1), ("small", 2), ("tiny", 3),
             ("tiny", 4), ("big", 5), ("tiny", 6), ("small", 7),
             ("tiny", 8), ("tiny", 9), ("big", 10), ("small", 11),
             ("tiny", 12)]


@functools.lru_cache(maxsize=None)
def _registry():
    """name -> (JAX program, port program, numpy weights, input shape)."""
    tiny = _tiny_programs()
    big, small = _mlp_programs(64, 128, 32, "big"), _mlp_programs(8, 16, 4,
                                                                  "small")
    return {"tiny": tiny + (_tiny_weights(), (1, 32, 32, 3)),
            "big": big + (_mlp_weights(64, 128, 32), (1, 64)),
            "small": small + (_mlp_weights(8, 16, 4, 1), (1, 8))}


def _input(name, seed):
    shape = _registry()[name][3]
    return np.random.default_rng(100 + seed).standard_normal(shape).astype(
        np.float32)


def _schedulers(policy, jcfg=JSERVING, tcfg=SERVING, **kw):
    js = JSCH.Scheduler(config=jcfg, policy=policy, max_batch=4, **kw)
    ts = SCH.Scheduler(config=tcfg, policy=policy, max_batch=4, **kw)
    for name, (jp, tp, w, _) in _registry().items():
        jw, tw = _both(w)
        js.register(name, jp, shared_args=(jw,))
        ts.register(name, tp, shared_args=(tw,))
    return js, ts


def _comparable(stats):
    """The stats without the wall-clock readings."""
    out = {k: v for k, v in stats.items()
           if k not in ("dispatch_wall_s", "throughput_rps")}
    return out


@functools.lru_cache(maxsize=None)
def _served(policy, precision="fp32"):
    """Both schedulers after draining _SEQUENCE: (JAX tickets, port
    tickets, JAX stats, port stats), tickets in completion order."""
    js, ts = _schedulers(policy, JSERVING.replace(precision=precision),
                         SERVING.replace(precision=precision))
    jt, tt = {}, {}
    for i, (name, seed) in enumerate(_SEQUENCE):
        x = _input(name, seed)
        jt[i] = js.submit(name, jnp.asarray(x))
        tt[i] = ts.submit(name, torch.from_numpy(x))
    jdone, tdone = js.drain(), ts.drain()
    ji = {id(t): i for i, t in jt.items()}
    ti = {id(t): i for i, t in tt.items()}
    return ([(ji[id(t)], t) for t in jdone], [(ti[id(t)], t) for t in tdone],
            js.stats(), ts.stats())


@pytest.mark.parametrize("policy", ["spf", "fifo"])
def test_scheduling_decisions_match_reference(policy):
    jdone, tdone, jstats, tstats = _served(policy)

    def decisions(done):
        return [(i, t.model, t.batch_bucket, t.batch_fill, t.batch_index)
                for i, t in done]

    assert decisions(tdone) == decisions(jdone)
    assert _comparable(tstats) == _comparable(jstats)
    assert tstats["plan_macs_served"] == jstats["plan_macs_served"] > 0
    for name in _registry():
        assert tstats["models"][name]["unit_plan_latency_s"] \
            == jstats["models"][name]["unit_plan_latency_s"]
    assert [t.unit_latency_s for _, t in tdone] \
        == [t.unit_latency_s for _, t in jdone]


@pytest.mark.parametrize("policy", ["spf", "fifo"])
def test_results_match_reference_and_the_request_alone(policy):
    jdone, tdone, _, _ = _served(policy)
    jres = {i: np.asarray(t.result) for i, t in jdone}
    alone = {name: TE.compile(tp, SERVING)
             for name, (_, tp, _, _) in _registry().items()}
    for i, t in tdone:
        name, seed = _SEQUENCE[i]
        got = t.result.numpy()
        want = jres[i]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()
        w = _both(_registry()[name][2])[1]
        solo = alone[name].apply(w, torch.from_numpy(_input(name, seed)))
        assert torch.equal(t.result, solo)
        assert len(t.ledger) == len(alone[name].plan.plans)


def test_int8_results_bitwise_equal_to_reference():
    jdone, tdone, jstats, tstats = _served("fifo", "int8")
    jres = {i: np.asarray(t.result) for i, t in jdone}
    assert _comparable(tstats) == _comparable(jstats)
    tiny = TE.compile(_registry()["tiny"][1], SERVING.replace(
        precision="int8"))
    assert set(tiny.precisions()) == {"int8"}
    for i, t in tdone:
        np.testing.assert_array_equal(t.result.numpy(), jres[i])
        name, seed = _SEQUENCE[i]
        if name == "tiny":
            w = _both(_registry()["tiny"][2])[1]
            assert torch.equal(t.result, tiny.apply(
                w, torch.from_numpy(_input(name, seed))))


def test_admission_refuses_the_same_request_as_reference():
    js, ts = _schedulers("fifo")
    unit = ts._entries["tiny"].unit_plan.total_latency_s
    assert unit == js._entries["tiny"].unit_plan.total_latency_s
    js.max_queue_cost_s = ts.max_queue_cost_s = 2.5 * unit
    refused = {"jax": [], "port": []}
    for i, (name, seed) in enumerate(_SEQUENCE):
        x = _input(name, seed)
        for key, s, arg in (("jax", js, jnp.asarray(x)),
                            ("port", ts, torch.from_numpy(x))):
            try:
                s.submit(name, arg)
            except (JSCH.AdmissionError, SCH.AdmissionError) as err:
                assert isinstance(err, JSCH.AdmissionError if key == "jax"
                                  else SCH.AdmissionError)
                refused[key].append((i, str(err)))
    assert refused["port"] == refused["jax"] and refused["port"]
    assert ts.queue_cost_s() == js.queue_cost_s()
    assert ts.pending() == js.pending()


def test_mesh_and_faults_name_their_roadmap_items():
    with pytest.raises(NotImplementedError, match="item 11"):
        SCH.Scheduler(mesh=object())
    with pytest.raises(NotImplementedError, match="item 9"):
        SCH.Scheduler(faults=object())


# ---------------------------------------------------------------------------
# golden parity: the port's scheduler against its batch-1 apply, bitwise
# (the cases of tests/test_scheduler.py)
# ---------------------------------------------------------------------------

def _port_mlp(d_in=16, d_h=32, d_out=10, name="mlp", seed=0):
    prog = _mlp_programs(d_in, d_h, d_out, name)[1]
    return prog, _both(_mlp_weights(d_in, d_h, d_out, seed))[1]


def _randn(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def test_mlp_requests_bitwise():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=4)
    sched.register("mlp", prog, shared_args=(w,))
    xs = [_randn(10 + i, 1, 16) for i in range(6)]
    tickets = [sched.submit("mlp", x) for x in xs]
    done = sched.drain()
    assert len(done) == 6 and all(t.done for t in tickets)
    alone = TE.compile(prog, SERVING)
    for t, x in zip(tickets, xs):
        assert torch.equal(t.result, alone.apply(w, x))


def test_cnn_requests_bitwise():
    # AlexNet at full width through cnn.program: conv and FC modes in one
    # batch, the reference's case
    params = t_cnn.init_cnn("alexnet", seed=0, device="cpu")
    prog = t_cnn.program("alexnet")
    sched = SCH.Scheduler(config=SERVING, max_batch=2)
    sched.register("alexnet", prog, shared_args=(params,))
    xs = [_randn(i, 1, 227, 227, 3) * 0.1 for i in range(3)]
    tickets = [sched.submit("alexnet", x) for x in xs]
    done = sched.drain()
    assert [t.batch_bucket for t in done] == [2, 2, 1]
    alone = TE.compile(prog, SERVING)
    for t, x in zip(tickets, xs):
        assert torch.equal(t.result, alone.apply(params, x))


def test_decode_requests_bitwise(cfg, lm):
    # a per-request dense state (batch axis 1 in the grouped layers) packed
    # into one batch-8 step; the shared position is a scalar
    prog = SE.decode_program(cfg, batch=1, max_len=MAX_LEN,
                             param_dtype=torch.float32)
    sched = SCH.Scheduler(config=SERVING, max_batch=8)
    pos = torch.tensor(3, dtype=torch.int32)
    sched.register("decode", prog, shared_args=(lm, pos))
    states = []
    for i in range(8):
        prompt = torch.from_numpy(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (1, 3)).astype(np.int32))
        with TE.using_config(SERVING), torch.no_grad():
            states.append(T.prefill(cfg, lm, {"tokens": prompt}, MAX_LEN)[1])
    toks = [torch.full((1, 1), 7 + i, dtype=torch.int32) for i in range(8)]
    tickets = [sched.submit("decode", s, t) for s, t in zip(states, toks)]
    done = sched.drain()
    assert len(done) == 8 and done[0].batch_bucket == 8
    alone = TE.compile(prog, SERVING)
    for t, s, tok in zip(tickets, states, toks):
        # the step writes its key and value into the state it is given
        copy = jax.tree_util.tree_map(torch.clone, s)
        assert torch.equal(t.result, alone.apply(lm, copy, tok, pos))


def test_scoring_requests_bitwise_and_match_reference(cfg, lm, smollm_reduced,
                                                      smollm_params):
    prog = SE.prefill_program(cfg, batch=1, seq=9, logits_only=True,
                              param_dtype=torch.float32)
    sched = SCH.Scheduler(config=SERVING, max_batch=4)
    sched.register("score", prog, shared_args=(lm,))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)
               for _ in range(3)]
    tickets = [sched.submit("score", {"tokens": torch.from_numpy(p)})
               for p in prompts]
    done = sched.drain()
    assert [t.batch_bucket for t in done] == [4, 4, 4]
    alone = TE.compile(prog, SERVING)
    jalone = JE.compile(JSE.prefill_program(smollm_reduced, 1, 9,
                                            logits_only=True), JSERVING)
    for t, p in zip(tickets, prompts):
        assert torch.equal(t.result, alone.apply(
            lm, {"tokens": torch.from_numpy(p)}))
        want = np.asarray(jalone.apply(smollm_params,
                                       {"tokens": jnp.asarray(p)}))
        got = t.result.numpy()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_bucket_beyond_row_align_bitwise():
    # max_batch=16 > row_align=8: the 16-bucket GEMMs run M=16 while the
    # solo path pads to M=8
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=16)
    sched.register("mlp", prog, shared_args=(w,))
    xs = [_randn(40 + i, 1, 16) for i in range(16)]
    tickets = [sched.submit("mlp", x) for x in xs]
    done = sched.drain()
    assert all(t.batch_bucket == 16 for t in done)
    alone = TE.compile(prog, SERVING)
    for t, x in zip(tickets, xs):
        assert torch.equal(t.result, alone.apply(w, x))


def test_mixed_queue_keeps_parity():
    big, bw = _port_mlp(64, 128, 32, "big")
    small, sw = _port_mlp(8, 16, 4, "small", seed=1)
    sched = SCH.Scheduler(config=SERVING, policy="spf", max_batch=4)
    sched.register("big", big, shared_args=(bw,))
    sched.register("small", small, shared_args=(sw,))
    reqs = []
    for i in range(4):
        name = "big" if i % 2 == 0 else "small"
        x = _randn(20 + i, 1, 64 if name == "big" else 8)
        reqs.append((name, x, sched.submit(name, x)))
    sched.drain()
    compiled = {"big": TE.compile(big, SERVING),
                "small": TE.compile(small, SERVING)}
    weights = {"big": bw, "small": sw}
    for name, x, t in reqs:
        assert torch.equal(t.result, compiled[name].apply(weights[name], x))


# ---------------------------------------------------------------------------
# policies, admission, bucketing, accounting (tests/test_scheduler.py)
# ---------------------------------------------------------------------------

def _mixed_queue(policy):
    big, bw = _port_mlp(512, 512, 256, "big")
    small, sw = _port_mlp(8, 16, 4, "small", seed=1)
    sched = SCH.Scheduler(config=SERVING, policy=policy, max_batch=4)
    sched.register("big", big, shared_args=(bw,))
    sched.register("small", small, shared_args=(sw,))
    for i, name in enumerate(["big", "small", "big", "small"]):
        sched.submit(name, _randn(i, 1, 512 if name == "big" else 8))
    done = sched.drain()
    return [t.model for t in done], sched


def test_spf_serves_cheapest_plan_first():
    models, sched = _mixed_queue("spf")
    assert models == ["small", "small", "big", "big"]
    e = sched._entries
    assert e["small"].unit_plan.total_latency_s \
        < e["big"].unit_plan.total_latency_s


def test_fifo_serves_arrival_order():
    models, _ = _mixed_queue("fifo")
    assert models == ["big", "big", "small", "small"]


def test_unknown_policy_rejected():
    with pytest.raises(ValueError, match="unknown policy"):
        SCH.Scheduler(policy="lifo")


def test_queue_cost_budget():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=4)
    entry = sched.register("mlp", prog, shared_args=(w,))
    unit = entry.unit_plan.total_latency_s
    sched.max_queue_cost_s = 2.5 * unit        # room for two requests
    x = torch.ones((1, 16))
    sched.submit("mlp", x)
    sched.submit("mlp", x)
    assert sched.queue_cost_s() == pytest.approx(2 * unit)
    with pytest.raises(SCH.AdmissionError, match="max_queue_cost_s"):
        sched.submit("mlp", x)
    sched.drain()                              # the queue empties, and
    sched.submit("mlp", x)                     # admission reopens


def test_submit_validation():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING)
    sched.register("mlp", prog, shared_args=(w,))
    with pytest.raises(KeyError, match="unknown model"):
        sched.submit("nope", torch.ones((1, 16)))
    with pytest.raises(ValueError, match="per-request"):
        sched.submit("mlp", torch.ones((1, 16)), torch.ones((1, 16)))
    with pytest.raises(ValueError, match="batch-1 avals"):
        sched.submit("mlp", torch.ones((2, 16)))      # a batch-2 request
    with pytest.raises(ValueError, match="batch-1 avals"):
        sched.submit("mlp", torch.ones((1, 8)))       # wrong feature dim
    with pytest.raises(ValueError, match="batch-1 avals"):
        sched.submit("mlp", torch.ones((1, 16), dtype=torch.float64))


def test_register_validation():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING)
    sched.register("mlp", prog, shared_args=(w,))
    with pytest.raises(ValueError, match="already registered"):
        sched.register("mlp", prog, shared_args=(w,))
    with pytest.raises(ValueError, match="shared_args"):
        sched.register("mlp2", prog)                  # missing weights
    with pytest.raises(ValueError, match="no executable fn"):
        sched.register("bare", TE.Program("bare", prog.ops))
    with pytest.raises(ValueError, match="no batch metadata"):
        sched.register("unbatched", TE.Program("u", prog.ops, fn=prog.fn,
                                               in_avals=prog.in_avals))


def test_mixed_batched_unbatched_leaves_rejected():
    def fn(w, req):
        return TE.dense(req["x"], w) * req["scale"]

    def avals(b):
        return (_meta(16, 4), {"x": _meta(b, 16), "scale": _meta()})

    prog = TE.trace_program(fn, *avals(1), name="mixed", batch_size=1,
                            batch_axes=TE.infer_batch_axes(avals(1),
                                                           avals(2)))
    sched = SCH.Scheduler(config=SERVING)
    with pytest.raises(ValueError, match="mixes batched and unbatched"):
        sched.register("mixed", prog)


def test_register_does_not_pollute_active_ledgers():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING)
    with TE.tracking() as led:
        sched.register("mlp", prog, shared_args=(w,))
    assert len(led) == 0


def test_bucket_ladder_and_padding():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=8)
    assert sched.buckets == (1, 2, 4, 8)
    sched.register("mlp", prog, shared_args=(w,))
    xs = [_randn(i, 1, 16) for i in range(3)]
    for x in xs:
        sched.submit("mlp", x)
    done = sched.drain()
    # 3 requests pack into the 4-bucket: fill 3, one slot padded with the
    # first request's tensors
    assert all(t.batch_bucket == 4 and t.batch_fill == 3 for t in done)
    assert [t.batch_index for t in done] == [0, 1, 2]
    stats = sched.stats()
    assert stats["models"]["mlp"]["padded_slots"] == 1
    assert stats["models"]["mlp"]["occupancy"] == pytest.approx(0.75)
    assert stats["models"]["mlp"]["compiled_buckets"] == [4]
    # the keys of unported items keep their idle values
    assert (stats["tuning"], stats["replicas"], stats["fallbacks"],
            stats["latency_spikes"], stats["faults"]) == ("off", 1, [], 0,
                                                          None)


def test_warmup_prebuilds_every_bucket_path():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=4)
    entry = sched.register("mlp", prog, shared_args=(w,))
    sched.warmup()
    assert sorted(entry.compiled) == [1, 2, 4]
    assert entry.pack_fn is not None
    assert sorted(entry.unpack) == [1, 2, 4]
    x = _randn(0, 1, 16)
    t = sched.submit("mlp", x)
    sched.drain()
    assert torch.equal(t.result, TE.compile(prog, SERVING).apply(w, x))


def test_pending_ticket_latency_is_nan_and_cancel_and_deadline():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING)
    sched.register("mlp", prog, shared_args=(w,))
    t = sched.submit("mlp", torch.ones((1, 16)))
    assert math.isnan(t.latency_s)
    gone = sched.submit("mlp", torch.ones((1, 16)))
    late = sched.submit("mlp", torch.ones((1, 16)), timeout_s=-1.0)
    assert sched.cancel(gone) and not sched.cancel(gone)
    done = sched.drain()
    assert done == [t] and t.latency_s >= 0.0 and not sched.cancel(t)
    assert late.expired and not late.done and gone.cancelled


def test_explicit_buckets_validated():
    with pytest.raises(ValueError, match="must end at"):
        SCH.Scheduler(max_batch=8, buckets=(1, 2))
    s = SCH.Scheduler(max_batch=6, buckets=(2, 6))
    assert s.buckets == (2, 6)
    assert s._bucket_for(1) == 2 and s._bucket_for(3) == 6


def test_ticket_ledger_records_unit_plan():
    prog, w = _port_mlp()
    sched = SCH.Scheduler(config=SERVING, max_batch=4)
    entry = sched.register("mlp", prog, shared_args=(w,))
    tickets = [sched.submit("mlp", torch.ones((1, 16))) for _ in range(4)]
    sched.drain()
    unit = entry.unit_plan
    for t in tickets:
        assert [r.plan for r in t.ledger] == list(unit.plans)
        assert t.ledger.total_macs == unit.total_macs
        assert t.ledger.total_cycles == unit.conv_cycles + unit.fc_cycles
    assert sched.ledger.total_macs == 4 * unit.total_macs
    stats = sched.stats()
    assert stats["plan_macs_served"] == 4 * unit.total_macs
    assert stats["throughput_rps"] > 0.0


# ---------------------------------------------------------------------------
# the conv plans: one split of K at every batch
# ---------------------------------------------------------------------------

def _conv_shapes(net):
    seen = {}
    for s in t_cnn.analytics_layers(net, main_path_only=False)[0]:
        key = (s.h_out * s.w_out, s.h_f * s.w_f * (s.c_in // s.groups),
               s.c_out // s.groups, s.groups, s.c_in // s.groups)
        seen.setdefault(key, s.name)
    return seen


@pytest.mark.parametrize("net", ["alexnet", "vgg16", "resnet50"])
def test_conv_plans_split_k_alike_at_every_batch(net):
    for (hw, k, og, groups, cg), name in _conv_shapes(net).items():
        for plan in (gfid_conv.f32_plan, gfid_conv.bf16_plan):
            one = plan(hw, k, og, groups, cg, image_pixels=hw)
            for b in range(1, 33):
                p = plan(b * hw, k, og, groups, cg, image_pixels=hw)
                assert (p.splits, p.chunks_per_split) \
                    == (one.splits, one.chunks_per_split), (name, b)
                # several splits: through the workspace while the blocks
                # leave the card idle, folded in each block once they fill it
                assert p.grid[2] in (1, p.splits)
                assert not p.fold or (p.grid[0] * p.grid[1] >= 132)
    # AlexNet's conv3-5 split K at batch 1 and fold at batch 32
    if net == "alexnet":
        conv3 = next(key for key, n in _conv_shapes(net).items()
                     if n == "conv3")
        for plan in (gfid_conv.f32_plan, gfid_conv.bf16_plan):
            assert plan(conv3[0], *conv3[1:], image_pixels=conv3[0]).splits > 1
            assert plan(32 * conv3[0], *conv3[1:],
                        image_pixels=conv3[0]).fold
