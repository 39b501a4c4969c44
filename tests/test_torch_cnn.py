"""The port's CNN path on the CPU against the JAX package.

Weights are made with numpy from a seed and moved into both packages (the
port through `params_from_jax`). The port runs its "cuda" backend on CPU
tensors, i.e. each kernel wrapper's plain version.

Tolerance: max|port - jax| <= 1e-4 * max|jax logits| for fp32: sums taken
in other orders across a deep network. Under int8 the logits are bitwise
equal (`assert_array_equal`): quantization, the exact int32 sums and the
dequant order are pinned, every op is relu or has no activation, and
max-pool is exact.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.models import cnn as jax_cnn
from repro_torch import engine as TE
from repro_torch.core import quant
from repro_torch.kernels import gfid_conv, gfid_matmul
from repro_torch.models import cnn as t_cnn

jax.config.update("jax_platform_name", "cpu")

TOL = 1e-4


def _numpy_params(convs, fcs, seed):
    """He-normal weights and small random biases, in the reference's
    layouts (HWIO conv, (n, m) FC)."""
    rng = np.random.default_rng(seed)

    def normal(shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"conv": {}, "fc": {}}
    for cd in convs:
        cg = cd.c_in // cd.groups
        params["conv"][cd.name] = {
            "w": normal((cd.k, cd.k, cg, cd.c_out),
                        (2.0 / (cd.k * cd.k * cg)) ** 0.5),
            "b": normal((cd.c_out,), 0.05)}
    for fd in fcs:
        params["fc"][fd.name] = {"w": normal((fd.n, fd.m), (2.0 / fd.n) ** 0.5),
                                 "b": normal((fd.m,), 0.05)}
    return params


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def _tiny(mod):
    """2 convs (the second grouped and strided) + 2 FCs at 32x32x3."""
    convs = (mod.ConvDef("a", 3, 8, 3, stride=1, pad=1, pool=2),
             mod.ConvDef("b", 8, 12, 3, stride=2, pad=1, groups=2))
    fcs = (mod.FCDef("fc1", 8 * 8 * 12, 32), mod.FCDef("fc2", 32, 10,
                                                        relu=False))
    return mod.CNNDef("tiny", (32, 32, 3), convs, fcs, "plain")


@pytest.mark.parametrize("backend", ["cuda", "torch", "ref"])
def test_tiny_cnn_matches_pallas_forward(backend):
    net_j, net_t = _tiny(jax_cnn), _tiny(t_cnn)
    params = _numpy_params(net_j.convs, net_j.fcs, seed=0)
    x = np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with jax_engine.using_config(jax_engine.EngineConfig(backend="pallas",
                                                         interpret=True)):
        want = jax_cnn._forward(net_j, _to_jax(params), jnp.asarray(x))
    with TE.using_config(TE.EngineConfig(backend=backend)), torch.no_grad():
        got = t_cnn._forward(net_t, t_cnn.params_from_jax(params, "cpu"),
                             torch.from_numpy(x))
    _close(got, want)


def test_alexnet_full_width_matches_jax_xla():
    convs, fcs = jax_cnn.ALEXNET_CONVS, jax_cnn.ALEXNET_FCS
    params = _numpy_params(convs, fcs, seed=2)
    x = np.random.default_rng(3).standard_normal((1, 227, 227, 3)).astype(
        np.float32)
    want = jax_cnn.apply_cnn("alexnet", _to_jax(params), jnp.asarray(x),
                             backend="xla")
    compiled = TE.compile(t_cnn.program("alexnet"),
                          TE.EngineConfig(backend="cuda"))
    assert compiled.backends() == ("cuda",) * 8
    got = compiled.apply(t_cnn.params_from_jax(params, "cpu"),
                         torch.from_numpy(x))
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _tiny_int8_case():
    """Weights, input and the Pallas (interpret) int8 logits of the tiny
    net, computed once for the three backends' tests."""
    net_j = _tiny(jax_cnn)
    params = _numpy_params(net_j.convs, net_j.fcs, seed=4)
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    with jax_engine.using_config(jax_engine.EngineConfig(
            backend="pallas", interpret=True, precision="int8")):
        want = jax_cnn._forward(net_j, _to_jax(params), jnp.asarray(x))
    return params, x, np.asarray(want)


@pytest.mark.parametrize("backend", ["cuda", "torch", "ref"])
def test_tiny_cnn_int8_matches_pallas_forward_bitwise(backend):
    net_t = _tiny(t_cnn)
    params, x, want = _tiny_int8_case()
    with TE.using_config(TE.EngineConfig(backend=backend, precision="int8")), \
            torch.no_grad():
        got = t_cnn._forward(net_t, t_cnn.params_from_jax(params, "cpu"),
                             torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_alexnet_full_width_int8_bitwise_equal_to_jax_xla():
    convs, fcs = jax_cnn.ALEXNET_CONVS, jax_cnn.ALEXNET_FCS
    params = _numpy_params(convs, fcs, seed=6)
    x = np.random.default_rng(7).standard_normal((1, 227, 227, 3)).astype(
        np.float32)
    cfg = jax_engine.EngineConfig(backend="xla", precision="int8")
    # jitted: the same ops as eager (the reference pins jit/eager parity
    # of its int8 path), in a fraction of the time
    want = jax.jit(lambda p, xx: jax_cnn.apply_cnn("alexnet", p, xx,
                                                   config=cfg))(
        _to_jax(params), jnp.asarray(x))
    t_params = t_cnn.params_from_jax(params, "cpu")
    compiled = TE.compile(t_cnn.program("alexnet"),
                          TE.EngineConfig(backend="cuda", precision="int8"))
    assert compiled.backends() == ("cuda",) * 8
    assert compiled.precisions() == ("int8",) * 8
    got = compiled.apply(t_params, torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fp32 = TE.compile(t_cnn.program("alexnet"),
                      TE.EngineConfig(backend="cuda")).apply(
                          t_params, torch.from_numpy(x))
    assert quant.snr_db(fp32, got).item() >= 28.0


def test_program_precisions_pin_exactly_the_named_layer():
    prog = t_cnn.program("alexnet", precisions={"fc6": "int8"})
    compiled = TE.compile(prog, TE.EngineConfig())
    assert compiled.precisions() == ("fp32",) * 5 + ("int8", "fp32", "fp32")
    j_prog = jax_cnn.program("alexnet", precisions={"fc6": "int8"})
    assert jax_engine.compile(j_prog, jax_engine.EngineConfig()
                              ).precisions() == compiled.precisions()
    # an explicit per-layer fp32 wins over an int8 config
    mixed = TE.compile(t_cnn.program("alexnet", precisions={"conv1": "fp32"}),
                       TE.EngineConfig(precision="int8"))
    assert mixed.precisions() == ("fp32",) + ("int8",) * 7


def test_per_layer_precisions_run_eagerly_and_compiled_alike():
    net = _tiny(t_cnn)
    params = t_cnn.params_from_jax(_numpy_params(net.convs, net.fcs, 8),
                                   "cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(9))
    precs = {"b": "int8", "fc2": "int8"}
    prog = TE.Program("tiny", (), fn=lambda p, x: t_cnn._forward(
        net, p, x, precs), in_avals=(t_cnn._meta_params(net),
                                     torch.empty(2, 32, 32, 3, device="meta")))
    compiled = TE.compile(prog)
    assert compiled.precisions() == ("fp32", "int8", "fp32", "int8")
    with torch.no_grad():
        eager = t_cnn._forward(net, params, x, precs)
        fp32 = t_cnn._forward(net, params, x)
    assert torch.equal(compiled.apply(params, x), eager)
    assert not torch.equal(eager, fp32)


def test_unknown_layer_name_in_precisions_raises():
    params = t_cnn.init_cnn("alexnet", seed=0, device="cpu")
    with pytest.raises(ValueError, match="unknown layer"):
        t_cnn.apply_cnn("alexnet", params, torch.zeros(1, 227, 227, 3),
                        precisions={"fc9": "int8"})
    with pytest.raises(ValueError, match="unknown layer"):
        t_cnn.program("resnet50", precisions={"conv9": "int8"})
    assert t_cnn.program("resnet50", precisions={"s2b1_proj": "int8"})


def test_init_cnn_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None picks it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cnn.init_cnn("alexnet", seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cnn.params_from_jax({"fc": {"f": {"w": np.ones((2, 2))}}})


def test_init_cnn_is_seeded_and_in_reference_layouts():
    a = t_cnn.init_cnn("alexnet", seed=5, device="cpu")
    b = t_cnn.init_cnn("alexnet", seed=5, device="cpu")
    ref_shapes = jax.tree_util.tree_map(
        lambda v: tuple(v.shape),
        jax.eval_shape(lambda k: jax_cnn.init_cnn("alexnet", k),
                       jax.random.PRNGKey(0)))
    got_shapes = {kind: {name: {k: tuple(v.shape) for k, v in leaf.items()}
                         for name, leaf in layers.items()}
                  for kind, layers in a.items()}
    assert got_shapes == ref_shapes
    assert torch.equal(a["fc"]["fc6"]["w"], b["fc"]["fc6"]["w"])
    assert not torch.equal(
        a["fc"]["fc6"]["w"],
        t_cnn.init_cnn("alexnet", seed=6, device="cpu")["fc"]["fc6"]["w"])


@pytest.mark.parametrize("knob", [
    dict(parallel="data"), dict(parallel=object()),
])
def test_unported_config_knobs_raise_naming_the_roadmap(knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TE.EngineConfig(**knob)


def test_eager_apply_matches_compiled_apply():
    params = t_cnn.init_cnn("alexnet", seed=1, device="cpu")
    x = torch.randn(1, 227, 227, 3, generator=torch.Generator().manual_seed(0))
    compiled = TE.compile(t_cnn.program("alexnet"))
    eager = t_cnn.apply_cnn("alexnet", params, x, backend="cuda")
    assert torch.equal(eager, compiled.apply(params, x))


def test_compiled_replay_is_strict_and_one_device():
    params = t_cnn.init_cnn("alexnet", seed=0, device="cpu")
    compiled = TE.compile(t_cnn.program("alexnet", batch=1))
    with pytest.raises(RuntimeError, match="recompile"):
        compiled.apply(params, torch.zeros(2, 227, 227, 3))
    with pytest.raises(ValueError, match="one device"):
        compiled.apply(params, torch.zeros(1, 227, 227, 3, device="meta"))


def test_ledger_records_the_forward_without_launching():
    net = _tiny(t_cnn)
    params = t_cnn.params_from_jax(_numpy_params(net.convs, net.fcs, 0),
                                   "cpu")
    prog = TE.Program("tiny", (), fn=lambda p, x: t_cnn._forward(net, p, x),
                      in_avals=(t_cnn._meta_params(net),
                                torch.empty(2, 32, 32, 3, device="meta")))
    compiled = TE.compile(prog)
    before = (gfid_conv.gfid_conv2d_nhwc.launches,
              gfid_matmul.gfid_matmul.launches)
    with TE.tracking() as ledger:
        compiled.apply(params, torch.zeros(2, 32, 32, 3))
    assert [r.kind for r in ledger] == ["conv2d", "conv2d", "matmul",
                                       "matmul"]
    assert ledger.total_macs == sum(p.macs for _, p in compiled.exec_pairs)
    assert (gfid_conv.gfid_conv2d_nhwc.launches,
            gfid_matmul.gfid_matmul.launches) == before


# ---------------------------------------------------------------------------
# policy="auto" (`plan.auto_backend`) and the config's public names
# ---------------------------------------------------------------------------

# Every executed op of each net and the backend "auto" gives it, whatever
# the fallback: each conv and FC fills the kernels' tiles.
AUTO_OPS = {"alexnet": (5, 3), "vgg16": (13, 3), "resnet50": (53, 1)}


@pytest.mark.parametrize("net", sorted(AUTO_OPS))
@pytest.mark.parametrize("fallback", ["torch", "ref"])
def test_auto_backend_pins_every_layer_and_keeps_table4(net, fallback):
    import json
    from pathlib import Path
    golden = json.loads((Path(__file__).parent / "goldens"
                         / f"table4_{net}.json").read_text())
    prog = t_cnn.program(net)
    cfg = TE.EngineConfig(backend=fallback, policy="auto")
    compiled = TE.compile(prog, cfg)
    kinds = [op.kind for op, _ in compiled.exec_pairs]
    assert (kinds.count("conv2d"), kinds.count("dense")) == AUTO_OPS[net]
    assert compiled.backends() == ("cuda",) * len(kinds)
    assert compiled.backends() == tuple(
        TE.auto_backend(op, fallback) for op, _ in compiled.exec_pairs)
    assert {p.backend for p in compiled.plan.plans} == {"cuda"}
    assert compiled.cost == golden
    assert TE.plan_network(prog, cfg).table4_row() \
        == TE.plan_network(prog, TE.EngineConfig()).table4_row()


def test_auto_backend_rule_at_its_edges():
    def spec(kind, x, w, **kw):
        return TE.OpSpec(kind, x, w, **kw)

    cases = [
        (spec("dense", (8, 576), (576, 64), spec="...n,nm->...m"), "cuda"),
        (spec("dense", (8, 576), (576, 63), spec="...n,nm->...m"), "torch"),
        (spec("dense", (8, 7), (7, 512), spec="...n,nm->...m"), "torch"),
        (spec("dense", (1, 3, 576), (49152, 576), spec="bsd,vd->bsv"),
         "cuda"),
        (spec("dense", (4, 2, 8, 32), (4, 32, 64), spec="ebcd,edf->ebcf"),
         "torch"),                              # batched weights
        (spec("conv2d", (1, 9, 9, 8), (3, 3, 4, 128), groups=2), "cuda"),
        (spec("conv2d", (1, 9, 9, 8), (3, 3, 4, 96), groups=2), "torch"),
        (spec("conv2d", (1, 9, 9, 1), (1, 1, 1, 128)), "torch"),
        (spec("conv1d_dw", (1, 16, 64), (4, 64)), "cuda"),
        (spec("gather", (9, 4, 2, 3), (2, 3)), "torch"),
    ]
    for op, want in cases:
        assert TE.auto_backend(op, "torch") == want, op
        assert TE.auto_backend(op, "ref") == want.replace("torch", "ref")
    assert TE.auto_backend(cases[0][0]) == "cuda"


def test_auto_policy_runs_eagerly_and_compiled_alike():
    net = _tiny(t_cnn)
    params = t_cnn.params_from_jax(_numpy_params(net.convs, net.fcs, 10),
                                   "cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(11))
    cfg = TE.EngineConfig(backend="ref", policy="auto")
    prog = TE.Program("tiny", (), fn=lambda p, v: t_cnn._forward(net, p, v),
                      in_avals=(t_cnn._meta_params(net),
                                torch.empty(2, 32, 32, 3, device="meta")))
    compiled = TE.compile(prog, cfg)
    # conv a (8 columns), conv b (6 a group) and fc2 (10) are too narrow
    assert compiled.backends() == ("ref", "ref", "ref", "ref")
    with TE.using_config(cfg), TE.tracking() as led, torch.no_grad():
        eager = t_cnn._forward(net, params, x)
    assert [r.plan.backend for r in led] == list(compiled.backends())
    assert torch.equal(compiled.apply(params, x), eager)


def test_auto_policy_is_validated_as_the_reference():
    for bad in ("fastest", "AUTO"):
        with pytest.raises(ValueError, match="policy"):
            TE.EngineConfig(policy=bad)
        with pytest.raises(ValueError, match="policy"):
            jax_engine.EngineConfig(policy=bad)


def test_public_config_names_behave_as_the_reference():
    assert TE.PRECISIONS == jax_engine.PRECISIONS
    assert TE.backend_names() == ("cuda", "ref", "torch")
    assert jax_engine.backend_names() == ("pallas", "ref", "xla")
    for E, cfg in ((TE, TE.EngineConfig(backend="ref")),
                   (jax_engine, jax_engine.EngineConfig(backend="ref"))):
        base = E.current_config()
        assert not E.in_config_context() and not E.is_tracking()
        with E.using_config(cfg):
            assert E.in_config_context() and E.default_backend() == "ref"
            with pytest.raises(RuntimeError, match="shadowed"):
                E.set_default_config(cfg)
        with E.tracking():
            assert E.is_tracking()
        E.set_default_config(cfg)
        try:
            assert E.current_config() is cfg and E.default_backend() == "ref"
            assert not E.in_config_context()
        finally:
            E.set_default_config(base)
        assert E.current_config() is base
        with pytest.raises(KeyError, match="unknown engine backend"):
            E.set_default_config(cfg.replace(backend="nope"))
