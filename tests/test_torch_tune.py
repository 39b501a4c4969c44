"""The port's kernel autotuner (`repro_torch.engine.tune`) against the
reference's (`repro.engine.tune`), on the CPU.

The reference's tile keys and canonical GEMM shapes are the contract: the
port's (M, K, N) of every dense op of AlexNet, VGG-16 and ResNet-50 equals
the reference's, and its key identity equals the reference's but for the
backend's name ("cuda" for "pallas") and the operand dtype the port adds.
Every tile a tuner may pin leaves the fp32 and bf16 plans' split of K as
the untuned plan's, at batch 1, 8 and 32, so no tile changes a bit. The
reference's cache cases (`tests/test_tune.py`: round trip, miss, corrupted,
stale and malformed files, pinned tiles, reuse, an invalid mode, atomic
saves) run on the port with fake timings: timing a tile needs the card,
and without one "autotune" raises.
"""
import hashlib
import json
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.engine import tune as jtune
from repro.models import cnn as jax_cnn
from repro_torch import engine as TE
from repro_torch.configs.base import get_config
from repro_torch.engine import tune
from repro_torch.kernels import gfid_conv, gfid_matmul, ops
from repro_torch.models import cnn as t_cnn
from repro_torch.serve import engine as serve_engine
from repro_torch.serve import faults
from repro_torch.serve import scheduler as SCH

jax.config.update("jax_platform_name", "cpu")

NETS = ("alexnet", "vgg16", "resnet50")
FLOAT_DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture()
def tune_dir(tmp_path):
    """Redirect the tile cache to a throwaway dir (and drop the memo)."""
    tune.set_cache_dir(tmp_path)
    yield tmp_path
    tune.set_cache_dir(None)


def _fake_us(op, tile, cfg, repeats=tune.BENCH_REPEATS, precision="fp32",
             dtype=None):
    """A timing that favours narrow tiles, deterministic: no card here."""
    return (tile[0] * 1000 + tile[1]) * 1e-9


@pytest.fixture()
def fake_bench(monkeypatch):
    monkeypatch.setattr(tune, "benchmark_tile", _fake_us)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _mlp_program(d_in=64, d_h=96, d_out=40, batch=8, name="tunemlp",
                 dtype=torch.float32):
    def fn(w, x):                       # results in x's dtype
        h = TE.matmul(x, w["w1"], bias=w["b1"], act="relu")
        return TE.matmul(h, w["w2"], bias=w["b2"])

    def avals(b):
        return ({"w1": _meta(d_in, d_h, dtype=dtype),
                 "b1": _meta(d_h, dtype=dtype),
                 "w2": _meta(d_h, d_out, dtype=dtype),
                 "b2": _meta(d_out, dtype=dtype)},
                _meta(b, d_in, dtype=dtype))

    return TE.trace_program(fn, *avals(batch), name=name, batch_size=batch,
                            batch_axes=TE.infer_batch_axes(avals(batch),
                                                           avals(batch + 1)))


def _mlp_weights(d_in=64, d_h=96, d_out=40, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    return {"w1": t(d_in, d_h), "b1": t(d_h), "w2": t(d_h, d_out),
            "b2": t(d_out)}


def _conv_program(batch=2):
    """A small conv (bias, relu) then a flatten and a dense layer."""
    def fn(w, x):
        h = TE.conv2d(x, w["c"], stride=2, pad=1, bias=w["cb"], act="relu")
        return TE.dense(h.reshape(h.shape[0], -1), w["f"])

    def avals(b):
        return ({"c": _meta(3, 3, 8, 24), "cb": _meta(24),
                 "f": _meta(5 * 5 * 24, 10)}, _meta(b, 10, 10, 8))

    return TE.trace_program(fn, *avals(batch), name="tuneconv",
                            batch_size=batch,
                            batch_axes=TE.infer_batch_axes(avals(batch),
                                                           avals(batch + 1)))


def _conv_weights(seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return {"c": t(3, 3, 8, 24), "cb": t(24), "f": t(5 * 5 * 24, 10)}


def _x(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _cuda(tuning, **kw):
    return TE.EngineConfig(backend="cuda", tuning=tuning, **kw)


# ---------------------------------------------------------------------------
# Against the reference: canonical shapes and key identities
# ---------------------------------------------------------------------------


def _program_pairs(net, batch=1):
    jp = jax_cnn.program(net).with_batch(batch)
    tp = t_cnn.program(net).with_batch(batch)
    assert len(jp.ops) == len(tp.ops)
    return list(zip(tp.ops, jp.ops))


@pytest.mark.parametrize("net", NETS)
def test_canonical_dense_matches_reference(net):
    pairs = [(t, j) for t, j in _program_pairs(net) if t.kind == "dense"]
    assert pairs
    for t_op, j_op in pairs:
        assert tune._canonical_dense(t_op) == jtune._canonical_dense(j_op)


def _reference_hash(ident):
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


@pytest.mark.parametrize("net", NETS)
def test_key_identity_matches_reference_but_backend_and_dtype(net):
    for t_op, j_op in _program_pairs(net):
        for accum in (None, "float32"):
            for prec in ("fp32", "int8"):
                ident = tune._key_ident(t_op, "cuda", accum, prec,
                                        torch.float32)
                want = jtune.tile_key(j_op, "pallas", accum, prec)
                assert ident is not None and want is not None
                assert ident[-1] == ("int8" if prec == "int8"
                                     else "float32")
                ref_ident = [("pallas" if v == "cuda" else v)
                             for v in ident[:-1]]
                assert _reference_hash(ref_ident) == want
                assert tune.tile_key(t_op, "cuda", accum, prec) \
                    == _reference_hash(ident)


@pytest.mark.parametrize("net", NETS)
def test_keys_drop_rows_and_batch_and_carry_the_dtype(net):
    ops1 = t_cnn.program(net).with_batch(1).ops
    ops32 = t_cnn.program(net).with_batch(32).ops
    for a, b in zip(ops1, ops32):
        for dt in FLOAT_DTYPES:
            assert tune.tile_key(a, "cuda", None, "fp32", dt) \
                == tune.tile_key(b, "cuda", None, "fp32", dt)
        # fp32 and bf16 operands run other entries; int8 runs one for both
        assert tune.tile_key(a, "cuda", None, "fp32", torch.float32) \
            != tune.tile_key(a, "cuda", None, "fp32", torch.bfloat16)
        assert tune.tile_key(a, "cuda", None, "int8", torch.float32) \
            == tune.tile_key(a, "cuda", None, "int8", torch.bfloat16)


# ---------------------------------------------------------------------------
# Every admissible tile keeps K's split
# ---------------------------------------------------------------------------


def _plans(op, dtype):
    """(untuned plan, {tile: plan}) of every tile the op's entry takes."""
    if op.kind == "dense":
        m, k, n = tune._canonical_dense(op)
        tiles = gfid_matmul.tiles_for(m, k, n, dtype)
        if dtype == torch.bfloat16:
            plan = lambda t: gfid_matmul.bf16_plan(m, k, n, tile=t)  # noqa
        else:
            plan = lambda t: gfid_matmul.f32_plan(m, k, n, tile=t)   # noqa
    else:
        out = tune._conv_out_shape(op)
        h_f, w_f, cg, c_out = op.w_shape
        pixels, image = out[0] * out[1] * out[2], out[1] * out[2]
        tiles = gfid_conv.tiles_for(out, op.w_shape, op.groups, dtype)
        fn = gfid_conv.bf16_plan if dtype == torch.bfloat16 \
            else gfid_conv.f32_plan
        plan = lambda t: fn(pixels, h_f * w_f * cg, c_out // op.groups,  # noqa
                            op.groups, cg, image_pixels=image, tile=t)
    assert tiles
    return plan(None), {t: plan(t) for t in tiles}


def _hold_split(ops, dtype):
    checked = 0
    for op in ops:
        if op.kind == "dense" and tune._canonical_dense(op) is None:
            continue
        base, tuned = _plans(op, dtype)
        assert (base.bm, base.bn) in tuned
        for t, p in tuned.items():
            assert (p.bm, p.bn) == t
            assert (p.splits, p.chunks_per_split) \
                == (base.splits, base.chunks_per_split), (op, t)
            checked += 1
    assert checked


# The batches each split is held at. They loop inside the tests, which
# keeps this file's test count under test_archs.py's: xdist's loadfile
# queue takes files largest first, so the files ahead of it keep their
# order and their workers.
SPLIT_BATCHES = (1, 8, 32)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("net", NETS)
def test_every_candidate_keeps_the_split_of_k(net, dtype):
    for batch in SPLIT_BATCHES:
        prog = t_cnn.program(net).with_batch(batch)
        _hold_split(prog.ops, dtype)
        # and the executed ops too (ResNet's projection shortcuts)
        _hold_split(TE.compile(prog, _cuda("off")).program.ops, dtype)


@pytest.fixture(scope="module")
def smollm_decode_ops():
    cfg = get_config("smollm_135m")
    prog = serve_engine.decode_program(cfg, 8, 256,
                                       param_dtype=torch.float32)
    return prog


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=["fp32", "bf16"])
def test_smollm_candidates_keep_the_split_of_k(smollm_decode_ops, dtype):
    for batch in SPLIT_BATCHES:
        ops = smollm_decode_ops.with_batch(batch).ops
        shapes = {tune._canonical_dense(op)[1:] for op in ops
                  if op.kind == "dense" and tune._canonical_dense(op)}
        assert len(shapes) == 5
        _hold_split(ops, dtype)


def test_int8_candidates_are_the_entries_tiles():
    for op in t_cnn.program("alexnet").with_batch(32).ops:
        cands = tune.candidates_for(op, precision="int8")
        tiles = (gfid_matmul.INT8_MM_TILES if op.kind == "dense"
                 else gfid_conv.INT8_TILES)
        assert set(cands) == set(tiles)
        for t in cands:
            plan = tune._entry_plan(op, t, "int8", None, 132)
            assert (plan.bm, plan.bn) == t and plan.splits >= 1


# ---------------------------------------------------------------------------
# Refused tiles
# ---------------------------------------------------------------------------


def test_refused_tiles_raise():
    with pytest.raises(ValueError, match="block tile"):
        gfid_matmul.f32_plan(4, 64, 64, tile=(16, 64))
    with pytest.raises(ValueError, match="block tile"):
        gfid_matmul.bf16_plan(4, 64, 64, tile=(128, 128))
    with pytest.raises(ValueError, match="block tile"):
        gfid_matmul.int8_mm_plan(4, 64, 64, tile=(8, 64))
    for plan in (gfid_conv.f32_plan, gfid_conv.bf16_plan,
                 gfid_conv.int8_plan):
        with pytest.raises(ValueError, match="block tile"):
            plan(100, 72, 64, 1, 8, tile=(16, 64))
    # the bf16 conv's wide tile under a split of K: a filter that guards
    # the fold's shared memory
    split = gfid_conv.bf16_plan(169, 3 * 3 * 256, 384, 1, 256)
    assert split.splits > 1
    assert (128, 128) not in gfid_conv.tiles_for((1, 13, 13, 384),
                                                 (3, 3, 256, 384), 1,
                                                 torch.bfloat16)
    with pytest.raises(ValueError, match="wide"):
        gfid_conv.bf16_plan(169, 3 * 3 * 256, 384, 1, 256, tile=(128, 128))


def test_wrappers_check_the_tile_on_cpu_and_ignore_it():
    x, w = _x(0, 5, 16), _x(1, 16, 8)
    want = gfid_matmul.gfid_matmul(x, w)
    for t in gfid_matmul.tiles_for(5, 16, 8):
        assert torch.equal(gfid_matmul.gfid_matmul(x, w, tile=t), want)
        assert torch.equal(ops.gfid_matmul(x, w, tile=list(t)), want)
    with pytest.raises(ValueError, match="block tile"):
        gfid_matmul.gfid_matmul(x, w, tile=(7, 7))
    with pytest.raises(ValueError, match="block tile"):
        ops.gfid_matmul(x, w, tile=(8, 512), precision="int8")
    with pytest.raises(ValueError, match="grouped"):
        gfid_matmul.gfid_matmul(_x(2, 2, 5, 16), _x(3, 2, 16, 8),
                                tile=(8, 64))
    xm, wm = x.to("meta"), w.to("meta")
    assert gfid_matmul.gfid_matmul(xm, wm, tile=(8, 64)).device.type == "meta"
    with pytest.raises(ValueError, match="block tile"):
        gfid_matmul.gfid_matmul(xm, wm, tile=(7, 7))
    xc, wc = _x(4, 2, 9, 9, 8), _x(5, 3, 3, 8, 24)
    want = ops.gfid_conv2d(xc, wc, pad=1)
    for prec in ("fp32", "int8"):
        ref = ops.gfid_conv2d(xc, wc, pad=1, precision=prec)
        for t in gfid_conv.INT8_TILES:
            assert torch.equal(ops.gfid_conv2d(xc, wc, pad=1, precision=prec,
                                               tile=t), ref)
        with pytest.raises(ValueError, match="block tile"):
            ops.gfid_conv2d(xc, wc, pad=1, precision=prec, tile=(16, 64))
    assert torch.equal(ops.gfid_conv2d(xc, wc, pad=1, tile=(32, 64)), want)


def test_tile_runner_gives_each_candidate_the_default_output_on_cpu():
    for op in _conv_program().ops:
        for prec in ("fp32", "int8"):
            run = tune.tile_runner(op, prec, device="cpu")
            want = run(None)
            for t in tune.candidates_for(op, precision=prec):
                assert torch.equal(run(t), want)


# ---------------------------------------------------------------------------
# Tile keys and candidates (the reference's TestTileKeys)
# ---------------------------------------------------------------------------


class TestTileKeys:
    def test_dense_key_drops_rows(self):
        a = TE.OpSpec("dense", (1, 64), (64, 32), spec=TE.dense_spec(2))
        b = TE.OpSpec("dense", (16, 64), (64, 32), spec=TE.dense_spec(2))
        assert tune.tile_key(a, "cuda", None) == tune.tile_key(b, "cuda", None)

    def test_key_distinguishes_shapes_backend_accum(self):
        a = TE.OpSpec("dense", (8, 64), (64, 32), spec=TE.dense_spec(2))
        c = TE.OpSpec("dense", (8, 64), (64, 48), spec=TE.dense_spec(2))
        assert tune.tile_key(a, "cuda", None) != tune.tile_key(c, "cuda", None)
        assert tune.tile_key(a, "cuda", None) \
            != tune.tile_key(a, "cuda", "bfloat16")
        assert tune.tile_key(a, "torch", None) is None      # no tile knob

    def test_conv_key_drops_batch(self):
        a = TE.OpSpec("conv2d", (1, 14, 14, 8), (3, 3, 8, 16), stride=1,
                      pad=1)
        b = TE.OpSpec("conv2d", (4, 14, 14, 8), (3, 3, 8, 16), stride=1,
                      pad=1)
        assert tune.tile_key(a, "cuda", None) == tune.tile_key(b, "cuda", None)

    def test_untunable_ops_have_no_key(self):
        dw = TE.OpSpec("conv1d_dw", (1, 16, 8), (4, 8))
        assert tune.tile_key(dw, "cuda", None) is None
        moe = TE.OpSpec("dense", (3, 4, 8), (3, 8, 5), spec="ecd,edf->ecf")
        assert tune.tile_key(moe, "cuda", None) is None     # grouped GEMM
        assert tune.candidates_for(moe) == []

    def test_candidates_are_the_entry_tiles_best_first(self):
        op = TE.OpSpec("dense", (8, 1000), (1000, 4096),
                       spec=TE.dense_spec(2))
        for dt, tiles in ((torch.float32, gfid_matmul.F32_TILES),
                          (torch.bfloat16, gfid_matmul.BF16_TILES)):
            cands = tune.candidates_for(op, dtype=dt)
            assert 0 < len(cands) <= tune.MAX_CANDIDATES
            assert set(cands) <= set(tiles)
            assert tune.default_tile(op, dtype=dt) in cands
        scored = tune._scored(op, "fp32", None, 132)
        best = min(scored, key=lambda c: (c.score, c.tile))
        assert tune.candidates_for(op)[0] == best.tile
        # a limit cuts the list, never the entry's own tile
        own = tune.default_tile(op)
        assert own in tune.candidates_for(op, limit=1)


# ---------------------------------------------------------------------------
# Cache round trip / corruption / staleness (the reference's TestTuneCache)
# ---------------------------------------------------------------------------


class TestTuneCache:
    def test_autotune_roundtrip(self, tune_dir, fake_bench):
        prog, w = _mlp_program(), _mlp_weights()
        x = _x(5, 8, 64)
        off = TE.compile(prog, _cuda("off"))
        assert off.tiles() == (None, None)
        tuned = TE.compile(prog, _cuda("autotune"))
        assert all(t is not None for t in tuned.tiles())
        # the fake timing favours the fewest rows, then the fewest columns
        assert tuned.tiles() == ((8, 64), (8, 64))
        path = tune.cache_path()
        assert path.exists() and path.parent == tune_dir
        raw = json.loads(path.read_text())
        assert raw["version"] == tune.CACHE_VERSION
        assert len(raw["entries"]) == 2
        for entry in raw["entries"].values():
            assert entry["kind"] == "dense" and entry["device_us"] > 0
            assert entry["dtype"] == "float32" and entry["rows"] == 8
            assert entry["candidates"] == len(entry["timings_us"])
        # a fresh process (memo dropped) resolves the same tiles from disk
        tune.set_cache_dir(tune_dir)
        cached = TE.compile(prog, _cuda("cached"))
        assert cached.tiles() == tuned.tiles()
        assert torch.equal(cached.apply(w, x), off.apply(w, x))
        assert torch.equal(cached.apply(w, x), tuned.apply(w, x))
        # another batch shares the keys, so the tiles
        assert TE.compile(prog.with_batch(32), _cuda("cached")).tiles() \
            == tuned.tiles()
        # bf16 operands key apart: a miss
        prog16 = _mlp_program(dtype=torch.bfloat16)
        assert TE.compile(prog16, _cuda("cached")).tiles() == (None, None)

    def test_cached_identical_outputs_off_torch(self, tune_dir, fake_bench):
        # on a backend with no tile knob, the tuning mode is pure metadata
        prog, w = _mlp_program(), _mlp_weights()
        x = _x(6, 8, 64)
        TE.compile(prog, _cuda("autotune"))
        off = TE.compile(prog, TE.EngineConfig(backend="torch"))
        cached = TE.compile(prog, TE.EngineConfig(backend="torch",
                                                  tuning="cached"))
        assert cached.tiles() == (None, None)
        assert torch.equal(cached.apply(w, x), off.apply(w, x))

    def test_cached_miss_falls_back_to_defaults(self, tune_dir):
        prog, w = _mlp_program(), _mlp_weights()
        x = _x(7, 8, 64)
        net = TE.compile(prog, _cuda("cached"))
        assert net.tiles() == (None, None)
        assert torch.equal(net.apply(w, x),
                           TE.compile(prog, _cuda("off")).apply(w, x))

    def test_corrupted_cache_degrades_cleanly(self, tune_dir):
        tune.cache_path().parent.mkdir(parents=True, exist_ok=True)
        tune.cache_path().write_text("{not json")
        tune.set_cache_dir(tune_dir)            # drop memo, force re-read
        net = TE.compile(_mlp_program(), _cuda("cached"))
        assert net.tiles() == (None, None)      # fell back, no crash

    def test_stale_version_ignored(self, tune_dir):
        op = _mlp_program().ops[0]
        key = tune.tile_key(op, "cuda", None)
        tune.cache_path().parent.mkdir(parents=True, exist_ok=True)
        tune.cache_path().write_text(json.dumps({
            "version": tune.CACHE_VERSION + 1, "device_kind": "cpu",
            "entries": {key: {"kind": "dense", "tile": [8, 64]}}}))
        tune.set_cache_dir(tune_dir)
        assert tune.lookup(op, _cuda("cached")) is None
        assert TE.compile(_mlp_program(), _cuda("cached")).tiles() \
            == (None, None)

    def test_malformed_entry_ignored(self, tune_dir):
        op = _mlp_program().ops[0]
        key = tune.tile_key(op, "cuda", None)
        tune.cache_path().parent.mkdir(parents=True, exist_ok=True)
        tune.cache_path().write_text(json.dumps({
            "version": tune.CACHE_VERSION, "device_kind": "cpu",
            "entries": {key: {"kind": "dense", "tile": [8, -1]}}}))
        tune.set_cache_dir(tune_dir)
        assert tune.lookup(op, _cuda("cached")) is None

    def test_a_cached_tile_the_entry_refuses_raises(self, tune_dir):
        # never the rule in its place: the capture's eager lookup meets it,
        # and the wrapper refuses it on `meta`
        prog, w = _mlp_program(), _mlp_weights()
        key = tune.tile_key(prog.ops[0], "cuda", None)
        tune.load_cache()["entries"][key] = {"kind": "dense",
                                             "tile": [16, 16]}
        assert tune.lookup(prog.ops[0], _cuda("cached")) == (16, 16)
        with pytest.raises(ValueError, match="block tile"):
            TE.compile(prog, _cuda("cached"))
        with pytest.raises(ValueError, match="block tile"):
            with TE.using_config(_cuda("cached")):
                TE.matmul(_x(8, 8, 64), w["w1"])

    def test_compiled_tiles_stay_pinned_after_cache_fill(self, tune_dir,
                                                         monkeypatch,
                                                         fake_bench):
        prog, w = _mlp_program(), _mlp_weights()
        missed = TE.compile(prog, _cuda("cached"))      # empty cache
        assert missed.tiles() == (None, None)
        TE.compile(prog, _cuda("autotune"))             # now fill it

        def boom(*a, **kw):
            raise AssertionError("replay consulted the tile cache")
        monkeypatch.setattr(tune, "lookup", boom)
        missed.apply(w, _x(8, 8, 64))
        assert missed.tiles() == (None, None)

    def test_autotune_reuses_cache(self, tune_dir, monkeypatch, fake_bench):
        prog = _mlp_program()
        TE.compile(prog, _cuda("autotune"))

        def boom(*a, **kw):
            raise AssertionError("re-benchmarked a cached op")
        monkeypatch.setattr(tune, "benchmark_tile", boom)
        net = TE.compile(prog, _cuda("autotune"))
        assert all(t is not None for t in net.tiles())

    def test_invalid_tuning_mode_rejected(self):
        with pytest.raises(ValueError, match="tuning mode"):
            TE.EngineConfig(tuning="always")


# ---------------------------------------------------------------------------
# The card, the eager path, dispatch and the schedulers
# ---------------------------------------------------------------------------


def test_autotune_without_a_card_raises(tune_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        TE.compile(_mlp_program(), _cuda("autotune"))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tune.benchmark_tile(_mlp_program().ops[0], None, _cuda("autotune"))
    assert not tune.cache_path().exists()
    # "cached" and "off" need no card
    assert TE.compile(_mlp_program(), _cuda("cached")).tiles() \
        == (None, None)


def test_cached_conv_net_bitwise_equal_to_off(tune_dir, fake_bench):
    prog, w = _conv_program(), _conv_weights()
    x = _x(9, 2, 10, 10, 8)
    for prec in ("fp32", "int8"):
        off = TE.compile(prog, _cuda("off", precision=prec))
        TE.compile(prog, _cuda("autotune", precision=prec))
        tune.set_cache_dir(tune_dir)
        cached = TE.compile(prog, _cuda("cached", precision=prec))
        assert all(t is not None for t in cached.tiles())
        assert cached.backends() == off.backends()
        assert cached.precisions() == off.precisions()
        assert torch.equal(cached.apply(w, x), off.apply(w, x))
    # int8 and fp32 key apart
    entries = tune.load_cache()["entries"].values()
    assert sorted(e["precision"] for e in entries) \
        == ["fp32", "fp32", "int8", "int8"]


def test_dispatch_passes_the_pinned_tile_to_the_kernel(tune_dir, fake_bench,
                                                       monkeypatch):
    prog, w = _conv_program(), _conv_weights()
    TE.compile(prog, _cuda("autotune"))
    net = TE.compile(prog, _cuda("cached"))
    seen = []
    for name in ("gfid_conv2d", "gfid_matmul"):
        real = getattr(ops, name)

        def spy(*a, _real=real, **kw):
            seen.append(kw.get("tile"))
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, spy)
    off = TE.compile(prog, _cuda("off"))
    seen.clear()                        # the captures' calls, on `meta`
    net.apply(w, _x(10, 2, 10, 10, 8))
    assert tuple(seen) == net.tiles()
    seen.clear()
    off.apply(w, _x(10, 2, 10, 10, 8))
    assert seen == [None, None]


def test_eager_path_pins_cached_tiles_and_never_benchmarks(tune_dir,
                                                           fake_bench,
                                                           monkeypatch):
    prog, w = _mlp_program(), _mlp_weights()
    tuned = TE.compile(prog, _cuda("autotune"))

    def boom(*a, **kw):
        raise AssertionError("the eager path benchmarked")
    monkeypatch.setattr(tune, "benchmark_tile", boom)
    x = _x(11, 3, 64)
    with TE.using_config(_cuda("autotune")), TE.tracking() as led:
        h = TE.matmul(x, w["w1"], bias=w["b1"], act="relu")
        TE.matmul(h, w["w2"], bias=w["b2"])
        TE.matmul(x, _x(12, 64, 24))                # a miss: the rule
    assert tuple(r.plan.tile_config for r in led) \
        == tuned.tiles() + (None,)
    with TE.using_config(_cuda("off")), TE.tracking() as led:
        TE.dense(x, w["w1"])
    assert [r.plan.tile_config for r in led] == [None]


def test_a_fallback_hop_drops_the_tile(tune_dir, fake_bench):
    prog, w = _mlp_program(), _mlp_weights()
    cfg = _cuda("autotune", precision="int8", fallback="chain")
    TE.compile(prog, cfg)
    net = TE.compile(prog, cfg.replace(tuning="cached"))
    assert all(t is not None for t in net.tiles())
    inj = faults.FaultInjector(schedule={("kernel", "dense:cuda"): (0,)})
    with faults.injecting(inj):
        out = net.apply(w, _x(13, 8, 64))
    assert net.backends() == ("torch", "cuda")
    assert net.tiles()[0] is None and net.tiles()[1] is not None
    clean = TE.compile(prog, TE.EngineConfig(backend="cuda",
                                             precision="int8"))
    assert torch.equal(out, clean.apply(w, _x(13, 8, 64)))


def test_static_scheduler_reports_and_keeps_its_tuning(tune_dir, fake_bench):
    prog, w = _mlp_program(batch=1), _mlp_weights()
    TE.compile(prog.with_batch(4), _cuda("autotune", row_align=8))
    xs = [_x(20 + i, 1, 64) for i in range(3)]
    results = {}
    for tuning in ("off", "cached"):
        sched = SCH.Scheduler(config=_cuda(tuning, row_align=8),
                              max_batch=4)
        sched.register("mlp", prog, shared_args=(w,))
        for x in xs:
            sched.submit("mlp", x)
        results[tuning] = [t.result for t in sched.drain()]
        assert sched.stats()["tuning"] == tuning
        tiles = {sched._entries["mlp"].compiled[4].tiles()}
        assert tiles == ({(None, None)} if tuning == "off"
                         else {((8, 64), (8, 64))})
    for a, b in zip(results["off"], results["cached"]):
        assert torch.equal(a, b)
    single = TE.compile(prog, _cuda("off", row_align=8))
    for x, r in zip(xs, results["cached"]):
        assert torch.equal(r, single.apply(w, x))


def test_tune_program_counts_the_tunable_ops(tune_dir, fake_bench):
    prog = _conv_program()
    ops_ = prog.ops + (TE.OpSpec("conv1d_dw", (1, 16, 8), (4, 8)),)
    assert tune.tune_program(ops_, _cuda("autotune")) == 2
    assert tune.tune_program(ops_, TE.EngineConfig(backend="torch",
                                                   tuning="autotune")) == 0
    assert len(tune.load_cache()["entries"]) == 2


def test_device_kind_and_default_cache_dir(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert tune.device_kind() == "nvidia_h100_80gb_hbm3"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tune.device_kind() == "cpu"
    tune.set_cache_dir(None)
    monkeypatch.delenv(tune.CACHE_DIR_ENV, raising=False)
    assert tune.cache_dir().parts[-2:] == (".tuning", "repro_torch")
    with tempfile.TemporaryDirectory() as d:
        monkeypatch.setenv(tune.CACHE_DIR_ENV, d)
        assert str(tune.cache_dir()) == d
    # the reference's variable and file are the reference's alone
    assert tune.CACHE_DIR_ENV != jtune.CACHE_DIR_ENV
    assert tune.cache_path("cpu") != jtune.cache_path("cpu")


# ---------------------------------------------------------------------------
# Crash-safe saves (the reference's TestAtomicSave)
# ---------------------------------------------------------------------------


class TestAtomicSave:
    def _fill(self, entries):
        cache = tune.load_cache()
        cache["entries"].clear()
        cache["entries"].update(entries)
        return cache

    def test_crash_before_replace_preserves_old_cache(self, tune_dir,
                                                      monkeypatch):
        self._fill({"k0": {"kind": "dense", "tile": [8, 64]}})
        tune.save_cache()
        old = tune.cache_path().read_text()
        self._fill({"k1": {"kind": "dense", "tile": [32, 256]}})

        def crash(src, dst):
            raise OSError("simulated crash before rename")
        monkeypatch.setattr(tune.os, "replace", crash)
        with pytest.raises(OSError, match="simulated crash"):
            tune.save_cache()
        monkeypatch.undo()
        assert tune.cache_path().read_text() == old
        assert json.loads(old)["entries"].keys() == {"k0"}
        assert [p.name for p in tune_dir.iterdir()] \
            == [tune.cache_path().name]
        tune.save_cache()
        assert json.loads(
            tune.cache_path().read_text())["entries"].keys() == {"k1"}

    def test_crash_mid_write_never_truncates(self, tune_dir, monkeypatch):
        self._fill({"k0": {"kind": "dense", "tile": [8, 64]}})
        tune.save_cache()
        old = tune.cache_path().read_text()
        self._fill({"k1": {"kind": "dense", "tile": [32, 256]}})

        def crash(fd):
            raise OSError("simulated crash mid-write")
        monkeypatch.setattr(tune.os, "fsync", crash)
        with pytest.raises(OSError, match="simulated crash"):
            tune.save_cache()
        monkeypatch.undo()
        assert tune.cache_path().read_text() == old
        assert not list(tune_dir.glob("*.tmp"))
        tune.set_cache_dir(tune_dir)
        assert tune.load_cache()["entries"].keys() == {"k0"}

    def test_unique_temp_names(self, tune_dir, monkeypatch):
        seen = []
        orig = tempfile.mkstemp

        def spy(*a, **kw):
            fd, name = orig(*a, **kw)
            seen.append(name)
            return fd, name
        monkeypatch.setattr(tempfile, "mkstemp", spy)
        self._fill({"k0": {"kind": "dense", "tile": [8, 64]}})
        tune.save_cache()
        tune.save_cache()
        assert len(seen) == 2 and seen[0] != seen[1]
