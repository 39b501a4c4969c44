"""The port's paged-KV gather on the CPU against the JAX package.

`paged_gather_plain` (what the kernel wrapper runs for CPU tensors) must be
bitwise equal to the reference's Pallas kernel `kernels.ops.paged_gather`
run in interpret mode: a gather is a copy, so the tolerance is zero. Pools
are made with numpy from a seed and cast to bf16 on each side (both round
to nearest even, so the two pools hold the same bits).

The CUDA kernel itself (`csrc/paged_gather.cu`) runs only on the card;
`chip_smoke.py` holds it against this plain version there, bitwise.
"""
import ctypes
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as jax_engine
from repro.kernels import ops as jax_ops
from repro_torch import engine as TE
from repro_torch.kernels import build, paged

jax.config.update("jax_platform_name", "cpu")

# The four cases of tests/test_kv_pool.py (num_blocks, block_size, feature,
# batch, blocks_per_req), then an fp32 pool and smollm-135m's full-width
# cache feature (30 layers x 3 kv heads x 64).
CASES = [
    (10, 4, (3, 2, 5), 2, 3, "bfloat16"),
    (16, 8, (4, 16), 3, 4, "bfloat16"),
    (5, 2, (), 1, 2, "bfloat16"),
    (12, 8, (7,), 4, 1, "bfloat16"),
    (9, 4, (3, 5), 3, 2, "float32"),
    (6, 16, (30, 3, 64), 2, 3, "bfloat16"),
]


def _pool_and_table(nb, bs, feat, b, npr, dtype, seed=0):
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((nb, bs) + feat).astype(np.float32)
    table = rng.integers(0, nb, (b, npr)).astype(np.int32)
    table[0, 0] = 0                      # the reserved block is copied too
    jp = jnp.asarray(pool).astype(jnp.dtype(dtype))
    tp = torch.from_numpy(pool).to(getattr(torch, dtype))
    return jp, jnp.asarray(table), tp, torch.from_numpy(table)


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("nb,bs,feat,b,npr,dtype", CASES)
def test_plain_matches_pallas_bitwise(nb, bs, feat, b, npr, dtype):
    jp, jt, tp, tt = _pool_and_table(nb, bs, feat, b, npr, dtype)
    want = jax_ops.paged_gather(jp, jt, interpret=True)
    got = paged.paged_gather(tp, tt)
    assert got.dtype == tp.dtype
    assert tuple(got.shape) == tuple(want.shape) == \
        (b, npr * bs) + feat
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


@pytest.mark.parametrize("nb,bs,feat,b,npr,dtype", CASES[:2] + CASES[4:5])
def test_engine_backends_agree_bitwise(nb, bs, feat, b, npr, dtype):
    """engine.paged_gather gives the same bits on "cuda" (the wrapper's
    plain version on the CPU), "torch" and "ref", and the same bits as the
    reference's engine on "xla"."""
    jp, jt, tp, tt = _pool_and_table(nb, bs, feat, b, npr, dtype, seed=3)
    outs = []
    for backend in ("cuda", "torch", "ref"):
        with TE.using_config(TE.EngineConfig(backend=backend)):
            outs.append(_as_f32(TE.paged_gather(tp, tt)))
    with jax_engine.using_config(jax_engine.EngineConfig(backend="xla")):
        want = _as_f32(jax_engine.paged_gather(jp, jt))
    for out in outs:
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("x_shape,w_shape", [
    ((16, 8, 4), (2, 3)), ((257, 16, 30, 3, 64), (8, 32)),
    ((1025, 16, 30, 3, 64), (1, 128)), ((5, 2), (1, 2))])
def test_plan_gather_matches_reference(x_shape, w_shape):
    t = TE.plan_gather(x_shape, w_shape, "cuda")
    j = jax_engine.plan_gather(x_shape, w_shape, "xla")
    assert (t.kind, dataclasses.astuple(t.mode), t.cycles, t.ma_words,
            t.macs, t.note) == (j.kind, dataclasses.astuple(j.mode),
                                j.cycles, j.ma_words, j.macs, j.note)
    assert t.macs == 0 and t.precision == "fp32"
    assert t.tiling == (1, x_shape[1], int(np.prod(x_shape[2:])))


def test_meta_pool_only_allocates():
    before = paged.paged_gather.launches
    pool = torch.empty((257, 16, 30, 3, 64), dtype=torch.bfloat16,
                       device="meta")
    table = torch.empty((8, 32), dtype=torch.int32, device="meta")
    out = paged.paged_gather(pool, table)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (8, 512, 30, 3, 64)
    cpu = paged.paged_gather(torch.zeros(4, 2, 3), torch.zeros(
        (1, 2), dtype=torch.int32))
    assert cpu.shape == (1, 4, 3)
    assert paged.paged_gather.launches == before   # no kernel on CPU/meta


@pytest.mark.parametrize("bad_id", [10, 11, -1])
def test_out_of_range_id_raises_on_the_cpu(bad_id):
    pool = torch.zeros((10, 2, 3))
    table = torch.tensor([[1, bad_id]], dtype=torch.int32)
    with pytest.raises(IndexError):
        paged.paged_gather(pool, table)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    pool = torch.zeros((4, 2, 3))
    with pytest.raises(TypeError, match="int32"):
        paged.paged_gather(pool, torch.zeros((1, 2), dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        paged.paged_gather(pool.transpose(1, 2),
                           torch.zeros((1, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="table"):
        paged.paged_gather(pool, torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("block_bytes,ptrs,unit", [
    (184320, (0x7f0000000000, 0x7f0000100000), 16),
    (2 * 30 * 7, (256, 512), 4), (6, (256, 512), 2), (16, (256, 514), 2),
    (3, (256, 512), 1), (24, (264, 512), 8)])
def test_copy_unit_is_the_widest_that_divides(block_bytes, ptrs, unit):
    assert paged.copy_unit(block_bytes, *ptrs) == unit


def test_ctypes_signature_matches_the_c_interface():
    """The ctypes argument list (bound only on a GPU) follows the C
    signature, read from the source here."""
    src = (build.CSRC / "paged_gather.cu").read_text()
    sig = src[src.index('extern "C" int paged_gather('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")

    def ctype(p):
        if "*" in p:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in p else ctypes.c_int

    assert paged.ARGTYPES == [ctype(p) for p in params]
    assert "paged_gather" in build.SOURCES
    for unit in paged.UNITS:
        assert f"case {unit}:" in src


def test_gather_is_a_planned_engine_op():
    pool = torch.zeros((6, 2, 3))
    table = torch.tensor([[1, 2], [0, 5]], dtype=torch.int32)
    with TE.tracking() as led:
        TE.paged_gather(pool, table)
    (rec,) = led.records
    assert rec.kind == "gather" and rec.macs == 0
    prog = TE.trace_program(TE.paged_gather,
                            pool.to("meta"), table.to("meta"), name="g")
    assert [(op.kind, op.x_shape, op.w_shape) for op in prog.ops] == \
        [("gather", (6, 2, 3), (2, 2))]
    plan = TE.plan_network(prog, TE.EngineConfig())
    assert plan.gather_plans and plan.gather_cycles == 1
    assert plan.total_latency_s == plan.gather_latency_s > 0
