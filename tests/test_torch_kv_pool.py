"""The port's paged KV pool on the CPU, against the JAX package's.

  * `BlockAllocator` — the unit cases of tests/test_kv_pool.py and the
    hypothesis properties of tests/test_kv_pool_properties.py, plus the
    port and the reference driven by one trace ending in the same tables
    and free-list. The property harness treats a re-registered rid as a
    no-op: the reference harness catches only `PoolExhausted`, so a trace
    that registers a rid twice fails there on the allocator's documented
    `ValueError` (a fault of that harness, ROADMAP section 3).
  * `PagedLayout` — its leaf specs equal the JAX layout's, at the reduced
    and the full-width smollm-135m config; scatter then gather is a
    bitwise round trip.
  * `KVBlockPool` — lifecycle, snapshot accounting, slot exhaustion.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.serve import kv_pool as jax_kv
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves
from repro_torch.serve.kv_pool import (BlockAllocator, KVBlockPool,
                                       PagedLayout, PoolExhausted)

hypothesis = pytest.importorskip(
    "hypothesis", reason="property tests need hypothesis (requirements-dev.txt)")
import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SETTINGS = settings(max_examples=60, deadline=None)
BLOCK_SIZE = 4
ops_strategy = st.lists(
    st.tuples(st.sampled_from(["register", "ensure", "release"]),
              st.integers(0, 5),        # rid
              st.integers(0, 31)),      # pos (block_size 4 -> idx 0..7)
    min_size=1, max_size=60)


@pytest.fixture(scope="module")
def cfg():
    return reduced("smollm_135m")


@pytest.fixture(scope="module")
def params(cfg):
    return T.init_params(cfg, seed=0, device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# BlockAllocator
# ---------------------------------------------------------------------------

class TestAllocator:
    def test_validation(self):
        with pytest.raises(ValueError):
            BlockAllocator(1, 4)
        with pytest.raises(ValueError):
            BlockAllocator(4, 0)
        alloc = BlockAllocator(4, 2)
        alloc.register(0)
        with pytest.raises(ValueError):
            alloc.register(0)

    def test_ensure_is_incremental(self):
        alloc = BlockAllocator(8, 4)
        alloc.register(0)
        assert len(alloc.ensure(0, 0, 4)) == 1      # covers pos 0
        assert alloc.ensure(0, 3, 4) == []          # same block
        assert len(alloc.ensure(0, 11, 4)) == 2     # blocks 1 and 2
        assert alloc.live_blocks == 3
        assert alloc.free_blocks + alloc.live_blocks == 7

    def test_lifo_reuse(self):
        alloc = BlockAllocator(8, 2)
        alloc.register(0)
        b = alloc.alloc_block(0, 0)
        alloc.release(0)
        alloc.register(1)
        assert alloc.alloc_block(1, 0) == b         # warm block first

    def test_clean_exhaustion_and_double_free(self):
        alloc = BlockAllocator(4, 8)
        alloc.register(0)
        for idx in range(3):
            assert alloc.alloc_block(0, idx) != 0   # block 0 reserved
        before = (alloc.free_blocks, list(alloc.tables[0]))
        with pytest.raises(PoolExhausted):
            alloc.alloc_block(0, 3)
        assert (alloc.free_blocks, list(alloc.tables[0])) == before
        assert alloc.low_water == 0
        assert alloc.release(0) and alloc.free_blocks == 3
        with pytest.raises(KeyError):
            alloc.release(0)


def _drive(alloc, trace, exhausted):
    """Apply a raw op trace, swallowing the documented exhaustion; a
    register of a rid that is already registered is skipped."""
    cap = alloc.blocks_per_req * BLOCK_SIZE - 1
    for kind, rid, pos in trace:
        try:
            if kind == "register":
                if rid not in alloc.tables:
                    alloc.register(rid)
            elif rid in alloc.tables:
                if kind == "ensure":
                    alloc.ensure(rid, min(pos, cap), BLOCK_SIZE)
                else:
                    alloc.release(rid)
        except exhausted:
            pass


class TestAllocatorProperties:
    @SETTINGS
    @given(trace=ops_strategy, num_blocks=st.integers(2, 12))
    def test_conservation(self, trace, num_blocks):
        alloc = BlockAllocator(num_blocks, blocks_per_req=8)
        _drive(alloc, trace, PoolExhausted)
        assert alloc.free_blocks + alloc.live_blocks == num_blocks - 1
        assert 0 <= alloc.low_water <= num_blocks - 1
        assert alloc.low_water <= alloc.free_blocks

    @SETTINGS
    @given(trace=ops_strategy, num_blocks=st.integers(2, 12))
    def test_disjoint_tables_and_reserved_zero(self, trace, num_blocks):
        alloc = BlockAllocator(num_blocks, blocks_per_req=8)
        _drive(alloc, trace, PoolExhausted)
        live = [b for t in alloc.tables.values() for b in t if b]
        assert 0 not in live                      # block 0 never allocated
        assert len(live) == len(set(live))        # no block shared
        assert not set(live) & set(alloc._free)   # live disjoint from free

    @SETTINGS
    @given(trace=ops_strategy, num_blocks=st.integers(2, 12))
    def test_double_release_raises(self, trace, num_blocks):
        alloc = BlockAllocator(num_blocks, blocks_per_req=8)
        _drive(alloc, trace, PoolExhausted)
        rid = 99
        alloc.register(rid)
        alloc.release(rid)
        with pytest.raises(KeyError):
            alloc.release(rid)
        assert alloc.free_blocks + alloc.live_blocks == num_blocks - 1

    @SETTINGS
    @given(trace=ops_strategy, num_blocks=st.integers(2, 8))
    def test_clean_exhaustion(self, trace, num_blocks):
        alloc = BlockAllocator(num_blocks, blocks_per_req=num_blocks + 4)
        _drive(alloc, trace, PoolExhausted)
        rid = 99
        alloc.register(rid)
        idx = 0
        while alloc.free_blocks:
            alloc.alloc_block(rid, idx)
            idx += 1
        before = (alloc.free_blocks, list(alloc.tables[rid]))
        with pytest.raises(PoolExhausted):
            alloc.alloc_block(rid, idx)
        assert (alloc.free_blocks, list(alloc.tables[rid])) == before
        assert alloc.free_blocks + alloc.live_blocks == num_blocks - 1

    @SETTINGS
    @given(trace=ops_strategy, num_blocks=st.integers(2, 12))
    def test_same_state_as_the_reference(self, trace, num_blocks):
        """The port's allocator and the reference's, driven by one trace,
        end with the same tables, free-list and low-water mark."""
        port = BlockAllocator(num_blocks, blocks_per_req=8)
        ref = jax_kv.BlockAllocator(num_blocks, blocks_per_req=8)
        _drive(port, trace, PoolExhausted)
        _drive(ref, trace, jax_kv.PoolExhausted)
        assert port.tables == ref.tables
        assert port._free == ref._free
        assert port.low_water == ref.low_water


# ---------------------------------------------------------------------------
# PagedLayout
# ---------------------------------------------------------------------------

def _spec_tuples(specs):
    leaves = (tree_leaves(specs) if isinstance(specs, dict)
              else specs)
    return [(s.batch_ax, s.len_ax, s.ndim, s.paged) for s in leaves]


@pytest.mark.parametrize("name,full,max_len,block_size", [
    ("smollm_135m", False, 32, 8), ("smollm_135m", True, 2048, 16)])
def test_layout_specs_equal_the_reference(name, full, max_len, block_size):
    t_cfg = get_config(name) if full else reduced(name)
    j_cfg = jax_get_config(name) if full else jax_reduced(name)
    t = PagedLayout.build(t_cfg, max_len=max_len, block_size=block_size,
                          num_blocks=1025)
    j = jax_kv.PagedLayout.build(j_cfg, max_len=max_len,
                                 block_size=block_size, num_blocks=1025)
    j_specs = jax.tree_util.tree_leaves(
        j.specs, is_leaf=lambda x: hasattr(x, "paged"))
    assert _spec_tuples(t.specs) == _spec_tuples(j_specs)
    assert t.blocks_per_req == j.blocks_per_req
    t_avals = tree_leaves(t.array_avals())
    j_avals = jax.tree_util.tree_leaves(j.array_avals())
    assert [tuple(a.shape) for a in t_avals] == [a.shape for a in j_avals]
    assert all(a.dtype == torch.bfloat16 and a.device.type == "meta"
               for a in t_avals)
    assert all(a.dtype == jnp.bfloat16 for a in j_avals)
    if full:
        assert [tuple(a.shape) for a in t_avals] == \
            [(1025, 16, 30, 3, 64)] * 2


def test_block_size_must_divide(cfg):
    with pytest.raises(ValueError, match="multiple"):
        PagedLayout.build(cfg, max_len=30, block_size=8, num_blocks=8)


@pytest.mark.parametrize("seq,table_row", [(5, [3, 0, 0, 0]),
                                           (11, [6, 2, 0, 0])])
def test_scatter_gather_roundtrip_bitwise(cfg, params, seq, table_row):
    """A prefilled dense state pushed through scatter_prefill then gather
    comes back bitwise on every written block (the live prefix, and the
    tail of the last block, which carries the dense state's zeros)."""
    layout = PagedLayout.build(cfg, max_len=32, block_size=8, num_blocks=16)
    toks = (torch.arange(seq, dtype=torch.int32)[None, :] % 50) + 1
    _, state = T.prefill(cfg, params, {"tokens": toks}, layout.max_len)
    arrays = layout.init_arrays("cpu")
    n_blocks = -(-seq // layout.block_size)
    row = torch.tensor(table_row, dtype=torch.int32)
    out = layout.scatter_prefill(arrays, state, row, torch.tensor(2),
                                 n_blocks)
    assert all(a is b for a, b in zip(tree_leaves(out),
                                      tree_leaves(arrays)))   # in place
    got = layout.gather(arrays, row[None], torch.tensor([2]))
    n = n_blocks * layout.block_size
    for g, want in zip(tree_leaves(got), tree_leaves(state)):
        assert g.dtype == want.dtype == torch.bfloat16
        assert torch.equal(g[:, :, :n], want[:, :, :n])
    assert int(torch.count_nonzero(arrays["groups"]["0"]["k"][0])) == 0


def test_scatter_step_writes_one_position(cfg):
    layout = PagedLayout.build(cfg, max_len=32, block_size=8, num_blocks=16)
    arrays = layout.init_arrays("cpu")
    tables = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    pos = torch.tensor([9], dtype=torch.int32)   # block idx 1, offset 1
    ones = {"groups": {"0": {k: torch.ones_like(v, device="cpu") for k, v in
                             layout.template["groups"]["0"].items()}},
            "rem": {}}
    layout.scatter_step(arrays, ones, tables, torch.tensor([1]), pos)
    for arr in tree_leaves(arrays):
        assert (arr[2, 1] == 1.0).all()           # offset 1 written
        assert (arr[2, 0] == 0.0).all()           # offset 0 untouched
        assert (arr[1] == 0.0).all() and (arr[0] == 0.0).all()


# ---------------------------------------------------------------------------
# KVBlockPool
# ---------------------------------------------------------------------------

class TestKVBlockPool:
    def test_lifecycle_and_snapshot(self, cfg):
        pool = KVBlockPool(cfg, max_len=32, block_size=8, num_blocks=10,
                           max_slots=8, device="cpu")
        pool.register(0)
        pool.register(1)
        pool.ensure(0, 10)                         # blocks 0, 1
        pool.ensure(1, 3)                          # block 0
        snap = pool.snapshot()
        assert snap["live_blocks"] == 3
        assert snap["free_blocks"] == 6
        assert snap["live_requests"] == 2
        assert snap["occupancy"] == pytest.approx(3 / 9)
        assert snap["free_low_water"] == 6
        assert snap["free_slots"] == 5             # slot 0 reserved
        tables = pool.table_rows([0, 1], 4)
        assert tables.shape == (4, 4) and tables.dtype == torch.int32
        assert (tables[2:] == 0).all()
        assert pool.slot_rows([0, 1], 3)[2] == 0
        pool.release(0)
        snap = pool.snapshot()
        assert snap["live_blocks"] == 1 and snap["free_blocks"] == 8
        assert snap["free_low_water"] == 6         # low-water sticks
        with pytest.raises(KeyError):
            pool.release(0)

    def test_slot_exhaustion(self, cfg):
        pool = KVBlockPool(cfg, max_len=16, block_size=8, num_blocks=32,
                           max_slots=3, device="cpu")
        pool.register(0)
        pool.register(1)                           # slots 1, 2 now taken
        with pytest.raises(PoolExhausted, match="slot"):
            pool.register(2)

    def test_scrub_release_zeroes_the_blocks(self, cfg):
        pool = KVBlockPool(cfg, max_len=16, block_size=8, num_blocks=6,
                           device="cpu")
        pool.register(0)
        blocks = pool.ensure(0, 9)
        for arr in tree_leaves(pool.arrays):
            arr.fill_(1.0)
        assert pool.scrub_release(0) == blocks
        for arr in tree_leaves(pool.arrays):
            assert (arr[blocks] == 0).all() and (arr[0] == 1.0).all()
        assert pool.snapshot()["live_requests"] == 0

    def test_pool_defaults_to_the_gpu(self, cfg, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KVBlockPool(cfg, max_len=16, block_size=8, num_blocks=4)
