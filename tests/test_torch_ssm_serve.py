"""xLSTM served by the port's `ContinuousScheduler` on the CPU, against the
JAX package.

Every decode-state leaf of xLSTM (conv tail, fp32 memory) is a slot store:
none has a cache-length axis, so nothing is paged and the serving step
gathers no block. On the reduced xlstm_125m config with the reference's
fp32 parameters (carried across by `params_from_jax`):

  * a request's tokens are bitwise equal solo, in a drained batch and in a
    continuous batch, equal to the port's dense `greedy_generate`, and
    equal to the JAX scheduler's tokens on the same workload;
  * the serving programs record the reference's ops with the layer group
    repeated `n_groups` times, on a 12-layer variant (two groups; the stock
    reduced config has one group, which would prove nothing): the
    reference traces its scanned layers once, the port loops over them
    (ROADMAP section 3);
  * at full width (captured on `meta`) a decode step records 67 GEMMs and a
    prefill 79 ops, 12 of them depthwise convs.
"""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import reduced as jax_reduced
from repro.models import transformer as JT
from repro.serve import engine as JSE
from repro.serve import kv_pool as jax_kv
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch import engine as TE
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import transformer as T
from repro_torch.models.layers import tree_leaves
from repro_torch.serve import engine as SE
from repro_torch.serve.kv_pool import KVBlockPool, PagedLayout
from repro_torch.serve.scheduler import ContinuousScheduler

jax.config.update("jax_platform_name", "cpu")

MAX_LEN = 32
# prompts of at least d_conv - 1 = 3 tokens (the reference fails below)
WORK = [((3, 1, 4, 1, 5), 6), ((9, 2, 6), 9), ((2, 7, 1), 3),
        ((1, 1, 2, 3, 5), 5)]
SERVING = TE.EngineConfig(row_align=8)


@pytest.fixture(scope="module")
def jcfg():
    return jax_reduced("xlstm_125m")


@pytest.fixture(scope="module")
def cfg():
    return reduced("xlstm_125m")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return JT.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)


@pytest.fixture(scope="module")
def params(jparams):
    return T.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def jax_tokens(jcfg, jparams):
    """The JAX scheduler's tokens on WORK (its default serving config)."""
    s = JaxScheduler(jcfg, jparams, max_len=MAX_LEN, num_blocks=24,
                     block_size=8, max_batch=2)
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    assert all(t.status == "done" for t in tickets)
    return [t.tokens for t in tickets]


def make_sched(cfg, params, **kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    return ContinuousScheduler(cfg, params, **kw)


@pytest.mark.parametrize("mode,max_batch", [
    ("solo", 1), ("drain", 2), ("continuous", 2)])
def test_tokens_bitwise_equal_across_modes_and_to_the_reference(
        cfg, params, jax_tokens, mode, max_batch):
    s = make_sched(cfg, params, max_batch=max_batch,
                   admission="drain" if mode == "drain" else "continuous")
    tickets = [s.submit(list(p), n) for p, n in WORK]
    s.run()
    with TE.using_config(SERVING):
        dense = [SE.greedy_generate(cfg, params,
                                    {"tokens": torch.tensor([list(p)])}, n,
                                    MAX_LEN)[0].tolist() for p, n in WORK]
    for t, want, ref in zip(tickets, jax_tokens, dense):
        assert t.status == "done" and t.preemptions == 0
        assert t.tokens == ref, (mode, t.rid)
        assert t.tokens == want, (mode, t.rid)
    st = s.stats()
    assert st["compiled_decode_buckets"] == [8]
    assert st["unit_step_gather_s"] == 0.0      # nothing is paged


def test_every_leaf_is_a_slot_store_and_round_trips(cfg, params):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=4, max_slots=4)
    jlayout = jax_kv.PagedLayout.build(jax_reduced("xlstm_125m"),
                                       max_len=MAX_LEN, block_size=8,
                                       num_blocks=4, max_slots=4)
    specs = tree_leaves(layout.specs)
    assert specs and all(not sp.paged and sp.batch_ax == 1 for sp in specs)
    assert [(sp.batch_ax, sp.len_ax) for sp in specs] == \
        [(sp.batch_ax, sp.len_ax)
         for sp in jax.tree_util.tree_leaves(jlayout.specs)]
    pool = KVBlockPool(cfg, max_len=MAX_LEN, block_size=8, num_blocks=4,
                       max_slots=4, device="cpu")
    with TE.using_config(SERVING):
        _, state = T.prefill(cfg, params, {"tokens": torch.tensor(
            [[4, 2, 7, 1, 3]])}, MAX_LEN)
    table = torch.zeros(layout.blocks_per_req, dtype=torch.int32)
    layout.scatter_prefill(pool.arrays, state, table, torch.tensor(2), 1)
    back = layout.gather(pool.arrays, table[None].repeat(2, 1),
                         torch.tensor([2, 0], dtype=torch.int32))
    for got, want in zip(tree_leaves(back), tree_leaves(state), strict=True):
        assert torch.equal(got[:, :1], want)


def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec,
             op.causal) for op in ops]


def _repeat_groups(ops, n_groups, n_body):
    """The reference's op list with its one traced group body repeated."""
    return ops[:n_body] * n_groups + ops[n_body:]


@pytest.fixture(scope="module")
def two_groups():
    """The reduced config at 12 layers: two (mLSTM x 5, sLSTM) groups."""
    return (dataclasses.replace(reduced("xlstm_125m"), n_layers=12),
            dataclasses.replace(jax_reduced("xlstm_125m"), n_layers=12))


@pytest.mark.parametrize("batch", [1, 8])
def test_paged_decode_program_repeats_the_reference_group(two_groups, batch):
    tcfg, jcfg2 = two_groups
    layout = PagedLayout.build(tcfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=8)
    jlayout = jax_kv.PagedLayout.build(jcfg2, max_len=MAX_LEN, block_size=8,
                                       num_blocks=8)
    t = _op_keys(SE.paged_decode_program(tcfg, layout, batch).ops)
    j = _op_keys(JSE.paged_decode_program(jcfg2, jlayout, batch).ops)
    assert len(j) == 5 * 6 + 3 + 1                # one group traced
    assert t == _repeat_groups(j, tcfg.n_groups, 33)
    assert len(t) == 2 * 33 + 1


@pytest.mark.parametrize("seq", [3, 9])
def test_prefill_ingest_program_repeats_the_reference_group(two_groups, seq):
    tcfg, jcfg2 = two_groups
    layout = PagedLayout.build(tcfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=8)
    jlayout = jax_kv.PagedLayout.build(jcfg2, max_len=MAX_LEN, block_size=8,
                                       num_blocks=8)
    t = _op_keys(SE.prefill_ingest_program(tcfg, layout, seq).ops)
    j = _op_keys(JSE.prefill_ingest_program(jcfg2, jlayout, seq).ops)
    assert Counter(k[0] for k in j) == {"dense": 34, "conv1d_dw": 6}
    assert t == _repeat_groups(j, tcfg.n_groups, 39)


def test_full_width_programs_on_meta():
    """xlstm_125m at full width and depth, captured on `meta` (no
    arithmetic): 67 GEMMs a decode step (6 a mLSTM layer, 3 a sLSTM
    layer, the tied unembedding) and no gather; a prefill adds one
    depthwise conv a layer."""
    full = get_config("xlstm_125m")
    layout = PagedLayout.build(full, max_len=512, block_size=16,
                               num_blocks=257, max_slots=16)
    with TE.using_config(SERVING):
        dec = SE.paged_decode_program(full, layout, 8)
        pre = SE.prefill_ingest_program(full, layout, 16)
    assert Counter(op.kind for op in dec.ops) == {"dense": 67}
    assert Counter(op.kind for op in pre.ops) == {"dense": 67,
                                                  "conv1d_dw": 12}
    assert Counter((op.x_shape, op.w_shape, op.causal) for op in pre.ops
                   if op.kind == "conv1d_dw") == {
        ((1, 16, 1536), (4, 1536), True): 10,
        ((1, 16, 768), (4, 768), True): 2}
    assert Counter(op.w_shape for op in dec.ops) == {
        (768, 3072): 12, (1536, 1536): 30, (1536, 8): 10, (1536, 768): 10,
        (768, 2048): 2, (1024, 768): 2, (50304, 768): 1}
