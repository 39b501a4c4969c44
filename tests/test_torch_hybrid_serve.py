"""jamba-1.5-large's hybrid stack served by the port's `ContinuousScheduler`
on the CPU, against the JAX package.

The attention layer's k and v have a cache-length axis and are paged; the
Mamba layers' conv tail (B, d_conv - 1, d_inner) and fp32 state h (B,
d_inner, d_state) have none and go to the slot store. On the reduced
jamba15_large config with the reference's fp32 parameters (carried across
by `params_from_jax`):

  * a request's tokens are bitwise equal solo, in a drained batch and in a
    continuous batch, equal to the port's dense `greedy_generate`, and
    equal to the JAX scheduler's tokens on the same workload;
  * the layout's specs equal the reference's, and a prefill's state round
    trips through the pool;
  * the serving programs record the reference's ops with the layer group
    repeated `n_groups` times, on a 16-layer variant (two groups);
  * prompts shorter than d_conv - 1 = 3 tokens are refused;
  * on `meta`, chip_smoke.py phase 17's cut (8 layers, MoE on layer 1
    alone) records 58 GEMMs a decode step, 3 of them grouped, and 2
    gathers; its prefill 58 GEMMs and 7 depthwise convs; the full 72-layer
    model 541 GEMMs a pass and 63 depthwise convs a prefill.
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
WORK = [((3, 1, 4, 1, 5), 6), ((9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3), 4),
        ((2, 7, 1), 7), ((1, 1, 2, 3, 5, 8, 13), 5)]
SERVING = TE.EngineConfig(row_align=8)
ATTN_LAYER = "4"


@pytest.fixture(scope="module")
def jcfg():
    return jax_reduced("jamba15_large")


@pytest.fixture(scope="module")
def cfg():
    return reduced("jamba15_large")


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


@pytest.fixture(scope="module")
def programs():
    """Compiled programs shared by the three modes' schedulers."""
    return {}, {}


def make_sched(cfg, params, programs, **kw):
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("num_blocks", 24)
    kw.setdefault("block_size", 8)
    kw.setdefault("max_batch", 2)
    s = ContinuousScheduler(cfg, params, **kw)
    s._prefill, s._decode = programs
    return s


@pytest.mark.parametrize("mode,max_batch", [
    ("solo", 1), ("drain", 2), ("continuous", 2)])
def test_tokens_bitwise_equal_across_modes_and_to_the_reference(
        cfg, params, programs, jax_tokens, mode, max_batch):
    s = make_sched(cfg, params, programs, max_batch=max_batch,
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
    assert s.pool.allocator.free_blocks == s.pool.allocator.num_blocks - 1


def test_layout_pages_the_attention_cache_and_slots_the_mamba_state(
        cfg, jcfg, params):
    layout = PagedLayout.build(cfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=4, max_slots=4)
    jlayout = jax_kv.PagedLayout.build(jcfg, max_len=MAX_LEN, block_size=8,
                                       num_blocks=4, max_slots=4)
    specs = layout.specs["groups"]
    for j, leaves in specs.items():
        want = j == ATTN_LAYER
        assert sorted(leaves) == (["k", "v"] if want else ["conv", "h"])
        assert all(sp.paged is want and sp.batch_ax == 1
                   for sp in leaves.values()), j
    assert [(sp.paged, sp.batch_ax, sp.len_ax)
            for sp in tree_leaves(layout.specs)] == \
        [(sp.paged, sp.batch_ax, sp.len_ax)
         for sp in jax.tree_util.tree_leaves(jlayout.specs)]
    pool = KVBlockPool(cfg, max_len=MAX_LEN, block_size=8, num_blocks=8,
                       max_slots=4, device="cpu")
    assert pool.arrays["groups"]["0"]["h"].dtype == torch.float32
    with TE.using_config(SERVING):
        _, state = T.prefill(cfg, params, {"tokens": torch.tensor(
            [[4, 2, 7, 1, 3, 8, 8, 1, 9]])}, MAX_LEN)
    table = torch.arange(1, 1 + layout.blocks_per_req, dtype=torch.int32)
    layout.scatter_prefill(pool.arrays, state, table, torch.tensor(2), 9)
    back = layout.gather(pool.arrays, table[None].repeat(2, 1),
                         torch.tensor([2, 0], dtype=torch.int32))
    for (path, got), want in zip(_leaves_with_paths(back),
                                 tree_leaves(state), strict=True):
        if path[-1] in ("k", "v"):
            assert torch.equal(got[:, :1, :9], want[:, :, :9]), path
        else:
            assert torch.equal(got[:, :1], want), path


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield path, tree


def test_prompts_shorter_than_the_conv_window_are_refused(cfg, params,
                                                          programs):
    s = make_sched(cfg, params, programs)
    with pytest.raises(ValueError, match="d_conv - 1 = 3"):
        s.submit([5, 7], 2)
    s.submit([5, 7, 1], 2)


def _op_keys(ops):
    return [(op.kind, tuple(op.x_shape), tuple(op.w_shape), op.spec,
             op.causal) for op in ops]


def _repeat_groups(ops, n_groups, n_body):
    """The reference's op list with its one traced group body repeated."""
    return ops[:n_body] * n_groups + ops[n_body:]


@pytest.fixture(scope="module")
def two_groups():
    """The reduced config at 16 layers: two jamba groups of 8."""
    return (dataclasses.replace(reduced("jamba15_large"), n_layers=16),
            dataclasses.replace(jax_reduced("jamba15_large"), n_layers=16))


@pytest.mark.parametrize("batch", [1, 8])
def test_paged_decode_program_repeats_the_reference_group(two_groups, batch):
    """A group: 8 layers of 4 projections, 4 dense FFNs of 3 GEMMs and 4
    MoE FFNs of a router and 3 grouped GEMMs; then the unembedding. The
    attention layer's k and v are gathered."""
    tcfg, jcfg2 = two_groups
    layout = PagedLayout.build(tcfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=8)
    jlayout = jax_kv.PagedLayout.build(jcfg2, max_len=MAX_LEN, block_size=8,
                                       num_blocks=8)
    t = _op_keys(SE.paged_decode_program(tcfg, layout, batch).ops)
    j = _op_keys(JSE.paged_decode_program(jcfg2, jlayout, batch).ops)
    assert Counter(k[0] for k in j) == {"gather": 2, "dense": 8 * 4 + 4 * 3
                                        + 4 * 4 + 1}
    # both gather the stacked k and v of every group first
    assert t[:2] == j[:2] and {k[0] for k in j[:2]} == {"gather"}
    assert t[2:] == _repeat_groups(j[2:], tcfg.n_groups, len(j) - 3)


@pytest.mark.parametrize("seq", [3, 9])
def test_prefill_ingest_program_repeats_the_reference_group(two_groups, seq):
    tcfg, jcfg2 = two_groups
    layout = PagedLayout.build(tcfg, max_len=MAX_LEN, block_size=8,
                               num_blocks=8)
    jlayout = jax_kv.PagedLayout.build(jcfg2, max_len=MAX_LEN, block_size=8,
                                       num_blocks=8)
    t = _op_keys(SE.prefill_ingest_program(tcfg, layout, seq).ops)
    j = _op_keys(JSE.prefill_ingest_program(jcfg2, jlayout, seq).ops)
    assert Counter(k[0] for k in j) == {"dense": 61, "conv1d_dw": 7}
    assert t == _repeat_groups(j, tcfg.n_groups, len(j) - 1)


def _counts(ops):
    kinds = Counter(op.kind for op in ops)
    grouped = sum(op.kind == "dense" and len(op.w_shape) == 3 for op in ops)
    return dict(kinds), grouped


def test_phase17_cut_programs_on_meta():
    """chip_smoke.py phase 17's cut at full width: 8 of 72 layers, the MoE
    on layer 1 alone (`period` 8). A decode step: 58 GEMMs (the 3 grouped
    expert GEMMs and the router among them) and 2 gathers; the 1,100-token
    prefill 58 GEMMs and 7 depthwise convs, all at d_inner 16,384."""
    full = get_config("jamba15_large")
    cut = dataclasses.replace(full, n_layers=8, moe=dataclasses.replace(
        full.moe, period=8, first=1))
    assert [cut.is_moe_layer(i) for i in range(8)] == [False, True] \
        + [False] * 6
    layout = PagedLayout.build(cut, max_len=1152, block_size=16,
                               num_blocks=217, max_slots=9)
    with TE.using_config(SERVING):
        dec = SE.paged_decode_program(cut, layout, 8)
        pre = SE.prefill_ingest_program(cut, layout, 1100)
    assert _counts(dec.ops) == ({"dense": 58, "gather": 2}, 3)
    assert _counts(pre.ops) == ({"dense": 58, "conv1d_dw": 7}, 3)
    assert Counter((op.x_shape, op.w_shape) for op in pre.ops
                   if op.kind == "conv1d_dw") == {
        ((1, 1100, 16384), (4, 16384)): 7}
    assert Counter(op.w_shape for op in dec.ops if len(op.w_shape) == 3) \
        == {(16, 8192, 24576): 2, (16, 24576, 8192): 1}
    n = sum(a.numel() for a in tree_leaves(T.param_shapes(cut)))
    assert n == 18_058_977_280


def test_full_depth_programs_on_meta():
    """The 72-layer config on `meta`: 541 GEMMs a pass (72 layers of 4
    projections, 36 dense FFNs of 3, 36 MoE FFNs of 4, the unembedding),
    108 of them grouped, and 63 depthwise convs a prefill."""
    full = get_config("jamba15_large")
    with TE.using_config(SERVING):
        dec = SE.decode_program(full, 8, 1152)
        pre = SE.prefill_program(full, 1, 1100, max_len=1152)
    assert _counts(dec.ops) == ({"dense": 541}, 108)
    assert _counts(pre.ops) == ({"dense": 541, "conv1d_dw": 63}, 108)
