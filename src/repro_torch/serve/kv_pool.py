"""Fixed-size paged KV block pool for continuous-batching decode serving.

A copy of the JAX package's `serve/kv_pool.py` in PyTorch. Every request's
KV cache lives as fixed-size blocks of one preallocated pool tensor per
cache leaf, shaped `(num_blocks, block_size, *feature)` — the grouped
attention cache `(n_groups, B, max_len, kv_heads, head_dim)` becomes
`(num_blocks, block_size, n_groups, kv_heads, head_dim)` — addressed by a
per-request block table that maps cache position `p` to block
`table[p // block_size]`, offset `p % block_size`. A host-side free-list
(`BlockAllocator`) hands out blocks as positions advance and takes them
back when a request finishes, is cancelled or is preempted. Leaves without
a `max_len` axis live in a `(max_slots, *feature)` slot store, one row per
live request: every leaf of xLSTM's recurrent decode state (conv tail and
fp32 memory) does, so an xLSTM decode step gathers no block.

Block 0 and slot 0 are reserved dummies: unallocated table entries and pad
rows point at them, so a gather over a partly allocated table stays in
bounds. Their contents are garbage by contract and are masked exactly
downstream.

Bitwise parity: `PagedLayout.gather` rebuilds each request's dense decode
state from its blocks (`engine.paged_gather`, an exact copy); the dense
decode math runs on it unchanged; `scatter_step` writes back only the slot
each row wrote. Positions `<= pos` hold the dense path's values bit for
bit; positions past `pos` hold recycled garbage where the dense path holds
zeros, but the decode mask gives both a softmax weight of exactly 0.0, so
a request's tokens are the same whether its cache was dense or paged. The
pool starts at zero and only ever holds finite cache values.

Where the reference threads new arrays through donated jitted steps, the
port writes the pool tensors in place (`index_put_`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from repro_torch import engine as E
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import resolve_device, tree_map
from repro_torch.serve import faults


class PoolExhausted(RuntimeError):
    """Block allocation failed: the free-list is empty. The failed alloc
    has no side effects — already-held blocks stay recorded in their
    tables, so the caller can preempt or queue and retry without repair."""


# ---------------------------------------------------------------------------
# Host-side allocator (free-list + block tables)
# ---------------------------------------------------------------------------

class BlockAllocator:
    """Free-list of pool blocks plus per-request block tables (pure host
    bookkeeping):

      * conservation — `free_blocks + live_blocks == num_blocks - 1`
        always (block 0 is reserved and never allocated);
      * disjointness — live requests' tables never share a block;
      * no double-free — releasing a request twice raises `KeyError`;
      * clean exhaustion — `PoolExhausted` leaves all state consistent.
    """

    def __init__(self, num_blocks: int, blocks_per_req: int):
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 (block 0 is the reserved dummy), "
                f"got {num_blocks}")
        if blocks_per_req < 1:
            raise ValueError(
                f"blocks_per_req must be >= 1, got {blocks_per_req}")
        self.num_blocks = int(num_blocks)
        self.blocks_per_req = int(blocks_per_req)
        # LIFO free-list: recently-freed (cache-warm) blocks are reused first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.tables: Dict[int, List[int]] = {}      # rid -> [block or 0] * bpr
        self.low_water = num_blocks - 1             # min free count ever seen

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def live_blocks(self) -> int:
        return sum(sum(1 for b in t if b) for t in self.tables.values())

    def register(self, rid: int) -> None:
        """Open an (empty) block table for request `rid`."""
        if rid in self.tables:
            raise ValueError(f"request {rid} already registered")
        self.tables[rid] = [0] * self.blocks_per_req

    def alloc_block(self, rid: int, idx: int) -> int:
        """Allocate table slot `idx` for `rid` (idempotent if already
        allocated); raises `PoolExhausted` when the free-list is empty."""
        table = self.tables[rid]
        if table[idx]:
            return table[idx]
        if not self._free:
            usable = self.num_blocks - 1
            raise PoolExhausted(
                f"no free blocks for request {rid} (need table slot {idx}): "
                f"{self.live_blocks}/{usable} blocks live "
                f"({self.live_blocks / usable:.0%} occupancy) across "
                f"{len(self.tables)} requests, free-block low-water "
                f"{self.low_water} — evict or wait")
        block = self._free.pop()
        table[idx] = block
        self.low_water = min(self.low_water, len(self._free))
        return block

    def ensure(self, rid: int, pos: int, block_size: int) -> List[int]:
        """Allocate every block covering cache positions [0, pos]; returns
        the newly allocated block ids (usually 0 or 1 of them)."""
        new = []
        table = self.tables[rid]
        for idx in range(pos // block_size + 1):
            if not table[idx]:
                new.append(self.alloc_block(rid, idx))
        return new

    def release(self, rid: int) -> List[int]:
        """Return `rid`'s blocks to the free-list; raises `KeyError` on a
        double release (the table is gone after the first)."""
        table = self.tables.pop(rid)
        blocks = [b for b in table if b]
        self._free.extend(blocks)
        return blocks


# ---------------------------------------------------------------------------
# Layout: classify decode-state leaves, build pool tensors, gather/scatter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    """Axis roles of one decode-state leaf (from shape diffs alone)."""

    batch_ax: int
    len_ax: int         # -1: not paged (whole-leaf slot store)
    ndim: int

    @property
    def paged(self) -> bool:
        return self.len_ax >= 0

    def rest_axes(self) -> Tuple[int, ...]:
        drop = {self.batch_ax} | ({self.len_ax} if self.paged else set())
        return tuple(i for i in range(self.ndim) if i not in drop)

    def to_bl_perm(self) -> Tuple[int, ...]:
        """Permutation taking the dense leaf to (B, L, *rest) layout."""
        return (self.batch_ax, self.len_ax) + self.rest_axes()

    def from_bl_perm(self) -> Tuple[int, ...]:
        """Inverse: (B, L, *rest) back to the dense leaf's axis order."""
        src = self.to_bl_perm()
        return tuple(src.index(i) for i in range(self.ndim))


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """The model's decode state mapped onto a block pool (and a slot store
    for leaves without a length axis).

    Derived from `T.init_decode_state` shapes alone (on `meta`): diffing
    the state at two batch sizes locates each leaf's batch axis, diffing
    it at two `max_len`s its cache-length axis. A leaf is paged iff its
    length axis scales 1:1 with `max_len`.
    """

    cfg: ModelConfig = dataclasses.field(compare=False)
    max_len: int
    block_size: int
    num_blocks: int
    max_slots: int
    specs: Any = dataclasses.field(compare=False)       # _LeafSpec tree
    template: Any = dataclasses.field(compare=False)    # batch-1 meta tree

    @property
    def blocks_per_req(self) -> int:
        return self.max_len // self.block_size

    # -- construction -------------------------------------------------------

    @staticmethod
    def build(cfg: ModelConfig, *, max_len: int, block_size: int,
              num_blocks: int, max_slots: int = 64,
              state_dtype: torch.dtype = torch.bfloat16) -> "PagedLayout":
        if max_len % block_size:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"block_size={block_size}")

        def sh(b, ml):
            return T.init_decode_state(cfg, b, ml, state_dtype, "meta")

        base, b2, l2 = sh(1, max_len), sh(2, max_len), sh(1, 2 * max_len)

        def spec(la, lb, lc):
            bdiff = [i for i, (p, q) in enumerate(zip(la.shape, lb.shape))
                     if p != q]
            if len(bdiff) != 1:
                raise ValueError(
                    f"ambiguous batch axis for leaf {tuple(la.shape)}: "
                    f"{bdiff}")
            ldiff = [i for i, (p, q) in enumerate(zip(la.shape, lc.shape))
                     if p != q]
            paged = (len(ldiff) == 1
                     and la.shape[ldiff[0]] == max_len
                     and lc.shape[ldiff[0]] == 2 * max_len)
            return _LeafSpec(bdiff[0], ldiff[0] if paged else -1, la.ndim)

        return PagedLayout(cfg=cfg, max_len=max_len, block_size=block_size,
                           num_blocks=num_blocks, max_slots=max_slots,
                           specs=tree_map(spec, base, b2, l2), template=base)

    def _shape(self, aval: torch.Tensor, sp: _LeafSpec) -> Tuple[int, ...]:
        rest = tuple(aval.shape[i] for i in sp.rest_axes())
        if sp.paged:
            return (self.num_blocks, self.block_size) + rest
        return (self.max_slots,) + rest

    def init_arrays(self, device) -> Any:
        """Zero-filled pool/slot tensors on `device`, one per decode-state
        leaf."""
        return tree_map(lambda a, sp: torch.zeros(
            self._shape(a, sp), dtype=a.dtype, device=device),
            self.template, self.specs)

    def array_avals(self) -> Any:
        """The pool/slot tensors as `meta` tensors."""
        return self.init_arrays("meta")

    # -- gather / scatter ---------------------------------------------------

    def gather(self, arrays: Any, tables: torch.Tensor,
               slots: torch.Tensor) -> Any:
        """Dense decode state for a batch: tables (B, blocks_per_req) int32,
        slots (B,) int32 -> the `init_decode_state(cfg, B, max_len)` tree,
        rebuilt leaf by leaf from the pool (paged leaves through
        `engine.paged_gather`; returned as permuted views of its output)."""
        def leaf(arr, sp):
            if sp.paged:
                g = E.paged_gather(arr, tables)      # (B, L, *rest)
                return g.permute(sp.from_bl_perm())
            g = arr.index_select(0, slots)           # (B, *rest)
            return torch.movedim(g, 0, sp.batch_ax)
        return tree_map(leaf, arrays, self.specs)

    def scatter_step(self, arrays: Any, state: Any, tables: torch.Tensor,
                     slots: torch.Tensor, pos: torch.Tensor) -> Any:
        """Write one decode step back, in place: for paged leaves only the
        slot each row wrote (position `pos[b]`), for slot leaves the whole
        row. Returns `arrays`.

        Pad rows (table all zeros, pos 0) all write block 0, slot 0. With
        duplicate indices `index_put_` keeps an arbitrary one of the
        writes on the card; that is harmless only because block 0 and slot
        0 are never read unmasked by a live request."""
        bs = self.block_size
        pos = pos.long()
        bids = torch.gather(tables.long(), 1, (pos // bs)[:, None])[:, 0]
        offs = pos % bs
        rows = torch.arange(pos.shape[0], device=pos.device)

        def leaf(arr, new, sp):
            if sp.paged:
                bl = new.permute(sp.to_bl_perm())          # (B, L, *rest)
                arr.index_put_((bids, offs), bl[rows, pos].to(arr.dtype))
            else:
                vals = torch.movedim(new, sp.batch_ax, 0)  # (B, *rest)
                arr.index_put_((slots.long(),), vals.to(arr.dtype))
            return arr
        return tree_map(leaf, arrays, state, self.specs)

    def scatter_prefill(self, arrays: Any, state: Any,
                        table_row: torch.Tensor, slot: torch.Tensor,
                        n_blocks: int) -> Any:
        """Ingest a batch-1 prefill state, in place: the first `n_blocks`
        blocks of every paged leaf (`n_blocks = ceil(prompt_len /
        block_size)`) plus the whole slot-store row. The tail of the last
        block carries the dense state's zeros. Returns `arrays`."""
        npb, bs = self.blocks_per_req, self.block_size

        def leaf(arr, new, sp):
            if sp.paged:
                bl = new.permute(sp.to_bl_perm())          # (1, L, *rest)
                vals = bl[0].reshape((npb, bs) + tuple(bl.shape[2:]))[:n_blocks]
                arr.index_put_((table_row[:n_blocks].long(),),
                               vals.to(arr.dtype))
            else:
                # an index tensor, not a scalar index: no host read of the
                # slot (which `meta` capture could not do)
                vals = torch.movedim(new, sp.batch_ax, 0)[:1]
                arr.index_put_((slot.long().reshape(1),), vals.to(arr.dtype))
            return arr
        return tree_map(leaf, arrays, state, self.specs)


# ---------------------------------------------------------------------------
# KVBlockPool: layout + allocator + live tensors
# ---------------------------------------------------------------------------

class KVBlockPool:
    """The serving-side pool: `PagedLayout` tensors on `device` plus the
    host allocator. The scheduler's compiled steps write `self.arrays` in
    place; alloc/free/snapshot stay host bookkeeping."""

    def __init__(self, cfg: ModelConfig, *, max_len: int, block_size: int,
                 num_blocks: int, max_slots: int = 64,
                 state_dtype: torch.dtype = torch.bfloat16, device=None):
        self.layout = PagedLayout.build(
            cfg, max_len=max_len, block_size=block_size,
            num_blocks=num_blocks, max_slots=max_slots,
            state_dtype=state_dtype)
        self.allocator = BlockAllocator(num_blocks,
                                        self.layout.blocks_per_req)
        self.device = resolve_device(device)
        self.arrays = self.layout.init_arrays(self.device)
        # slot 0 reserved for pad rows, like block 0
        self._free_slots: List[int] = list(range(max_slots - 1, 0, -1))
        self._slot_of: Dict[int, int] = {}
        # prefix of this pool's fault-injection sites (the reference's
        # ReplicaSpread sets "r<i>:" a replica)
        self.fault_site = ""

    # -- request lifecycle ---------------------------------------------------

    def register(self, rid: int) -> None:
        if not self._free_slots:
            s = self.snapshot()
            raise PoolExhausted(
                f"no free state slots for request {rid} "
                f"(max_slots={self.layout.max_slots}, "
                f"{s['live_requests']} live requests, block occupancy "
                f"{s['occupancy']:.0%}, free-block low-water "
                f"{s['free_low_water']})")
        self.allocator.register(rid)
        self._slot_of[rid] = self._free_slots.pop()

    def ensure(self, rid: int, pos: int) -> List[int]:
        """Blocks covering positions [0, pos] — allocate the missing ones.

        An installed `serve.faults` injector may fire the "pool" point here
        (an injected exhaustion storm, site "<fault_site><rid>"): the raise
        looks like a real empty free list, with no side effect, so the
        schedulers' preempt and retry paths run as under real pressure."""
        inj = faults.active()
        if inj is not None and inj.fire("pool",
                                        site=f"{self.fault_site}{rid}"):
            s = self.snapshot()
            raise PoolExhausted(
                f"injected pool-exhaustion storm for request {rid} "
                f"({s['live_blocks']}/{s['num_blocks'] - 1} blocks live, "
                f"{s['live_requests']} live requests)")
        return self.allocator.ensure(rid, pos, self.layout.block_size)

    def release(self, rid: int) -> List[int]:
        blocks = self.allocator.release(rid)
        self._free_slots.append(self._slot_of.pop(rid))
        return blocks

    def scrub_release(self, rid: int) -> List[int]:
        """Zero `rid`'s blocks and state slot, then release them (so no
        non-finite value recycles into another request's blocks)."""
        blocks = [b for b in self.allocator.tables[rid] if b]
        slot = self._slot_of[rid]
        ids = torch.tensor(blocks, dtype=torch.long, device=self.device)

        def leaf(arr, sp):
            if sp.paged:
                if blocks:
                    arr[ids] = 0
            else:
                arr[slot] = 0
            return arr
        tree_map(leaf, self.arrays, self.layout.specs)
        return self.release(rid)

    # -- batch views ---------------------------------------------------------

    def table_rows(self, rids: List[int], bucket: int) -> torch.Tensor:
        """(bucket, blocks_per_req) int32 block tables on the pool's device;
        pad rows all zero (the reserved dummy block)."""
        npb = self.layout.blocks_per_req
        rows = [self.allocator.tables[r] for r in rids]
        rows += [[0] * npb] * (bucket - len(rids))
        return torch.tensor(rows, dtype=torch.int32, device=self.device)

    def slot_rows(self, rids: List[int], bucket: int) -> torch.Tensor:
        slots = [self._slot_of[r] for r in rids]
        slots += [0] * (bucket - len(rids))
        return torch.tensor(slots, dtype=torch.int32, device=self.device)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        alc = self.allocator
        usable = alc.num_blocks - 1
        return {
            "num_blocks": alc.num_blocks,
            "block_size": self.layout.block_size,
            "blocks_per_req": self.layout.blocks_per_req,
            "free_blocks": alc.free_blocks,
            "live_blocks": alc.live_blocks,
            "live_requests": len(alc.tables),
            "occupancy": (alc.live_blocks / usable) if usable else 0.0,
            "free_low_water": alc.low_water,
            "free_slots": len(self._free_slots),
        }
