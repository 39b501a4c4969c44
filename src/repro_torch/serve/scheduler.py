"""Serving schedulers over compiled engine programs. A copy of the JAX
package's `serve/scheduler.py`: the static `Scheduler` with `Ticket` and
`AdmissionError`, and, for its LM path, `GenTicket`, `latency_percentiles`
and `ContinuousScheduler`. Not ported (ROADMAP queue 1): fault injection,
the numerics guard and retries (item 9), the `mesh=` path and
`ReplicaSpread` (item 11), kernel tuning (item 6). The reference's default
config, `EngineConfig(row_align=8, fallback="chain")`, becomes
`EngineConfig(row_align=8)` in both schedulers: a fallback chain would hide
a kernel failure behind another backend's result.

`Scheduler` is the paper's one-engine-for-heterogeneous-work claim at
serving granularity: requests for different programs (CNN forwards built by
`models.cnn.program`, transformer scoring prefills and decode steps built by
`serve.engine.prefill_program` / `decode_program`, or anything from
`engine.trace_program` with batch metadata) enter one queue and are packed,
a program at a time, into batches padded up to a bucket ladder (1, 2, 4,
..., `max_batch`), each bucket `engine.compile(program.with_batch(bucket))`.
Everything cost-aware reads the analytic plan: admission bounds the queue
by the summed `NetworkPlan.total_latency_s` of its requests
(`max_queue_cost_s`), "spf" serves the program with the shortest batch-1
plan first ("fifo" keeps arrival order), and each ticket's ledger holds its
batch-1 plan's ops. Its contract: a request's result is bitwise the same
as that request run alone through the batch-1 `CompiledNet.apply`, whatever
bucket it rode in, for programs whose every op treats rows alone (the CNN
forwards, dense prefill and decode). On the card that rests on kernels
whose sums ignore the batch (`gfid_conv.f32_plan` / `bf16_plan`, the GEMM
plans); the decode step's attention products run on cuBLAS, whose
algorithm may follow the row count (ROADMAP section 3).

Parity contract of `ContinuousScheduler` (as the reference's): a request's
tokens are bitwise
identical whether it ran solo (`max_batch=1`), rode a drained batch
(`admission="drain"`) or a continuous batch whose rows joined and left
mid-generation. Prefill is always batch 1 at the exact prompt length;
under `row_align` the decode buckets start at `row_align` rows, so with
`max_batch <= row_align` every decode step has one shape whatever the
number of live rows (a divergence from the reference, whose buckets start
at 1: on the card a reduction's or a batched product's algorithm may
follow the row count); the decode mask zeroes positions past `pos`
exactly.
The one carve-out is preemption: a preempted request re-prefills its
prompt and generated tokens, which is not bitwise the same as the decode
steps it replaces, so preemptions are counted (`GenTicket.preemptions`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import engine as E
from repro_torch.engine import ledger as _ledger
from repro_torch.engine.program import tree_leaves, tree_map
from repro_torch.models.layers import resolve_device
from repro_torch.serve import engine as serve_engine
from repro_torch.serve.kv_pool import KVBlockPool, PoolExhausted


def latency_percentiles(tickets: Sequence[Any],
                        pcts: Sequence[float] = (50, 95, 99),
                        ) -> Dict[str, float]:
    """Wall-clock submit-to-completion percentiles over served tickets."""
    lats = sorted(t.latency_s for t in tickets if t.done)
    if not lats:
        return {f"p{p:g}_ms": 0.0 for p in pcts}
    return {f"p{p:g}_ms": float(np.percentile(np.asarray(lats), p) * 1e3)
            for p in pcts}


class AdmissionError(RuntimeError):
    """Request rejected: admitting it would exceed `max_queue_cost_s`."""


_POLICIES = ("fifo", "spf")


def _buckets_up_to(max_batch: int) -> List[int]:
    """The default ladder: powers of two below `max_batch`, then it."""
    buckets, b = [], 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    return buckets + [max_batch]


@dataclasses.dataclass(eq=False)      # identity semantics: args hold tensors
class Ticket:
    """One admitted request and, after its batch ran, its result.

    `unit_latency_s` is the MMIE-projected latency of this request's
    batch-1 plan, the number admission and "spf" order by. `ledger` holds
    the request's batch-1 plan ops once served."""

    rid: int
    model: str
    args: Tuple[Any, ...]           # the values of the batched positions
    submit_s: float
    unit_latency_s: float
    deadline_s: Optional[float] = None  # absolute perf_counter deadline
    cancelled: bool = False
    expired: bool = False
    ledger: E.Ledger = dataclasses.field(default_factory=E.Ledger)
    result: Any = None
    done: bool = False
    batch_index: int = -1           # row this request occupied in its batch
    batch_fill: int = 0             # real requests in the executed batch
    batch_bucket: int = 0           # padded bucket size the batch ran at
    done_s: float = 0.0             # completion timestamp (perf_counter)

    @property
    def latency_s(self) -> float:
        """Submit-to-completion wall time; NaN while pending."""
        if not self.done:
            return float("nan")
        return self.done_s - self.submit_s


@dataclasses.dataclass
class _Entry:
    """One registered program: its batch-1 plan and compiled buckets."""

    name: str
    program: E.Program              # at batch 1
    shared: Dict[int, Any]          # arg position -> bound value
    batch_positions: Tuple[int, ...]
    request_avals: Tuple[Any, ...]  # (shape, dtype) trees for submit()
    out_axes: Any                   # per-leaf output batch axis (or -1)
    unit_plan: E.NetworkPlan
    device: torch.device
    compiled: Dict[int, E.CompiledNet] = dataclasses.field(
        default_factory=dict)          # bucket -> CompiledNet
    pack_fn: Any = None             # one packer for every bucket
    unpack: Dict[int, Any] = dataclasses.field(default_factory=dict)
    served: int = 0
    batches: int = 0
    padded_slots: int = 0


def _aval_of(x: torch.Tensor) -> Tuple[Tuple[int, ...], torch.dtype]:
    return tuple(x.shape), x.dtype


class Scheduler:
    """Shared-queue batched scheduler over registered engine programs.

    config           — `EngineConfig` every bucket compiles under; default
                       `EngineConfig(row_align=8)`.
    policy           — "fifo" (arrival order) or "spf" (shortest plan
                       first: the program whose batch-1 analytic latency is
                       smallest; arrival order within a program).
    max_batch        — the largest batch one dispatch carries.
    buckets          — the batch-size ladder, ending at `max_batch`; a batch
                       is padded up to the next bucket, so each program
                       compiles one `CompiledNet` per bucket. Default:
                       powers of two.
    max_queue_cost_s — admission budget: `submit` raises `AdmissionError`
                       once the queue's summed plan latency would pass it
                       (None admits everything).
    mesh, faults     — not ported: a value other than None raises (ROADMAP
                       queue 1, items 11 and 9).

    Batches run on the device of each program's shared arguments."""

    def __init__(self, config: Optional[E.EngineConfig] = None,
                 policy: str = "fifo", max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue_cost_s: Optional[float] = None,
                 mesh: Optional[Any] = None, faults: Optional[Any] = None):
        if mesh is not None:
            raise NotImplementedError(
                "Scheduler(mesh=...) is not ported: multi-device serving is "
                "ROADMAP queue 1, item 11")
        if faults is not None:
            raise NotImplementedError(
                "Scheduler(faults=...) is not ported: fault injection is "
                "ROADMAP queue 1, item 9")
        if policy not in _POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one of "
                             f"{_POLICIES}")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.config = config if config is not None \
            else E.EngineConfig(row_align=8)
        self.policy = policy
        self.max_batch = max_batch
        if buckets is None:
            buckets = _buckets_up_to(max_batch)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        if self.buckets[-1] != max_batch:
            raise ValueError(f"buckets {self.buckets} must end at "
                             f"max_batch={max_batch}")
        self.max_queue_cost_s = max_queue_cost_s
        self.ledger = E.Ledger()        # batch-1 plans of everything served
        self._entries: Dict[str, _Entry] = {}
        self._queue: List[Ticket] = []
        self._next_rid = 0
        self._wall_s = 0.0              # summed dispatch wall time

    # -- registration -------------------------------------------------------

    def register(self, name: str, program: E.Program,
                 shared_args: Sequence[Any] = ()) -> _Entry:
        """Register `program` under `name`.

        The program must be executable (carry `fn`) and re-batchable (carry
        batch metadata); it is taken at batch 1. Argument positions with no
        batch axis (weights, a decode position) are shared: bound once here
        through `shared_args` (in positional order) and reused by every
        request, whose `submit` then passes only the batched positions.
        Batches run on the device of the first shared tensor."""
        if name in self._entries:
            raise ValueError(f"model {name!r} already registered")
        if program.fn is None:
            raise ValueError(
                f"program {program.name!r} carries no executable fn — the "
                "scheduler can only serve programs built with trace_program "
                "or a model-side builder like cnn.program")
        prog1 = program.with_batch(1)   # also checks the batch metadata
        batched, unbatched = [], []
        for i, axes in enumerate(prog1.batch_axes):
            leaves = tree_leaves(axes)
            if any(a >= 0 for a in leaves):
                if any(a < 0 for a in leaves):
                    # packing would reuse request 0's value of the unbatched
                    # leaves for every request in the batch
                    raise ValueError(
                        f"arg position {i} of program {prog1.name!r} mixes "
                        "batched and unbatched leaves in one pytree; bind "
                        "the unbatched data as its own (shared) argument "
                        "position instead")
                batched.append(i)
            else:
                unbatched.append(i)
        if len(shared_args) != len(unbatched):
            raise ValueError(
                f"program {prog1.name!r} has {len(unbatched)} unbatched arg "
                f"position(s) {tuple(unbatched)}; pass exactly that many "
                f"shared_args (got {len(shared_args)})")
        shared = dict(zip(unbatched, shared_args))
        # The output batch axes, found as the input ones are: the outputs on
        # `meta` at batch 1 and 2, with the ledgers paused (no phantom ops).
        with _ledger.paused(), E.using_config(self.config), torch.no_grad():
            out1 = prog1.fn(*prog1.in_avals)
            out2 = prog1.fn(*prog1.with_batch(2).in_avals)
        out_axes = E.infer_batch_axes((out1,), (out2,))[0]
        tensors = [t for t in tree_leaves(tuple(shared_args))
                   if isinstance(t, torch.Tensor)]
        entry = _Entry(
            name=name, program=prog1, shared=shared,
            batch_positions=tuple(batched),
            request_avals=tuple(tree_map(_aval_of, prog1.in_avals[pos])
                                for pos in batched),
            out_axes=out_axes,
            unit_plan=E.plan_network(prog1, self.config),
            device=tensors[0].device if tensors else resolve_device(None))
        self._entries[name] = entry
        return entry

    def compiled(self, name: str, bucket: int) -> E.CompiledNet:
        """The (program, bucket) `CompiledNet`, built once, then cached."""
        entry = self._entries[name]
        if bucket not in entry.compiled:
            entry.compiled[bucket] = E.compile(
                entry.program.with_batch(bucket), self.config)
        return entry.compiled[bucket]

    def _pack_fn(self, entry: _Entry):
        """The packer: the batch's per-request argument tuples in, the
        batched values of the program's batched positions out, each leaf
        the requests' leaves joined along its batch axis."""
        if entry.pack_fn is None:
            axes_by_pos = tuple(entry.program.batch_axes[pos]
                                for pos in entry.batch_positions)

            def pack(per):
                return tuple(
                    tree_map(lambda ax, *ls: torch.cat(ls, dim=ax), axes,
                              *(p[j] for p in per))
                    for j, axes in enumerate(axes_by_pos))

            entry.pack_fn = pack
        return entry.pack_fn

    def _unpack_fn(self, entry: _Entry, bucket: int):
        """The unpacker: the batched output in, `bucket` per-request
        slices (the batch axis kept, of size 1) out."""
        if bucket not in entry.unpack:
            out_axes = entry.out_axes

            def unpack(out):
                return tuple(
                    tree_map(lambda leaf, ax: leaf if ax < 0
                              else leaf.narrow(ax, i, 1), out, out_axes)
                    for i in range(bucket))

            entry.unpack[bucket] = unpack
        return entry.unpack[bucket]

    def _dispatch(self, entry: _Entry, bucket: int,
                  per: Tuple[Tuple[Any, ...], ...]) -> Tuple[Any, ...]:
        """The batch path (pack, shared arguments spliced in, apply,
        unpack), shared by `step` and `warmup`; waits for the device."""
        packed = iter(self._pack_fn(entry)(per))
        args = [entry.shared[pos] if pos in entry.shared else next(packed)
                for pos in range(len(entry.program.in_avals))]
        out = self.compiled(entry.name, bucket).apply(*args)
        results = self._unpack_fn(entry, bucket)(out)
        if entry.device.type == "cuda":
            torch.cuda.synchronize(entry.device)
        return results

    def warmup(self, name: Optional[str] = None) -> None:
        """Compile and run every bucket of `name` (default: every program)
        once on a zero-filled batch, so no request waits on a compile."""
        for n in ([name] if name else list(self._entries)):
            entry = self._entries[n]
            zeros = tuple(
                tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype,
                                                device=entry.device),
                          entry.program.in_avals[pos])
                for pos in entry.batch_positions)
            for bucket in self.buckets:
                self._dispatch(entry, bucket, (zeros,) * bucket)

    # -- admission ----------------------------------------------------------

    def queue_cost_s(self) -> float:
        """Summed MMIE-projected latency of every pending request."""
        return sum(t.unit_latency_s for t in self._queue)

    def pending(self) -> int:
        return len(self._queue)

    def submit(self, name: str, *args: Any,
               timeout_s: Optional[float] = None) -> Ticket:
        """Admit one request for program `name`.

        `args` are the request's values of the program's batched argument
        positions, in order, each shaped exactly like the program's batch-1
        avals. `timeout_s` sets a wall-clock deadline relative to now; a
        ticket still queued past it is dropped (`expired`).
        Raises `AdmissionError` when the queue's plan-cost budget is full,
        `KeyError` for an unknown program, `ValueError` for a shape or dtype
        mismatch."""
        try:
            entry = self._entries[name]
        except KeyError:
            raise KeyError(f"unknown model {name!r}; registered: "
                           f"{sorted(self._entries)}") from None
        if len(args) != len(entry.batch_positions):
            raise ValueError(
                f"{name!r} takes {len(entry.batch_positions)} per-request "
                f"arg(s) (positions {entry.batch_positions} of the program "
                f"signature); got {len(args)}")
        for val, pos, want in zip(args, entry.batch_positions,
                                  entry.request_avals):
            got = tree_map(_aval_of, val)
            if want != got:
                raise ValueError(
                    f"request arg for position {pos} of {name!r} does not "
                    f"match the program's batch-1 avals:\n  want {want}\n"
                    f"  got  {got}")
        unit = entry.unit_plan.total_latency_s
        if self.max_queue_cost_s is not None \
                and self.queue_cost_s() + unit > self.max_queue_cost_s:
            served = sum(e.served for e in self._entries.values())
            raise AdmissionError(
                f"queue plan-cost {self.queue_cost_s():.6f}s + request "
                f"{unit:.6f}s exceeds max_queue_cost_s="
                f"{self.max_queue_cost_s:.6f}s ({len(self._queue)} pending "
                f"across {len({t.model for t in self._queue})} program(s), "
                f"{served} served in "
                f"{sum(e.batches for e in self._entries.values())} batches, "
                f"budget {self.queue_cost_s() / self.max_queue_cost_s:.0%} "
                "used)")
        now = time.perf_counter()
        ticket = Ticket(rid=self._next_rid, model=name, args=tuple(args),
                        submit_s=now, unit_latency_s=unit,
                        deadline_s=None if timeout_s is None
                        else now + timeout_s)
        self._next_rid += 1
        self._queue.append(ticket)
        return ticket

    def cancel(self, ticket: Ticket) -> bool:
        """Drop a still-queued ticket; False once it ran (results are not
        taken back) or was dropped before."""
        if ticket.done or ticket.cancelled or ticket.expired:
            return False
        ticket.cancelled = True
        ticket.args = ()
        self._queue = [t for t in self._queue if t is not ticket]
        return True

    def _expire(self) -> None:
        now = time.perf_counter()
        keep = []
        for t in self._queue:
            if t.deadline_s is not None and now > t.deadline_s:
                t.expired = True
                t.args = ()
            else:
                keep.append(t)
        self._queue = keep

    # -- dispatch -----------------------------------------------------------

    def _pick_model(self) -> str:
        if self.policy == "spf":
            return min(self._queue,
                       key=lambda t: (t.unit_latency_s, t.rid)).model
        return self._queue[0].model

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def step(self) -> List[Ticket]:
        """Form and run one batch; returns the tickets it served."""
        self._expire()
        if not self._queue:
            return []
        name = self._pick_model()
        entry = self._entries[name]
        batch = [t for t in self._queue if t.model == name][:self.max_batch]
        self._queue = [t for t in self._queue if t not in batch]
        k = len(batch)
        bucket = self._bucket_for(k)

        t0 = time.perf_counter()
        # pad with the first request's tensors (references, not copies), so
        # the packer always sees `bucket` requests
        per = tuple(t.args for t in batch) + (batch[0].args,) * (bucket - k)
        results = self._dispatch(entry, bucket, per)
        self._wall_s += time.perf_counter() - t0
        entry.batches += 1
        entry.served += k
        entry.padded_slots += bucket - k

        for i, ticket in enumerate(batch):
            ticket.result = results[i]
            ticket.args = ()    # served: release the request's inputs
            ticket.done = True
            ticket.batch_index = i
            ticket.batch_fill = k
            ticket.batch_bucket = bucket
            ticket.done_s = time.perf_counter()
            for plan in entry.unit_plan.plans:
                ticket.ledger.record_plan(plan)
                self.ledger.record_plan(plan)
        return batch

    def drain(self) -> List[Ticket]:
        """Serve until the queue is empty; tickets in completion order."""
        done: List[Ticket] = []
        while self._queue:
            done.extend(self.step())
        return done

    # -- stats --------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """The reference's counters; those of unported items keep their
        idle values (`tuning` "off", one replica, no fallbacks, spikes or
        faults)."""
        per_model = {
            n: {
                "served": e.served,
                "batches": e.batches,
                "padded_slots": e.padded_slots,
                "occupancy": (e.served / (e.served + e.padded_slots)
                              if e.served else 0.0),
                "unit_plan_latency_s": e.unit_plan.total_latency_s,
                "compiled_buckets": sorted(e.compiled),
            }
            for n, e in self._entries.items()
        }
        served = sum(e.served for e in self._entries.values())
        return {
            "policy": self.policy,
            "max_batch": self.max_batch,
            "tuning": "off",
            "replicas": 1,
            "buckets": list(self.buckets),
            "served": served,
            "batches": sum(e.batches for e in self._entries.values()),
            "dispatch_wall_s": self._wall_s,
            "throughput_rps": served / self._wall_s if self._wall_s else 0.0,
            "pending": len(self._queue),
            "plan_macs_served": self.ledger.total_macs,
            "plan_cycles_served": self.ledger.total_cycles,
            "fallbacks": [],
            "latency_spikes": 0,
            "faults": None,
            "models": per_model,
        }


_TERMINAL = ("done", "cancelled", "expired")


@dataclasses.dataclass(eq=False)
class GenTicket:
    """One generation request in the continuous scheduler.

    `prompt` is the submitted prompt; `context` is the prefix the
    request's cache currently encodes (it grows past `prompt` only when a
    preemption folds generated tokens back through prefill). `tokens` is
    every token generated so far; `status` walks queued -> running ->
    done | cancelled | expired.
    """

    rid: int
    prompt: Tuple[int, ...]
    steps: int
    submit_s: float
    deadline_s: Optional[float] = None  # absolute perf_counter deadline
    context: Tuple[int, ...] = ()
    tokens: List[int] = dataclasses.field(default_factory=list)
    status: str = "queued"
    pos: int = 0                    # next cache position to be written
    preemptions: int = 0
    done_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.status == "done"

    @property
    def latency_s(self) -> float:
        if self.status not in _TERMINAL:
            return float("nan")
        return self.done_s - self.submit_s


class ContinuousScheduler:
    """Per-step admission decode scheduler over a paged `KVBlockPool`.

    The decode batch is re-formed every step: finished rows leave, waiting
    requests join (their prompt runs through a batch-1
    `prefill_ingest_program` compiled at its exact length, between decode
    steps), and each request's KV cache lives in pool blocks allocated on
    demand. Admission reads pool occupancy and the analytic plan:

      * blocks    — a request joins only when the pool can cover its
        prompt plus the next decode write, and the youngest running
        request is evicted when an older one needs a block the pool cannot
        supply;
      * plan cost — `max_live_cost_s` bounds the running set by the summed
        MMIE-projected latency of one batch-1 paged decode step per live
        request (`NetworkPlan.total_latency_s` of `paged_decode_program`,
        gathers included). The port's programs record every layer (the
        reference's scanned trace records one group), so its `unit_step_s`
        is the whole step's.

    Everything runs on the device of `params` (the pool is allocated
    there); the compiled programs write the pool in place.
    """

    def __init__(self, cfg, params, *, max_len: int, num_blocks: int,
                 block_size: int = 8, max_batch: int = 8,
                 buckets: Optional[Sequence[int]] = None,
                 config: Optional[E.EngineConfig] = None,
                 admission: str = "continuous",
                 max_live_cost_s: Optional[float] = None,
                 max_slots: int = 64,
                 state_dtype: torch.dtype = torch.bfloat16):
        if admission not in ("continuous", "drain"):
            raise ValueError(f"unknown admission {admission!r}; expected "
                             "'continuous' or 'drain'")
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.cfg = cfg
        self.params = params
        self.config = config if config is not None \
            else E.EngineConfig(row_align=8)
        self.admission = admission
        self.max_batch = max_batch
        self.max_live_cost_s = max_live_cost_s
        if buckets is None:
            buckets = _buckets_up_to(max_batch)
        if max(buckets) != max_batch:
            raise ValueError(f"buckets {tuple(buckets)} must end at "
                             f"max_batch={max_batch}")
        # the row_align floor: one decode shape up to row_align live rows
        floor = self.config.row_align or 1
        self.buckets = tuple(sorted({max(int(b), floor) for b in buckets}))
        self.device = tree_leaves(params)[0].device
        self.param_dtype = params["embed"].dtype    # the programs' stand-ins
        self.pool = KVBlockPool(cfg, max_len=max_len, block_size=block_size,
                                num_blocks=num_blocks, max_slots=max_slots,
                                state_dtype=state_dtype, device=self.device)
        self.layout = self.pool.layout
        # analytic unit cost of one live request: a batch-1 paged decode
        # step (attention/FFN GEMMs + the paged-gather rebuild)
        self.unit_step_plan = E.plan_network(
            serve_engine.paged_decode_program(cfg, self.layout, 1,
                                              self.param_dtype),
            self.config)
        self.unit_step_s = self.unit_step_plan.total_latency_s
        self._decode: Dict[int, E.CompiledNet] = {}
        self._prefill: Dict[int, E.CompiledNet] = {}
        self._waiting: List[GenTicket] = []
        self._running: List[GenTicket] = []
        self._next_rid = 0
        self._steps = 0
        self._tokens_out = 0
        self._fill_sum = 0.0
        self._admitted = 0
        self._evicted = 0
        self._expired = 0
        self._cancelled = 0
        self._admit_history: List[int] = []
        self._evict_history: List[int] = []
        self._wall_s = 0.0
        self._terminated: Dict[int, str] = {}

    def _mark_terminal(self, t: GenTicket, status: str) -> None:
        """The single gate to a terminal status: records the completion
        time, bumps the matching counter, and raises if a ticket would
        terminate twice."""
        if t.rid in self._terminated or t.status in _TERMINAL:
            raise RuntimeError(
                f"request {t.rid} terminated twice: already "
                f"{self._terminated.get(t.rid, t.status)!r}, now {status!r}")
        self._terminated[t.rid] = status
        t.status = status
        t.done_s = time.perf_counter()
        self._expired += status == "expired"
        self._cancelled += status == "cancelled"

    # -- compiled-program caches --------------------------------------------

    def decode_compiled(self, bucket: int) -> E.CompiledNet:
        """The paged decode step at `bucket` rows."""
        if bucket not in self._decode:
            prog = serve_engine.paged_decode_program(self.cfg, self.layout,
                                                     bucket, self.param_dtype)
            self._decode[bucket] = E.compile(prog, self.config)
        return self._decode[bucket]

    def prefill_compiled(self, seq: int) -> E.CompiledNet:
        """Batch-1 prefill-ingest at exact prompt length `seq`."""
        if seq not in self._prefill:
            prog = serve_engine.prefill_ingest_program(self.cfg, self.layout,
                                                       seq, self.param_dtype)
            self._prefill[seq] = E.compile(prog, self.config)
        return self._prefill[seq]

    # -- request lifecycle --------------------------------------------------

    def validate_request(self, prompt: Sequence[int],
                         steps: int) -> Tuple[int, ...]:
        """Shape and capacity checks for one request; returns the
        normalized prompt."""
        prompt = tuple(int(t) for t in prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if self.cfg.ssm is not None and len(prompt) < self.cfg.ssm.d_conv - 1:
            # the decode state's conv window is the prompt's last
            # d_conv - 1 inputs; the reference fails on a shorter prompt
            # too (ROADMAP section 3), and the port adds no padding rule
            raise ValueError(
                f"{self.cfg.name}: a prompt of {len(prompt)} tokens is "
                f"shorter than the conv window (d_conv - 1 = "
                f"{self.cfg.ssm.d_conv - 1} tokens) the decode state holds")
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        total = len(prompt) + steps
        if total > self.layout.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + steps ({steps}) exceeds "
                f"max_len={self.layout.max_len}")
        # guarantee forward progress: a request alone in the pool must fit
        need = -(-total // self.layout.block_size)
        if need > self.pool.allocator.num_blocks - 1:
            raise ValueError(
                f"request needs {need} blocks but the pool only has "
                f"{self.pool.allocator.num_blocks - 1} usable ones")
        return prompt

    def submit(self, prompt: Sequence[int], steps: int,
               timeout_s: Optional[float] = None) -> GenTicket:
        """Queue one greedy-generation request: `steps` tokens after
        `prompt`. `timeout_s` is a wall-clock deadline relative to now;
        past it the request is dropped (queued or mid-generation) and its
        blocks return to the pool."""
        prompt = self.validate_request(prompt, steps)
        now = time.perf_counter()
        t = GenTicket(rid=self._next_rid, prompt=prompt, steps=steps,
                      submit_s=now, context=prompt,
                      deadline_s=None if timeout_s is None
                      else now + timeout_s)
        self._next_rid += 1
        self._waiting.append(t)
        return t

    def cancel(self, ticket: GenTicket) -> bool:
        """Cancel a queued or running request. A running request's blocks
        return to the pool immediately (before the next step)."""
        if ticket.status == "queued":
            self._mark_terminal(ticket, "cancelled")
            self._waiting = [t for t in self._waiting if t is not ticket]
            return True
        if ticket.status == "running":
            self.pool.release(ticket.rid)
            self._mark_terminal(ticket, "cancelled")
            self._running = [t for t in self._running if t is not ticket]
            return True
        return False

    def pending(self) -> int:
        return len(self._waiting)

    def running(self) -> int:
        return len(self._running)

    # -- internal step machinery --------------------------------------------

    def _expire_deadlines(self) -> None:
        now = time.perf_counter()

        def past(t):
            return t.deadline_s is not None and now > t.deadline_s

        for t in [t for t in self._running if past(t)]:
            self.pool.release(t.rid)
            self._mark_terminal(t, "expired")
        self._running = [t for t in self._running if t.status == "running"]
        for t in [t for t in self._waiting if past(t)]:
            self._mark_terminal(t, "expired")
        self._waiting = [t for t in self._waiting if t.status == "queued"]

    def _can_admit(self, t: GenTicket) -> bool:
        seq = len(t.context)
        # blocks for the whole prompt plus the next decode write
        need = seq // self.layout.block_size + 1
        if self.pool.allocator.free_blocks < need:
            return False
        if not self.pool._free_slots:
            return False
        if self.max_live_cost_s is not None and \
                (len(self._running) + 1) * self.unit_step_s \
                > self.max_live_cost_s:
            return False
        return True

    def _int32(self, values) -> torch.Tensor:
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    def _admit(self, t: GenTicket) -> None:
        """Prefill-ingest `t` into the pool and join the running set
        (`_can_admit` has checked that its blocks are free)."""
        seq = len(t.context)
        self.pool.register(t.rid)
        self.pool.ensure(t.rid, seq)          # prompt + next decode write
        pre = self.prefill_compiled(seq)
        tok, _ = pre.apply(self.params, self.pool.arrays,
                           self._int32(self.pool.allocator.tables[t.rid]),
                           self._int32(self.pool._slot_of[t.rid]),
                           self._int32([t.context]))
        t.tokens.append(int(tok[0]))
        t.pos = seq
        t.status = "running"
        self._running.append(t)
        self._admitted += 1

    def _preempt(self, t: GenTicket) -> None:
        """Evict a running request: free its blocks and requeue it at the
        front, its generated tokens folded into `context`, so one prefill
        rebuilds its cache on re-admission."""
        self.pool.release(t.rid)
        t.context = t.context + tuple(t.tokens[len(t.context)
                                               - len(t.prompt):])
        t.status = "queued"
        t.preemptions += 1
        self._running = [r for r in self._running if r is not t]
        self._waiting.insert(0, t)
        self._evicted += 1

    def _finish(self, t: GenTicket) -> None:
        self.pool.release(t.rid)
        self._mark_terminal(t, "done")

    def _bucket_for(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    # -- the per-step loop ---------------------------------------------------

    def step(self) -> List[GenTicket]:
        """One scheduler step: expire deadlines, admit from the queue
        (continuous: whenever a batch row and pool capacity are free;
        drain: only once the running set empties), ensure every running
        row's next block (preempting youngest-first on exhaustion), run
        one batched paged decode step, retire finished requests. Returns
        the tickets that finished this step."""
        t0 = time.perf_counter()
        self._expire_deadlines()
        admitted_now = 0
        finished: List[GenTicket] = []
        if self.admission == "continuous" or not self._running:
            for t in list(self._waiting):
                if len(self._running) >= self.max_batch:
                    break
                if not self._can_admit(t):
                    break           # head-of-line blocking preserved
                self._waiting.remove(t)
                self._admit(t)
                admitted_now += 1
                if len(t.tokens) >= t.steps:
                    # finished at prefill: never occupies a decode row
                    self._finish(t)
                    self._running = [r for r in self._running if r is not t]
                    finished.append(t)
        self._admit_history.append(admitted_now)
        evicted_now = 0

        # grow each running row's table to cover its next write; on
        # exhaustion evict the youngest admit until the older ones fit
        i = 0
        while i < len(self._running):
            t = self._running[i]
            try:
                self.pool.ensure(t.rid, t.pos)
                i += 1
            except PoolExhausted:
                victim = self._running[-1]
                if victim is t and len(self._running) == 1:
                    raise RuntimeError(
                        "single running request exhausted the pool — "
                        "impossible when submit()'s whole-request fit "
                        "check passed")  # pragma: no cover
                self._preempt(victim)
                evicted_now += 1
                if victim is t:
                    break
        self._evict_history.append(evicted_now)

        k = len(self._running)
        if k:
            bucket = self._bucket_for(k)
            rids = [t.rid for t in self._running]
            toks = self._int32([t.tokens[-1] for t in self._running]
                               + [0] * (bucket - k))[:, None]
            pos = self._int32([t.pos for t in self._running]
                              + [0] * (bucket - k))
            tok, _ = self.decode_compiled(bucket).apply(
                self.params, self.pool.arrays,
                self.pool.table_rows(rids, bucket),
                self.pool.slot_rows(rids, bucket), toks, pos)
            tok = tok.tolist()
            self._steps += 1
            self._fill_sum += k / bucket
            for i, t in enumerate(self._running):
                t.tokens.append(int(tok[i]))
                t.pos += 1
                self._tokens_out += 1
            for t in [t for t in self._running if len(t.tokens) >= t.steps]:
                self._finish(t)
                finished.append(t)
            self._running = [t for t in self._running
                             if t.status == "running"]
        self._wall_s += time.perf_counter() - t0
        return finished

    def run(self) -> List[GenTicket]:
        """Serve until queue and batch are empty; terminal tickets in
        completion order."""
        done: List[GenTicket] = []
        while self._waiting or self._running:
            before = (len(self._waiting), len(self._running),
                      self._tokens_out, self._admitted, self._expired,
                      self._cancelled)
            done.extend(self.step())
            after = (len(self._waiting), len(self._running),
                     self._tokens_out, self._admitted, self._expired,
                     self._cancelled)
            if before == after and self._waiting and not self._running:
                raise RuntimeError(
                    f"no progress: {len(self._waiting)} waiting but none "
                    "admittable (pool or live-cost budget too small for "
                    "the head request)")
        return done

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Serving counters plus pool occupancy. `decode_fill` is the mean
        real-rows / bucket-rows ratio over decode steps; `pool` carries the
        block-pool snapshot; the `*_per_step` lists hold the per-step
        admitted/evicted counts."""
        return {
            "admission": self.admission,
            "max_batch": self.max_batch,
            "buckets": list(self.buckets),
            "steps": self._steps,
            "tokens_out": self._tokens_out,
            "decode_fill": (self._fill_sum / self._steps
                            if self._steps else 0.0),
            "admitted": self._admitted,
            "evicted": self._evicted,
            "expired": self._expired,
            "cancelled": self._cancelled,
            "admitted_per_step": list(self._admit_history),
            "evicted_per_step": list(self._evict_history),
            "pending": len(self._waiting),
            "running": len(self._running),
            "dispatch_wall_s": self._wall_s,
            "throughput_tps": (self._tokens_out / self._wall_s
                               if self._wall_s else 0.0),
            "unit_step_s": self.unit_step_s,
            "unit_step_gather_s": self.unit_step_plan.gather_latency_s,
            "compiled_decode_buckets": sorted(self._decode),
            "compiled_prefill_lens": sorted(self._prefill),
            "pool": self.pool.snapshot(),
        }
