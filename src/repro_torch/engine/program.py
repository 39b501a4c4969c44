"""Whole-network planning: Program -> compile(cfg) -> CompiledNet.

  * `Program`     — an ordered, shape-complete op graph (a tuple of
    `plan.OpSpec`s) plus the executable forward it was derived from and the
    `meta` tensors that stand for its inputs.
  * `NetworkPlan` — the per-op `EnginePlan`s with the paper's Table-4
    aggregates (conv @200 MHz vs FC @40 MHz latency, memory-access bytes,
    performance efficiency), computed from shapes alone.
  * `compile(program, cfg)` -> `CompiledNet` — plans every op under one
    frozen `EngineConfig`, exposes `.plan` / `.cost`, and an `.apply(*args)`
    that runs the forward with each op pinned to its planned backend
    (strict: divergence from the captured op sequence raises).

The executed op sequence is captured by running the forward on `meta`
tensors (shapes only, no data, no device) — the analogue of the reference's
`jax.eval_shape`. `trace_program(fn, *avals)` builds a `Program` from any
function that way. Unlike the reference, whose `jax.lax.scan` over a
model's layer groups is traced once (so its programs record one group),
the port runs layers in a Python loop: its programs record every executed
op, and a compiled program's strict replay sees each of them.

A program that carries batch metadata (`batch_size` and per-leaf
`batch_axes`, see `infer_batch_axes`) is re-batchable: `with_batch(B)`
rewrites its op graph and its `meta` inputs to batch B without running the
model again, so a serving scheduler plans and compiles one traced program at
any batch bucket.

Capture and execution both run through `api.capturing` / `api.replaying`,
so a compiled network and an eager call see the exact same planning logic.
Under `policy="auto"` each op's backend is `plan.auto_backend`'s choice.
A compiled program's ops meet the kernel-fault hook (`engine.dispatch.
run_op`) on its first complete `apply` only, the counterpart of the
reference's jit trace: a fallback hop made there is pinned into
`exec_pairs` (and shows in `backends()`), and later applies replay the
pinned backends with no hook. An apply that raises leaves the program as
it was, to meet the hook again on the next apply.
A program may update tensors it is given in place (the serving programs
write the paged KV pool with `index_put_`); that takes the place of the
reference's `compile(donate_argnums=)`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import modes
from repro_torch.engine import api
from repro_torch.engine import tune as tunelib
from repro_torch.engine.config import EngineConfig, current_config, using_config
from repro_torch.engine.plan import (EnginePlan, OpSpec, parse_einsum,
                                     plan_op, select_backend, with_precision)

# Plans priced on the conv side of the Table-4 rollup (the 200 MHz clock).
_CONV_KINDS = ("conv2d", "conv1d_dw")


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map `fn` over the leaves of nested dicts, tuples and lists (the
    argument and output trees of a program, and their batch-axis trees),
    with the same places of `rest` alongside; dicts keep their key
    order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of nested dicts, tuples and lists, in the
    order `tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class Program:
    """An ordered, shape-complete engine-op graph for one network.

    `ops` alone determines the `NetworkPlan`; `fn` / `in_avals` (pytrees of
    `meta` tensors) carry the executable forward for `CompiledNet.apply`
    and are excluded from equality and hashing.

    Batch metadata makes the program re-batchable: `batch_size` is the
    batch the avals were built at, and `batch_axes` a tuple (one entry per
    positional argument) of trees matching `in_avals`, with an int leaf per
    tensor leaf: the axis that carries the batch, or -1 for unbatched
    leaves (weights, scalars); see `infer_batch_axes`. Both stay outside
    equality and hashing."""

    name: str
    ops: Tuple[OpSpec, ...]
    fn: Optional[Callable[..., Any]] = dataclasses.field(
        default=None, compare=False)
    in_avals: Tuple[Any, ...] = dataclasses.field(default=(), compare=False)
    batch_size: Optional[int] = dataclasses.field(default=None,
                                                  compare=False)
    batch_axes: Optional[Tuple[Any, ...]] = dataclasses.field(
        default=None, compare=False)

    def with_batch(self, batch: int) -> "Program":
        """The same program at batch `batch`: op shapes and `meta` inputs
        rewritten along the recorded batch axes, the model not run again.

        A conv op carries the batch on x's axis 0 (NHWC, (B, L, D)); a dense
        op is rebatched where its leading x axis is a pure row label of size
        `batch_size`; a gather's batch is its block table's leading axis.
        Ops that fold the batch elsewhere keep their shapes; only the
        analytic plan sees that, since `engine.compile` captures the
        executed ops from `fn` at the new inputs."""
        if self.batch_size is None or self.batch_axes is None:
            raise ValueError(
                f"program {self.name!r} carries no batch metadata; build it "
                "with cnn.program / serve.prefill_program / serve."
                "decode_program, or pass batch_size= and batch_axes= to "
                "trace_program (see engine.infer_batch_axes)")
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if batch == self.batch_size:
            return self
        ops = tuple(_rebatch_op(op, self.batch_size, batch)
                    for op in self.ops)
        in_avals = tuple(
            tree_map(lambda aval, ax: _rebatch_aval(aval, ax,
                                                     self.batch_size, batch),
                      arg, axes)
            for arg, axes in zip(self.in_avals, self.batch_axes))
        return dataclasses.replace(self, ops=ops, in_avals=in_avals,
                                   batch_size=batch)


def infer_batch_axes(avals_a: Tuple[Any, ...], avals_b: Tuple[Any, ...],
                     ) -> Tuple[Any, ...]:
    """Per-leaf batch axes from the same argument trees built at two batch
    sizes: the one axis whose size changed is the batch axis; a leaf whose
    shape did not change (a weight, a scalar) gets -1, so the axes tree
    keeps the structure of the argument tree."""
    def leaf(a, b):
        sa, sb = tuple(a.shape), tuple(b.shape)
        if sa == sb:
            return -1
        if len(sa) != len(sb):
            raise ValueError(f"rank changed with batch: {sa} vs {sb}")
        diffs = [i for i, (x, y) in enumerate(zip(sa, sb)) if x != y]
        if len(diffs) != 1:
            raise ValueError(
                f"ambiguous batch axis: {sa} vs {sb} differ on axes {diffs}")
        return diffs[0]

    return tuple(tree_map(leaf, a, b) for a, b in zip(avals_a, avals_b))


def _rebatch_aval(aval: torch.Tensor, axis: int, old: int,
                  new: int) -> torch.Tensor:
    if axis < 0:
        return aval
    shape = list(aval.shape)
    if shape[axis] != old:
        raise ValueError(
            f"batch axis {axis} of aval {tuple(aval.shape)} has size "
            f"{shape[axis]}, expected batch_size={old}")
    shape[axis] = new
    return torch.empty(shape, dtype=aval.dtype, device="meta")


def _rebatch_op(op: OpSpec, old: int, new: int) -> OpSpec:
    """Rewrite one op's batch dim (leading x axis) from `old` to `new`."""
    if op.kind == "gather":
        # the batch lives on the block table's (w's) leading axis; x is the
        # pool, whose block count may equal the old batch by chance
        if op.w_shape and op.w_shape[0] == old:
            return dataclasses.replace(op, w_shape=(new,) + op.w_shape[1:])
        return op
    if not op.x_shape or op.x_shape[0] != old:
        return op
    if op.kind == "dense":
        st = parse_einsum(op.spec, len(op.x_shape), len(op.w_shape))
        if st.x_labels[0] not in st.x_free:
            return op                   # the leading axis is not a row axis
    return dataclasses.replace(op, x_shape=(new,) + op.x_shape[1:])


def trace_program(fn: Callable[..., Any], *avals: Any,
                  name: str = "traced", batch_size: Optional[int] = None,
                  batch_axes: Optional[Tuple[Any, ...]] = None) -> Program:
    """Capture `fn`'s engine ops into a `Program` by running it on `meta`
    tensors (`avals`: pytrees of them, the analogue of the reference's
    `jax.ShapeDtypeStruct`s). No arithmetic runs and no device memory is
    touched; every `engine.*` op that `fn` calls is recorded in call order with
    its static shapes, and ops outside the engine (elementwise math,
    softmax, indexing) run on `meta` without being recorded.

    Pass `batch_size` (the batch the avals were built at) together with
    `batch_axes` (per-argument axis trees, see `infer_batch_axes`) to make
    the program re-batchable with `Program.with_batch`."""
    if (batch_size is None) != (batch_axes is None):
        raise ValueError("pass batch_size and batch_axes together")
    return Program(name=name,
                   ops=_capture_ops(fn, avals, current_config())[0], fn=fn,
                   in_avals=tuple(avals), batch_size=batch_size,
                   batch_axes=batch_axes)


def _capture_ops(fn: Callable[..., Any], avals: Tuple[Any, ...],
                 cfg: EngineConfig
                 ) -> Tuple[Tuple[OpSpec, ...], Tuple[Optional[str], ...],
                            Tuple[Optional[torch.dtype], ...]]:
    """Run `fn` on `meta` tensors under `cfg` and return its engine ops in
    call order, with each op's explicit precision override (None where the
    call left precision to the config) and its input's dtype (conv2d and
    einsum ops; None for the others). Every op only allocates `meta`
    outputs, so nothing runs."""
    ops: list = []
    precs: list = []
    dtypes: list = []
    with api.capturing(ops, precs, dtypes), using_config(cfg), \
            torch.no_grad():
        fn(*avals)
    return tuple(ops), tuple(precs), tuple(dtypes)


# ---------------------------------------------------------------------------
# NetworkPlan — Table-4 aggregates from plans alone
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """Per-op plans plus the paper's network-level rollups (Table 4).

    Aggregation matches `core.analytics.NetworkCost` exactly: conv-side
    cycles are priced at the 200 MHz conv clock, FC-side (every `dense`
    plan) at the 40 MHz FC clock; memory accesses are 16-bit words.
    """

    name: str
    plans: Tuple[EnginePlan, ...]

    @property
    def conv_plans(self) -> Tuple[EnginePlan, ...]:
        """Conv-mode plans: conv2d and the 1-D depthwise conv."""
        return tuple(p for p in self.plans if p.kind in _CONV_KINDS)

    @property
    def fc_plans(self) -> Tuple[EnginePlan, ...]:
        return tuple(p for p in self.plans if p.kind == "dense")

    @property
    def gather_plans(self) -> Tuple[EnginePlan, ...]:
        """Paged-KV gather ops (serving memory moves, zero MACs)."""
        return tuple(p for p in self.plans if p.kind == "gather")

    @property
    def conv_cycles(self) -> int:
        return sum(p.cycles for p in self.conv_plans)

    @property
    def fc_cycles(self) -> int:
        return sum(p.cycles for p in self.fc_plans)

    @property
    def gather_cycles(self) -> int:
        return sum(p.cycles for p in self.gather_plans)

    @property
    def conv_latency_s(self) -> float:
        return self.conv_cycles / modes.MMIE_CONV_FREQ_HZ

    @property
    def fc_latency_s(self) -> float:
        return self.fc_cycles / modes.MMIE_FC_FREQ_HZ

    @property
    def gather_latency_s(self) -> float:
        """Paged-KV reconstruction time, priced at the conv (memory-system)
        clock — a pure data move never waits on the 40 MHz FC array."""
        return self.gather_cycles / modes.MMIE_CONV_FREQ_HZ

    @property
    def total_latency_s(self) -> float:
        """The analytic latency of the whole program: conv, FC and gather
        time (one device; the reference's collective term is zero without
        a mesh)."""
        return self.conv_latency_s + self.fc_latency_s + self.gather_latency_s

    @property
    def conv_ma_words(self) -> int:
        return sum(p.ma_words for p in self.conv_plans)

    @property
    def fc_ma_words(self) -> int:
        return sum(p.ma_words for p in self.fc_plans)

    # Executed memory traffic: int8 plans halve their 16-bit-word booking;
    # `ma_words` stays the paper's model, so the goldens never move.

    @property
    def conv_exec_ma_words(self) -> int:
        return sum(p.exec_ma_words for p in self.conv_plans)

    @property
    def fc_exec_ma_words(self) -> int:
        return sum(p.exec_ma_words for p in self.fc_plans)

    @property
    def exec_ma_words(self) -> int:
        """Memory words moved at each plan's execution precision."""
        return sum(p.exec_ma_words for p in self.plans)

    @property
    def conv_ma_bytes(self) -> int:
        return self.conv_ma_words * modes.MMIE_WORD_BYTES

    @property
    def fc_ma_bytes(self) -> int:
        return self.fc_ma_words * modes.MMIE_WORD_BYTES

    @property
    def conv_macs(self) -> int:
        return sum(p.macs for p in self.conv_plans)

    @property
    def fc_macs(self) -> int:
        return sum(p.macs for p in self.fc_plans)

    @property
    def total_macs(self) -> int:
        return self.conv_macs + self.fc_macs

    @property
    def conv_perf_efficiency(self) -> float:
        cyc = self.conv_cycles
        return self.conv_macs / (modes.MMIE_NUM_PES * cyc) if cyc else 0.0

    @property
    def fc_perf_efficiency(self) -> float:
        cyc = self.fc_cycles
        return self.fc_macs / (modes.MMIE_NUM_PES * cyc) if cyc else 0.0

    def table4_row(self) -> Dict[str, Any]:
        """The network's Table-4 row, straight off the plan (MMIE analytic
        model, not a measured time)."""
        return {
            "net": self.name,
            "conv_ms": self.conv_latency_s * 1e3,
            "fc_ms": self.fc_latency_s * 1e3,
            "conv_MA_MB": self.conv_ma_bytes / 1e6,
            "fc_MA_MB": self.fc_ma_bytes / 1e6,
            "conv_eff": self.conv_perf_efficiency,
            "fc_eff": self.fc_perf_efficiency,
        }


def plan_network(program: Program,
                 cfg: Optional[EngineConfig] = None) -> NetworkPlan:
    """Plan every op of `program` under `cfg` (no execution, no tensors),
    each on its selected backend and at the config's precision where the
    int8 contract covers it."""
    cfg = current_config() if cfg is None else cfg
    return NetworkPlan(program.name, tuple(
        with_precision(plan_op(op, select_backend(op, cfg)), op,
                       cfg.precision)
        for op in program.ops))


# ---------------------------------------------------------------------------
# compile -> CompiledNet
# ---------------------------------------------------------------------------

class CompiledNet:
    """A network compiled against one `EngineConfig`.

    .plan   — `NetworkPlan` over the program's op graph (Table-4 analytics).
    .cost   — the plan's aggregate Table-4 row (dict).
    .apply  — executor: every engine op runs on its planned backend, in the
              captured order, on the device of the tensors given (all of
              them on one device). Executing with shapes that change the op
              sequence raises (recompile instead). The first complete apply
              runs each op through the kernel-fault hook and pins any
              fallback hop; later applies call the pinned backends.
    """

    def __init__(self, program: Program, config: EngineConfig,
                 plan: NetworkPlan,
                 exec_pairs: Optional[Tuple[Tuple[OpSpec, EnginePlan], ...]]):
        self.program = program
        self.config = config
        self.plan = plan
        self.exec_pairs = exec_pairs
        self.hooked = True          # the next apply meets the fault hook

    @property
    def cost(self) -> Dict[str, Any]:
        return self.plan.table4_row()

    def apply(self, *args):
        if self.program.fn is None:
            raise ValueError(
                f"program {self.program.name!r} carries no executable fn "
                "(analytic op tables only)")
        devices = {t.device for t in tree_leaves(args)
                   if isinstance(t, torch.Tensor)}
        if len(devices) != 1:
            raise ValueError(f"CompiledNet.apply needs every tensor on one "
                             f"device; got {sorted(map(str, devices))}")
        hooks = self.hooked
        with using_config(self.config), \
                api.replaying(self.exec_pairs, hooks) as cur, \
                torch.no_grad():
            out = self.program.fn(*args)
        if hooks:
            self.exec_pairs = tuple(cur.pairs)  # hops, pinned
            self.hooked = False
        return out

    __call__ = apply

    def backends(self) -> Tuple[str, ...]:
        """Per-op backend assignment of the execution plan, in call order."""
        pairs = self.exec_pairs if self.exec_pairs is not None else ()
        return tuple(plan.backend for _, plan in pairs)

    def precisions(self) -> Tuple[str, ...]:
        """Per-op execution precision, in call order: "fp32" for every op
        the int8 contract does not cover, whatever the config asked for."""
        pairs = self.exec_pairs if self.exec_pairs is not None else ()
        return tuple(plan.precision for _, plan in pairs)

    def tiles(self) -> Tuple[Optional[Tuple[int, int]], ...]:
        """Per-op tuned block tiles of the execution plan, in call order
        (None: the kernel's own rule, or an op with no tile knob)."""
        pairs = self.exec_pairs if self.exec_pairs is not None else ()
        return tuple(plan.tile_config for _, plan in pairs)


def compile(program: Program,  # noqa: A001 (mirrors the reference's API)
            cfg: Optional[EngineConfig] = None) -> CompiledNet:
    """Plan the whole network under `cfg` and return a `CompiledNet`.

    The analytic plan covers `program.ops` (which may follow the paper's
    layer counting, e.g. ResNet main-path booking). The execution plan is
    captured fresh from `program.fn` at the program's `meta` inputs, so
    `.apply` always matches the real op sequence — including layers the
    paper's counting omits (projection shortcuts).

    Every executed op is pinned to its precision: a per-op override baked
    into the forward (`cnn.program(precisions=...)`) wins over the config's
    `precision`. Then, under `cfg.tuning` "cached" or "autotune", each
    "cuda" conv and GEMM is pinned to its tuned tile (`engine/tune.py`;
    "autotune" times the candidates of a cache miss on the CUDA device
    here), keyed by that precision; `CompiledNet.tiles()` lists them."""
    cfg = current_config() if cfg is None else cfg
    net_plan = plan_network(program, cfg)
    exec_pairs = None
    if program.fn is not None:
        ops, precs, dtypes = _capture_ops(program.fn, program.in_avals, cfg)
        # precision pins before tile resolution, so the tuner keys on it
        exec_pairs = tuple(
            (op, tunelib.attach(
                op, with_precision(plan_op(op, select_backend(op, cfg)), op,
                                   prec or cfg.precision),
                cfg, allow_autotune=True, dtype=dt))
            for op, prec, dt in zip(ops, precs, dtypes))
    return CompiledNet(program, cfg, net_plan, exec_pairs)
