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

Capture and execution both run through `api.capturing` / `api.replaying`,
so a compiled network and an eager call see the exact same planning logic.
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
from repro_torch.engine.config import EngineConfig, current_config, using_config
from repro_torch.engine.plan import (EnginePlan, OpSpec, plan_op,
                                     with_precision)

# Plans priced on the conv side of the Table-4 rollup (the 200 MHz clock).
_CONV_KINDS = ("conv2d", "conv1d_dw")


@dataclasses.dataclass(frozen=True)
class Program:
    """An ordered, shape-complete engine-op graph for one network.

    `ops` alone determines the `NetworkPlan`; `fn` / `in_avals` (pytrees of
    `meta` tensors) carry the executable forward for `CompiledNet.apply`
    and are excluded from equality and hashing."""

    name: str
    ops: Tuple[OpSpec, ...]
    fn: Optional[Callable[..., Any]] = dataclasses.field(
        default=None, compare=False)
    in_avals: Tuple[Any, ...] = dataclasses.field(default=(), compare=False)


def trace_program(fn: Callable[..., Any], *avals: Any,
                  name: str = "traced") -> Program:
    """Capture `fn`'s engine ops into a `Program` by running it on `meta`
    tensors (`avals`: pytrees of them, the analogue of the reference's
    `jax.ShapeDtypeStruct`s). No arithmetic runs and no device memory is
    touched; every `engine.*` op that `fn` calls is recorded in call order with
    its static shapes, and ops outside the engine (elementwise math,
    softmax, indexing) run on `meta` without being recorded.

    The reference's `batch_size`/`batch_axes` (re-batching with
    `Program.with_batch`) are not ported: ROADMAP queue 1, item 2."""
    return Program(name=name,
                   ops=_capture_ops(fn, avals, current_config())[0], fn=fn,
                   in_avals=tuple(avals))


def _capture_ops(fn: Callable[..., Any], avals: Tuple[Any, ...],
                 cfg: EngineConfig
                 ) -> Tuple[Tuple[OpSpec, ...], Tuple[Optional[str], ...]]:
    """Run `fn` on `meta` tensors under `cfg` and return its engine ops in
    call order, with each op's explicit precision override (None where the
    call left precision to the config). Every op only allocates `meta`
    outputs, so nothing runs."""
    ops: list = []
    precs: list = []
    with api.capturing(ops, precs), using_config(cfg), torch.no_grad():
        fn(*avals)
    return tuple(ops), tuple(precs)


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
    each at the config's precision where the int8 contract covers it."""
    cfg = current_config() if cfg is None else cfg
    return NetworkPlan(program.name, tuple(
        with_precision(plan_op(op, cfg.backend), op, cfg.precision)
        for op in program.ops))


# ---------------------------------------------------------------------------
# compile -> CompiledNet
# ---------------------------------------------------------------------------

def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class CompiledNet:
    """A network compiled against one `EngineConfig`.

    .plan   — `NetworkPlan` over the program's op graph (Table-4 analytics).
    .cost   — the plan's aggregate Table-4 row (dict).
    .apply  — executor: every engine op runs on its planned backend, in the
              captured order, on the device of the tensors given (all of
              them on one device). Executing with shapes that change the op
              sequence raises (recompile instead).
    """

    def __init__(self, program: Program, config: EngineConfig,
                 plan: NetworkPlan,
                 exec_pairs: Optional[Tuple[Tuple[OpSpec, EnginePlan], ...]]):
        self.program = program
        self.config = config
        self.plan = plan
        self.exec_pairs = exec_pairs

    @property
    def cost(self) -> Dict[str, Any]:
        return self.plan.table4_row()

    def apply(self, *args):
        if self.program.fn is None:
            raise ValueError(
                f"program {self.program.name!r} carries no executable fn "
                "(analytic op tables only)")
        devices = {t.device for t in _leaves(args)}
        if len(devices) != 1:
            raise ValueError(f"CompiledNet.apply needs every tensor on one "
                             f"device; got {sorted(map(str, devices))}")
        with using_config(self.config), api.replaying(self.exec_pairs), \
                torch.no_grad():
            return self.program.fn(*args)

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
    `precision`."""
    cfg = current_config() if cfg is None else cfg
    net_plan = plan_network(program, cfg)
    exec_pairs = None
    if program.fn is not None:
        ops, precs = _capture_ops(program.fn, program.in_avals, cfg)
        exec_pairs = tuple(
            (op, with_precision(plan_op(op, cfg.backend), op,
                                prec or cfg.precision))
            for op, prec in zip(ops, precs))
    return CompiledNet(program, cfg, net_plan, exec_pairs)
