"""Explicit analytic ledgers for the engine (paper Eqs. 15-18, Fig. 5).

    with engine.tracking() as ledger:
        logits = apply_model(params, x)
    print(ledger.report())

Every engine op issued in the block records its plan (pure metadata, from
shapes) into every active ledger on this thread; nested `tracking()` blocks
stack. Program capture (`engine.compile`) pauses the ledgers: a capture is
a shape trace, not a run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Iterator, List, Optional

from repro_torch.core import analytics, modes
from repro_torch.engine.plan import EnginePlan


@dataclasses.dataclass
class OpRecord:
    """One executed engine op."""

    kind: str                       # "conv2d" | "conv1d_dw" | "matmul" | ...
    mode: modes.Mode
    cost_cycles: int
    cost_ma_words: int
    macs: int
    plan: Optional[EnginePlan] = None


@dataclasses.dataclass
class FallbackRecord:
    """One backend hop: an op whose planned backend met an injected kernel
    fault and that ran further down the dispatch fallback chain
    (`EngineConfig.fallback="chain"`). Recorded when the hop is made: on
    every call of an eager op, on the first complete apply of a compiled
    program (which then replays the hop with no record)."""

    kind: str                       # op kind ("dense", "conv2d", ...)
    src: str                        # the backend that faulted
    dst: str                        # the backend that ran instead
    error: str                      # str() of the fault that forced it


class Ledger:
    """An append-only list of `OpRecord`s with the paper's rollups, and the
    backend hops (`FallbackRecord`) observed while it was active."""

    def __init__(self) -> None:
        self.records: List[OpRecord] = []
        self.fallbacks: List[FallbackRecord] = []

    def __iter__(self) -> Iterator[OpRecord]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)

    def record_plan(self, plan: EnginePlan) -> None:
        kind = "matmul" if plan.kind == "dense" else plan.kind
        self.records.append(OpRecord(kind, plan.mode, plan.cycles,
                                     plan.ma_words, plan.macs, plan))

    # -- rollups (paper Table 4 / Fig. 5) ---------------------------------

    @property
    def total_cycles(self) -> int:
        return sum(r.cost_cycles for r in self.records)

    @property
    def total_ma_words(self) -> int:
        return sum(r.cost_ma_words for r in self.records)

    @property
    def total_macs(self) -> int:
        return sum(r.macs for r in self.records)

    @property
    def performance_efficiency(self) -> float:
        """MMIE-projected perf efficiency of everything recorded so far."""
        cyc = self.total_cycles
        return self.total_macs / (modes.MMIE_NUM_PES * cyc) if cyc else 0.0

    def report(self) -> str:
        lines = ["kind,mode(Wf,S),T,cycles,ma_words,macs,uf_max"]
        for r in self.records:
            lines.append(
                f"{r.kind},({r.mode.w_f},{r.mode.s}),{r.mode.t},"
                f"{r.cost_cycles},{r.cost_ma_words},{r.macs},"
                f"{analytics.utilization_factor_max(r.mode.w_f, r.mode.s):.3f}")
        return "\n".join(lines)


class _Active(threading.local):
    def __init__(self) -> None:
        self.stack: List[Ledger] = []


_TLS = _Active()


@contextlib.contextmanager
def tracking(ledger: Optional[Ledger] = None) -> Iterator[Ledger]:
    """Activate a ledger for every engine op issued in the block (on this
    thread)."""
    led = ledger if ledger is not None else Ledger()
    _TLS.stack.append(led)
    try:
        yield led
    finally:
        _TLS.stack.remove(led)


def is_tracking() -> bool:
    return bool(_TLS.stack)


@contextlib.contextmanager
def paused() -> Iterator[None]:
    """Suspend this thread's active ledgers for the block (program
    capture)."""
    saved = _TLS.stack[:]
    _TLS.stack.clear()
    try:
        yield
    finally:
        _TLS.stack.extend(saved)


def record(plan: EnginePlan) -> None:
    """Record `plan` into every ledger active on this thread."""
    for led in _TLS.stack:
        led.record_plan(plan)


def record_fallback(rec: FallbackRecord) -> None:
    """Record a backend hop into every ledger active on this thread."""
    for led in _TLS.stack:
        led.fallbacks.append(rec)
