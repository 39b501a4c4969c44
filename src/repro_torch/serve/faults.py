"""Deterministic seed-driven fault injection for the serving stack. A copy
of the JAX package's `serve/faults.py` (pure Python; the port keeps its own
copy, and its decisions are the reference's bit for bit).

A `FaultInjector` makes the fault decisions; the hook sites are
`engine/dispatch.py` (per-op kernel errors, the "kernel" point),
`serve/scheduler.py` (NaN logits through the numerics guard, latency
spikes) and `serve/kv_pool.py` (pool-exhaustion storms). The "replica"
point is known here, but its hook sites come with `ReplicaSpread`, which
is not ported (ROADMAP queue 1, item 11).

Determinism contract
--------------------
Every fault decision is a pure function of `(seed, point, site, visit)`:
the n-th visit of a given fault point and site either fires or not,
whatever the wall clock, the thread interleaving or the other sites did.
Two runs with the same seed over the same per-site visit sequences inject
the same fault schedule, which is what lets the chaos tests compare a
faulted run bitwise against a clean one. Explicit schedules
(`FaultInjector(schedule={...})`) pin exact visits instead of rates.

Zero overhead when disabled
---------------------------
Hook sites read one module-level slot (`faults.active()`); with no
injector installed that returns None and the hook body never runs. No
tensor operation is issued here: the numerics guard's poison reaches a
compiled program as a tensor argument the scheduler builds, so the clean
path runs the unguarded programs, op for op what they were.

When the "kernel" point fires: an eager engine op meets it on every call;
an op of a `CompiledNet` meets it once, on the program's first complete
`apply` (the counterpart of the reference's jit trace), and the program
then replays with no hook. A kernel fault is answered by the dispatch
fallback chain (`EngineConfig.fallback="chain"`) where the chain may hop,
else it reaches the scheduler as a `TransientError`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import struct
from typing import Dict, Iterator, List, Optional, Tuple

# The five fault points. Hook sites pass one of these
# strings; unknown points raise so a typo cannot silently never-fire.
POINTS = ("kernel", "numerics", "replica", "pool", "latency")


class ServeError(RuntimeError):
    """Base of the serving error taxonomy."""


class TransientError(ServeError):
    """Recoverable: the operation may succeed if retried (after backoff).
    Schedulers catch these, apply capped exponential backoff, and retry up
    to their retry budget."""


class FatalError(ServeError):
    """Non-recoverable: retrying cannot help (budget exhausted, invariant
    broken, no healthy replicas). Propagates to the caller."""


class KernelFault(TransientError):
    """An injected fault of one op's backend kernel. Answered by the
    dispatch fallback chain under `EngineConfig.fallback="chain"` where the
    chain may hop (`engine.dispatch.fallback_chain`); otherwise it surfaces
    as a transient scheduler error."""


class ReplicaLost(TransientError):
    """A replica's device (group) is gone; its in-flight requests need
    re-prefill on a surviving replica."""


def _u01(seed: int, point: str, site: str, visit: int) -> float:
    """Uniform [0, 1) from a sha1 of the decision coordinates — stable
    across processes and hash randomization."""
    h = hashlib.sha1(
        f"{seed}|{point}|{site}|{visit}".encode()).digest()
    (u,) = struct.unpack(">Q", h[:8])
    return u / float(1 << 64)


def backoff_s(attempt: int, *, base: float = 0.01, cap: float = 1.0,
              seed: int = 0, token: str = "") -> float:
    """Capped exponential backoff with deterministic jitter.

    attempt 1 waits ~base, attempt k waits ~base * 2**(k-1), capped at
    `cap`; the jitter multiplier in [0.5, 1.0) is a pure function of
    (seed, token, attempt) so retry schedules are reproducible — the
    decorrelation real jitter buys still happens because distinct tokens
    (request ids, replica ids) draw distinct multipliers.
    """
    if attempt < 1:
        return 0.0
    raw = min(cap, base * (2.0 ** (attempt - 1)))
    return raw * (0.5 + 0.5 * _u01(seed, "backoff", token, attempt))


@dataclasses.dataclass
class FaultEvent:
    """One fired fault, for post-mortem assertions in the chaos tests."""

    point: str
    site: str
    visit: int


class FaultInjector:
    """Deterministic fault schedule over the five serving fault points.

    rates    — per-point fire probability per visit, e.g.
               ``{"numerics": 0.05, "pool": 0.1}``; unlisted points never
               fire.
    schedule — exact visits that fire, overriding rates for their point:
               ``{("kernel", "dense:pallas"): (0,)}`` fires the first
               visit of that site only. Keys are (point, site) pairs;
               values are iterables of 0-based visit indices.
    max_fires— global cap across all points (None = unlimited); the
               injector goes quiescent after that many fires.
    latency_s— the delay a fired "latency" point asks the hook to sleep.

    `fire(point, site)` advances the (point, site) visit counter and
    returns whether this visit faults; `events` records every fired
    fault. The object is single-thread mutable state — one injector per
    scheduler stack, like one Ledger per tracking block.
    """

    def __init__(self, seed: int = 0, *,
                 rates: Optional[Dict[str, float]] = None,
                 schedule: Optional[Dict[Tuple[str, str],
                                         Tuple[int, ...]]] = None,
                 max_fires: Optional[int] = None,
                 latency_s: float = 0.002):
        rates = dict(rates or {})
        for p in rates:
            if p not in POINTS:
                raise ValueError(f"unknown fault point {p!r}; expected one "
                                 f"of {POINTS}")
        for (p, _site) in (schedule or {}):
            if p not in POINTS:
                raise ValueError(f"unknown fault point {p!r} in schedule; "
                                 f"expected one of {POINTS}")
        self.seed = int(seed)
        self.rates = rates
        self.schedule = {k: tuple(v) for k, v in (schedule or {}).items()}
        self.max_fires = max_fires
        self.latency_s = float(latency_s)
        self.visits: Dict[Tuple[str, str], int] = {}
        self.fired: Dict[str, int] = {p: 0 for p in POINTS}
        self.events: List[FaultEvent] = []
        self.fallbacks: List[Tuple[str, str, str]] = []  # (kind, from, to)

    @property
    def total_fired(self) -> int:
        return sum(self.fired.values())

    def fire(self, point: str, site: str = "") -> bool:
        """Advance the (point, site) visit counter; True iff this visit
        faults under the seed/rates/schedule."""
        if point not in POINTS:
            raise ValueError(f"unknown fault point {point!r}; expected one "
                             f"of {POINTS}")
        key = (point, site)
        visit = self.visits.get(key, 0)
        self.visits[key] = visit + 1
        if self.max_fires is not None and self.total_fired >= self.max_fires:
            return False
        if key in self.schedule:
            hit = visit in self.schedule[key]
        else:
            rate = self.rates.get(point, 0.0)
            hit = rate > 0.0 and _u01(self.seed, point, site, visit) < rate
        if hit:
            self.fired[point] += 1
            self.events.append(FaultEvent(point, site, visit))
        return hit

    def latency(self, site: str = "") -> float:
        """Seconds the hook should stall (0.0 = no spike this visit)."""
        return self.latency_s if self.fire("latency", site) else 0.0

    def note_fallback(self, kind: str, src: str, dst: str) -> None:
        """Record a backend degradation observed while installed (dispatch
        calls this alongside `ledger.record_fallback`)."""
        self.fallbacks.append((kind, src, dst))

    def summary(self) -> Dict[str, object]:
        return {
            "seed": self.seed,
            "rates": dict(self.rates),
            "fired": {p: n for p, n in self.fired.items() if n},
            "total_fired": self.total_fired,
            "fallbacks": len(self.fallbacks),
        }


# ---------------------------------------------------------------------------
# Activation: one process-wide slot, read by every hook site
# ---------------------------------------------------------------------------

_ACTIVE: Optional[FaultInjector] = None     # process-wide, on purpose


def active() -> Optional[FaultInjector]:
    """The installed injector, or None (the common, zero-cost answer)."""
    return _ACTIVE


def install(inj: Optional[FaultInjector]) -> None:
    """Install `inj` process-wide (None uninstalls). Prefer the
    `injecting()` context manager, which restores the previous state."""
    global _ACTIVE
    _ACTIVE = inj


@contextlib.contextmanager
def injecting(inj: FaultInjector) -> Iterator[FaultInjector]:
    """Install `inj` for the block; restores the prior injector after."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = inj
    try:
        yield inj
    finally:
        _ACTIVE = prev
