"""EngineConfig — the frozen, explicit execution configuration of the engine.

One immutable, hashable object carries what the engine needs to resolve a
call. Ambient resolution goes through a *thread-local* stack of configs:
`using_config(cfg)` (and the thin `using_backend(name)` shim over it)
pushes for the dynamic extent of a block; `current_config()` reads the top,
else the process default `EngineConfig()`.

The reference's other knobs are accepted only at their default here: each
one raises `NotImplementedError` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, List, Optional

from repro_torch.engine.plan import PRECISIONS

# knob -> (its only supported value, the ROADMAP item that brings the rest)
_NOT_YET = {
    "policy": ("fixed", "ROADMAP queue 1, item 4 (policy='auto' backend "
                        "selection)"),
    "tuning": ("off", "ROADMAP queue 1, item 6 (autotuner, engine/tune.py)"),
    "parallel": (None, "ROADMAP queue 1, item 11 (multi-device engine)"),
    "fallback": ("none", "ROADMAP queue 1, item 4 (the fallback='chain' "
                         "decision)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen engine execution config (hashable).

    backend   — registry name: "cuda" (the hand-written kernels; the
                counterpart of the reference's "pallas"), "torch" (the GFID
                lowering in PyTorch ops; the counterpart of "xla") or "ref"
                (the library's conv and matmul).
    precision — "fp32" or "int8" (quantize conv and canonical-GEMM ops to
                int8 with exact int32 accumulation; other ops stay fp32).
                Any other value raises `ValueError`.
    row_align — None, or a positive int R: every dense op whose leading x
                axis is a pure row dim zero-pads that axis to a multiple of
                R before the GEMM and slices the result back (the
                reference's serving knob). `ContinuousScheduler` also
                starts its decode buckets at R rows, so up to R live rows
                share one decode shape and a row's tokens do not depend on
                the batch it rides in.
    policy, tuning, parallel, fallback — the reference's knobs, not ported
                yet: any value but the default raises `NotImplementedError`.
    """

    backend: str = "cuda"
    policy: str = "fixed"
    tuning: str = "off"
    parallel: Optional[Any] = None
    precision: str = "fp32"
    fallback: str = "none"
    row_align: Optional[int] = None

    def __post_init__(self) -> None:
        if self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r}; "
                             f"expected one of {PRECISIONS}")
        if self.row_align is not None and (
                not isinstance(self.row_align, int) or self.row_align < 1):
            raise ValueError(f"row_align must be None or a positive int; "
                             f"got {self.row_align!r}")
        for knob, (supported, item) in _NOT_YET.items():
            value = getattr(self, knob)
            if value != supported:
                raise NotImplementedError(
                    f"EngineConfig({knob}={value!r}) is not ported to "
                    f"repro_torch yet; see {item}")

    def replace(self, **kw) -> "EngineConfig":
        return dataclasses.replace(self, **kw)


class _Stack(threading.local):
    def __init__(self) -> None:
        self.configs: List[EngineConfig] = []


_TLS = _Stack()
_DEFAULT = EngineConfig()


def current_config() -> EngineConfig:
    """The ambient config: innermost active `using_config` block on this
    thread, else the default `EngineConfig()`."""
    return _TLS.configs[-1] if _TLS.configs else _DEFAULT


@contextlib.contextmanager
def using_config(cfg: Optional[EngineConfig]) -> Iterator[None]:
    """Ambient `EngineConfig` for every engine call in the block
    (None = no-op, so call sites can thread an optional config)."""
    if cfg is None:
        yield
        return
    from repro_torch.engine import dispatch
    dispatch.get_backend(cfg.backend)       # validate eagerly
    _TLS.configs.append(cfg)
    try:
        yield
    finally:
        _TLS.configs.pop()


def using_backend(name: Optional[str]):
    """Ambient backend for the block, keeping every other knob of the
    current config (None = no-op)."""
    if name is None:
        return contextlib.nullcontext()
    return using_config(current_config().replace(backend=name))
