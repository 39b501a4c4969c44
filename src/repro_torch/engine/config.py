"""EngineConfig — the frozen, explicit execution configuration of the engine.

One immutable, hashable object carries what the engine needs to resolve a
call. Ambient resolution goes through a *thread-local* stack of configs:
`using_config(cfg)` (and the thin `using_backend(name)` shim over it)
pushes for the dynamic extent of a block; `current_config()` reads the top,
else the process-wide base config (`set_default_config`, which raises
inside an active context rather than being shadowed by it).

One of the reference's knobs is accepted only at its default here:
`parallel` raises `NotImplementedError` naming the ROADMAP item that ports
it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Iterator, List, Optional

import torch

from repro_torch.engine.plan import PRECISIONS

_POLICIES = ("fixed", "auto")
_FALLBACKS = ("none", "chain")
_TUNING_MODES = ("off", "cached", "autotune")
# knob -> (its only supported value, the ROADMAP item that brings the rest)
_NOT_YET = {
    "parallel": (None, "ROADMAP queue 1, item 11 (multi-device engine)"),
}


def accum_dtype_of(name: str) -> torch.dtype:
    """The torch dtype a dtype name (`EngineConfig.accum`) names:
    "float32", "bfloat16", ...; `ValueError` for anything else."""
    dt = getattr(torch, name, None) if isinstance(name, str) else None
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"accum must be None, 'native' or a dtype name; "
                         f"got {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen engine execution config (hashable).

    backend   — registry name: "cuda" (the hand-written kernels; the
                counterpart of the reference's "pallas"), "torch" (the GFID
                lowering in PyTorch ops; the counterpart of "xla") or "ref"
                (the library's conv and matmul).
    policy    — backend selection: "fixed" runs every op on `backend`;
                "auto" picks "cuda" or `backend` per op from its shapes
                (`plan.auto_backend`).
    accum     — the ambient accumulation knob: None keeps each op's own
                default (fp32 for conv2d and dense, native for einsum),
                "native" gives plain-`@` numerics, a dtype name
                ("float32", "bfloat16") asks for that accumulator. An
                explicit `accum_dtype=` argument wins. The kernels sum in
                fp32, so an accumulator they cannot honour raises on
                "cuda" (`api._check_accum`).
    precision — "fp32" or "int8" (quantize conv and canonical-GEMM ops to
                int8 with exact int32 accumulation; other ops stay fp32),
                on fp32 or bf16 inputs. Any other value raises
                `ValueError`.
    fallback  — kernel-failure policy at dispatch: "none" (fail-stop) or
                "chain": an op whose kernel meets an injected `KernelFault`
                re-runs on the next backend of
                `dispatch.fallback_chain`, which lists only backends a test
                holds bitwise equal for that op kind, precision and
                activation; where the chain is empty the fault propagates
                (a `TransientError` the schedulers retry). A real build or
                launch error is never caught. Each hop is recorded into
                every active `Ledger` (`ledger.fallbacks`).
    row_align — None, or a positive int R: every dense op whose leading x
                axis is a pure row dim zero-pads that axis to a multiple of
                R before the GEMM and slices the result back (the
                reference's serving knob). `ContinuousScheduler` also
                starts its decode buckets at R rows, so up to R live rows
                share one decode shape and a row's tokens do not depend on
                the batch it rides in.
    tuning    — the kernel tiles (`engine/tune.py`): "off" (each kernel's
                own rule), "cached" (a tile from the port's tuning cache
                where it has one for the op, else the rule) or "autotune"
                ("cached", and `engine.compile` times the candidates of a
                miss on the CUDA device and caches the winner; it raises
                without a device). A tile never changes a bit of the
                result. Any other value raises `ValueError`.
    parallel  — the reference's multi-device knob, not ported yet: any
                value but None raises `NotImplementedError`.
    """

    backend: str = "cuda"
    accum: Optional[str] = None
    policy: str = "fixed"
    tuning: str = "off"
    parallel: Optional[Any] = None
    precision: str = "fp32"
    fallback: str = "none"
    row_align: Optional[int] = None

    def __post_init__(self) -> None:
        if self.policy not in _POLICIES:
            raise ValueError(f"unknown backend-selection policy "
                             f"{self.policy!r}; expected one of {_POLICIES}")
        if self.fallback not in _FALLBACKS:
            raise ValueError(f"unknown fallback policy {self.fallback!r}; "
                             f"expected one of {_FALLBACKS}")
        if self.tuning not in _TUNING_MODES:
            raise ValueError(f"unknown tuning mode {self.tuning!r}; "
                             f"expected one of {_TUNING_MODES}")
        if self.accum is not None and self.accum != "native":
            accum_dtype_of(self.accum)
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
# the process-wide base config, at the bottom of every thread's resolution
_BASE: List[EngineConfig] = [EngineConfig()]


def current_config() -> EngineConfig:
    """The ambient config: innermost active `using_config` block on this
    thread, else the process-wide base config."""
    return _TLS.configs[-1] if _TLS.configs else _BASE[0]


def default_backend() -> str:
    return current_config().backend


def in_config_context() -> bool:
    return bool(_TLS.configs)


def set_default_config(cfg: EngineConfig) -> None:
    """Replace the process-wide base config. Raises `RuntimeError` inside
    an active `using_config` / `using_backend` block, where the write would
    be shadowed until the block ends."""
    from repro_torch.engine import dispatch
    dispatch.get_backend(cfg.backend)
    if _TLS.configs:
        raise RuntimeError(
            "set_default_config() inside an active using_backend()/"
            "using_config() context would be silently shadowed until the "
            "context exits; pass a config/backend to the context instead, "
            "or call this outside it")
    _BASE[0] = cfg


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
