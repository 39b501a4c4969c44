"""Functional entrypoints of the multi-mode engine.

One call surface for the dense ops (the paper's "conv and FC on the same
PEs" contract):

    y = engine.conv2d(x, w, stride=2, pad=3, bias=b, act="relu")  # conv modes
    y = engine.dense(x, w)                            # FC mode, (…,n)@(n,m)
    y = engine.einsum("bn,nm->bm", x, w)              # FC mode, general
    y = engine.conv1d_depthwise(x, taps)              # 1-D short-conv mode
    y = engine.proj(x, w)                             # parameter GEMM, x @ w
    kv = engine.paged_gather(pool, table)             # paged-KV block gather

Every call builds the op's `OpSpec` from its static shapes, computes the
pure `EnginePlan` (cached), records it into any active `tracking()` ledger,
and dispatches to the selected backend: the plan's backend inside an
executing `CompiledNet` (program replay), else the ambient `EngineConfig`'s
(per op under `policy="auto"`, `plan.auto_backend`). The op's precision
resolves likewise (`_pin_precision`): an explicit `precision=` argument,
else the replayed plan's, else the config's. Dispatch goes through
`dispatch.run_op` (the kernel-fault hook and the fallback chain), except
in a compiled program's replays after its first complete apply, which call
the pinned backend directly.

Numerics follow the reference's API contract (what its "xla" and "ref"
backends implement) on every backend, "cuda" included. `dense`
accumulates in fp32 by default, `einsum` and `proj` natively:
`accum_dtype=torch.float32` makes an einsum/dense return fp32 on bf16
operands, `accum_dtype=None` keeps the operands' dtype, and `out_dtype=`
casts the result. `conv2d` accumulates in fp32 and returns x's dtype. The
kernels accumulate in fp32 either way and store the dtype the op returns.
(The reference's "pallas" backend drops `accum_dtype` and returns x's
dtype: ROADMAP section 3.) An unset `accum_dtype` resolves from the
ambient `EngineConfig.accum` (`_resolve_accum`); on "cuda", whose kernels
sum in fp32, an accumulator other than fp32 or native raises rather than
being ignored, and `conv2d` sums in fp32 on every backend. An int8 op
quantizes fp32 or bf16 inputs and returns x's dtype, as the reference's
(its accumulator is the exact int32 sum, whatever `accum` says).
Under `EngineConfig(row_align=R)`
a dense op whose leading x axis is a pure row dim pads it with zeros to a
multiple of R and slices the result back (`_row_pad_axis`), as the
reference does; a grouped GEMM (`plan.grouped_gemm`: an MoE layer's
experts) pads its rows, the x axis after the group, the same way, where
the reference pads nothing: its plain version on the CPU then sums a token
alone as in a bucket of R.

Ops run on the device of the tensors they are given.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from repro_torch.engine import dispatch, ledger as ledger_mod, plan as planlib
from repro_torch.engine import tune as tunelib
from repro_torch.engine.config import accum_dtype_of, current_config
from repro_torch.kernels.epilogue import check_act


class _Unset:
    def __repr__(self) -> str:      # keeps signatures readable in help()
        return "<per-op default>"


_UNSET = _Unset()

# Each op's accumulator when neither the call nor the config names one.
_ACCUM_DEFAULTS = {"conv2d": torch.float32, "dense": torch.float32,
                   "einsum": None}


def _resolve_accum(arg, op_kind: str) -> Optional[torch.dtype]:
    """An op's accumulator: an explicit `accum_dtype=` (None = native), else
    the config's `accum` (None: the op's default; "native"; a dtype
    name)."""
    if not isinstance(arg, _Unset):
        if arg is not None and not isinstance(arg, torch.dtype):
            raise ValueError(f"accum_dtype={arg!r} is not a torch dtype "
                             "(or None, native)")
        return arg
    accum = current_config().accum
    if accum is None:
        return _ACCUM_DEFAULTS[op_kind]
    return None if accum == "native" else accum_dtype_of(accum)


def _check_accum(accum: Optional[torch.dtype],
                 plan: planlib.EnginePlan, what: str) -> None:
    """The accumulators a plan can honour: any on "torch" and "ref" (and
    none matters on an int8 plan, whose sums are exact); on "cuda", whose
    kernels sum in fp32, only fp32 or native."""
    if plan.backend == "cuda" and plan.precision != "int8" \
            and accum not in (None, torch.float32):
        raise ValueError(
            f"accum_dtype={accum} on {what}: the 'cuda' kernels sum in "
            "fp32; take accum_dtype None (native) or torch.float32, or "
            "backend='torch'")

# ---------------------------------------------------------------------------
# Program capture & replay (used by engine/program.py)
# ---------------------------------------------------------------------------


class _ProgramState(threading.local):
    def __init__(self) -> None:
        self.capture: List[Tuple[List[planlib.OpSpec],
                                 Optional[List[Optional[str]]],
                                 Optional[List[Optional[torch.dtype]]]]] = []
        self.replay: List["_Cursor"] = []


class _Cursor:
    """Mutable position over a compiled (OpSpec, EnginePlan) sequence.
    `hooks` is True on a program's first complete apply: its ops go
    through the kernel-fault hook, and a hop is pinned into `pairs`."""

    def __init__(self, pairs: Sequence[Tuple[planlib.OpSpec,
                                             planlib.EnginePlan]],
                 hooks: bool = False):
        self.pairs = list(pairs)
        self.index = 0
        self.hooks = hooks

    def pin(self, plan: planlib.EnginePlan) -> None:
        """Replace the plan of the op just issued (a fallback hop)."""
        op, _ = self.pairs[self.index - 1]
        self.pairs[self.index - 1] = (op, plan)

    def next_for(self, op: planlib.OpSpec) -> planlib.EnginePlan:
        if self.index >= len(self.pairs):
            raise RuntimeError(
                f"compiled program expected {len(self.pairs)} engine ops but "
                f"a further {op.kind} op was issued — the executed function "
                "diverged from its captured op sequence (did the input "
                "shapes change since compile()?)")
        want, plan = self.pairs[self.index]
        if want != op:
            raise RuntimeError(
                f"compiled program op {self.index} mismatch: planned "
                f"{want.kind}{want.x_shape}x{want.w_shape}, executing "
                f"{op.kind}{op.x_shape}x{op.w_shape} — recompile for these "
                "input shapes")
        self.index += 1
        return plan


_PROG = _ProgramState()


@contextlib.contextmanager
def capturing(into: List[planlib.OpSpec],
              precisions_into: Optional[List[Optional[str]]] = None,
              dtypes_into: Optional[List[Optional[torch.dtype]]] = None,
              ) -> Iterator[List[planlib.OpSpec]]:
    """Record the `OpSpec` of every engine call in the block, in call order
    (ledgers are paused: a capture is a shape trace, not a run).

    `precisions_into`, when given, receives one entry per op: the call's
    explicit `precision=` argument, or None where the op left precision to
    the config. `compile` pins these per-op overrides (e.g. those of
    `models.cnn.program(..., precisions={"fc6": "int8"})`). `dtypes_into`
    likewise receives the dtype of each conv2d and einsum op's input x
    (None for the other ops): the tuner keys a tile by it, while `OpSpec`
    stays the reference's."""
    _PROG.capture.append((into, precisions_into, dtypes_into))
    try:
        with ledger_mod.paused():
            yield into
    finally:
        _PROG.capture.pop()


@contextlib.contextmanager
def replaying(pairs: Sequence[Tuple[planlib.OpSpec, planlib.EnginePlan]],
              hooks: bool = False) -> Iterator[_Cursor]:
    """Execute the block against a compiled plan sequence: each engine call
    consumes the next (OpSpec, EnginePlan) pair and runs on the plan's
    backend, through the kernel-fault hook where `hooks` is set, else
    directly. Divergence from the captured sequence raises."""
    cur = _Cursor(pairs, hooks)
    _PROG.replay.append(cur)
    try:
        yield cur
    finally:
        _PROG.replay.pop()
    if cur.index != len(cur.pairs):
        raise RuntimeError(
            f"compiled program executed {cur.index} of {len(cur.pairs)} "
            "planned engine ops — the function diverged from its captured "
            "op sequence")


def _plan_for(op: planlib.OpSpec,
              dtype: Optional[torch.dtype] = None) -> planlib.EnginePlan:
    """Capture/replay hook + plan resolution for one issued op (`dtype`:
    its input's, for the captured dtypes)."""
    for ops, precs, dtypes in _PROG.capture:
        ops.append(op)
        if precs is not None:
            precs.append(None)          # _pin_precision fills in an explicit arg
        if dtypes is not None:
            dtypes.append(dtype)
    if _PROG.replay:
        return _PROG.replay[-1].next_for(op)
    name = planlib.select_backend(op, current_config())
    dispatch.get_backend(name)          # validate before caching a plan
    return planlib.plan_op(op, name)


def _run(op: planlib.OpSpec, plan: planlib.EnginePlan, call,
         act: Optional[str] = None):
    """Dispatch one op. In a compiled program's replays after its first
    complete apply: the pinned backend, directly. Otherwise through
    `dispatch.run_op`, a hop on a first apply pinned into the program."""
    cur = _PROG.replay[-1] if _PROG.replay else None
    if cur is not None and not cur.hooks:
        return call(dispatch.get_backend(plan.backend), plan)
    return dispatch.run_op(op, plan, call, act=act,
                           on_hop=None if cur is None else cur.pin)


def _pin_precision(op: planlib.OpSpec, plan: planlib.EnginePlan,
                   arg: Optional[str]) -> planlib.EnginePlan:
    """Resolve the op's precision and pin it onto the plan: an explicit
    `precision=` wins (and an int8 request for an op the int8 contract does
    not cover raises), then a replayed plan's pinned precision, then the
    ambient config's (quietly fp32 for an op int8 does not cover)."""
    if arg is not None:
        if arg not in planlib.PRECISIONS:
            raise ValueError(f"unknown precision {arg!r}; expected one of "
                             f"{planlib.PRECISIONS}")
        if arg == "int8" and not planlib.supports_int8(op):
            raise ValueError(
                f"precision='int8' requested for {op.kind} {op.x_shape}x"
                f"{op.w_shape}, but the int8 contract only covers conv2d "
                "and canonical-GEMM dense ops")
        # tell an active capture, so a compiled program pins the override
        for _, precs, _ in _PROG.capture:
            if precs:
                precs[-1] = arg
        return planlib.pinned(plan, arg)
    if _PROG.replay:
        return plan                         # pinned by compile
    return planlib.with_precision(plan, op, current_config().precision)


def _maybe_tile(op: planlib.OpSpec, plan: planlib.EnginePlan,
                dtype: torch.dtype) -> planlib.EnginePlan:
    """Eager-path tile resolution: pin a *cached* tuned tile under
    `cfg.tuning != "off"`. Replayed plans (a `CompiledNet` executing) are
    returned untouched: what `engine.compile` pinned, a None on a cache
    miss included, is the execution contract, so a cache written after
    compile never changes a compiled net. Timing candidates happens at
    compile time only, never per call."""
    if _PROG.replay:
        return plan
    cfg = current_config()
    if cfg.tuning == "off" or plan.backend != "cuda":
        return plan
    return tunelib.attach(op, plan, cfg, dtype=dtype)


def _row_pad_axis(structure: planlib.EinsumStructure,
                  x_shape: Tuple[int, ...], w_ndim: int) -> Tuple[int, int]:
    """(axis, rows) to zero-pad onto x under `cfg.row_align`: its leading
    axis where that is a pure row dim (an x-free label, so rows are
    independent and the output can be sliced back), a grouped GEMM's row
    axis (the one after the group), else none (rows 0). A fixed GEMM row
    count keeps each row's arithmetic independent of the batch size."""
    align = current_config().row_align
    if not align or not x_shape or 0 in x_shape:
        return 0, 0
    if structure.x_labels[0] in structure.x_free:
        return 0, -x_shape[0] % align
    if planlib.grouped_gemm(structure, w_ndim) \
            and structure.x_labels[1] in structure.x_free:
        return 1, -x_shape[1] % align
    return 0, 0


def _result_dtype(x: torch.Tensor, w: torch.Tensor,
                  bias: Optional[torch.Tensor],
                  accum: Optional[torch.dtype]) -> torch.dtype:
    """What an einsum returns before `out_dtype`: the accumulator's dtype,
    or natively the operands' promoted dtype, promoted with the bias's (as
    the reference's `apply_epilogue` promotes)."""
    dt = accum if accum is not None else torch.promote_types(x.dtype, w.dtype)
    return dt if bias is None else torch.promote_types(dt, bias.dtype)


def _check_epilogue(bias: Optional[torch.Tensor], act: Optional[str],
                    n_out: int, what: str) -> None:
    check_act(act)
    if bias is not None and tuple(bias.shape) != (n_out,):
        raise ValueError(
            f"epilogue bias for {what} must have shape ({n_out},) — one "
            f"entry per output feature; got {tuple(bias.shape)}")


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, pad: int = 0,
           groups: int = 1, bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None,
           precision: Optional[str] = None) -> torch.Tensor:
    """Conv mode. x: (B,H,W,C_in) NHWC; w: (H_f,W_f,C_in/g,C_out) HWIO.
    Returns (B,H_out,W_out,C_out) in x's dtype, accumulated in fp32 (the
    reference's default; its "native" conv accumulates in fp32 too; a
    config `accum` of another dtype raises).

    `bias` ((C_out,)) and `act` ("relu" | "gelu") form the op's fused
    epilogue: conv+bias+activation is one kernel launch on the "cuda"
    backend and ordinary post-ops elsewhere. On the int8 path
    (`precision="int8"` here or on the config) dequant, bias and activation
    fuse into the same epilogue: still one launch."""
    op = planlib.OpSpec("conv2d", tuple(map(int, x.shape)),
                        tuple(map(int, w.shape)), stride=int(stride),
                        pad=int(pad), groups=int(groups))
    _check_epilogue(bias, act, op.w_shape[3], "conv2d")
    accum = _resolve_accum(_UNSET, "conv2d")
    plan = _pin_precision(op, _plan_for(op, x.dtype), precision)
    if plan.precision != "int8" and accum not in (None, torch.float32):
        raise ValueError(f"accum={accum} on conv2d: the port's conv sums in "
                         "fp32 on every backend")
    plan = _maybe_tile(op, plan, x.dtype)
    ledger_mod.record(plan)
    return _run(op, plan, lambda be, pl: be.conv2d(
        x, w, pl, stride=stride, pad=pad, groups=groups, out_dtype=x.dtype,
        bias=bias, act=act), act)


def conv1d_depthwise(x: torch.Tensor, w: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """1-D depthwise mode (the SSM short convs). x: (B, L, D); w: (W_f, D).
    Returns (B, L, D) in x.dtype, accumulated in fp32: causal (W_f - 1
    zeros before the sequence) or centred."""
    op = planlib.OpSpec("conv1d_dw", tuple(map(int, x.shape)),
                        tuple(map(int, w.shape)), causal=bool(causal))
    plan = _plan_for(op)
    ledger_mod.record(plan)
    out = _run(op, plan, lambda be, pl: be.conv1d_depthwise(
        x, w, pl, causal=causal))
    return out.to(x.dtype)


def einsum(spec: str, x: torch.Tensor, w: torch.Tensor, *,
           bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None,
           accum_dtype=_UNSET,
           out_dtype: Optional[torch.dtype] = None,
           precision: Optional[str] = None) -> torch.Tensor:
    """FC mode for any two-operand dense contraction (weights second).

    `bias` ((n_out,), one entry per trailing output feature) and `act`
    form the fused epilogue; the trailing output label must be a
    weight-side (w-free) dim for a bias to be well-defined. Native numerics
    by default (bf16 in, bf16 out; or the config's `accum`);
    `accum_dtype=torch.float32` returns the fp32 sums, and `out_dtype`
    casts the result. An int8 op returns x's dtype before `out_dtype`."""
    op = planlib.OpSpec("dense", tuple(map(int, x.shape)),
                        tuple(map(int, w.shape)), spec=spec)
    structure = planlib.parse_einsum(spec, x.ndim, w.ndim)
    if bias is not None:
        if not structure.out_labels \
                or structure.out_labels[-1] not in structure.w_free:
            raise ValueError(
                f"epilogue bias on einsum {spec!r}: the trailing output "
                "label must be a weight-only (w-free) dim to carry a "
                "per-feature bias")
        lab = structure.out_labels[-1]
        n_out = op.w_shape[structure.w_labels.index(lab)]
        _check_epilogue(bias, act, n_out, f"einsum {spec!r}")
    else:
        check_act(act)
    accum = _resolve_accum(accum_dtype, "einsum")
    plan = _pin_precision(op, _plan_for(op, x.dtype), precision)
    _check_accum(accum, plan, f"einsum {spec!r}")
    plan = _maybe_tile(op, plan, x.dtype)
    int8 = plan.precision == "int8"
    if int8:
        want = x.dtype              # the dequantized sums, cast to x's dtype
    else:
        want = out_dtype if out_dtype is not None \
            else _result_dtype(x, w, bias, accum)
    ledger_mod.record(plan)
    axis, pad = _row_pad_axis(structure, op.x_shape, w.ndim)
    if pad:
        zeros = list(x.shape)
        zeros[axis] = pad
        x = torch.cat([x, x.new_zeros(zeros)], dim=axis)
    out = _run(op, plan, lambda be, pl: be.einsum(
        spec, x, w, pl, structure, accum_dtype=accum, out_dtype=want,
        bias=bias, act=act), act)
    if pad:
        ax = structure.out_labels.index(structure.x_labels[axis])
        out = out.narrow(ax, 0, op.x_shape[axis])
    if int8 and out_dtype is not None:
        out = out.to(out_dtype)
    return out


def dense(x: torch.Tensor, w: torch.Tensor, *,
          bias: Optional[torch.Tensor] = None,
          act: Optional[str] = None,
          accum_dtype=_UNSET,
          out_dtype: Optional[torch.dtype] = None,
          precision: Optional[str] = None) -> torch.Tensor:
    """FC mode (W_f = 1): x (..., n) @ w (n, m) -> (..., m), with an
    optional fused bias ((m,)) / activation epilogue. Accumulates in fp32
    and returns fp32 by default (bf16 operands included), unless the
    config's `accum` says otherwise."""
    if isinstance(accum_dtype, _Unset):
        accum_dtype = _resolve_accum(accum_dtype, "dense")
    return einsum(planlib.dense_spec(x.ndim), x, w, bias=bias, act=act,
                  accum_dtype=accum_dtype, out_dtype=out_dtype,
                  precision=precision)


def proj(x: torch.Tensor, w: torch.Tensor, *,
         precision: Optional[str] = None) -> torch.Tensor:
    """The model code's parameter GEMM, `x @ w` with plain-`@` numerics
    (`dense(accum_dtype=None)`): the result has the operands' dtype, bf16
    for bf16 parameters."""
    return dense(x, w, accum_dtype=None, precision=precision)


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Paged-KV block gather (a serving memory move).

    pool:  (num_blocks, block_size, *feature), any dtype — a
           `serve.kv_pool` block pool tensor.
    table: (B, blocks_per_req) int32 — per-request block ids.
    Returns (B, blocks_per_req * block_size, *feature): each request's
    dense cache view rebuilt from its blocks, bitwise.

    Routed through the engine like any dense op: it records a zero-MAC
    "gather" plan, is captured into programs, and dispatches per backend
    (the `paged_gather` kernel on "cuda", `index_select` on "torch" and
    "ref")."""
    op = planlib.OpSpec("gather", tuple(map(int, pool.shape)),
                        tuple(map(int, table.shape)))
    plan = _plan_for(op)
    ledger_mod.record(plan)
    return _run(op, plan, lambda be, pl: be.gather(pool, table, pl))


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           bias: Optional[torch.Tensor] = None,
           act: Optional[str] = None,
           precision: Optional[str] = None) -> torch.Tensor:
    """FC mode with the result cast back to x's dtype (the reference's
    `engine.matmul` contract: fp32 sums whatever the config's `accum`; the
    "cuda" kernels store it directly)."""
    return dense(x, w, bias=bias, act=act, accum_dtype=torch.float32,
                 out_dtype=x.dtype, precision=precision)
