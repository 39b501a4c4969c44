"""Backend registry of the multi-mode engine.

A backend implements the engine's op kinds against a precomputed
`EnginePlan`:

  * ``"cuda"``  — the hand-written Hopper kernels (`repro_torch.kernels`);
                  the counterpart of the reference's ``"pallas"``. On a CPU
                  tensor each kernel wrapper runs its plain version.
  * ``"torch"`` — the GFID shifted-GEMM lowering in PyTorch ops
                  (`core.gfid`); the counterpart of ``"xla"``.
  * ``"ref"``   — the library's own convolution and matrix product: the
                  "direct engine" baseline the paper compares against.

`run_op` is the kernel-fault chokepoint. With no `serve.faults` injector
installed and `EngineConfig.fallback="none"` it calls the planned backend
directly. An installed injector may fire the "kernel" point for an
(op kind, backend) visit, raising `KernelFault` where the kernel would
have run. Under `fallback="chain"` an injected fault sends the op down
`fallback_chain`, which is narrower than the reference's pallas -> xla ->
ref: the port's "cuda" and "torch" fp32 and bf16 paths are only allclose,
so a backend is listed only where a test holds the pair bitwise equal for
that op kind, precision and activation, and a hop changes where an op ran,
never what it returned. Where the chain is empty the fault propagates. A
real build or launch error is never caught: "launch or raise, no quiet
fallback" (the reference's chain catches any exception).

The paged-KV gather (`engine.paged_gather`) is a copy: "cuda" launches the
`paged_gather` kernel, "torch" and "ref" run its plain version
(`index_select`); all three are bitwise equal.

The 1-D depthwise conv (`engine.conv1d_depthwise`): "cuda" launches the
`gfid_conv1d_depthwise` kernel, "torch" runs the GFID shifted accumulation
(`core.gfid.conv1d_depthwise_gfid`, bitwise equal to the kernel for W_f
<= 8) and "ref" the library's grouped conv.

A plan pinned to `precision="int8"` runs the shared quantized contract on
every backend: quantize both operands (`core.quant`, fp32 or bf16 inputs
widened to fp32), an exact int32 product, then `dequant_epilogue` in fp32,
cast to x's dtype (the reference's `.astype(x.dtype)`). "torch" and "ref"
lower it here; "cuda" runs the int8 kernels, whose wrapper casts their
fp32 store (one rounding to nearest even, as the reference's cast). Exact
integer sums make the three bitwise equal.

`conv2d` and `einsum` receive the `out_dtype` the op returns and return
that dtype; `einsum` also receives its resolved `accum_dtype` (None: the
operands' own, native; or a dtype). "torch" and "ref" follow the
reference's "xla" lowering: a conv and an fp32 accumulation sum the
operands widened to fp32 (exact for bf16), a native one runs in the
operands' dtype, a narrower accumulator stores the wider sums rounded to
it, and the epilogue runs in the result's dtype before the cast. "cuda"
always accumulates in fp32 and its kernels store `out_dtype` from their
fp32 epilogue (`api._check_accum` refuses any other accumulator there).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import gfid, quant
from repro_torch.engine import ledger as _ledger
from repro_torch.engine.config import current_config
from repro_torch.engine.plan import canonical_gemm, grouped_gemm
from repro_torch.kernels import ops, paged
from repro_torch.kernels.epilogue import apply_epilogue, dequant_epilogue
from repro_torch.serve import faults as _faults


@dataclasses.dataclass(frozen=True)
class EngineBackend:
    """One execution strategy for the engine's op kinds. `conv2d` and
    `einsum` receive the op's `EnginePlan`, `out_dtype=` and the
    fused-epilogue kwargs (`bias=`, `act=`); `einsum` also receives
    `accum_dtype=`, the literal spec and its
    parsed `EinsumStructure`; `gather` receives the pool, the block table
    and the plan; `conv1d_depthwise` receives x, the taps, the plan and
    `causal=`."""

    name: str
    conv2d: Callable[..., torch.Tensor]
    einsum: Callable[..., torch.Tensor]
    gather: Callable[..., torch.Tensor]
    conv1d_depthwise: Callable[..., torch.Tensor]


_REGISTRY: Dict[str, EngineBackend] = {}


def register_backend(backend: EngineBackend) -> None:
    if backend.name in _REGISTRY:
        raise ValueError(f"backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend


def get_backend(name: str) -> EngineBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown engine backend {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def backend_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Execution chokepoint: the kernel-fault hook and the fallback chain
# ---------------------------------------------------------------------------

# Activations whose epilogue the int8 kernels compute bitwise as the plain
# `dequant_epilogue` does (gelu's tanh agrees to about an ulp only).
_EXACT_ACTS = (None, "relu")


def fallback_chain(name: str, kind: str, precision: str = "fp32",
                   act: Optional[str] = None, taps: int = 0
                   ) -> Tuple[str, ...]:
    """The backends an op on `name` may hop to under `fallback="chain"`, in
    order: only those held bitwise equal to it for this op kind, precision
    and activation (`taps` is a depthwise conv's W_f).

      * the gather: "cuda" -> "torch" -> "ref" (a copy on each);
      * int8 conv2d and dense with act None or relu: "cuda" -> "torch" ->
        "ref" (exact int32 sums, the same dequant epilogue);
      * the depthwise conv with W_f <= 8: "cuda" -> "torch" (the kernel's
        sum order; "ref" is the library's grouped conv);
      * dense from "torch": -> "ref" (one function); int8 conv2d from
        "torch": -> "ref" (exact sums);
      * nothing else hops: fp32 and bf16 conv and GEMM kernels sum in
        other orders than the torch lowerings."""
    int8 = kind in ("conv2d", "dense") and precision == "int8"
    if name == "cuda":
        if kind == "gather" or (int8 and act in _EXACT_ACTS):
            return ("torch", "ref")
        if kind == "conv1d_dw" and taps <= 8:
            return ("torch",)
    elif name == "torch":
        if kind in ("gather", "dense") or (kind == "conv2d" and int8):
            return ("ref",)
    return ()


def run_op(op, plan, call, *, act: Optional[str] = None,
           on_hop: Optional[Callable] = None):
    """Execute one planned op: `call(backend, plan)` on the plan's backend,
    through the kernel-fault hook and the fallback chain.

    With no injector installed and `fallback="none"` (the default) this is
    a direct call. Otherwise each backend of the op's chain (its planned
    backend, then `fallback_chain` under "chain") meets the "kernel" point
    at site "<kind>:<backend>"; a fired visit raises `KernelFault` there,
    and the chain moves on. A hop is recorded into every active ledger, onto
    the injector, and through `on_hop(plan)` (a compiled program pins it);
    the hop's plan drops any tuned tile, which was the "cuda" entry's.
    Only the injected fault is answered: a backend's own error propagates.
    """
    inj = _faults.active()
    chained = current_config().fallback == "chain"
    if inj is None and not chained:
        return call(get_backend(plan.backend), plan)
    chain = (plan.backend,)
    if chained:
        chain += fallback_chain(plan.backend, op.kind, plan.precision, act,
                                op.w_shape[0] if op.kind == "conv1d_dw"
                                else 0)
    fault = None
    for name in chain:
        if inj is not None and inj.fire("kernel", site=f"{op.kind}:{name}"):
            fault = _faults.KernelFault(
                f"injected kernel fault: {op.kind} on backend {name!r}")
            continue
        pl = plan if name == plan.backend else dataclasses.replace(
            plan, backend=name, tile_config=None)
        out = call(get_backend(name), pl)
        if fault is not None:
            _ledger.record_fallback(_ledger.FallbackRecord(
                op.kind, plan.backend, name, str(fault)))
            if inj is not None:
                inj.note_fallback(op.kind, plan.backend, name)
            if on_hop is not None:
                on_hop(pl)
        return out
    raise fault


# ---------------------------------------------------------------------------
# int8 lowerings shared by the "torch" and "ref" backends
# ---------------------------------------------------------------------------

def _quant_conv2d(conv_i32, x, w, *, stride, pad, groups, bias, act):
    """Quantize (the shared rule, from fp32 or bf16 inputs widened), an
    exact int32 conv (`conv_i32`: the GFID shifted GEMM or the library's
    conv), then the fp32 dequant epilogue; the caller casts to x's dtype."""
    xq, wq, sx, sw = quant.quantize_conv_operands(x, w)
    acc = conv_i32(xq, wq, stride, pad, groups)
    return dequant_epilogue(acc, sx * sw, bias, act)


def _quant_canonical_einsum(x, w, structure, *, bias, act):
    """A canonical (M, K) @ (K, N) contraction on int8: the canonicalization
    of the "cuda" path, the shared quantization, the exact int32 GEMM and
    the dequant epilogue. Canonical means the output is already laid out
    (lead..., N)."""
    c = structure.contract[0]
    xm = torch.movedim(x, structure.x_labels.index(c), -1)
    w2 = w if structure.w_labels[0] == c else w.T
    xq, wq, sx, sw = quant.quantize_matmul_operands(xm, w2)
    acc = quant.int8_matmul_i32(xq, wq)
    return dequant_epilogue(acc, sx * sw, bias, act)


# ---------------------------------------------------------------------------
# "torch" — GFID shifted-GEMM lowering in PyTorch ops
# ---------------------------------------------------------------------------

def _torch_conv2d(x, w, plan, *, stride, pad, groups, out_dtype, bias=None,
                  act=None):
    if plan.precision == "int8":
        out = _quant_conv2d(gfid.conv2d_gfid_int8, x, w, stride=stride,
                            pad=pad, groups=groups, bias=bias, act=act)
    else:
        out = apply_epilogue(gfid.conv2d_gfid(x, w, stride, pad, groups),
                             bias, act)
    return out.to(out_dtype)


def _torch_einsum(spec, x, w, plan, structure, *, accum_dtype, out_dtype,
                  bias=None, act=None):
    """Also the "ref" backend's einsum, as in the reference. An int8 plan
    is always canonical: `supports_int8` pins others to fp32."""
    if plan.precision == "int8":
        out = _quant_canonical_einsum(x, w, structure, bias=bias, act=act)
    else:
        # the operands widened to the accumulator where it is wider, the
        # sums stored in it (the reference's `preferred_element_type`)
        dt = torch.promote_types(x.dtype, w.dtype)
        if accum_dtype is not None:
            dt = torch.promote_types(dt, accum_dtype)
        prod = torch.einsum(spec, x.to(dt), w.to(dt))
        if accum_dtype is not None:
            prod = prod.to(accum_dtype)
        out = apply_epilogue(prod, bias, act)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# "ref" — the library's direct ops
# ---------------------------------------------------------------------------

def _torch_conv1d_dw(x, w, plan, *, causal):
    return gfid.conv1d_depthwise_gfid(x, w, causal=causal)


def _ref_conv1d_dw(x, w, plan, *, causal):
    return gfid.conv1d_depthwise_reference(x, w, causal=causal)


def _ref_conv2d(x, w, plan, *, stride, pad, groups, out_dtype, bias=None,
                act=None):
    if plan.precision == "int8":
        out = _quant_conv2d(gfid.conv2d_reference_int8, x, w, stride=stride,
                            pad=pad, groups=groups, bias=bias, act=act)
    else:
        out = apply_epilogue(gfid.conv2d_reference(x, w, stride, pad,
                                                   groups), bias, act)
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# "cuda" — the hand-written kernels
# ---------------------------------------------------------------------------

def _cuda_conv2d(x, w, plan, *, stride, pad, groups, out_dtype, bias=None,
                 act=None):
    return ops.gfid_conv2d(x, w, stride=stride, pad=pad, groups=groups,
                           bias=bias, act=act, precision=plan.precision,
                           out_dtype=out_dtype, tile=plan.tile_config)


def _cuda_einsum(spec, x, w, plan, structure, *, accum_dtype, out_dtype,
                 bias=None, act=None):
    """Canonicalize to (M, K) @ (K, N) for the GEMM kernel, which sums in
    fp32 whatever `accum_dtype` is and stores `out_dtype`; a contraction
    over stacked weights that is one grouped GEMM (`grouped_gemm`: an MoE
    layer's experts) to (G, M, K) @ (G, K, N), one launch of the same
    kernel, where the reference sends it to XLA. Any other batched-weight
    contraction raises: a library product behind the "cuda" name would hide
    it."""
    st = structure
    if grouped_gemm(st, w.ndim):
        c = st.contract[0]
        xm = torch.movedim(x, st.x_labels.index(c), -1)
        w3 = w if st.w_labels[1] == c else w.transpose(1, 2)
        return ops.gfid_matmul_grouped(xm, w3, bias=bias, act=act,
                                       precision=plan.precision,
                                       out_dtype=out_dtype)
    if not canonical_gemm(st, w.ndim):
        raise NotImplementedError(
            f"einsum {spec!r} is neither a single (M, K) @ (K, N) GEMM nor "
            "one grouped (G, M, K) @ (G, K, N) GEMM; its batched-weight "
            "kernel is not ported (ROADMAP queue 1, item 10: MLA) — use "
            "backend='torch'")
    c = st.contract[0]
    xm = torch.movedim(x, st.x_labels.index(c), -1)
    w2 = w if st.w_labels[0] == c else w.T
    return ops.gfid_matmul(xm, w2, bias=bias, act=act,
                           precision=plan.precision, out_dtype=out_dtype,
                           tile=plan.tile_config)


def _cuda_conv1d_dw(x, w, plan, *, causal):
    return ops.gfid_conv1d_depthwise(x, w, causal=causal)


def _cuda_gather(pool, table, plan):
    return ops.paged_gather(pool, table)


def _plain_gather(pool, table, plan):
    """The "torch" and "ref" gather: the kernel's plain version, on any
    device."""
    return paged.paged_gather_plain(pool, table.to(torch.int32))


register_backend(EngineBackend("cuda", _cuda_conv2d, _cuda_einsum,
                               _cuda_gather, _cuda_conv1d_dw))
register_backend(EngineBackend("torch", _torch_conv2d, _torch_einsum,
                               _plain_gather, _torch_conv1d_dw))
register_backend(EngineBackend("ref", _ref_conv2d, _torch_einsum,
                               _plain_gather, _ref_conv1d_dw))
