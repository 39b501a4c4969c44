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

`run_op` calls the planned backend directly. The reference's
pallas -> xla -> ref degradation chain is not ported: a backend's error
propagates (see `EngineConfig.fallback`).

The paged-KV gather (`engine.paged_gather`) is a copy: "cuda" launches the
`paged_gather` kernel, "torch" and "ref" run its plain version
(`index_select`); all three are bitwise equal.

The 1-D depthwise conv (`engine.conv1d_depthwise`): "cuda" launches the
`gfid_conv1d_depthwise` kernel, "torch" runs the GFID shifted accumulation
(`core.gfid.conv1d_depthwise_gfid`, bitwise equal to the kernel for W_f
<= 8) and "ref" the library's grouped conv.

A plan pinned to `precision="int8"` runs the shared quantized contract on
every backend: quantize both operands (`core.quant`), an exact int32
product, then `dequant_epilogue`. "torch" and "ref" lower it here; "cuda"
runs the int8 kernels. Exact integer sums make the three bitwise equal.

`conv2d` and `einsum` receive the `out_dtype` the op returns and return
that dtype; `einsum` also receives its `accum_dtype` (None: the operands'
own, native; or fp32). "torch" and "ref" follow the reference's "xla"
lowering: a conv and an fp32 accumulation sum the operands widened to
fp32 (exact for bf16), a native one runs in the operands' dtype, and the
epilogue runs in the result's dtype before the cast. "cuda" always
accumulates in fp32 and its kernels store `out_dtype` from their fp32
epilogue.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from repro_torch.core import gfid, quant
from repro_torch.engine.plan import canonical_gemm
from repro_torch.kernels import ops, paged
from repro_torch.kernels.epilogue import apply_epilogue, dequant_epilogue


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


def run_op(plan, call):
    """Execute one planned op: `call(backend, plan)` on the plan's backend."""
    return call(get_backend(plan.backend), plan)


# ---------------------------------------------------------------------------
# int8 lowerings shared by the "torch" and "ref" backends
# ---------------------------------------------------------------------------

def _quant_conv2d(conv_i32, x, w, *, stride, pad, groups, bias, act):
    """Quantize (the shared rule), an exact int32 conv (`conv_i32`: the GFID
    shifted GEMM or the library's conv), then the dequant epilogue (fp32
    inputs only: `api._check_int8_input`)."""
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
        dt = accum_dtype if accum_dtype is not None \
            else torch.promote_types(x.dtype, w.dtype)
        out = apply_epilogue(torch.einsum(spec, x.to(dt), w.to(dt)), bias,
                             act)
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
                           out_dtype=out_dtype)


def _cuda_einsum(spec, x, w, plan, structure, *, accum_dtype, out_dtype,
                 bias=None, act=None):
    """Canonicalize to (M, K) @ (K, N) for the GEMM kernel, which sums in
    fp32 whatever `accum_dtype` is and stores `out_dtype`. A contraction
    that does not canonicalize (batched weights) raises: the reference sends
    it to its XLA lowering, which would hide a library call behind the
    "cuda" name."""
    st = structure
    if not canonical_gemm(st, w.ndim):
        raise NotImplementedError(
            f"einsum {spec!r} is not a single (M, K) @ (K, N) GEMM; the "
            "batched-weight GEMM kernel is not ported (ROADMAP queue 1, "
            "item 10) — use backend='torch'")
    c = st.contract[0]
    xm = torch.movedim(x, st.x_labels.index(c), -1)
    w2 = w if st.w_labels[0] == c else w.T
    return ops.gfid_matmul(xm, w2, bias=bias, act=act,
                           precision=plan.precision, out_dtype=out_dtype)


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
