"""Quantization: the paper's 16-bit fixed point (§5.1) and the engine's int8
path, in PyTorch ops.

A copy of the JAX package's `repro.core.quant` (which the port may not
import). It is the single source of truth for `EngineConfig(precision=
"int8")`: symmetric per-row / per-channel scales, the pinned rounding rule
(ties away from zero) and the exact int32 GEMM. Every backend of the port
quantizes through here, so the quantized results of "cuda", "torch" and
"ref" are bitwise equal to each other and to the JAX package's.

Quantization is plain torch ops on the tensors' own device; only the int8
products run in the hand-written kernels.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    total_bits: int = 16
    frac_bits: int = 2      # activations: Q13.2 (paper: "2 fractional bits")

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def max_int(self) -> int:
        return 2 ** (self.total_bits - 1) - 1

    @property
    def min_int(self) -> int:
        return -(2 ** (self.total_bits - 1))


ACT_FORMAT = FixedPointFormat(16, 2)
WEIGHT_FORMAT = FixedPointFormat(16, 15)   # Q0.15
PARTIAL_FORMAT = FixedPointFormat(24, 17)  # 24-bit PE scratch (paper §5)

# int8 symmetric range: ±127 keeps the grid symmetric under negation and
# bounds every product by 127².
INT8_QMAX = 127

# Largest contraction chunk whose int8 x int8 partial sum is exact in fp32:
# 1024 * 127 * 127 = 16 516 096 < 2**24. `int8_matmul_i32` chunks K at this
# size so its fp32 products are exact integers.
INT8_EXACT_K = 1024

# The scale is absmax times the fp32 reciprocal of 127 (a tensor, so the
# multiply is fp32 x fp32), never absmax / 127: the reference pins the
# multiply so that every execution mode computes the same scale.
_INV_QMAX = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
    float(INT8_QMAX), dtype=torch.float32)


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round to nearest integer, ties away from zero (add half an LSB and
    truncate), in fp32. `torch.round` rounds ties to even."""
    x = x.float()
    half = torch.where(x >= 0, 0.5, -0.5).to(torch.float32)
    return torch.trunc(x + half)


def quantize(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Project onto the Qm.f fixed-point grid, with saturation; ties round
    away from zero (Q13.2 takes 0.375 to 0.5)."""
    q = round_half_away(x.float() * fmt.scale)
    q = torch.clamp(q, fmt.min_int, fmt.max_int)
    return q / fmt.scale


def snr_db(reference: torch.Tensor, test: torch.Tensor) -> torch.Tensor:
    """Signal-to-noise ratio of `test` against `reference`, in dB."""
    ref = reference.float()
    err = ref - test.float()
    num = torch.mean(ref ** 2)
    den = torch.mean(err ** 2) + 1e-30
    return 10.0 * torch.log10(num / den)


def quantization_snr_db(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    """Signal-to-quantization-noise ratio in dB."""
    return snr_db(x, quantize(x, fmt))


# ---------------------------------------------------------------------------
# int8 symmetric quantization (engine precision="int8")
# ---------------------------------------------------------------------------

def symmetric_scale(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Symmetric int8 scale: absmax * (1/127) over `axis` (an int, a tuple,
    or None for all), keepdims. An all-zero slice gets scale 1.0.

    Reducing per row for activations and per output channel for weights
    keeps the scales batch-invariant: one example's scale depends on that
    example alone."""
    a = x.float().abs()
    if axis is None:
        absmax = a.amax().reshape((1,) * x.ndim)
    else:
        absmax = a.amax(dim=axis, keepdim=True)
    # a 0-dim CPU tensor enters a CUDA op as an fp32 scalar: no copy
    return torch.where(absmax > 0, absmax * _INV_QMAX, 1.0)


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 on the symmetric grid: a true fp32 divide by `scale`, the pinned
    rounding rule, then a clip to ±127."""
    q = round_half_away(x.float() / scale)
    return torch.clamp(q, -INT8_QMAX, INT8_QMAX).to(torch.int8)


def quantize_conv_operands(x: torch.Tensor, w: torch.Tensor):
    """int8 operands of an NHWC x HWIO conv: per-example activation scales
    (over H, W, C of the unpadded x) and per-output-channel weight scales.
    Returns (xq, wq, sx (B,1,1,1), sw (1,1,1,C_out))."""
    sx = symmetric_scale(x, axis=(1, 2, 3))
    sw = symmetric_scale(w, axis=(0, 1, 2))
    return quantize_int8(x, sx), quantize_int8(w, sw), sx, sw


def quantize_matmul_operands(x: torch.Tensor, w: torch.Tensor):
    """int8 operands of (..., K) @ (K, N): per-row activation scales and
    per-column weight scales. Returns (xq, wq, sx (..., 1), sw (1, N))."""
    sx = symmetric_scale(x, axis=-1)
    sw = symmetric_scale(w, axis=0)
    return quantize_int8(x, sx), quantize_int8(w, sw), sx, sw


def int8_matmul_i32(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product `(..., K) @ (K, N)` of int8 operands.

    K-chunked fp32 matmuls (a chunk of at most INT8_EXACT_K keeps every
    partial sum below 2**24, hence exact) whose integer-valued results are
    summed in int32. On a CUDA tensor the fp32 matmuls run with TF32 off."""
    k = xq.shape[-1]
    acc = None
    with no_tf32():
        for c0 in range(0, max(k, 1), INT8_EXACT_K):
            part = torch.matmul(xq[..., c0:c0 + INT8_EXACT_K].float(),
                                wq[c0:c0 + INT8_EXACT_K].float()
                                ).to(torch.int32)
            acc = part if acc is None else acc + part
    return acc


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    """Switch TF32 off for CUDA fp32 matmuls in the block, then restore it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
