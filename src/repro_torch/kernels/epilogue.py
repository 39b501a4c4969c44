"""Fused-epilogue activation registry and the int8 dequant epilogue.

"gelu" is the tanh approximation, as in the JAX package (`jax.nn.gelu(
approximate=True)`). The hand-written kernels apply the same bias-then-
activation order to their fp32 accumulator (`apply_act` in `csrc/epilogue.cuh`,
selected by `ACT_CODES`); the plain versions and the "torch"/"ref"
backends apply it after the op with `apply_epilogue`. The int8 kernels end
in `dequant_epilogue` (the same op order as the device function of that
name in `csrc/epilogue.cuh`).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

ACTS = {
    "relu": torch.relu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
}

# The `act` argument of the CUDA launchers (`apply_act` in csrc/epilogue.cuh).
ACT_CODES = {None: 0, "relu": 1, "gelu": 2}


def check_act(act: Optional[str]) -> None:
    if act is not None and act not in ACTS:
        raise ValueError(f"unknown epilogue activation {act!r}; "
                         f"expected one of {sorted(ACTS)}")


def apply_epilogue(out: torch.Tensor, bias: Optional[torch.Tensor],
                   act: Optional[str]) -> torch.Tensor:
    """The unfused epilogue: bias broadcast-added on the trailing axis, then
    the activation, under PyTorch's type promotion (JAX's for these pairs):
    a bf16 bias meets an fp32 accumulator widened to fp32, as the kernels'
    epilogue reads it, and a bf16 result with a bf16 bias stays bf16."""
    if bias is not None:
        out = out + bias
    if act is not None:
        out = ACTS[act](out)
    return out


def dequant_epilogue(acc_i32: torch.Tensor, scale: torch.Tensor,
                     bias: Optional[torch.Tensor],
                     act: Optional[str]) -> torch.Tensor:
    """Dequantize an exact int32 accumulator and apply bias + activation,
    in the reference's pinned order: cast to fp32; `y + bias / scale` when
    there is a bias (the add in the quantized domain); `y * scale`; then the
    activation. No multiply feeds an add, so no execution mode can contract
    the chain into an FMA: the same inputs give the same fp32 bits on every
    backend and in the kernels (relu exactly, gelu to about an ulp)."""
    y = acc_i32.to(torch.float32)
    if bias is not None:
        y = y + bias / scale
    y = y * scale
    if act is not None:
        y = ACTS[act](y)
    return y
