"""Fused-epilogue activation registry.

"gelu" is the tanh approximation, as in the JAX package (`jax.nn.gelu(
approximate=True)`). The hand-written kernels apply the same bias-then-
activation order to their fp32 accumulator (`apply_act` in `csrc/epilogue.cuh`,
selected by `ACT_CODES`); the plain versions and the "torch"/"ref"
backends apply it after the op with `apply_epilogue`.
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
    the activation."""
    if bias is not None:
        out = out + bias
    if act is not None:
        out = ACTS[act](out)
    return out
