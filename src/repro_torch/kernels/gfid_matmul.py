"""FC mode of the multi-mode engine: the hand-written GEMM of
`csrc/gfid_matmul.cu` (the port of the Pallas kernel
`repro.kernels.gfid_matmul.gfid_matmul`) and its plain PyTorch version.

`gfid_matmul` launches the CUDA kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_matmul.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import gfid
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import ACT_CODES, apply_epilogue, check_act

# (rows of x, K chunk, columns) of one block: kBM, kKT, kBN in the source.
TILE = (8, 256, 32)


def gfid_matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The plain version: the FC mode's GEMM (`core.gfid.fc_gfid`), then
    bias and activation."""
    return apply_epilogue(gfid.fc_gfid(x, w), bias, act)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("gfid_matmul")
    fn = lib.gfid_matmul_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
           act: Optional[str]) -> None:
    check_act(act)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gfid_matmul takes (M, K) @ (K, N); got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (w.shape[1],):
        raise ValueError(f"bias must have shape ({w.shape[1]},); "
                         f"got {tuple(bias.shape)}")
    build.check_operands("gfid_matmul", x, w=w, bias=bias)


def gfid_matmul(x: torch.Tensor, w: torch.Tensor, *,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """x (M, K) fp32 @ w (K, N) fp32 -> (M, N) fp32, with the optional fused
    epilogue: `bias` (N,) added to the accumulator, then `act` ("relu" |
    "gelu")."""
    _check(x, w, bias, act)
    m, n = x.shape[0], w.shape[1]
    kind = x.device.type
    if kind == "cpu":
        return gfid_matmul_plain(x, w, bias=bias, act=act)
    if kind == "meta":
        return torch.empty((m, n), device="meta")
    if kind != "cuda":
        raise ValueError(f"gfid_matmul runs on CUDA or CPU tensors, not {kind}")
    out = torch.empty((m, n), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 m, x.shape[1], n, ACT_CODES[act], stream)
    build.check(lib, err, "gfid_matmul")
    gfid_matmul.launches += 1
    return out


gfid_matmul.launches = 0
