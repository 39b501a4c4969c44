"""FC mode of the multi-mode engine: the hand-written GEMMs of
`csrc/gfid_matmul.cu` (fp32; the port of the Pallas kernel
`repro.kernels.gfid_matmul.gfid_matmul`) and `csrc/gfid_matmul_int8.cu`
(int8 operands, exact int32 accumulator, fused dequant; the port of
`gfid_matmul_int8`), each with its plain PyTorch version.

Each wrapper launches its CUDA kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_matmul.launches` and `gfid_matmul_int8.launches`
count the kernels' launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import gfid, quant
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import (ACT_CODES, apply_epilogue,
                                         check_act, dequant_epilogue)

# (rows of x, K chunk, columns) of one block: kBM, kKT, kBN in the source.
TILE = (8, 256, 32)
# The same for csrc/gfid_matmul_int8.cu.
TILE_INT8 = (8, 256, 64)


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
    f32 = torch.float32
    build.check_operands("gfid_matmul", x=(x, f32), w=(w, f32),
                         bias=(bias, f32))


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


# ---------------------------------------------------------------------------
# int8
# ---------------------------------------------------------------------------

def gfid_matmul_int8_plain(xq: torch.Tensor, wq: torch.Tensor,
                           sx: torch.Tensor, sw: torch.Tensor, *,
                           bias: Optional[torch.Tensor] = None,
                           act: Optional[str] = None) -> torch.Tensor:
    """The plain version: the exact int32 product (`quant.int8_matmul_i32`),
    then `dequant_epilogue` with scale sx * sw."""
    return dequant_epilogue(quant.int8_matmul_i32(xq, wq), sx * sw, bias, act)


# xq, wq, sx, sw, bias, out, ws, tickets; M, K, N, splits, chunks_per_split,
# act, vec_x, vec_w; stream.
INT8_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _launcher_int8():
    lib = build.library("gfid_matmul_int8")
    fn = lib.gfid_matmul_int8
    fn.argtypes = INT8_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _check_int8(xq, wq, sx, sw, bias, act) -> None:
    check_act(act)
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f"gfid_matmul_int8 takes (M, K) @ (K, N); got "
                         f"{tuple(xq.shape)} @ {tuple(wq.shape)}")
    m, n = xq.shape[0], wq.shape[1]
    if tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(f"scales must be sx ({m}, 1) and sw (1, {n}); got "
                         f"{tuple(sx.shape)} and {tuple(sw.shape)}")
    if bias is not None and tuple(bias.shape) != (n,):
        raise ValueError(f"bias must have shape ({n},); "
                         f"got {tuple(bias.shape)}")
    build.check_int8_depth("gfid_matmul_int8", xq.shape[1])
    i8, f32 = torch.int8, torch.float32
    build.check_operands("gfid_matmul_int8", xq=(xq, i8), wq=(wq, i8),
                         sx=(sx, f32), sw=(sw, f32), bias=(bias, f32))


def gfid_matmul_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                     sw: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """xq (M, K) int8 @ wq (K, N) int8 -> (M, N) fp32: the exact int32 sum,
    dequantized with the per-row scales `sx` (M, 1) and per-column scales
    `sw` (1, N), with the optional `bias` (N,) and `act` ("relu" | "gelu")
    fused into the same epilogue."""
    _check_int8(xq, wq, sx, sw, bias, act)
    (m, k), n = xq.shape, wq.shape[1]
    kind = xq.device.type
    if kind == "cpu":
        return gfid_matmul_int8_plain(xq, wq, sx, sw, bias=bias, act=act)
    if kind == "meta":
        return torch.empty((m, n), device="meta")
    if kind != "cuda":
        raise ValueError(f"gfid_matmul_int8 runs on CUDA or CPU tensors, "
                         f"not {kind}")
    out = torch.empty((m, n), device=xq.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    bm, kt, bn = TILE_INT8
    tiles = -(-n // bn) * -(-m // bm)
    splits, per = build.split_k(tiles, -(-k // kt),
                                build.sm_count(xq.device.index or 0))
    ws, ws_ptr, tickets_ptr = build.split_workspace(splits, m * n, tiles,
                                                    xq.device)
    lib, fn = _launcher_int8()
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 ws_ptr, tickets_ptr, m, k, n, splits, per, ACT_CODES[act],
                 int(k % 4 == 0 and xq.data_ptr() % 4 == 0),
                 int(n % 4 == 0 and wq.data_ptr() % 4 == 0), stream)
    build.check(lib, err, "gfid_matmul_int8")
    gfid_matmul_int8.launches += 1
    return out


gfid_matmul_int8.launches = 0
