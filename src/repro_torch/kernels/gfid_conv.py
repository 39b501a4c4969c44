"""GFID convolution: the hand-written kernel of `csrc/gfid_conv.cu` (the port
of the Pallas kernel `repro.kernels.gfid_conv.gfid_conv2d_nhwc`) and its
plain PyTorch version.

Unlike the Pallas kernel, which takes an already padded input and one
group, the CUDA kernel takes `pad` (a bounds mask on its loads) and
`groups` (an axis of its launch grid), so a padded, grouped conv with its
bias and activation is one launch.

`gfid_conv2d_nhwc` launches the CUDA kernel for CUDA tensors, uses the
plain version for CPU tensors, and only allocates the output for `meta`
tensors (program capture). `gfid_conv2d_nhwc.launches` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core import gfid
from repro_torch.kernels import build
from repro_torch.kernels.epilogue import ACT_CODES, apply_epilogue, check_act

# (output pixels, C_in chunk, C_out) of one block pass: kPixTile, kCinTile,
# kCoutTile in the source.
TILE = (64, 8, 64)


def gfid_conv2d_nhwc_plain(x: torch.Tensor, w: torch.Tensor, *,
                           stride: int = 1, pad: int = 0, groups: int = 1,
                           bias: Optional[torch.Tensor] = None,
                           act: Optional[str] = None) -> torch.Tensor:
    """The plain version: the GFID shifted-GEMM lowering, then bias and
    activation."""
    return apply_epilogue(gfid.conv2d_gfid(x, w, stride, pad, groups),
                          bias, act)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("gfid_conv")
    fn = lib.gfid_conv2d_nhwc_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, w: torch.Tensor, stride: int, pad: int,
           groups: int, bias: Optional[torch.Tensor],
           act: Optional[str]) -> None:
    check_act(act)
    if x.ndim != 4 or w.ndim != 4:
        raise ValueError(f"expected NHWC x and HWIO w, got {tuple(x.shape)} "
                         f"{tuple(w.shape)}")
    c_in, c_out = x.shape[3], w.shape[3]
    if groups < 1 or c_in % groups or c_out % groups \
            or c_in // groups != w.shape[2]:
        raise ValueError(f"groups mismatch: C_in={c_in}, groups={groups}, "
                         f"w={tuple(w.shape)}")
    if stride < 1 or pad < 0 or x.shape[1] + 2 * pad < w.shape[0] \
            or x.shape[2] + 2 * pad < w.shape[1]:
        raise ValueError(f"invalid stride={stride} / pad={pad} for x "
                         f"{tuple(x.shape)} and filter {tuple(w.shape)}")
    if bias is not None and tuple(bias.shape) != (c_out,):
        raise ValueError(f"bias must have shape ({c_out},); "
                         f"got {tuple(bias.shape)}")
    build.check_operands("gfid_conv2d_nhwc", x, w=w, bias=bias)


def gfid_conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1,
                     pad: int = 0, groups: int = 1,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """Conv of x (B, H_in, W_in, C_in) NHWC fp32 with w (H_f, W_f,
    C_in/groups, C_out) HWIO fp32 after symmetric zero padding `pad`.
    Returns (B, H_out, W_out, C_out) fp32, with the optional fused
    epilogue: `bias` (C_out,) added to the accumulator, then `act`
    ("relu" | "gelu")."""
    _check(x, w, stride, pad, groups, bias, act)
    b, h_in, w_in, c_in = x.shape
    h_f, w_f, _, c_out = w.shape
    h_out = (h_in + 2 * pad - h_f) // stride + 1
    w_out = (w_in + 2 * pad - w_f) // stride + 1
    kind = x.device.type
    if kind == "cpu":
        return gfid_conv2d_nhwc_plain(x, w, stride=stride, pad=pad,
                                      groups=groups, bias=bias, act=act)
    if kind == "meta":
        return torch.empty((b, h_out, w_out, c_out), device="meta")
    if kind != "cuda":
        raise ValueError(f"gfid_conv2d_nhwc runs on CUDA or CPU tensors, "
                         f"not {kind}")
    out = torch.empty((b, h_out, w_out, c_out), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib, fn = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(),
                 None if bias is None else bias.data_ptr(), out.data_ptr(),
                 b, h_in, w_in, c_in, h_f, w_f, c_out, h_out, w_out,
                 stride, pad, groups, ACT_CODES[act], stream)
    build.check(lib, err, "gfid_conv2d_nhwc")
    gfid_conv2d_nhwc.launches += 1
    return out


gfid_conv2d_nhwc.launches = 0
