"""1-D depthwise mode of the multi-mode engine: the hand-written kernel of
`csrc/conv1d_depthwise.cu` (the port of the Pallas kernel
`repro.kernels.conv1d.gfid_conv1d_depthwise`) and its plain PyTorch version.

x (B, L, D) and taps w (W_f, D), fp32 or bf16, give an fp32 (B, L, D):
`out[b, l, d] = sum_i x[b, l + i - lpad, d] * w[i, d]` with zeros outside
the sequence, `lpad = W_f - 1` (causal) or `(W_f - 1) // 2` (centred). The
kernel sums the taps in ascending order from 0.0 with each product and sum
rounded on its own, so on the card it is bitwise equal to the plain version.

`gfid_conv1d_depthwise` launches the kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_conv1d_depthwise.launches` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import gfid
from repro_torch.kernels import build

# x, w, out; b, l, d; w_f, lpad, x_bf16, w_bf16; stream.
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3
            + [ctypes.c_int] * 4 + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)
# One block of the kernel (the plan's `tiling`): 256 consecutive outputs of
# the flattened (B, L, D), one a thread, each summing its W_f taps; kThreads
# in the source.
TILE = (1, 1, 256)


def gfid_conv1d_depthwise_plain(x: torch.Tensor, w: torch.Tensor, *,
                                causal: bool = True) -> torch.Tensor:
    """The plain version: the 1-D mode's shifted accumulation
    (`core.gfid.conv1d_shifted_sum`) for any W_f, fp32 out."""
    return gfid.conv1d_shifted_sum(x, w, causal=causal)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("conv1d_depthwise")
    fn = lib.conv1d_depthwise
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 3 or w.ndim != 2 or w.shape[1] != x.shape[2] \
            or w.shape[0] < 1:
        raise ValueError(f"gfid_conv1d_depthwise takes x (B, L, D) and w "
                         f"(W_f, D); got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in DTYPES:
            raise TypeError(f"gfid_conv1d_depthwise {name} must be fp32 or "
                            f"bf16, got {t.dtype}")
    build.check_operands("gfid_conv1d_depthwise", x=(x, x.dtype),
                         w=(w, w.dtype))


def gfid_conv1d_depthwise(x: torch.Tensor, w: torch.Tensor, *,
                          causal: bool = True) -> torch.Tensor:
    """x (B, L, D), w (W_f, D), each fp32 or bf16 -> fp32 (B, L, D): the
    depthwise conv, causal or centred, any D and any W_f."""
    _check(x, w)
    kind = x.device.type
    if kind == "cpu":
        return gfid_conv1d_depthwise_plain(x, w, causal=causal)
    if kind == "meta":
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    if kind != "cuda":
        raise ValueError(f"gfid_conv1d_depthwise runs on CUDA or CPU "
                         f"tensors, not {kind}")
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    b, l, d = x.shape
    w_f = w.shape[0]
    lib, fn = _launcher()
    bf16 = torch.bfloat16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), b, l, d, w_f,
                 gfid.conv1d_lpad(w_f, causal), int(x.dtype == bf16),
                 int(w.dtype == bf16), stream)
    build.check(lib, err, "gfid_conv1d_depthwise")
    gfid_conv1d_depthwise.launches += 1
    return out


gfid_conv1d_depthwise.launches = 0
