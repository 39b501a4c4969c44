"""1-D depthwise mode of the multi-mode engine: the hand-written kernel of
`csrc/conv1d_depthwise.cu` (the port of the Pallas kernel
`repro.kernels.conv1d.gfid_conv1d_depthwise`) and its plain PyTorch version.

x (B, L, D) and taps w (W_f, D), fp32 or bf16, give an fp32 (B, L, D):
`out[b, l, d] = sum_i x[b, l + i - lpad, d] * w[i, d]` with zeros outside
the sequence, `lpad = W_f - 1` (causal) or `(W_f - 1) // 2` (centred). The
kernel sums the taps in ascending order from 0.0 with each product and sum
rounded on its own, so on the card it is bitwise equal to the plain version.

A block of the kernel owns TILE's positions x channels of one sequence:
up to REG_TAPS taps it loads the tile's rows with their halo into registers
and slides a W_f-row window down them; with more taps it stages the rows in
shared memory TAP_CHUNK taps at a time. `launch_plan` says which, and
whether the loads are vectors.

`gfid_conv1d_depthwise` launches the kernel for CUDA tensors, uses the plain
version for CPU tensors, and only allocates the output for `meta` tensors
(program capture). `gfid_conv1d_depthwise.launches` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.core import gfid
from repro_torch.kernels import build

# x, w, out; b, l, d, w_f, lpad, x_bf16, w_bf16, vec; stream.
ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
DTYPES = (torch.float32, torch.bfloat16)
# One block of the kernel (the plan's `tiling`): one sequence, kT
# consecutive positions, kC channels (4 a thread, one warp); kT and kC in
# the source.
TILE = (1, 8, 128)
# W_f up to REG_TAPS (kRegTaps): the register window; above it the tile's
# rows staged in shared memory, TAP_CHUNK (kTapChunk) taps a piece.
REG_TAPS = 8
TAP_CHUNK = 32


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


class Conv1dPlan(NamedTuple):
    """One launch of `conv1d_depthwise`: the zero rows before the sequence,
    the shared-memory path (`staged`, for W_f above REG_TAPS) or the
    register window, float4 loads and stores (`vec`), and the grid (tiles
    of L times B, tiles of D, 1): any B, and D up to 65,535 x TILE[2]."""
    lpad: int
    staged: bool
    vec: bool
    grid: Tuple[int, int, int]


def launch_plan(b: int, l: int, d: int, w_f: int, causal: bool,
                x_ptr: int = 0) -> Conv1dPlan:
    """The launch for x (b, l, d) at `x_ptr` and w_f taps: vector loads
    where d % 4 == 0 and x is 16-byte aligned (the output, allocated by the
    wrapper, always is)."""
    lpad, staged, grid = _tiling(b, l, d, w_f, causal)
    return Conv1dPlan(lpad, staged, d % 4 == 0 and x_ptr % 16 == 0, grid)


@functools.lru_cache(maxsize=1024)
def _tiling(b: int, l: int, d: int, w_f: int,
            causal: bool) -> Tuple[int, bool, Tuple[int, int, int]]:
    """launch_plan's shape part, cached (the launch path runs it at every
    call)."""
    grid = (-(-l // TILE[1]) * b, -(-d // TILE[2]), 1)
    build.check_grid("gfid_conv1d_depthwise", grid)
    return gfid.conv1d_lpad(w_f, causal), w_f > REG_TAPS, grid


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
    if x.is_cuda:
        out = x.new_empty(x.shape, dtype=torch.float32)
        if out.numel():
            _launch(x, w, out, causal)
        return out
    kind = x.device.type
    if kind == "cpu":
        return gfid_conv1d_depthwise_plain(x, w, causal=causal)
    if kind == "meta":
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    raise ValueError(f"gfid_conv1d_depthwise runs on CUDA or CPU tensors, "
                     f"not {kind}")


def _launch(x, w, out, causal) -> None:
    """`conv1d_depthwise` on CUDA tensors into `out` with its plan, on the
    current stream of x's device (made current only when it is another);
    raise on a refused launch, count it."""
    b, l, d = x.shape
    w_f = w.shape[0]
    index = x.get_device()
    x_ptr = x.data_ptr()
    plan = launch_plan(b, l, d, w_f, causal, x_ptr)
    lib, fn = _launcher()
    bf16 = torch.bfloat16
    with build.on_device(index):
        err = fn(x_ptr, w.data_ptr(), out.data_ptr(), b, l, d, w_f,
                 plan.lpad, int(x.dtype is bf16), int(w.dtype is bf16),
                 int(plan.vec), build.raw_stream(index))
    build.check(lib, err, "gfid_conv1d_depthwise")
    gfid_conv1d_depthwise.launches += 1


gfid_conv1d_depthwise.launches = 0
