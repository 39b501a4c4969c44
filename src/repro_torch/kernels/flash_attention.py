"""Online-softmax attention forward: the hand-written kernels that port the
Pallas kernel `repro.kernels.flash_attention.flash_attention`, and their
plain PyTorch version. `csrc/flash_attention.cu` (entry `flash_attention`)
takes fp32 q, k, v on the CUDA cores (two register-tiled products around an
online softmax, in blocks of Q_ROWS q rows); `csrc/flash_attention_bf16.cu`
(entry `flash_attention_bf16`) takes bf16 q, k, v on the tensor cores (bf16
`mma.sync` with fp32 accumulators, p carried as a bf16 pair).

q (B, Sq, H, D) and k, v (B, Skv, KV, D), fp32 or bf16, with H a multiple
of KV: query head h reads kv head `h // (H // KV)`, which equals the
reference's `jnp.repeat` of the kv heads. The result is
`softmax(scale * q k^T) v` per head in fp32, causal (positions from 0 for q
and k) or not, returned in q's dtype as (B, Sq, H, D).

`flash_attention` launches the kernel of the operands' dtype for CUDA
tensors, uses the plain version for CPU tensors, and only allocates the
output for `meta` tensors (program capture). `flash_attention.launches`
counts the fp32 kernel's launches, `flash_attention_bf16.launches` the bf16
kernel's; `flash_attention_noncausal.launches` and
`flash_attention_bf16_noncausal.launches` count those of each that were
not causal (cross attention) once more.
There is no backward: an input that requires a gradient raises (ROADMAP
queue 1, item 13).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quant import no_tf32
from repro_torch.kernels import build

# q, k, v, out; b, sq, skv, h, n_kv, d; scale; causal, vec (16-byte
# copies); stream. Both entries take the same arguments.
ARGTYPES = BF16_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                            + [ctypes.c_float] + [ctypes.c_int] * 2
                            + [ctypes.c_void_p])
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
# The fp32 kernel's block in csrc/flash_attention.cu: q rows (kBQ, 4 rows a
# thread, 16 threads a row) and keys a kv tile (kBK); the plain version
# walks the keys in tiles of the same size.
Q_ROWS, KV_TILE = 32, 64
# The bf16 kernel's block: q rows (kBQ, 16 a warp of 4) and keys a kv tile
# (kBK) in csrc/flash_attention_bf16.cu.
BF16_Q_ROWS, BF16_KV_TILE = 64, 128
NEG_INF = -1.0e30           # the Pallas kernel's mask value


def _scale(d: int, scale: Optional[float]) -> float:
    return float(scale) if scale is not None else 1.0 / math.sqrt(d)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          scale: Optional[float] = None) -> torch.Tensor:
    """The plain version: the kernel's online softmax over kv tiles of
    KV_TILE keys, in fp32 with TF32 off (masked scores NEG_INF, the sum
    clamped at 1e-30, as the Pallas kernel), returned in q's dtype."""
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    sc = _scale(d, scale)
    qg = q.float().reshape(b, sq, n_kv, g, d)
    kf, vf = k.float(), v.float()
    qp = torch.arange(sq, device=q.device)
    m = torch.full((b, n_kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, d), device=q.device)
    neg = torch.full((), NEG_INF, device=q.device)
    with no_tf32():
        for k0 in range(0, skv, KV_TILE):
            kt, vt = kf[:, k0:k0 + KV_TILE], vf[:, k0:k0 + KV_TILE]
            s = torch.einsum("bskgd,bukd->bkgsu", qg, kt) * sc
            if causal:
                kp = torch.arange(k0, k0 + kt.shape[1], device=q.device)
                s = torch.where(qp[:, None] >= kp[None, :], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum("bkgsu,bukd->bkgsd",
                                                        p, vt)
            m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


@functools.lru_cache(maxsize=None)
def _launcher_bf16():
    lib = build.library("flash_attention_bf16")
    fn = lib.flash_attention_bf16
    fn.argtypes = BF16_ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


class F32Launch(NamedTuple):
    """One launch of the fp32 `flash_attention`: its grid (q tiles x heads
    x batch, 1, 1) and whether q, k and v go by 16-byte copies."""
    grid: Tuple[int, int, int]
    vec: bool


def f32_launch(b: int, sq: int, h: int, d: int, *ptrs: int) -> F32Launch:
    """The launch of the fp32 kernel for q (b, sq, h, d) at the addresses
    `ptrs` (of q, k and v): 16-byte copies for d % 4 == 0 on 16-byte
    aligned pointers, else element loads; raises where the grid passes
    CUDA's limits."""
    grid = (-(-sq // Q_ROWS) * h * b, 1, 1)
    build.check_grid("flash_attention", grid)
    return F32Launch(grid, d % 4 == 0 and all(p % 16 == 0 for p in ptrs))


class Bf16Launch(NamedTuple):
    """One launch of `flash_attention_bf16`: its grid (q tiles x heads,
    batch, 1), the head dim padded with zeros to the kernel's DP, and
    whether q, k and v go by 16-byte copies."""
    grid: Tuple[int, int, int]
    d_pad: int
    vec: bool


def bf16_launch(b: int, sq: int, h: int, d: int, *ptrs: int) -> Bf16Launch:
    """The launch of the bf16 kernel for q (b, sq, h, d) at the addresses
    `ptrs` (of q, k and v): 16-byte copies for d % 8 == 0 on 16-byte
    aligned pointers, else element loads; raises where the grid passes
    CUDA's limits."""
    grid = (-(-sq // BF16_Q_ROWS) * h, b, 1)
    build.check_grid("flash_attention_bf16", grid)
    d_pad = next(p for p in (16, 32, 64, 128) if d <= p)
    return Bf16Launch(grid, d_pad, d % 8 == 0 and all(p % 16 == 0 for p in ptrs))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention takes q (B, Sq, H, D) and k, v "
                         f"(B, Skv, KV, D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    if n_kv < 1 or h % n_kv:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {n_kv} kv heads")
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention takes a head dim of 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if skv < 1:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention q must be fp32 or bf16, got "
                        f"{q.dtype}")
    if any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet; see ROADMAP queue 1, "
            "item 13 (training)")
    build.check_operands("flash_attention", q=(q, q.dtype), k=(k, q.dtype),
                         v=(v, q.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Skv, KV, D), all fp32 (entry
    `flash_attention`, counted by `flash_attention.launches`) or all bf16
    (entry `flash_attention_bf16`, counted by
    `flash_attention_bf16.launches`), D <= 128 -> (B, Sq, H, D) in q's
    dtype: attention with an fp32 online softmax, causal or not, scale
    1/sqrt(D) unless given."""
    _check(q, k, v)
    kind = q.device.type
    if kind == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if kind == "meta":
        return torch.empty(q.shape, dtype=q.dtype, device="meta")
    if kind != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, not "
                         f"{kind}")
    out = torch.empty_like(q)
    if out.numel():
        _launch(q, k, v, out, causal, scale)
    return out


def _launch(q, k, v, out, causal, scale) -> None:
    """The kernel of q's dtype on (q, k, v) into `out`, counted."""
    b, sq, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    dims = (b, sq, k.shape[1], h, k.shape[2], d, _scale(d, scale), int(causal))
    is_bf16 = q.dtype == torch.bfloat16
    plan = (bf16_launch if is_bf16 else f32_launch)(b, sq, h, d, *ptrs[:3])
    lib, fn = _launcher_bf16() if is_bf16 else _launcher()
    dims += (int(plan.vec),)
    with torch.cuda.device(q.device):
        err = fn(*ptrs, *dims, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "flash_attention_bf16" if is_bf16 else "flash_attention")
    (flash_attention_bf16 if is_bf16 else flash_attention).launches += 1
    if not causal:
        (flash_attention_bf16_noncausal if is_bf16
         else flash_attention_noncausal).launches += 1


flash_attention.launches = 0
flash_attention_bf16 = build.Launches("flash_attention_bf16")
flash_attention_noncausal = build.Launches("flash_attention")
flash_attention_bf16_noncausal = build.Launches("flash_attention_bf16")
