"""Paged-KV block gather: the hand-written copy of `csrc/paged_gather.cu`
(the port of the Pallas kernel `repro.kernels.paged.paged_gather`) and its
plain PyTorch version.

The serving pool (`serve.kv_pool`) keeps every request's cache as
fixed-size blocks of one `(num_blocks, block_size, *feature)` tensor,
addressed by a per-request block table. A decode step rebuilds each
request's dense `(blocks_per_req * block_size, *feature)` cache view from
its blocks: `out[b, j*bs:(j+1)*bs] = pool[table[b, j]]`, bitwise, for any
element type. Block 0 is the reserved dummy block and is copied like any
other.

`paged_gather` launches the kernel for CUDA tensors, uses the plain version
for CPU tensors, and only allocates the output for `meta` tensors (program
capture). `paged_gather.launches` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import build

# pool, table, out; block_bytes; num_blocks, batch, blocks_per_req, unit; stream.
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
# The copy units the kernel takes, widest first (bytes).
UNITS = (16, 8, 4, 2, 1)


def _out_shape(pool: torch.Tensor, table: torch.Tensor) -> Tuple[int, ...]:
    b, blocks_per_req = table.shape
    return (b, blocks_per_req * pool.shape[1]) + tuple(pool.shape[2:])


def paged_gather_plain(pool: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The plain version: `pool.index_select(0, table.flatten())`, reshaped
    to (B, blocks_per_req * block_size, *feature). An id outside
    [0, num_blocks) raises `IndexError`."""
    return pool.index_select(0, table.reshape(-1)).reshape(
        _out_shape(pool, table))


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = build.library("paged_gather")
    fn = lib.paged_gather
    fn.argtypes = ARGTYPES
    fn.restype = ctypes.c_int
    return lib, fn


def _check(pool: torch.Tensor, table: torch.Tensor) -> None:
    if pool.ndim < 2 or table.ndim != 2:
        raise ValueError(f"paged_gather takes pool (num_blocks, block_size, "
                         f"*feature) and table (B, blocks_per_req); got "
                         f"{tuple(pool.shape)} and {tuple(table.shape)}")
    # the common case in one short test; anything else is named by
    # check_operands
    if table.dtype is torch.int32 and pool.is_contiguous() \
            and table.is_contiguous() and pool.device == table.device:
        return
    build.check_operands("paged_gather", pool=(pool, pool.dtype),
                         table=(table, torch.int32))


def copy_unit(block_bytes: int, *pointers: int) -> int:
    """The widest copy unit that divides the block's byte length and every
    pointer: the lowest set bit of their OR, at most UNITS[0]."""
    v = block_bytes | UNITS[0]
    for p in pointers:
        v |= p
    return v & -v


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool (num_blocks, block_size, *feature), any dtype; table
    (B, blocks_per_req) int32 -> (B, blocks_per_req * block_size, *feature),
    bitwise `pool[table[b, j]]` for block j of request b. On the card an id
    outside [0, num_blocks) stops the kernel before it reads (the launch
    fails and the next synchronisation raises); on the CPU it raises
    `IndexError`."""
    _check(pool, table)
    if not pool.is_cuda:
        kind = pool.device.type
        if kind == "cpu":
            return paged_gather_plain(pool, table)
        if kind == "meta":
            return torch.empty(_out_shape(pool, table), dtype=pool.dtype,
                               device="meta")
        raise ValueError(f"paged_gather runs on CUDA or CPU tensors, not {kind}")
    out = pool.new_empty(_out_shape(pool, table))
    if out.numel() == 0:
        return out
    block_bytes = math.prod(pool.shape[1:]) * pool.element_size()
    pool_ptr, out_ptr = pool.data_ptr(), out.data_ptr()
    index = pool.get_device()
    lib, fn = _launcher()
    with build.on_device(index):
        err = fn(pool_ptr, table.data_ptr(), out_ptr, block_bytes,
                 pool.shape[0], table.shape[0], table.shape[1],
                 copy_unit(block_bytes, pool_ptr, out_ptr),
                 build.raw_stream(index))
    build.check(lib, err, "paged_gather")
    paged_gather.launches += 1
    return out


paged_gather.launches = 0
