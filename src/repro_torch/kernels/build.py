"""Build the hand-written CUDA kernels of `csrc/` and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own by
`nvcc` for Hopper (`sm_90a`) into a shared library under
`build/repro_torch/` at the root of the checkout. The file name carries a
hash of the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is rebuilt and an unchanged one is loaded as it is. Nothing is built when this module is
imported: the first call of a kernel on a CUDA tensor builds it, and
`build_all` builds every source at once (one `nvcc` each, in parallel).

A failed build raises with the compiler's output. There is no fallback.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("gfid_conv", "gfid_matmul", "gfid_conv_bf16", "gfid_matmul_bf16",
           "gfid_conv_int8", "gfid_matmul_int8", "paged_gather",
           "conv1d_depthwise", "flash_attention", "flash_attention_bf16")
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError(f"nvcc not found on PATH or at {NVCC_DEFAULT}: the "
                       "CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the shared library of `csrc/<name>.cu` lives for this source,
    the headers of `csrc/` and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile(name: str) -> Tuple[Path, str, float]:
    """Compile `csrc/<name>.cu` unless its library exists. Returns the
    library path, the compiler's output (register and shared-memory use from
    `-Xptxas -v`) and the seconds spent."""
    lib = library_path(name)
    if lib.exists():
        return lib, "", 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)        # atomic: a parallel build never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, proc.stdout + proc.stderr, time.perf_counter() - t0


# csrc/epilogue.cuh's `repro_cuda_error_string(int e)`, in every library.
ERROR_STRING_ARGTYPES = [ctypes.c_int]


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of `csrc/<name>.cu`, built on first use."""
    lib = ctypes.CDLL(str(_compile(name)[0]))
    lib.repro_cuda_error_string.argtypes = ERROR_STRING_ARGTYPES
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every source in parallel, one `nvcc` per source, all started
    together. Returns {name: (seconds, compiler output)}; raises if any
    build failed, after every process has ended."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        futures = {name: pool.submit(_compile, name) for name in SOURCES}
    return {name: (f.result()[2], f.result()[1]) for name, f in futures.items()}


def check_operands(kernel: str, **operands) -> None:
    """What every launcher takes: each operand, given as `name=(tensor,
    dtype)` with the dtype that launcher reads (or a tuple of the dtypes
    it reads, told apart by a flag), has that dtype, is contiguous and lies
    on the device of the first operand. A tensor of None (an absent bias)
    is skipped. A wrong dtype raises: the kernel would read its bytes as
    another type."""
    device = None
    for name, (t, dtype) in operands.items():
        if t is None:
            continue
        allowed = dtype if isinstance(dtype, tuple) else (dtype,)
        if t.dtype not in allowed:
            want = " or ".join(str(d) for d in allowed)
            raise TypeError(f"{kernel} {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} {name} must be contiguous")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{kernel} {name} is on {t.device}, the first "
                             f"operand on {device}")


def check_float_operands(kernel: str, x: torch.Tensor, w: torch.Tensor,
                         bias: Optional[torch.Tensor]) -> bool:
    """The operands of a source with an fp32 and a bf16 entry: x and w both
    fp32 or both bf16, bias fp32 (or bf16 beside bf16 operands), each as
    `check_operands` asks. Returns whether they are bf16. Operands that
    pass take one short test (a launch's host time); any other goes through
    `check_operands`, which names what is wrong."""
    f32, bf16 = torch.float32, torch.bfloat16
    dt = x.dtype
    if (dt is f32 or dt is bf16) and w.dtype is dt \
            and x.is_contiguous() and w.is_contiguous() \
            and (bias is None or ((bias.dtype is f32 or bias.dtype is dt)
                                  and bias.is_contiguous())):
        device = x.device
        if w.device == device and (bias is None or bias.device == device):
            return dt is bf16
    check_operands(kernel, x=(x, (f32, bf16)))
    is_bf16 = x.dtype == bf16
    check_operands(kernel, x=(x, x.dtype), w=(w, x.dtype),
                   bias=(bias, (f32, bf16) if is_bf16 else f32))
    return is_bf16


def check_int8_operands(kernel: str, xq: torch.Tensor, wq: torch.Tensor,
                        sx: torch.Tensor, sw: torch.Tensor,
                        bias: Optional[torch.Tensor]) -> None:
    """The operands of an int8 kernel: int8 xq and wq, fp32 scales and
    bias, each as `check_operands` asks. Operands that pass take one short
    test (a launch's host time); any other goes through `check_operands`,
    which names what is wrong."""
    i8, f32 = torch.int8, torch.float32
    dev = xq.device
    if (xq.dtype is i8 and wq.dtype is i8 and sx.dtype is f32
            and sw.dtype is f32 and xq.is_contiguous() and wq.is_contiguous()
            and sx.is_contiguous() and sw.is_contiguous()
            and wq.device == dev and sx.device == dev and sw.device == dev
            and (bias is None or (bias.dtype is f32 and bias.is_contiguous()
                                  and bias.device == dev))):
        return
    check_operands(kernel, xq=(xq, i8), wq=(wq, i8), sx=(sx, f32),
                   sw=(sw, f32), bias=(bias, f32))


def stored_dtype(is_bf16: bool,
                 out_dtype: Optional[torch.dtype]) -> torch.dtype:
    """What such a kernel stores from its fp32 epilogue: bf16 where bf16 is
    asked for on bf16 operands, else fp32. Its wrapper casts that to any
    other `out_dtype`."""
    return torch.bfloat16 if is_bf16 and out_dtype == torch.bfloat16 \
        else torch.float32


class Launches:
    """The launch count of a kernel whose wrapper launches another kernel
    too (the bf16 entry of a source beside its fp32 entry, counted on the
    wrapper itself): `.launches`, as a wrapper function carries it. Not
    callable: the wrapper takes both dtypes."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self.launches = 0

    def __repr__(self) -> str:
        return f"Launches({self.kernel!r}, launches={self.launches})"


# The int8 kernels' int32 accumulators hold K * 127**2 at most.
INT8_MAX_K = (2 ** 31 - 1) // (127 * 127)


def check_int8_depth(kernel: str, k: int) -> None:
    if k > INT8_MAX_K:
        raise ValueError(f"{kernel}: a contraction depth of {k} could "
                         f"overflow the int32 accumulator (at most "
                         f"{INT8_MAX_K})")


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# csrc/mma_bf16.cuh, the bf16 kernels' tensor-core core: the K chunk (kBK)
# and the block tiles (rows, columns) that `mma::with_tile` is built for.
MMA_BK = 32
MMA_TILES = ((16, 64), (32, 64), (64, 64), (128, 128))
# CUDA's limits on a launch grid's x, y and z.
GRID_LIMITS = (2 ** 31 - 1, 65535, 65535)


class MmaPlan(NamedTuple):
    """One launch of a block-tiled GEMM or implicit-GEMM kernel (the bf16
    tensor-core pair, the fp32 conv, the int8 pair): a block tile of `bm`
    rows x `bn` columns, K cut into `splits` runs of `chunks_per_split`
    chunks of the kernel's depth (one split, or a fold: no workspace),
    16-byte copies of x and of w where `vec_x` and `vec_w` allow (the int8
    GEMM's `vec_w` is the bytes a copy of w, 16, 8 or 0), and the launch
    grid."""
    bm: int
    bn: int
    splits: int
    chunks_per_split: int
    vec_x: bool
    vec_w: Union[bool, int]
    grid: Tuple[int, int, int]

    @property
    def fold(self) -> bool:
        """Whether each block runs every split of K and adds them itself, in
        split order (grid z is 1 under several splits): no workspace."""
        return self.splits > 1 and self.grid[2] == 1


def mma_split(k: int, want: int, min_chunks: int,
              chunk: int = MMA_BK) -> Tuple[int, int]:
    """(splits, chunks per split) for a contraction of depth k in chunks of
    `chunk` (MMA_BK for the tensor-core kernels): at most `want` splits,
    each at least `min_chunks` chunks deep (one split when K is shorter),
    none empty."""
    n = max(-(-k // chunk), 1)
    splits = max(1, min(want, n // min_chunks))
    per = -(-n // splits)
    return -(-n // per), per


def check_grid(kernel: str, grid: Tuple[int, int, int]) -> None:
    if any(g > lim for g, lim in zip(grid, GRID_LIMITS)):
        raise ValueError(f"{kernel}: launch grid {grid} exceeds CUDA's "
                         f"{GRID_LIMITS}")


def mma_workspace(plan: MmaPlan, rows: int, cols: int,
                  device: torch.device) -> Optional[torch.Tensor]:
    """The fp32 partial sums of a split launch, (splits, rows, cols), not
    zeroed (the kernel writes every element); None for one split or a
    fold."""
    if plan.splits == 1 or plan.fold:
        return None
    return torch.empty((plan.splits, rows, cols), dtype=torch.float32,
                       device=device)


_CURRENT = contextlib.nullcontext()


def on_device(index: int):
    """The context a launch on CUDA device `index` runs in: that device made
    current for the launch, or nothing when it is current already (the
    common case, and the cheaper one on the host)."""
    if index == torch.cuda.current_device():
        return _CURRENT
    return torch.cuda.device(index)


def raw_stream(index: int) -> int:
    """The current stream of CUDA device `index` as the integer handle a
    launcher takes (`cudaStream_t`), without building a `torch.cuda.Stream`
    object as `torch.cuda.current_stream(index).cuda_stream` does."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
