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

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("gfid_conv", "gfid_matmul")
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


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library of `csrc/<name>.cu`, built on first use."""
    lib = ctypes.CDLL(str(_compile(name)[0]))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
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


def check_operands(kernel: str, x, **others) -> None:
    """What every launcher takes: fp32, contiguous tensors on x's device
    (entries of `others` may be None)."""
    for name, t in (("x", x), *others.items()):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel} {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{kernel} {name} is on {t.device}, x on "
                             f"{x.device}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
