"""Plan-guided kernel autotuner for the "cuda" backend: the port of the
reference's `engine/tune.py`.

The paper's whole argument (§4, Table 4) is that a fixed PE array only
sustains high utilization when the *schedule* adapts per layer. Each conv
and GEMM entry of `csrc/` compiles a few block tiles, and each launch plan
picks one by a fixed rule from M (or the output pixels) and the SM count.
This module closes the loop:

  * per op, keyed by a *stable* hash of the canonical `OpSpec` plus
    backend, accumulation label, precision and operand dtype, the
    candidates are the block tiles the op's entry launches at its shape
    (`tiles_for` of `kernels/gfid_matmul.py` and `kernels/gfid_conv.py`),
  * scored analytically (one block's padded MACs and a fixed cost, times
    the waves of blocks over the SMs: the Hopper counterpart of the
    reference's padding, launch and VMEM model) and cut to
    `MAX_CANDIDATES`,
  * timed on the card with CUDA events (a CUDA graph of `BENCH_LAUNCHES`
    launches, the least of `BENCH_REPEATS` replays), and
  * the winner persisted to a versioned JSON cache,
    `.tuning/repro_torch/<device_kind>.json` at the root of the checkout.

`EngineConfig.tuning` selects the behavior: "off" (the kernels' rules),
"cached" (a cache hit pins its tile, a miss keeps the rule) or "autotune"
(`engine.compile` times the candidates of each miss and persists the
winner; timing needs a CUDA device, and raises without one). Resolution
happens at `engine.compile`, which pins each op's `tile_config` into its
exec pairs; the eager API performs cached lookups only.

A tile never touches K's split: the fp32 and bf16 plans take it from
(K, N), or from one image's plan, whatever the tile, and int8 sums are
exact in any order. So a tuned op gives the bits of the untuned one, and
dense keys drop the rows (M) and conv keys the batch: one tile serves
every bucket of a program, and the schedulers' bitwise contracts survive
tuning.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import quant
from repro_torch.engine import plan as planlib
from repro_torch.engine.config import EngineConfig
from repro_torch.kernels import gfid_conv, gfid_matmul

Tile = Tuple[int, int]

# The port's cache files, apart from the reference's: (bm, bn) tiles of
# the CUDA entries, keyed with the operand dtype.
CACHE_VERSION = 1
CACHE_DIR_ENV = "REPRO_TORCH_TUNING_DIR"
MAX_CANDIDATES = 6          # timed per op after the analytic order
BENCH_REPEATS = 3           # least of N graph replays per candidate
BENCH_LAUNCHES = 20         # launches in the timed CUDA graph
# One wave of blocks over the SMs, priced in one SM's MAC-equivalents:
# about 2 µs of an H100 SM's fp32 rate (33.5 T MAC/s over 132 SMs), a
# wave's fill and drain. The score `waves * (block_macs + WAVE_MACS)` only
# orders the candidates.
WAVE_MACS = 1 << 19
DEFAULT_SMS = 132           # an H100 SXM's, where no card is present


def _default_dir() -> Path:
    """`.tuning/repro_torch/` at the root of the checkout (walking up from
    this file for a pyproject.toml or .git), else relative to the working
    directory."""
    for parent in Path(__file__).resolve().parents:
        if (parent / "pyproject.toml").exists() or (parent / ".git").exists():
            return parent / ".tuning" / "repro_torch"
    return Path(".tuning") / "repro_torch"


_dir_override: Optional[Path] = None
_MEMO: Dict[str, dict] = {}      # device_kind -> cache, read through


# ---------------------------------------------------------------------------
# Cache location / persistence
# ---------------------------------------------------------------------------

def cache_dir() -> Path:
    """Directory holding the `<device_kind>.json` tile caches: the
    `set_cache_dir()` override, then $REPRO_TORCH_TUNING_DIR, then
    `.tuning/repro_torch/` at the root of the checkout."""
    if _dir_override is not None:
        return _dir_override
    env = os.environ.get(CACHE_DIR_ENV)
    return Path(env) if env else _default_dir()


def set_cache_dir(path: Optional[os.PathLike]) -> None:
    """Override the cache directory (None restores the default). Drops the
    in-memory memo, so the next lookup reads the disk again."""
    global _dir_override
    _dir_override = Path(path) if path is not None else None
    _MEMO.clear()


def device_kind() -> str:
    """The device the cache is keyed by, safe for a file name: the current
    CUDA device's name lowercased (e.g. "nvidia_h100_80gb_hbm3"), "cpu"
    without one."""
    name = torch.cuda.get_device_name() if torch.cuda.is_available() \
        else "cpu"
    return "".join(c if c.isalnum() else "_" for c in name.lower())


def cache_path(kind: Optional[str] = None) -> Path:
    return cache_dir() / f"{kind or device_kind()}.json"


def load_cache(kind: Optional[str] = None) -> dict:
    """The (memoized) cache for `kind`. A missing, unreadable, corrupted or
    stale-versioned file degrades to an empty cache: tuning then keeps the
    kernels' rules instead of failing the run."""
    kind = kind or device_kind()
    if kind in _MEMO:
        return _MEMO[kind]
    cache = {"version": CACHE_VERSION, "device_kind": kind, "entries": {}}
    try:
        raw = json.loads(cache_path(kind).read_text())
        if (isinstance(raw, dict) and raw.get("version") == CACHE_VERSION
                and isinstance(raw.get("entries"), dict)):
            cache = raw
    except (OSError, ValueError):
        pass
    _MEMO[kind] = cache
    return cache


def save_cache(kind: Optional[str] = None) -> Path:
    """Write the in-memory cache for `kind` to disk, crash-safely: the JSON
    lands in a uniquely named temporary file in the cache directory, is
    fsync'd, then `os.replace`d over the cache (atomic on one file system).
    A crash leaves the old cache or the new one, never a truncated file,
    and two savers never share a temporary file; it is unlinked on any
    failure."""
    kind = kind or device_kind()
    cache = load_cache(kind)
    path = cache_path(kind)
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(json.dumps(cache, indent=2, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return path


# ---------------------------------------------------------------------------
# Stable op keys
# ---------------------------------------------------------------------------

def _canonical_dense(op: planlib.OpSpec) -> Optional[Tuple[int, int, int]]:
    """(M, K, N) of a dense op the GEMM kernel runs as one (M, K) @ (K, N)
    (`plan.canonical_gemm`, the test `dispatch._cuda_einsum` makes), else
    None: grouped GEMMs are not canonical and stay untuned."""
    st = planlib.parse_einsum(op.spec, len(op.x_shape), len(op.w_shape))
    if not planlib.canonical_gemm(st, len(op.w_shape)):
        return None
    dims = dict(zip(st.x_labels, op.x_shape))
    dims.update(zip(st.w_labels, op.w_shape))
    k = dims[st.contract[0]]
    n = math.prod(dims[l] for l in st.w_free)
    m = math.prod(dims[l] for l in st.x_free)
    return int(m), int(k), int(n)


def _entry_dtype(precision: str, dtype: Optional[torch.dtype]) -> torch.dtype:
    """The operand dtype of the entry that runs an op: int8 under the int8
    precision (fp32 and bf16 inputs quantize alike), else the inputs' bf16
    or fp32."""
    if precision == "int8":
        return torch.int8
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def _dtype_label(precision: str, dtype: Optional[torch.dtype]) -> str:
    """The entry's operand dtype by name: "float32", "bfloat16", "int8"."""
    return str(_entry_dtype(precision, dtype)).split(".")[-1]


def _key_ident(op: planlib.OpSpec, backend: str, accum: Optional[str],
               precision: str = "fp32",
               dtype: Optional[torch.dtype] = None) -> Optional[list]:
    """The list `tile_key` hashes: the reference's identity (op shape, the
    backend's name, accumulation label, precision) and the entry's operand
    dtype; None when the op has no tile knob on `backend`."""
    if backend != "cuda":
        return None
    if op.kind == "dense":
        mkn = _canonical_dense(op)
        if mkn is None:
            return None
        ident = ["dense", mkn[1], mkn[2]]
    elif op.kind == "conv2d":
        _, h_in, w_in, c_in = op.x_shape
        ident = ["conv2d", h_in, w_in, c_in, list(op.w_shape),
                 op.stride, op.pad, op.groups]
    else:
        return None
    return ident + [backend, accum or "default", precision,
                    _dtype_label(precision, dtype)]


def tile_key(op: planlib.OpSpec, backend: str, accum: Optional[str],
             precision: str = "fp32",
             dtype: Optional[torch.dtype] = None) -> Optional[str]:
    """Stable (process-independent) cache key for one tunable op, or None
    when the op has no tile knob on `backend`.

    Dense keys are (K, N) only: the row count M never changes a bit, and
    dropping it lets every batch bucket share one tile. Conv keys drop the
    batch for the same reason. `precision` and the operand dtype (fp32,
    bf16, or int8 under the int8 precision) are key dimensions: each runs
    another entry with other tiles. The hash is sha1 over the canonical
    JSON, so keys survive process restarts (unlike `hash(op)`)."""
    ident = _key_ident(op, backend, accum, precision, dtype)
    if ident is None:
        return None
    blob = json.dumps(ident, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


def _accum_label(cfg: EngineConfig) -> Optional[str]:
    return cfg.accum


# ---------------------------------------------------------------------------
# Candidates (the entry's tiles, analytically ordered)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Candidate:
    tile: Tile
    score: float        # analytic cost, lower is better (ordering only)


def _sms() -> int:
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(
            torch.cuda.current_device()).multi_processor_count
    return DEFAULT_SMS


def _conv_out_shape(op: planlib.OpSpec) -> Tuple[int, int, int, int]:
    b, h_in, w_in, _ = op.x_shape
    h_f, w_f, _, c_out = op.w_shape
    return (b, (h_in + 2 * op.pad - h_f) // op.stride + 1,
            (w_in + 2 * op.pad - w_f) // op.stride + 1, c_out)


def default_tile(op: planlib.OpSpec, precision: str = "fp32",
                 dtype: Optional[torch.dtype] = None,
                 sms: Optional[int] = None) -> Optional[Tile]:
    """The tile the entry's own rule picks for `op` (None: no tile knob)."""
    plan = _entry_plan(op, None, precision, dtype, sms or _sms())
    return None if plan is None else (plan.bm, plan.bn)


def _entry_plan(op, tile, precision, dtype, sms):
    dt = _entry_dtype(precision, dtype)
    if op.kind == "dense":
        mkn = _canonical_dense(op)
        return None if mkn is None \
            else gfid_matmul._plan_for(dt, *mkn, tile, sms)
    if op.kind == "conv2d":
        return gfid_conv._plan_for(dt, _conv_out_shape(op), op.w_shape,
                                   op.groups, tile, sms)
    return None


def _scored(op: planlib.OpSpec, precision: str,
            dtype: Optional[torch.dtype], sms: int) -> List[Candidate]:
    """Every tile the op's entry launches at the op's shape, scored by the
    waves of its blocks over `sms` SMs times one block's padded MACs plus
    WAVE_MACS: a tile that wastes rows or columns, leaves SMs idle or takes
    more waves scores worse."""
    dt = _entry_dtype(precision, dtype)
    if op.kind == "dense":
        mkn = _canonical_dense(op)
        if mkn is None:
            return []
        m, k, n = mkn
        rows, cols, groups = m, n, 1
        tiles = gfid_matmul.tiles_for(m, k, n, dt, sms)
    elif op.kind == "conv2d":
        out = _conv_out_shape(op)
        h_f, w_f, cg, c_out = op.w_shape
        rows, k, groups = out[0] * out[1] * out[2], h_f * w_f * cg, op.groups
        cols = c_out // groups
        tiles = gfid_conv.tiles_for(out, op.w_shape, groups, dt, sms)
    else:
        return []
    cands = []
    for bm, bn in tiles:
        plan = _entry_plan(op, (bm, bn), precision, dtype, sms)
        padded = (-(-rows // bm) * bm) * groups * (-(-cols // bn) * bn) * k
        blocks = math.prod(plan.grid)
        waves = -(-blocks // sms)
        cands.append(Candidate((bm, bn), waves * (padded / blocks + WAVE_MACS)))
    return cands


def candidates_for(op: planlib.OpSpec, limit: int = MAX_CANDIDATES,
                   precision: str = "fp32",
                   dtype: Optional[torch.dtype] = None,
                   sms: Optional[int] = None) -> List[Tile]:
    """The tiles `autotune_op` times for `op`, best-scored first: the best
    `limit` of the tiles its entry launches at its shape (at the op's own
    M or pixels), with the entry's own choice always among them."""
    sms = sms or _sms()
    cands = sorted(_scored(op, precision, dtype, sms),
                   key=lambda c: (c.score, c.tile))
    tiles = [c.tile for c in cands[:limit]]
    own = default_tile(op, precision, dtype, sms)
    if own is not None and own not in tiles:
        tiles.append(own)
    return tiles


# ---------------------------------------------------------------------------
# Timing on the card
# ---------------------------------------------------------------------------

def _require_card() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tuning='autotune' times candidate tiles on a CUDA device, and "
            "this process has none (torch.cuda.is_available() is False); "
            "compile under tuning='cached' or 'off' here, or tune on the "
            "card")


def tile_runner(op: planlib.OpSpec, precision: str = "fp32",
                dtype: Optional[torch.dtype] = None,
                device: str = "cuda", seed: int = 0
                ) -> Callable[[Optional[Tile]], torch.Tensor]:
    """A function of a tile (None: the plan's own) that launches the op's
    entry once on operands drawn from `seed` at the op's canonical shapes
    on `device`, and returns its output: the precision's real path, the
    operands quantized once beforehand under int8 (so a timing is the
    kernel's alone)."""
    gen = torch.Generator(device).manual_seed(seed)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=device).to(
            torch.bfloat16 if dtype == torch.bfloat16 else torch.float32)

    if op.kind == "dense":
        m, k, n = _canonical_dense(op)
        x, w = draw((m, k)), draw((k, n))
        if precision == "int8":
            xq, wq, sx, sw = quant.quantize_matmul_operands(x, w)
            wq = wq.contiguous()
            return lambda tile: gfid_matmul.gfid_matmul_int8(
                xq, wq, sx, sw, tile=tile)
        return lambda tile: gfid_matmul.gfid_matmul(x, w, tile=tile)
    if op.kind != "conv2d":
        raise ValueError(f"op kind {op.kind!r} has no tile knob")
    x, w = draw(op.x_shape), draw(op.w_shape)
    geo = dict(stride=op.stride, pad=op.pad, groups=op.groups)
    if precision == "int8":
        xq, wq, sx, sw = quant.quantize_conv_operands(x, w)
        sx, sw = sx.reshape(x.shape[0], 1), sw.reshape(1, w.shape[3])
        return lambda tile: gfid_conv.gfid_conv2d_nhwc_int8(
            xq, wq, sx, sw, tile=tile, **geo)
    return lambda tile: gfid_conv.gfid_conv2d_nhwc(x, w, tile=tile, **geo)


def _bench_once(fn: Callable[[], torch.Tensor], repeats: int) -> float:
    """Seconds a launch of `fn`: one warm-up call, a CUDA graph of
    BENCH_LAUNCHES calls, then the least of `repeats` replays between
    CUDA events, over the launches (the device's time, not the host's)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(BENCH_LAUNCHES):
            fn()
    graph.replay()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / BENCH_LAUNCHES)
    return best


def benchmark_tile(op: planlib.OpSpec, tile: Optional[Tile],
                   cfg: EngineConfig, repeats: int = BENCH_REPEATS,
                   precision: str = "fp32",
                   dtype: Optional[torch.dtype] = None) -> float:
    """Seconds a launch of the op's entry at `tile` (None: the plan's own)
    takes on the current CUDA device, on the precision's real path; raises
    without a device (never times a plain version)."""
    _require_card()
    run = tile_runner(op, precision, dtype)
    return _bench_once(lambda: run(tile), repeats)


def _op_desc(op: planlib.OpSpec) -> str:
    if op.kind == "dense":
        m, k, n = _canonical_dense(op)
        return f"dense {k}x{n}"
    return (f"conv2d {op.x_shape[1]}x{op.x_shape[2]}x{op.x_shape[3]}"
            f" w{op.w_shape[0]}x{op.w_shape[1]}->{op.w_shape[3]}"
            f" s{op.stride} p{op.pad} g{op.groups}")


# ---------------------------------------------------------------------------
# Resolution: lookup / autotune / attach
# ---------------------------------------------------------------------------

def lookup(op: planlib.OpSpec, cfg: EngineConfig, precision: str = "fp32",
           dtype: Optional[torch.dtype] = None) -> Optional[Tile]:
    """Cache-only tile resolution (never times anything). A malformed entry
    reads as a miss; a well-formed tile the entry cannot launch is
    returned, and its launch raises."""
    key = tile_key(op, "cuda", _accum_label(cfg), precision, dtype)
    if key is None:
        return None
    entry = load_cache().get("entries", {}).get(key)
    if not isinstance(entry, dict):
        return None
    tile = entry.get("tile")
    if (isinstance(tile, (list, tuple)) and len(tile) == 2
            and all(isinstance(v, int) and v > 0 for v in tile)):
        return tuple(tile)
    return None


def autotune_op(op: planlib.OpSpec, cfg: EngineConfig,
                repeats: int = BENCH_REPEATS, precision: str = "fp32",
                dtype: Optional[torch.dtype] = None) -> Optional[Tile]:
    """Time the op's candidate tiles, persist and return the winner (None
    when the op has no tile knob). A cached winner is reused: tuning an op
    again is a dict hit, not a benchmark. The entry records the M (or
    pixels) timed, every candidate's µs and the rule's own tile."""
    key = tile_key(op, "cuda", _accum_label(cfg), precision, dtype)
    if key is None:
        return None
    cached = lookup(op, cfg, precision, dtype)
    if cached is not None:
        return cached
    cands = candidates_for(op, precision=precision, dtype=dtype)
    if not cands:
        return None
    timed = [(benchmark_tile(op, t, cfg, repeats, precision, dtype), t)
             for t in cands]
    best_s, best = min(timed)
    own = default_tile(op, precision, dtype)
    kind = device_kind()
    load_cache(kind)["entries"][key] = {
        "kind": op.kind,
        "tile": list(best),
        "device_us": best_s * 1e6,
        "candidates": len(timed),
        "timings_us": {f"{bm}x{bn}": s * 1e6 for s, (bm, bn) in timed},
        "default_tile": list(own),
        "precision": precision,
        "dtype": _dtype_label(precision, dtype),
        "rows": (_canonical_dense(op)[0] if op.kind == "dense" else
                 math.prod(_conv_out_shape(op)[:3])),
        "desc": _op_desc(op),
    }
    save_cache(kind)
    return best


def attach(op: planlib.OpSpec, plan: planlib.EnginePlan, cfg: EngineConfig,
           *, allow_autotune: bool = False,
           dtype: Optional[torch.dtype] = None) -> planlib.EnginePlan:
    """The plan with its tuned tile pinned, per `cfg.tuning`.

    "off" (or a backend other than "cuda", or an untunable op, or a plan
    already pinned) returns the plan unchanged; "cached" pins a cache hit;
    "autotune" also times misses, but only with `allow_autotune`, i.e. from
    `engine.compile`, never from the eager per-op path. `dtype` is the op's
    input dtype (fp32 or bf16)."""
    if (cfg.tuning == "off" or plan.backend != "cuda"
            or plan.tile_config is not None):
        return plan
    prec = plan.precision           # pinned before tile resolution
    tile = lookup(op, cfg, prec, dtype)
    if tile is None and allow_autotune and cfg.tuning == "autotune":
        tile = autotune_op(op, cfg, precision=prec, dtype=dtype)
    if tile is None:
        return plan
    return dataclasses.replace(plan, tile_config=tile)


def tune_program(ops: Sequence[planlib.OpSpec], cfg: EngineConfig,
                 dtypes: Optional[Sequence[Optional[torch.dtype]]] = None
                 ) -> int:
    """Autotune every tunable "cuda" op of `ops` (inputs of `dtypes`, one
    an op; default fp32); returns the number of ops that now have a cache
    entry (for warm-up scripts)."""
    tuned = 0
    for op, dt in zip(ops, dtypes or [None] * len(ops)):
        backend = planlib.select_backend(op, cfg)
        prec = ("int8" if cfg.precision == "int8"
                and planlib.supports_int8(op) else "fp32")
        if tile_key(op, backend, _accum_label(cfg), prec, dt) is None:
            continue
        if autotune_op(op, cfg, precision=prec, dtype=dt) is not None:
            tuned += 1
    return tuned
