"""EnginePlan — the pure, hashable execution plan of one engine op.

A plan is a function of *op shapes alone* (plus the static knobs stride /
pad / groups / backend): no tensor data, no mutable state, so it is
cacheable and usable as a dict key. Each plan carries the paper-side
schedule (the Table-3 mode and its analytic cost, Eqs. 15-18) — every
analytic field equals the JAX package's plan for the same op — and the
Hopper-side schedule: `tiling`, the block tile of the hand-written kernel
that runs the op on the "cuda" backend. `precision` ("fp32" | "int8") is
pinned onto a plan by `with_precision` (compile) or the per-call resolver
(`api._pin_precision`); the planners never set it, and the analytic fields
do not move with it.

Einsum planning: a dense contraction `einsum(spec, x, w)` is classified per
axis label into batch (x, w and out), contraction (x and w, not out),
x-free and w-free dims. Its FC-mode cost is `fc_cost(n=prod(contract),
m=prod(w_free))` scaled by every remaining x dim.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import analytics, modes
from repro_torch.kernels import build as _build
from repro_torch.kernels import gfid_conv as _gfid_conv
from repro_torch.kernels import gfid_matmul as _gfid_matmul
from repro_torch.kernels.conv1d import TILE as CONV1D_TILE
from repro_torch.kernels.gfid_conv import TILE as CONV_TILE
from repro_torch.kernels.gfid_conv import TILE_INT8 as CONV_TILE_INT8
from repro_torch.kernels.gfid_matmul import TILE as MATMUL_TILE
from repro_torch.kernels.gfid_matmul import TILE_INT8 as MATMUL_TILE_INT8

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class OpSpec:
    """The shape-complete invocation record of one engine op: one node of a
    `program.Program` graph, re-plannable under any config via `plan_op`."""

    kind: str               # "conv2d" | "conv1d_dw" | "dense" | "gather"
    x_shape: Shape
    w_shape: Shape
    spec: str = ""                  # einsum spec ("dense" kind only)
    stride: int = 1
    pad: int = 0
    groups: int = 1
    causal: bool = True             # conv1d_dw only
    name: str = dataclasses.field(default="", compare=False)  # layer label

    def __post_init__(self) -> None:
        if self.kind not in ("conv2d", "conv1d_dw", "dense", "gather"):
            raise ValueError(f"unknown op kind {self.kind!r}")


def plan_op(op: OpSpec, backend: str) -> "EnginePlan":
    """Plan one `OpSpec` for `backend` (shares the per-op planners' caches)."""
    if op.kind == "conv2d":
        return plan_conv2d(op.x_shape, op.w_shape, op.stride, op.pad,
                           op.groups, backend)
    if op.kind == "conv1d_dw":
        return plan_conv1d_depthwise(op.x_shape, op.w_shape, backend)
    if op.kind == "gather":
        return plan_gather(op.x_shape, op.w_shape, backend)
    return plan_einsum(op.spec, op.x_shape, op.w_shape, backend)


@dataclasses.dataclass(frozen=True)
class EnginePlan:
    """Everything the engine decided about one op, from shapes alone."""

    kind: str               # "conv2d" | "conv1d_dw" | "dense" | "gather"
    backend: str                    # registry name ("cuda" | "torch" | "ref")
    mode: modes.Mode                # paper mode (W_f, S) with Table-3 schedule
    tiling: Tuple[int, int, int]    # Hopper block tile of the "cuda" kernel
    cycles: int                     # MMIE-projected cycles (batch included)
    ma_words: int                   # MMIE memory accesses, 16-bit words
    macs: int                       # useful multiply-accumulates
    note: str = ""                  # plan caveats (decimation, ...)
    # Execution precision, pinned by `with_precision` / the per-call
    # resolver: "fp32" or "int8". A quantized plan is a replace of the fp32
    # plan, so `ma_words` keeps its Table-4 meaning under every precision.
    precision: str = "fp32"
    # The block tile (bm, bn) the tuner pinned (`engine/tune.py`: at
    # `engine.compile`, or by the eager path's cached lookup); None keeps
    # the kernel's own rule. The planners never set it: a tuned plan is a
    # replace of the analytic plan, so the plan caches stay independent of
    # tuning and no analytic field moves with it.
    tile_config: Optional[Tuple[int, int]] = None

    @property
    def exec_ma_words(self) -> int:
        """Memory-access words as executed: `ma_words` for fp32, halved
        (ceil) for int8, whose operands take half a 16-bit MMIE word."""
        if self.precision == "int8":
            return -(-self.ma_words // 2)
        return self.ma_words


def _mode_for(w_f: int, s: int) -> modes.Mode:
    """Mode lookup that tolerates filters beyond the 11-register MMIE weight
    generator (hubert's 128-tap positional conv): such layers get the
    derived (N_eff, p_eff) schedule, as in the reference."""
    if w_f > 11:
        return modes.derived_mode(w_f, s)
    return modes.paper_mode(w_f, s)


@functools.lru_cache(maxsize=4096)
def plan_conv2d(x_shape: Shape, w_shape: Shape, stride: int, pad: int,
                groups: int, backend: str) -> EnginePlan:
    """x: (B, H, W, C_in) NHWC; w: (H_f, W_f, C_in/g, C_out) HWIO."""
    h_f, w_f, _, c_out = (int(v) for v in w_shape)
    b, h_in, w_in, c_in = (int(v) for v in x_shape)
    spec = analytics.ConvLayerSpec("conv2d", h_in, w_in, c_in, c_out,
                                   h_f, w_f, stride, pad, groups)
    cost = analytics.conv_cost(spec)
    note = ""
    if w_f <= stride:
        note = "W_f<=S: strided-out pixels decimated, booked at S=1"
    return EnginePlan(
        kind="conv2d", backend=backend, mode=cost.mode, tiling=CONV_TILE,
        cycles=cost.cycles * b, ma_words=cost.ma_total_words * b,
        macs=cost.macs * b, note=note)


@functools.lru_cache(maxsize=4096)
def plan_conv1d_depthwise(x_shape: Shape, w_shape: Shape,
                          backend: str) -> EnginePlan:
    """x: (B, L, D); w: (W_f, D). Each channel is an independent GFID row:
    one 1 x L map with a W_f-tap filter and a W_f - 1 pad, booked D x B
    times, as the reference books it. `tiling` is the kernel's block."""
    w_f = int(w_shape[0])
    b, l, d = (int(v) for v in x_shape)
    mode = _mode_for(w_f, 1)
    spec = analytics.ConvLayerSpec("conv1d_dw", 1, l, 1, 1, 1, w_f, 1,
                                   pad=w_f - 1)
    cost = analytics.conv_cost(spec, mode)
    return EnginePlan(
        kind="conv1d_dw", backend=backend, mode=mode, tiling=CONV1D_TILE,
        cycles=cost.cycles * d * b, ma_words=cost.ma_total_words * d * b,
        macs=cost.macs * d * b)


@dataclasses.dataclass(frozen=True)
class EinsumStructure:
    """Parsed two-operand einsum: per-axis roles, in operand order."""

    x_labels: Tuple[str, ...]
    w_labels: Tuple[str, ...]
    out_labels: Tuple[str, ...]
    batch: Tuple[str, ...]          # in x, w and out
    contract: Tuple[str, ...]       # in x and w, not out
    x_free: Tuple[str, ...]         # in x and out only
    w_free: Tuple[str, ...]         # in w and out only


def canonical_gemm(structure: EinsumStructure, w_ndim: int) -> bool:
    """True when a dense contraction lowers to ONE (M, K) @ (K, N) GEMM:
    single contract label, plain 2-D weights, no batched dims, output laid
    out x-free rows then w-free cols — exactly the ops the "cuda" backend's
    GEMM kernel runs."""
    return (w_ndim == 2 and len(structure.contract) == 1
            and not structure.batch
            and structure.out_labels == structure.x_free + structure.w_free)


def grouped_gemm(structure: EinsumStructure, w_ndim: int) -> bool:
    """True when a contraction with batched weights lowers to ONE grouped
    GEMM, (G, M, K) @ (G, K, N) -> (G, M, N): one batch label, leading in
    x, w and out; one contract label; 3-D weights; output laid out batch,
    x-free rows, w-free cols — the stacked-expert GEMMs of an MoE layer
    ("ecd,edf->ecf", "ecf,efd->ecd") that the "cuda" backend's GEMM kernel
    runs as one launch."""
    st = structure
    return (w_ndim == 3 and len(st.batch) == 1 and len(st.contract) == 1
            and st.x_labels[0] == st.w_labels[0] == st.out_labels[0]
            == st.batch[0]
            and st.out_labels == st.batch + st.x_free + st.w_free)


@functools.lru_cache(maxsize=1024)
def parse_einsum(spec: str, x_ndim: int, w_ndim: int) -> EinsumStructure:
    """Parse `spec` for operands of the given ranks. Ellipses in the spec are
    expanded to reserved per-position labels ("…0", "…1", ...)."""
    if "->" not in spec:
        raise ValueError(f"engine.einsum requires an explicit output: {spec!r}")
    lhs, rhs = spec.split("->")
    ops = lhs.split(",")
    if len(ops) != 2:
        raise ValueError(f"engine.einsum takes exactly two operands: {spec!r}")

    def _splice(sub: str, ell: Tuple[str, ...]) -> Tuple[str, ...]:
        head, tail = sub.split("...")
        return tuple(head) + ell + tuple(tail)

    def expand(sub: str, ndim: int) -> Tuple[str, ...]:
        sub = sub.replace(" ", "")
        if "..." in sub:
            n_ell = ndim - len(sub.replace("...", ""))
            if n_ell < 0:
                raise ValueError(f"operand rank {ndim} too small for {sub!r}")
            return _splice(sub, tuple(f"…{i}" for i in range(n_ell)))
        if len(sub) != ndim:
            raise ValueError(f"{sub!r} does not match operand rank {ndim}")
        return tuple(sub)

    x_labels = expand(ops[0], x_ndim)
    w_labels = expand(ops[1], w_ndim)
    for labels, side in ((x_labels, "operand 0"), (w_labels, "operand 1")):
        if len(set(labels)) != len(labels):
            raise ValueError(
                f"repeated label within {side} of {spec!r} (a diagonal, "
                "not a dense contraction the engine can plan)")
    rhs = rhs.replace(" ", "")
    if "..." in rhs:
        # the output ellipsis carries the x-side ellipsis labels (numpy
        # rule: broadcast dims lead; w never carries an ellipsis here)
        n_ell = sum(1 for l in x_labels if l.startswith("…"))
        out_labels = _splice(rhs, tuple(f"…{i}" for i in range(n_ell)))
    else:
        out_labels = tuple(rhs)

    xs, ws, os_ = set(x_labels), set(w_labels), set(out_labels)
    for lab in os_:
        if lab not in xs | ws:
            raise ValueError(f"output label {lab!r} missing from inputs: {spec!r}")
    for lab in xs | ws:
        if lab not in os_ and not (lab in xs and lab in ws):
            raise ValueError(
                f"label {lab!r} is summed within one operand — not a dense "
                f"contraction the engine can plan: {spec!r}")
    batch = tuple(l for l in x_labels if l in ws and l in os_)
    contract = tuple(l for l in x_labels if l in ws and l not in os_)
    x_free = tuple(l for l in x_labels if l not in ws)
    w_free = tuple(l for l in w_labels if l not in xs)
    return EinsumStructure(x_labels, w_labels, out_labels,
                           batch, contract, x_free, w_free)


@functools.lru_cache(maxsize=4096)
def plan_einsum(spec: str, x_shape: Shape, w_shape: Shape,
                backend: str) -> EnginePlan:
    """FC-mode plan for a dense contraction `einsum(spec, x, w)`."""
    st = parse_einsum(spec, len(x_shape), len(w_shape))
    dims: Dict[str, int] = {}
    for labels, shape in ((st.x_labels, x_shape), (st.w_labels, w_shape)):
        for lab, size in zip(labels, shape):
            if dims.setdefault(lab, int(size)) != int(size):
                raise ValueError(
                    f"size mismatch for {lab!r} in {spec!r}: "
                    f"{dims[lab]} vs {size}")
    n = math.prod(dims[l] for l in st.contract)
    m = math.prod(dims[l] for l in st.w_free)
    reps = math.prod(dims[l] for l in st.batch + st.x_free)
    fc = analytics.fc_cost(analytics.FCLayerSpec("fc", n, m))
    return EnginePlan(
        kind="dense", backend=backend, mode=modes.fc_mode(),
        tiling=MATMUL_TILE,
        cycles=fc.cycles * reps, ma_words=fc.ma_total_words * reps,
        macs=fc.macs * reps,
        note="" if not st.batch else
        f"batched weights over {len(st.batch)} dim(s)")


@functools.lru_cache(maxsize=4096)
def plan_gather(x_shape: Shape, w_shape: Shape, backend: str) -> EnginePlan:
    """x: (num_blocks, block_size, *feature) paged KV pool; w: (B,
    blocks_per_req) int32 block table. A pure memory move (zero MACs),
    priced as the reference prices it: the words gathered, one read and
    one write each, moved at one word per PE per cycle. `tiling` is the
    kernel's block tile: one pool block (block_size x feature) per thread
    block."""
    block_size = int(x_shape[1])
    feature = math.prod(int(v) for v in x_shape[2:])
    b, blocks_per_req = (int(v) for v in w_shape)
    words = b * blocks_per_req * block_size * feature
    return EnginePlan(
        kind="gather", backend=backend, mode=modes.fc_mode(),
        tiling=(1, block_size, feature),
        cycles=-(-words // modes.MMIE_NUM_PES),
        ma_words=2 * words, macs=0,
        note="paged-KV block gather (pure memory move)")


PRECISIONS = ("fp32", "int8")


def supports_int8(op: OpSpec) -> bool:
    """True when the int8 contract covers `op`: conv2d and dense ops that
    are one canonical (M, K) @ (K, N) GEMM. A shape-only predicate, so every
    backend agrees on which ops quantize."""
    if op.kind == "conv2d":
        return True
    if op.kind in ("conv1d_dw", "gather"):
        return False
    st = parse_einsum(op.spec, len(op.x_shape), len(op.w_shape))
    return canonical_gemm(st, len(op.w_shape))


def pinned(plan: EnginePlan, precision: str) -> EnginePlan:
    """`plan` at `precision`, with the tiling of the kernel that runs it."""
    if plan.precision == precision:
        return plan
    int8 = precision == "int8"
    if plan.kind == "conv2d":
        tiling = CONV_TILE_INT8 if int8 else CONV_TILE
    else:
        tiling = MATMUL_TILE_INT8 if int8 else MATMUL_TILE
    return dataclasses.replace(plan, precision=precision, tiling=tiling)


def with_precision(plan: EnginePlan, op: OpSpec,
                   precision: str) -> EnginePlan:
    """Pin `precision` onto a plan, as fp32 for an op outside the int8
    contract."""
    return pinned(plan, "int8" if precision == "int8" and supports_int8(op)
                  else "fp32")


# The "auto" policy's fill test. Every conv and GEMM kernel's narrowest
# block tile is 64 columns wide (the fp32 GEMM's (8, 64), the fp32 and int8
# convs' (32, 64), the bf16 core's (16, 64)), and the fp32 tiles take K in
# chunks of 8: an op narrower than one such tile, or shallower than one
# chunk, leaves most of the tile's lanes idle.
AUTO_MIN_COLUMNS = min(bn for tiles in (
    _gfid_matmul.F32_TILES, _gfid_conv.F32_TILES, _gfid_conv.INT8_TILES,
    _build.MMA_TILES) for _, bn in tiles)
AUTO_MIN_K = _gfid_matmul.F32_BK


def auto_backend(op: OpSpec, fallback: str = "torch") -> str:
    """The "auto" backend-selection policy: "cuda" or `fallback` per op,
    from the weight's shape alone (never the rows or the batch, so a
    request's ops run on the same backends in every bucket).

      * a conv2d, and a dense op that is one canonical (M, K) @ (K, N)
        GEMM, go to "cuda" when their columns (C_out of a group, N) and
        their depth (H_f * W_f * C_in of a group, K) each fill one of the
        kernels' narrowest tiles (`AUTO_MIN_COLUMNS`, `AUTO_MIN_K`): on
        the card the kernels outrun the "torch" lowering at every layer
        timed (PERF.md, "auto_backend");
      * a dense op that does not canonicalize goes to `fallback`, as the
        reference sends batched weights to its fallback: "cuda" runs the
        grouped GEMMs (`grouped_gemm`) when asked to, and raises on any
        other batched-weight contraction (`dispatch._cuda_einsum`);
      * the paged gather goes to `fallback`: `index_select` copies as fast
        as the kernel on the card (PERF.md);
      * the depthwise 1-D conv goes to "cuda", which outruns both the
        shifted sum in torch ops and the library's grouped conv.
    """
    if op.kind == "gather":
        return fallback
    if op.kind == "conv1d_dw":
        return "cuda"
    if op.kind == "conv2d":
        h_f, w_f, cg, c_out = op.w_shape
        cols, k = c_out // op.groups, h_f * w_f * cg
    else:
        st = parse_einsum(op.spec, len(op.x_shape), len(op.w_shape))
        if not canonical_gemm(st, len(op.w_shape)):
            return fallback
        c = st.contract[0]
        k = op.w_shape[st.w_labels.index(c)]
        cols = op.w_shape[1 - st.w_labels.index(c)]
    return "cuda" if cols >= AUTO_MIN_COLUMNS and k >= AUTO_MIN_K \
        else fallback


def select_backend(op: OpSpec, cfg) -> str:
    """The backend an `EngineConfig` runs `op` on: its `backend`, or under
    `policy="auto"` the rule's choice with `backend` as the fallback."""
    if cfg.policy == "auto":
        return auto_backend(op, cfg.backend)
    return cfg.backend


def dense_spec(x_ndim: int) -> str:
    """Canonical `(…, n) @ (n, m)` spec for `engine.dense`."""
    return "...n,nm->...m"
