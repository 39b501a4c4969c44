"""Shared building blocks: parameter definitions (one source of truth for
init and shape trees), norms, rotary embeddings, the tied head.

A copy of the JAX package's `models/layers.py` in PyTorch. Every weight is
declared as a `ParamDef` carrying logical axis names; the same def tree
materializes as real tensors (`init_tree`, from an explicit
`torch.Generator`) or as `meta` tensors (`shape_tree`, shapes and dtypes
only, the analogue of the reference's `jax.ShapeDtypeStruct`s). The two
frameworks draw other random numbers from one seed: the tests carry the
reference's parameters across (`transformer.params_from_jax`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import engine

# Logical axis vocabulary (the reference's; used by its sharding rules).
BATCH, SEQ, D_MODEL, D_FF, HEADS, KV_HEADS, HEAD_DIM, VOCAB, EXPERTS, \
    LAYERS, STATE, CONV, IMG = (
        "batch", "seq", "d_model", "d_ff", "heads", "kv_heads", "head_dim",
        "vocab", "experts", "layers", "state", "conv", "img")


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis per dim (None = replicated)
    init: str = "normal"                 # normal | zeros | ones | scaled
    scale: Optional[float] = None        # stddev override (normal/scaled)
    dtype: Any = None                    # default: factory dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ "
                             "in rank")


DefTree = Any  # nested dict of ParamDef


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """Map `fn` over the leaves of nested dicts (the trees of this port:
    parameters, decode states, pool tensors), in key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def resolve_device(device) -> torch.device:
    """`device` as given, else the GPU; never a silent move to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain CPU path explicitly")
    return torch.device("cuda")


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """A torch tensor of `a`'s dtype. A bfloat16 array (numpy's extension
    type, which `torch.from_numpy` refuses) goes across as its 16-bit
    patterns, bit-exact."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Carry the JAX package's parameters across: the same nested dicts,
    each leaf (a numpy array, or anything `np.asarray` takes) copied into a
    torch tensor of its dtype (bf16 included, bit for bit) on `device`
    (default: the GPU; raises when there is none). Layouts are kept: the
    CNNs' HWIO conv and (n, m) FC weights, the LMs' stacked layer
    groups."""
    dev = resolve_device(device)

    def move(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: move(v) for k, v in node.items()}
        return _from_numpy(np.array(node)).to(dev)

    return move(tree)


def _leaf_init(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    dt = d.dtype or dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init in ("normal", "scaled"):
        fan_in = d.shape[0] if len(d.shape) >= 2 else max(d.shape[0], 1)
        if len(d.shape) >= 3:  # stacked/expert weights: fan-in is 2nd-to-last
            fan_in = d.shape[-2]
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(fan_in)
        w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=gen.device).mul_(std)
        return w.to(device=device, dtype=dt)
    raise ValueError(d.init)


def init_tree(defs: DefTree, gen: torch.Generator, dtype: torch.dtype,
              device: torch.device) -> Any:
    """Real tensors for a def tree, drawn in fp32 in key order from `gen`
    on the generator's device (the host's: the same numbers for every
    target device; the GPU's: far faster for a multi-GB tree, other
    numbers), then cast and moved to `device` one leaf at a time: at most
    one leaf is ever held in fp32."""
    return tree_map(lambda d: _leaf_init(d, gen, dtype, device), defs)


def shape_tree(defs: DefTree, dtype: torch.dtype) -> Any:
    """`meta` tensors for a def tree: shapes and dtypes, no storage."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype or dtype,
                                          device="meta"), defs)


def count_params(defs: DefTree) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def stack_defs(defs: DefTree, n: int) -> DefTree:
    """Prepend a LAYERS axis of length n to every leaf (the reference scans
    over it; the port loops over it)."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (LAYERS,) + d.axes,
                                       d.init, d.scale, d.dtype), defs)


# ---------------------------------------------------------------------------
# Norms / activations (fp32 internals, cast back)
# ---------------------------------------------------------------------------

def row_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum over axis `dim` (the last by default), keeping it, in an order
    fixed by the axis length alone: halve while the length is even, then
    add the odd rest in order. Every step is elementwise, so a row's sum has
    the same bits whatever other rows share the tensor. `torch.sum`'s CUDA
    reduction splits a row over threads by the count of rows, so its bits
    follow the batch (ROADMAP section 3)."""
    while x.shape[dim] % 2 == 0:
        half = x.shape[dim] // 2
        x = x.narrow(dim, 0, half) + x.narrow(dim, half, half)
    acc = x.narrow(dim, 0, 1)
    for i in range(1, x.shape[dim]):
        acc = acc + x.narrow(dim, i, 1)
    return acc


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             scale_plus_one: bool = False,
             fixed_order: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis; `fixed_order` takes the mean with
    `row_sum`, so a row's bits do not depend on its batchmates."""
    xf = x.float()
    if fixed_order:
        var = row_sum(xf * xf) / xf.shape[-1]
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    s = scale.float()
    y = y * (1.0 + s) if scale_plus_one else y * s
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D) or (..., S, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)     # (D/2,)
    ang = positions.float()[..., None] * inv              # (..., S, D/2)
    if x.ndim == ang.ndim + 1:                            # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head (FC mode of the multi-mode engine)
# ---------------------------------------------------------------------------

def embed_def(vocab: int, d_model: int) -> ParamDef:
    return ParamDef((vocab, d_model), (VOCAB, D_MODEL), "normal", scale=1.0)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 scale_by_dim: bool = False) -> torch.Tensor:
    y = table.index_select(0, tokens.reshape(-1)).reshape(
        tuple(tokens.shape) + (table.shape[1],))
    if scale_by_dim:
        y = (y.float() * math.sqrt(table.shape[1])).to(y.dtype)
    return y


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the tied embedding (FC mode). x: (..., D) -> (..., V),
    fp32 (accumulated in fp32 from bf16 operands, as the reference)."""
    return engine.einsum("...d,vd->...v", x, table,
                         accum_dtype=torch.float32)
