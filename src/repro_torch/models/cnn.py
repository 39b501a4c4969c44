"""The paper's evaluation networks — AlexNet, VGGNet-16, ResNet-50 — in
PyTorch, with every conv and FC layer routed through the multi-mode engine.

Layer tables double as the input to `core.analytics` (paper Eqs. 15-18), so
the same definition yields (a) a runnable functional model and (b) the
MMIE-projected latency / memory-access / performance-efficiency numbers of
the paper's Table 4 and Fig. 5.

Parameters keep the JAX package's layouts and names, so weights move across
with `params_from_jax`: a nested dict `{"conv": {layer: {"w", "b"}}, "fc":
{layer: {"w", "b"}}}` with HWIO conv weights and (n, m) FC weights;
activations are NHWC.

Note on ResNet-50: the paper's Table 2 counts the 49 main-path convolutions
(1x 7x7, 16x 3x3, 32x 1x1) and models all 3x3/1x1 at S=1; the functional
model additionally contains the 4 projection shortcuts and the stride-2
downsampling convs required for correctness. `analytics_layers(
main_path_only=True)` reproduces the paper's counting; the functional path
uses the real geometry.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import engine as E
from repro_torch.core.analytics import ConvLayerSpec, FCLayerSpec
from repro_torch.models.layers import (  # noqa: F401 (re-exported)
    params_from_jax, resolve_device)


@dataclasses.dataclass(frozen=True)
class ConvDef:
    name: str
    c_in: int
    c_out: int
    k: int
    stride: int = 1
    pad: int = 0
    groups: int = 1
    pool: int = 1          # max-pool (k=stride=pool) applied after ReLU
    relu: bool = True


@dataclasses.dataclass(frozen=True)
class FCDef:
    name: str
    n: int
    m: int
    relu: bool = True


# AlexNet (227x227x3 input; grouped conv2/4/5 as in Krizhevsky 2012)
ALEXNET_CONVS: Tuple[ConvDef, ...] = (
    ConvDef("conv1", 3, 96, 11, stride=4, pad=0, pool=2),
    ConvDef("conv2", 96, 256, 5, stride=1, pad=2, groups=2, pool=2),
    ConvDef("conv3", 256, 384, 3, stride=1, pad=1),
    ConvDef("conv4", 384, 384, 3, stride=1, pad=1, groups=2),
    ConvDef("conv5", 384, 256, 3, stride=1, pad=1, groups=2, pool=2),
)
ALEXNET_FCS: Tuple[FCDef, ...] = (
    FCDef("fc6", 9216, 4096),
    FCDef("fc7", 4096, 4096),
    FCDef("fc8", 4096, 1000, relu=False),
)
ALEXNET_INPUT = (227, 227, 3)


# VGGNet-16 (224x224x3; all 3x3 s1 p1)
def _vgg_block(name: str, c_in: int, c_out: int, n: int,
               pool_last: bool = True) -> List[ConvDef]:
    defs = []
    for i in range(n):
        defs.append(ConvDef(f"{name}_{i+1}", c_in if i == 0 else c_out, c_out,
                            3, 1, 1, pool=2 if (pool_last and i == n - 1) else 1))
    return defs


VGG16_CONVS: Tuple[ConvDef, ...] = tuple(
    _vgg_block("conv1", 3, 64, 2) + _vgg_block("conv2", 64, 128, 2)
    + _vgg_block("conv3", 128, 256, 3) + _vgg_block("conv4", 256, 512, 3)
    + _vgg_block("conv5", 512, 512, 3))
VGG16_FCS: Tuple[FCDef, ...] = (
    FCDef("fc6", 25088, 4096),
    FCDef("fc7", 4096, 4096),
    FCDef("fc8", 4096, 1000, relu=False),
)
VGG16_INPUT = (224, 224, 3)

# ResNet-50 (v1: stride-2 in the first 1x1 of downsampling bottlenecks)
RESNET50_STAGES = (  # (n_blocks, c_mid, c_out, first_stride)
    (3, 64, 256, 1),
    (4, 128, 512, 2),
    (6, 256, 1024, 2),
    (3, 512, 2048, 2),
)
RESNET50_FCS: Tuple[FCDef, ...] = (FCDef("fc", 2048, 1000, relu=False),)
RESNET50_INPUT = (224, 224, 3)


@dataclasses.dataclass(frozen=True)
class CNNDef:
    name: str
    input_hw_c: Tuple[int, int, int]
    convs: Tuple[ConvDef, ...]      # empty for resnet (built structurally)
    fcs: Tuple[FCDef, ...]
    kind: str                       # "plain" | "resnet"


CNNS: Dict[str, CNNDef] = {
    "alexnet": CNNDef("alexnet", ALEXNET_INPUT, ALEXNET_CONVS, ALEXNET_FCS, "plain"),
    "vgg16": CNNDef("vgg16", VGG16_INPUT, VGG16_CONVS, VGG16_FCS, "plain"),
    "resnet50": CNNDef("resnet50", RESNET50_INPUT, (), RESNET50_FCS, "resnet"),
}


# ---------------------------------------------------------------------------
# Analytic layer tables
# ---------------------------------------------------------------------------

def analytics_layers(name: str, main_path_only: bool = True,
                     ) -> Tuple[List[ConvLayerSpec], List[FCLayerSpec]]:
    """Conv/FC layer geometry tables for the paper's cost model."""
    net = CNNS[name]
    h, w, _ = net.input_hw_c
    convs: List[ConvLayerSpec] = []
    if net.kind == "plain":
        for cd in net.convs:
            spec = ConvLayerSpec(cd.name, h, w, cd.c_in, cd.c_out, cd.k, cd.k,
                                 cd.stride, cd.pad, cd.groups)
            convs.append(spec)
            h, w = spec.h_out // cd.pool, spec.w_out // cd.pool
    else:
        # conv1 7x7/2 + maxpool/2
        spec = ConvLayerSpec("conv1", h, w, 3, 64, 7, 7, 2, 3)
        convs.append(spec)
        h = w = spec.h_out // 2
        c_in = 64
        for si, (n_blocks, c_mid, c_out, first_stride) in enumerate(RESNET50_STAGES):
            for b in range(n_blocks):
                s = first_stride if b == 0 else 1
                pre = f"s{si+2}b{b+1}"
                h2, w2 = (h + s - 1) // s, (w + s - 1) // s
                # Paper Table-2 counting books every 1x1/3x3 bottleneck conv
                # as an S=1 mode on the decimated map (same MACs and cycles
                # as the real stride-2 geometry); the functional model keeps
                # the stride.
                if main_path_only:
                    convs.append(ConvLayerSpec(f"{pre}_1x1a", h2, w2, c_in,
                                               c_mid, 1, 1, 1))
                else:
                    convs.append(ConvLayerSpec(f"{pre}_1x1a", h, w, c_in,
                                               c_mid, 1, 1, s))
                convs.append(ConvLayerSpec(f"{pre}_3x3", h2, w2, c_mid, c_mid,
                                           3, 3, 1, 1))
                convs.append(ConvLayerSpec(f"{pre}_1x1b", h2, w2, c_mid, c_out,
                                           1, 1, 1))
                if b == 0 and not main_path_only:
                    convs.append(ConvLayerSpec(f"{pre}_proj", h, w, c_in,
                                               c_out, 1, 1, s))
                h, w, c_in = h2, w2, c_out
    fcs = [FCLayerSpec(f.name, f.n, f.m) for f in net.fcs]
    return convs, fcs


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _param_defs(net: CNNDef) -> Tuple[List[ConvDef], Tuple[FCDef, ...]]:
    if net.kind == "plain":
        return list(net.convs), net.fcs
    convs, _ = analytics_layers(net.name, main_path_only=False)
    return [ConvDef(s.name, s.c_in, s.c_out, s.w_f, s.s, s.pad)
            for s in convs], net.fcs


def init_cnn(name: str, seed: int = 0, device: Optional[str] = None,
             dtype: torch.dtype = torch.float32
             ) -> Dict[str, Dict[str, Dict]]:
    """Random He-normal weights (zero biases) in `dtype` (fp32 or bf16;
    drawn in fp32, then cast) from an explicit `torch.Generator` seeded
    with `seed`, on `device` (default: the GPU; raises when there is
    none)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    convs, fcs = _param_defs(CNNS[name])
    params: Dict[str, Dict[str, Dict]] = {"conv": {}, "fc": {}}
    for cd in convs:
        fan_in = cd.k * cd.k * cd.c_in // cd.groups
        w = torch.randn((cd.k, cd.k, cd.c_in // cd.groups, cd.c_out),
                        generator=gen, dtype=torch.float32) * (2.0 / fan_in) ** 0.5
        params["conv"][cd.name] = {
            "w": w.to(device=dev, dtype=dtype),
            "b": torch.zeros(cd.c_out, dtype=dtype, device=dev)}
    for fd in fcs:
        w = torch.randn((fd.n, fd.m), generator=gen,
                        dtype=torch.float32) * (2.0 / fd.n) ** 0.5
        params["fc"][fd.name] = {
            "w": w.to(device=dev, dtype=dtype),
            "b": torch.zeros(fd.m, dtype=dtype, device=dev)}
    return params


def _meta_params(net: CNNDef, dtype: torch.dtype = torch.float32
                 ) -> Dict[str, Dict[str, Dict]]:
    convs, fcs = _param_defs(net)
    meta = functools.partial(torch.empty, device="meta", dtype=dtype)
    return {
        "conv": {cd.name: {"w": meta((cd.k, cd.k, cd.c_in // cd.groups,
                                      cd.c_out)),
                           "b": meta((cd.c_out,))} for cd in convs},
        "fc": {fd.name: {"w": meta((fd.n, fd.m)), "b": meta((fd.m,))}
               for fd in fcs},
    }


# ---------------------------------------------------------------------------
# Forward (every conv / FC through the engine)
# ---------------------------------------------------------------------------

def _maxpool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k / stride k max-pool of NHWC x (a plain torch op: the reference
    runs it outside every kernel too)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k).permute(0, 2, 3, 1)


def _layer_names(net: CNNDef) -> set:
    convs, fcs = _param_defs(net)
    return {cd.name for cd in convs} | {fd.name for fd in fcs}


def _check_precisions(net: CNNDef,
                      precisions: Optional[Dict[str, str]]) -> None:
    if precisions is None:
        return
    unknown = set(precisions) - _layer_names(net)
    if unknown:
        raise ValueError(f"unknown layer name(s) {sorted(unknown)} in "
                         f"precisions for {net.name!r}")


def _prec(precisions: Optional[Dict[str, str]], name: str) -> Optional[str]:
    return None if precisions is None else precisions.get(name)


def _forward(net: CNNDef, params: Dict, x: torch.Tensor,
             precisions: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """The functional forward pass, engine-routed, context-free — shared by
    eager `apply_cnn` and the compiled `program(...)` path. Bias and ReLU
    ride each conv/FC op as the engine's fused epilogue: a conv+bias+relu
    layer is ONE kernel launch on the "cuda" backend (fp32, or int8 with the
    dequant fused). `precisions` maps layer names to explicit per-layer
    precisions ("fp32" | "int8"), which win over the ambient config and
    over a compiled plan's pinned precision."""
    if net.kind == "plain":
        for cd in net.convs:
            p = params["conv"][cd.name]
            x = E.conv2d(x, p["w"], stride=cd.stride, pad=cd.pad,
                         groups=cd.groups, bias=p["b"],
                         act="relu" if cd.relu else None,
                         precision=_prec(precisions, cd.name))
            if cd.pool > 1:
                x = _maxpool(x, cd.pool)
        x = x.reshape(x.shape[0], -1)
    else:
        x = _resnet50_body(params, x, precisions)
        x = x.mean(dim=(1, 2))          # global average pool
    for fd in net.fcs:
        p = params["fc"][fd.name]
        x = E.matmul(x, p["w"], bias=p["b"], act="relu" if fd.relu else None,
                     precision=_prec(precisions, fd.name))
    return x


def _resnet50_body(params: Dict, x: torch.Tensor,
                   precisions: Optional[Dict[str, str]] = None
                   ) -> torch.Tensor:
    pc = params["conv"]

    def conv(nm, x, stride, pad, act=None):
        p = pc[nm]
        return E.conv2d(x, p["w"], stride=stride, pad=pad, bias=p["b"],
                        act=act, precision=_prec(precisions, nm))

    x = conv("conv1", x, 2, 3, act="relu")
    x = _maxpool(F.pad(x, (0, 0, 0, 1, 0, 1), value=float("-inf")), 2)
    for si, (n_blocks, c_mid, c_out, first_stride) in enumerate(RESNET50_STAGES):
        for b in range(n_blocks):
            s = first_stride if b == 0 else 1
            pre = f"s{si+2}b{b+1}"
            res = x
            y = conv(f"{pre}_1x1a", x, s, 0, act="relu")
            y = conv(f"{pre}_3x3", y, 1, 1, act="relu")
            y = conv(f"{pre}_1x1b", y, 1, 0)
            if b == 0:
                res = conv(f"{pre}_proj", x, s, 0)
            x = torch.relu(y + res)
    return x


def apply_cnn(name: str, params: Dict, x: torch.Tensor, *,
              backend: Optional[str] = None,
              precisions: Optional[Dict[str, str]] = None) -> torch.Tensor:
    """Eager forward pass through the multi-mode engine on `backend` (None:
    the ambient `EngineConfig`'s), on the device of `x` and `params`.
    x: (B, H, W, 3) NHWC -> logits (B, 1000). `precisions` maps layer names
    to per-layer precisions (e.g. {"fc6": "int8"}), which win over the
    config's `precision`. For the whole-network-planned path use
    `engine.compile(program(name), cfg)`."""
    net = CNNS[name]
    _check_precisions(net, precisions)
    with E.using_backend(backend), torch.no_grad():
        return _forward(net, params, x, precisions)


def program(name: str, *, batch: int = 1,
            dtype: torch.dtype = torch.float32, main_path_only: bool = True,
            precisions: Optional[Dict[str, str]] = None) -> E.Program:
    """The network as an `engine.Program`: an ordered, shape-complete op
    graph derived from the `CNNDef` layer tables, plus the executable
    functional forward and `meta` stand-ins for its (params, x) inputs.

    With `main_path_only=True` (default) the op graph follows the paper's
    Table-2/Table-4 counting — `engine.compile(program(net)).plan`
    reproduces `analytics.network_cost` exactly. The execution side always
    runs the real geometry: `compile()` captures the functional forward's
    own op sequence.

    `dtype` is that of the parameters and the input the program runs on
    (fp32 or bf16; with bf16 every conv and FC op takes bf16 operands,
    accumulates in fp32 and returns bf16 logits, as the reference's
    `program(dtype=)`). The op graph, and so the plan, does not depend on
    it.

    `precisions` bakes per-layer precision overrides into the forward: the
    named layers issue an explicit `precision=` at every execution, which
    wins over the compile config's `precision`."""
    net = CNNS[name]
    _check_precisions(net, precisions)
    h, w, c = net.input_hw_c
    conv_specs, fc_specs = analytics_layers(name, main_path_only)
    ops: List[E.OpSpec] = []
    for cs in conv_specs:
        ops.append(E.OpSpec(
            "conv2d",
            (batch, cs.h_in, cs.w_in, cs.c_in),
            (cs.h_f, cs.w_f, cs.c_in // cs.groups, cs.c_out),
            stride=cs.s, pad=cs.pad, groups=cs.groups, name=cs.name))
    for fs in fc_specs:
        ops.append(E.OpSpec(
            "dense", (batch, fs.n), (fs.n, fs.m),
            spec=E.dense_spec(2), name=fs.name))
    x_meta = torch.empty((batch, h, w, c), device="meta", dtype=dtype)
    fn = (functools.partial(_forward, net) if precisions is None
          else functools.partial(_forward, net, precisions=dict(precisions)))
    return E.Program(name=name, ops=tuple(ops), fn=fn,
                     in_avals=(_meta_params(net, dtype), x_meta))
