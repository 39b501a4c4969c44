"""Analytic performance model of the MMIE (paper Eqs. 8-18, Tables 2-4, Fig. 5).

Everything here is closed-form and hardware-faithful to the paper's 192-PE,
200 MHz (conv) / 40 MHz (FC), 16-bit MMIE chip: it projects the paper's
latency / memory-access / performance-efficiency numbers for AlexNet,
VGGNet-16 and ResNet-50. None of it is a time measured on a GPU.

A copy of `repro.core.analytics` (the JAX package's cost model), kept
separate so the port never imports the JAX package; the two must agree
exactly (tests/test_torch_analytics.py). The MXU-occupancy helpers of the
TPU side are not carried over.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

from repro_torch.core import modes as m


@dataclasses.dataclass(frozen=True)
class ConvLayerSpec:
    """Geometry of one convolutional layer (paper Eq. 2 symbols)."""

    name: str
    h_in: int
    w_in: int
    c_in: int
    c_out: int
    h_f: int
    w_f: int
    s: int = 1
    pad: int = 0
    groups: int = 1

    @property
    def h_out(self) -> int:
        return (self.h_in + 2 * self.pad - self.h_f + self.s) // self.s

    @property
    def w_out(self) -> int:
        return (self.w_in + 2 * self.pad - self.w_f + self.s) // self.s

    @property
    def macs(self) -> int:
        """Multiply-accumulates (paper counts 1 MAC = 2 ops)."""
        return (self.h_out * self.w_out * self.c_out
                * self.h_f * self.w_f * self.c_in // self.groups)


@dataclasses.dataclass(frozen=True)
class FCLayerSpec:
    """Geometry of one fully-connected layer (paper Eq. 1: n inputs, m outputs)."""

    name: str
    n: int
    m: int

    @property
    def macs(self) -> int:
        return self.n * self.m


# ---------------------------------------------------------------------------
# §3.6 — utilization factor
# ---------------------------------------------------------------------------

def utilization_factor(n: int, t: int, w_f: int, s: int) -> float:
    """Eq. (8): UF = (N/T * W_f) / (S*N + W_f - S), as a fraction in [0, 1]."""
    return (n / t * w_f) / (s * n + w_f - s)


def utilization_factor_max(w_f: int, s: int, t: Optional[int] = None) -> float:
    """Eq. (9): UF_max = W_f / (T*S)."""
    t = m.pes_per_tile(w_f, s) if t is None else t
    return w_f / (t * s)


def utilization_factor_mmie(n: int, w_f: int, s: int) -> float:
    """UF on the 6-PE reconfigurable tile (paper Eqs. 11-14).

    When T <= 3 the 6-PE tile splits evenly (T PEs each) and Eq. (8) applies
    with the true T; when T in {4,5,6} all six PEs are occupied but only W_f
    weights are non-zero, and the effective delay per output row grows to
    6/ceil(6/ (S... )) -- the paper's closed forms:
      W_f=3,S=1 : N/(N+2)              (Eq. 11)
      W_f=5,S=1 : 5N/(6N+24)           (Eq. 12)
      W_f=7,S=2 : 7N/(12N+30)          (Eq. 13)
      W_f=11,S=4: 11N/(12N+21)         (Eq. 14)
    The general rule reproducing all four: with T' = PEs actually devoted
    (T if T<=3 else 6) and row stride S' = T'*S/..., the engine advances one
    output pixel per PE every T'*S_eff cycles. We implement the published
    closed forms exactly and fall back to Eq. (8) with T'=T elsewhere.
    """
    t = m.pes_per_tile(w_f, s)
    if (w_f, s) == (3, 1):
        return n / (n + 2)
    if (w_f, s) == (5, 1):
        return 5 * n / (6 * n + 24)
    if (w_f, s) == (7, 2):
        return 7 * n / (12 * n + 30)
    if (w_f, s) == (11, 4):
        return 11 * n / (12 * n + 21)
    if (w_f, s) == (1, 1):
        return 1.0
    if t <= 3:
        return utilization_factor(n, t, w_f, s)
    # T in {4,5,6}: six PEs serve one virtual tile; each output pixel still
    # needs W_f MACs but the tile row-sweep advances 6 pixels per 6*S cycles.
    return w_f * n / (6 * s * n + 6 * (w_f - s))


# ---------------------------------------------------------------------------
# §4.4.1 — convolutional processes on MMIE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ConvCost:
    layer: ConvLayerSpec
    mode: m.Mode
    cycles: int
    ma_imaps: int       # input-map reads (words)
    ma_filters: int     # filter reads (words)
    ma_omaps: int       # output-map writes (words)
    macs: int

    @property
    def ma_total_words(self) -> int:
        return self.ma_imaps + self.ma_filters + self.ma_omaps

    @property
    def ma_total_bytes(self) -> int:
        return self.ma_total_words * m.MMIE_WORD_BYTES

    @property
    def latency_s(self) -> float:
        return self.cycles / m.MMIE_CONV_FREQ_HZ

    @property
    def performance_efficiency(self) -> float:
        """Useful MACs over peak MACs of the 192-PE array for these cycles."""
        return self.macs / (m.MMIE_NUM_PES * self.cycles)


def conv_cost(layer: ConvLayerSpec, mode: Optional[m.Mode] = None) -> ConvCost:
    """Paper Eqs. (15)-(16) with the Table-3 (N_eff, p_eff) schedule.

    When W_f <= S (ResNet's stride-2 1x1 downsampling convs) the strided-out
    input pixels never contribute to any output, so the engine streams the
    decimated map at S=1 — this matches the paper's Table 2, which books all
    ResNet 1x1 layers as S=1 modes.
    """
    eff_s = layer.s if layer.w_f > layer.s else 1
    mode = mode or m.paper_mode(layer.w_f, eff_s)
    n_eff, p_eff = mode.n_eff, mode.p_eff
    s, w_f, h_f = eff_s, layer.w_f, layer.h_f
    c_in = layer.c_in // layer.groups
    h_out, w_out = layer.h_out, layer.w_out
    cout_sweeps = math.ceil(layer.c_out / p_eff)

    # Eq. (15): row sweeps + weight-passing overhead.
    n_pix = h_out * w_out
    cc_main = (n_pix / n_eff) * (s * n_eff + w_f - s) * h_f * c_in * cout_sweeps
    cc_wp = (w_f - 1) * (h_out - 1) * h_f * c_in * cout_sweeps
    cycles = int(math.ceil(cc_main + cc_wp))

    # §4.4.1: input pixels are shared across tiles and read once per cycle.
    ma_imaps = cycles
    # Eq. (16).
    ma_filters = (h_f * w_f * c_in * math.ceil(n_pix / n_eff) * layer.c_out)
    ma_omaps = n_pix * layer.c_out
    return ConvCost(layer=layer, mode=mode, cycles=cycles, ma_imaps=ma_imaps,
                    ma_filters=ma_filters, ma_omaps=ma_omaps, macs=layer.macs)


# ---------------------------------------------------------------------------
# §4.4.2 — fully-connected computations on MMIE
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FCCost:
    layer: FCLayerSpec
    cycles: int
    ma_ip: int
    ma_weights: int
    ma_op: int
    macs: int

    @property
    def ma_total_words(self) -> int:
        return self.ma_ip + self.ma_weights + self.ma_op

    @property
    def ma_total_bytes(self) -> int:
        return self.ma_total_words * m.MMIE_WORD_BYTES

    @property
    def latency_s(self) -> float:
        return self.cycles / m.MMIE_FC_FREQ_HZ

    @property
    def performance_efficiency(self) -> float:
        return self.macs / (m.MMIE_NUM_PES * self.cycles)


def fc_cost(layer: FCLayerSpec, p: int = m.MMIE_NUM_PES) -> FCCost:
    """Paper Eqs. (17)-(18)."""
    cycles = math.ceil(layer.m / p) * layer.n
    ma_ip = cycles
    ma_weights = layer.m * layer.n    # Eq. (18)
    ma_op = layer.m
    return FCCost(layer=layer, cycles=cycles, ma_ip=ma_ip,
                  ma_weights=ma_weights, ma_op=ma_op, macs=layer.macs)


# ---------------------------------------------------------------------------
# Network-level rollups (Table 4 / Fig. 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NetworkCost:
    name: str
    conv: List[ConvCost]
    fc: List[FCCost]

    @property
    def conv_cycles(self) -> int:
        return sum(c.cycles for c in self.conv)

    @property
    def fc_cycles(self) -> int:
        return sum(c.cycles for c in self.fc)

    @property
    def conv_latency_s(self) -> float:
        return self.conv_cycles / m.MMIE_CONV_FREQ_HZ

    @property
    def fc_latency_s(self) -> float:
        return self.fc_cycles / m.MMIE_FC_FREQ_HZ

    @property
    def conv_ma_bytes(self) -> int:
        return sum(c.ma_total_bytes for c in self.conv)

    @property
    def fc_ma_bytes(self) -> int:
        return sum(c.ma_total_bytes for c in self.fc)

    @property
    def conv_perf_efficiency(self) -> float:
        macs = sum(c.macs for c in self.conv)
        return macs / (m.MMIE_NUM_PES * self.conv_cycles)

    @property
    def fc_perf_efficiency(self) -> float:
        macs = sum(c.macs for c in self.fc)
        return macs / (m.MMIE_NUM_PES * self.fc_cycles)

    @property
    def conv_throughput_gops(self) -> float:
        """Average Gops (1 MAC = 2 ops) during conv processing."""
        return 2 * sum(c.macs for c in self.conv) / self.conv_latency_s / 1e9

    @property
    def fc_throughput_gops(self) -> float:
        return 2 * sum(c.macs for c in self.fc) / self.fc_latency_s / 1e9


def network_cost(name: str, conv_layers: Sequence[ConvLayerSpec],
                 fc_layers: Sequence[FCLayerSpec]) -> NetworkCost:
    return NetworkCost(name=name,
                       conv=[conv_cost(l) for l in conv_layers],
                       fc=[fc_cost(l) for l in fc_layers])
