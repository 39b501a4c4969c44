"""Mode table for the multi-mode inference engine (paper §3-§4, Tables 2-3).

A *mode* is the pair (W_f, S) of a layer's filter width and stride. The paper
shows each mode needs T = ceil(W_f / S) active PEs per 1-D tile, and the MMIE
chip regroups its K=6 PEs per reconfigurable tile accordingly. Table 3 fixes
the effective output-row tile width N_eff and tile parallelism p_eff used by
the 192-PE chip for each mode.

A copy of `repro.core.modes` without its TPU constants and MXU tiling rule:
the port's kernels are tiled for Hopper (see `EnginePlan.tiling`), and
importing the JAX package would pull JAX in.
"""
from __future__ import annotations

import dataclasses
import math

# MMIE chip constants (paper §5).
MMIE_NUM_TILES = 32
MMIE_PES_PER_TILE = 6  # K = 6, Eq. (10) discussion
MMIE_NUM_PES = MMIE_NUM_TILES * MMIE_PES_PER_TILE  # 192
MMIE_CONV_FREQ_HZ = 200e6
MMIE_FC_FREQ_HZ = 40e6
MMIE_WORD_BYTES = 2          # 16-bit fixed point
MMIE_SCRATCH_ENTRIES = 64    # L = 64 24-bit partial sums per PE


def pes_per_tile(w_f: int, s: int) -> int:
    """T — minimum active neurons (PEs) per 1-D tile for mode (W_f, S).

    Paper §3: the GFID matrix M has at most ceil(W_f / S) non-zero entries
    per row, hence that many simultaneously active neurons (Table 2).
    """
    if w_f < 1 or s < 1:
        raise ValueError(f"invalid mode (W_f={w_f}, S={s})")
    return math.ceil(w_f / s)


@dataclasses.dataclass(frozen=True)
class Mode:
    """One operating mode of the multi-mode engine."""

    w_f: int           # filter width (1 for FC / pure GEMM mode)
    s: int             # stride
    n_eff: int         # effective output-row tile width N (Table 3)
    p_eff: int         # effective parallel tiles p (Table 3)

    @property
    def t(self) -> int:
        return pes_per_tile(self.w_f, self.s)

    @property
    def pes_per_virtual_tile(self) -> int:
        """PEs the reconfigurable 6-PE tile actually devotes (paper §4.1).

        T in {1,2,3} packs evenly into 6 PEs; T in {4,5,6} occupies the whole
        6-PE tile (the paper's K=6 compromise).
        """
        t = self.t
        return t if t <= 3 else 6

    @property
    def virtual_tiles_per_physical(self) -> int:
        """How many virtual tiles one 6-PE reconfigurable tile provides."""
        t = self.t
        return 6 // t if t <= 3 else 1


# Table 3 of the paper: effective N and p per filter mode on the 192-PE MMIE.
_TABLE3 = {
    (11, 4): Mode(11, 4, n_eff=192, p_eff=64),
    (7, 2): Mode(7, 2, n_eff=384, p_eff=32),
    (5, 1): Mode(5, 1, n_eff=384, p_eff=32),
    (3, 1): Mode(3, 1, n_eff=192, p_eff=64),
    (1, 1): Mode(1, 1, n_eff=64, p_eff=192),
}


def paper_mode(w_f: int, s: int) -> Mode:
    """Exact Table-3 mode if listed, else a derived mode with the same rule.

    Derivation for unlisted (W_f, S): the chip regroups its 32 physical tiles
    into `32 * (6 // T)` virtual tiles when T <= 3 and 32 when T in {4,5,6};
    N_eff keeps the per-PE scratch (L=64 partial sums) saturated:
    N_eff = L * PEs-per-virtual-tile ... matching Table 3's pattern
    (e.g. 3x3: 64*3=192, 5x5: 64*6=384, 1x1: 64*1=64).
    """
    key = (int(w_f), int(s))
    if key in _TABLE3:
        return _TABLE3[key]
    if w_f > 11:
        raise ValueError(
            f"mode (W_f={w_f}, S={s}) exceeds the 11-register weight sets of the "
            "MMIE weight generator (paper §4.1)")
    return derived_mode(w_f, s)


def derived_mode(w_f: int, s: int) -> Mode:
    """Table-3 derivation rule without the 11-register weight-generator
    guard — for planning layers the physical chip could not host, which
    still need a schedule."""
    t = pes_per_tile(w_f, s)
    pes = t if t <= 3 else 6
    virt = 6 // t if t <= 3 else 1
    return Mode(w_f, s, n_eff=MMIE_SCRATCH_ENTRIES * pes,
                p_eff=MMIE_NUM_TILES * virt)


def fc_mode(p: int = MMIE_NUM_PES) -> Mode:
    """Fully-connected mode (paper §4.1.6): every PE is its own tile, UF=100%."""
    return Mode(1, 1, n_eff=1, p_eff=p)
