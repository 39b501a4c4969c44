#!/usr/bin/env python3
"""Phase 3's jamba cases and phase 17 of `chip_smoke.py` alone:
jamba-1.5-large's hybrid stack at full width on one GPU, after building the
port's kernels.

    python3 scripts/hybrid_phase.py [--checks-only]

`--checks-only` builds the two sources of the path's new shapes alone
(`conv1d_depthwise`, `gfid_matmul_bf16`) and runs only phase 3's cases: the
bf16 depthwise conv at d_inner 16,384 and the 16-expert grouped GEMM. Exits
non-zero on any failed hold; the numbers are the last line, as JSON.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--checks-only", action="store_true",
                    help="build the conv and bf16 GEMM sources and run their "
                         "checks alone")
    args = ap.parse_args()
    C.require(torch.cuda.is_available(), "no CUDA device: this script runs only "
              "on a GPU")
    from repro_torch import engine as E
    from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                     gfid_matmul, paged)
    C.card_numerics()
    print(f"[card] nvidia-smi: {C.smi('name,power.limit')}")
    t0 = time.perf_counter()
    if args.checks_only:
        for name in ("conv1d_depthwise", "gfid_matmul_bf16"):
            build.library(name)
    else:
        build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    dev = torch.device(C.DEVICE)
    worst = {}
    t0 = time.perf_counter()
    checks = C.hybrid_kernel_check(dev, gfid_matmul, conv1d, worst)
    print(f"[time] phase 3's {checks} jamba checks {time.perf_counter() - t0:.1f} s")
    out = {"checks": checks}
    if not args.checks_only:
        G = gfid_matmul
        # lm_phase counts the bf16 and fp32 GEMM, the grouped bf16 GEMM, the
        # bf16 flash, the gather and the depthwise conv itself
        others = (gfid_conv.gfid_conv2d_nhwc, gfid_conv.gfid_conv2d_nhwc_int8,
                  G.gfid_matmul_int8, gfid_conv.gfid_conv2d_nhwc_bf16,
                  flash_attention.flash_attention, flash_attention.flash_attention_local,
                  G.gfid_matmul_grouped)
        out.update(C.hybrid_phase(dev, E, G, conv1d, paged, flash_attention, others,
                                  worst))
    print(json.dumps(dict(out, worst=worst), default=str))


if __name__ == "__main__":
    main()
