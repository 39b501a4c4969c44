#!/usr/bin/env python3
"""Phase 3's window, softcap and q_offset flash checks and phase 15 of
`chip_smoke.py` alone: gemma2-27b's local attention at full width on one
GPU, after building the port's kernels.

    python3 scripts/local_phase.py [--flash-only]

`--flash-only` builds the two flash sources alone and runs only phase 3's
flash cases (`local_flash_check`) and phase 15's flash timing at gemma2's
shape. Exits non-zero on any failed hold; the numbers are the last line,
as JSON.
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
    ap.add_argument("--flash-only", action="store_true",
                    help="build the flash sources and run their checks alone")
    args = ap.parse_args()
    C.require(torch.cuda.is_available(), "no CUDA device: this script runs only "
              "on a GPU")
    from repro_torch import engine as E
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                     gfid_matmul, paged)
    C.card_numerics()
    print(f"[card] nvidia-smi: {C.smi('name,power.limit')}")
    t0 = time.perf_counter()
    if args.flash_only:
        for name in ("flash_attention", "flash_attention_bf16"):
            build.library(name)
    else:
        build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    dev = torch.device(C.DEVICE)
    worst = {"flash_attention": 0.0, "flash_attention_bf16": 0.0,
             "gfid_matmul_bf16": 0.0}
    t0 = time.perf_counter()
    C.local_flash_check(dev, flash_attention, worst)
    print(f"[time] phase 3's local flash checks {time.perf_counter() - t0:.1f} s")
    if args.flash_only:
        out = C.local_flash_timing(dev, flash_attention, get_config(C.LOCAL_MODEL),
                                   worst)
    else:
        G = gfid_matmul
        others = (gfid_conv.gfid_conv2d_nhwc, G.gfid_matmul,
                  gfid_conv.gfid_conv2d_nhwc_int8, G.gfid_matmul_int8,
                  gfid_conv.gfid_conv2d_nhwc_bf16, conv1d.gfid_conv1d_depthwise,
                  flash_attention.flash_attention, flash_attention.flash_attention_local,
                  G.gfid_matmul_grouped, G.gfid_matmul_bf16_grouped)
        out = C.local_phase(dev, E, G, paged, flash_attention, others, worst)
    print(json.dumps(dict(out, worst=worst), default=str))


if __name__ == "__main__":
    main()
