#!/usr/bin/env python3
"""Phase 13 of `chip_smoke.py` alone: llama-3.2-vision-11b at full width and
depth on one GPU, after building the port's kernels.

    python3 scripts/vlm_phase.py [--host-weights]

With `--host-weights` the phase's own weights (not those `launch/serve.py`
draws for the main path) come from `init_params(..., device="cpu")`, drawn
by the host's generator (about 90 s for 9.77 B parameters), and are moved
to the card: the same holds on another draw of the same seed. Exits
non-zero on any failed hold; the phase's numbers are the last line, as
JSON.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--host-weights", action="store_true",
                    help="draw the phase's own weights on the host")
    args = ap.parse_args()
    C.require(torch.cuda.is_available(), "no CUDA device: this script runs only "
              "on a GPU")
    from repro_torch import engine as E
    from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                     gfid_matmul, paged)
    C.card_numerics()
    print(f"[card] nvidia-smi: {C.smi('name,power.limit')}")
    build.build_all()
    G = gfid_matmul
    others = (gfid_conv.gfid_conv2d_nhwc_int8, G.gfid_matmul_int8,
              gfid_conv.gfid_conv2d_nhwc_bf16, conv1d.gfid_conv1d_depthwise,
              paged.paged_gather, G.gfid_matmul_grouped, G.gfid_matmul_bf16_grouped)
    worst = {"flash_attention": 0.0, "flash_attention_bf16": 0.0,
             "gfid_matmul_bf16": 0.0}
    vlm = C.vlm_phase(torch.device(C.DEVICE), E, G, flash_attention, others, worst,
                      host_weights=args.host_weights)
    print(json.dumps(dict(vlm, worst=worst), default=str))


if __name__ == "__main__":
    main()
