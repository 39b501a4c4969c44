#!/usr/bin/env python3
"""Phase 14 of `chip_smoke.py` alone: the kernel tuner (`engine/tune.py`) on
one GPU, after building the port's kernels.

    python3 scripts/tune_phase.py

Autotunes AlexNet (fp32, int8, bf16; batch 1 and 32), VGG-16 and ResNet-50
(fp32, batch 1) into a temporary cache, holds every candidate tile bitwise
and the cached nets and the static `Scheduler` bitwise against the untuned
ones, and times the forwards. Exits non-zero on any failed hold; the
phase's numbers are the last line, as JSON.
"""
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as C  # noqa: E402


def main():
    C.require(torch.cuda.is_available(), "no CUDA device: this script runs only "
              "on a GPU")
    from repro_torch import engine as E
    from repro_torch.kernels import build, gfid_conv, gfid_matmul
    from repro_torch.models import cnn
    C.card_numerics()
    print(f"[card] nvidia-smi: {C.smi('name,power.limit')}")
    build.build_all()
    G, K = gfid_matmul, gfid_conv
    tuner = C.tuner_phase(torch.device(C.DEVICE), E, cnn, {
        "fp32": (K.gfid_conv2d_nhwc, G.gfid_matmul),
        "int8": (K.gfid_conv2d_nhwc_int8, G.gfid_matmul_int8),
        "bf16": (K.gfid_conv2d_nhwc_bf16, G.gfid_matmul_bf16)})
    rows = [{k: v for k, v in r.items() if k != "op"} for r in tuner["rows"]]
    print(json.dumps(dict(tuner, rows=rows,
                          fwd={" ".join(map(str, k)): v
                               for k, v in tuner["fwd"].items()})))


if __name__ == "__main__":
    main()
