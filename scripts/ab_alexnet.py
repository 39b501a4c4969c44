#!/usr/bin/env python3
"""Time AlexNet's forward in int8, fp32 or bf16 on one card for several
checkouts of the repo, one process each, in the order given, so that two
versions are compared on one machine (run them as A, B, B, A, A, B, ...:
the host's speed drifts between processes):

    python3 scripts/ab_alexnet.py [--precision int8|fp32|bf16] \\
        [--batches 1,32] [--out FILE] LABEL=TREE [LABEL=TREE ...]

TREE is the root of a checkout (its `src/` holds `repro_torch`). Each run
builds that checkout's conv and GEMM kernels of the precision, compiles
AlexNet through `engine.compile` for backend "cuda" (int8: at precision
int8; bf16: `program(dtype=torch.bfloat16)` on bf16 weights) with seeded
random weights, requires 5 conv and 3 GEMM calls a forward and logits equal
to the "torch" backend's (int8 bitwise, fp32 within 1e-4 and bf16 within
2e-2 of max|logits|), then times, at each batch:

  * forward_ms: `CompiledNet.apply` with the host (median of 20 CUDA-event
    timings after 3 warm-up calls);
  * quant_ms (int8): the forward's `core/quant` calls alone, replayed on the
    operands one forward gave them (the same median);
  * conv_ms / mm_ms: the forward's conv / GEMM calls replayed on the
    operands one forward gave them, each with the host (the same median),
    summed;
  * conv_alone_ms / mm_alone_ms: the same calls on the device alone (a
    CUDA graph of 100 calls replayed, median of 10, over 100), summed.

Prints the card's name and power limit, one JSON line a run, a table of
the runs and each label's medians over its runs; `--out` also writes the
JSON lines to a file. Needs a CUDA card and
imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def time_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, calls=100):
    """The device's time for one call of fn: a CUDA graph of `calls` calls
    replayed between CUDA events (median of 10), over `calls`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, iters=10) / calls


# precision -> (kernel sources, (module, wrapper) of the conv and the GEMM)
KERNELS = {"int8": (("gfid_conv_int8", "gfid_matmul_int8"),
                    ("gfid_conv2d_nhwc_int8", "gfid_matmul_int8")),
           "fp32": (("gfid_conv", "gfid_matmul"),
                    ("gfid_conv2d_nhwc", "gfid_matmul")),
           "bf16": (("gfid_conv_bf16", "gfid_matmul_bf16"),
                    ("gfid_conv2d_nhwc", "gfid_matmul"))}
# the logits against the "torch" backend's: max|d| / max|torch|
LOGITS_TOL = {"int8": 0.0, "fp32": 1e-4, "bf16": 2e-2}


def child(tree: str, batches, precision: str) -> dict:
    """One checkout's numbers (see the module's docstring)."""
    import torch
    from concurrent.futures import ThreadPoolExecutor
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script runs only on a GPU")
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    from repro_torch import engine as E
    from repro_torch.core import quant
    from repro_torch.kernels import build, gfid_conv, gfid_matmul
    from repro_torch.models import cnn

    sources, (conv_name, mm_name) = KERNELS[precision]
    with ThreadPoolExecutor(max_workers=2) as pool:
        list(pool.map(build.library, sources))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    params = cnn.init_cnn("alexnet", seed=0, device="cuda", dtype=dtype)
    hooks = ((gfid_conv, conv_name, "conv"), (gfid_matmul, mm_name, "mm"))
    if precision == "int8":
        hooks += ((quant, "quantize_conv_operands", "quant"),
                  (quant, "quantize_matmul_operands", "quant"))
    cfg = E.EngineConfig(backend="cuda", precision=(
        "int8" if precision == "int8" else "fp32"))
    out = {"tree": tree, "torch": torch.__version__, "precision": precision}
    for batch in batches:
        x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                        generator=torch.Generator().manual_seed(batch)).to(
                            dev, dtype)
        program = cnn.program("alexnet", batch=batch, dtype=dtype)
        compiled = E.compile(program, cfg)
        calls = {"conv": [], "mm": [], "quant": []}
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in hooks]

        def recorder(fn, kind):
            def call(*a, **kw):
                calls[kind].append((fn, a, kw))
                return fn(*a, **kw)
            call.launches = 0   # a wrapper counts its launches by its name
            return call
        for (mod, name, kind), (_, _, fn) in zip(hooks, saved):
            setattr(mod, name, recorder(fn, kind))
        try:
            logits = compiled.apply(params, x)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        torch.cuda.synchronize()
        got = {k: len(v) for k, v in calls.items()}
        want = {"conv": 5, "mm": 3, "quant": 8 if precision == "int8" else 0}
        if got != want:
            raise SystemExit(f"B={batch}: calls a forward {got}, expected "
                             f"{want}")
        ref = E.compile(program, cfg.replace(backend="torch")).apply(params, x)
        err = ((logits.float() - ref.float()).abs().max()
               / ref.float().abs().max()).item()
        if not err <= LOGITS_TOL[precision]:
            raise SystemExit(f"B={batch}: {precision} logits {err:.3e} of max "
                             f"from the torch backend's (limit "
                             f"{LOGITS_TOL[precision]})")
        row = {"forward_ms": time_ms(lambda: compiled.apply(params, x))}

        def replay(kind):
            return lambda: [fn(*a, **kw) for fn, a, kw in calls[kind]]
        if precision == "int8":
            row["quant_ms"] = time_ms(replay("quant"))
        for kind in ("conv", "mm"):
            row[f"{kind}_ms"] = sum(time_ms(lambda c=c: c[0](*c[1], **c[2]))
                                    for c in calls[kind])
            row[f"{kind}_alone_ms"] = sum(graph_ms(lambda c=c: c[0](*c[1], **c[2]))
                                          for c in calls[kind])
        out[f"B={batch}"] = row
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("runs", nargs="*", help="LABEL=TREE, in run order")
    parser.add_argument("--precision", default="int8",
                        choices=sorted(KERNELS))
    parser.add_argument("--batches", default="1,32",
                        type=lambda v: [int(b) for b in v.split(",")])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.child:
        print(json.dumps(child(args.child, args.batches, args.precision)))
        return
    if not args.runs:
        parser.error("give at least one LABEL=TREE")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    lines = []
    for run in args.runs:
        label, _, tree = run.partition("=")
        proc = subprocess.run([sys.executable, __file__, "--child", tree,
                               "--precision", args.precision,
                               "--batches", ",".join(map(str, args.batches))],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            sys.stderr.write(proc.stdout + proc.stderr)
            raise SystemExit(f"run {label} ({tree}) failed: exit {proc.returncode}")
        result = dict(json.loads(proc.stdout.strip().splitlines()[-1]),
                      label=label, card=card)
        lines.append(result)
        print(json.dumps(result), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))
    keys = (("forward_ms",) + (("quant_ms",) if args.precision == "int8"
                               else ())
            + ("conv_ms", "conv_alone_ms", "mm_ms", "mm_alone_ms"))
    print("run | batch | " + " | ".join(keys))
    for r in lines:
        for batch in args.batches:
            row = r[f"B={batch}"]
            print(f"{r['label']} | {batch} | "
                  + " | ".join(f"{row[k]:.4f}" for k in keys))
    # each label's median over its runs (a process's host varies more than
    # the 20 timings inside it)
    print("label (runs) | batch | median " + " | median ".join(keys))
    for label in dict.fromkeys(r["label"] for r in lines):
        mine = [r for r in lines if r["label"] == label]
        for batch in args.batches:
            print(f"{label} ({len(mine)}) | {batch} | " + " | ".join(
                f"{statistics.median(r[f'B={batch}'][k] for r in mine):.4f}"
                for k in keys))


if __name__ == "__main__":
    main()
