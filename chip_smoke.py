#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and `nvcc`:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no result:

  1. the card: name, SM count, `nvidia-smi` name and power limit; TF32 off.
  2. build every kernel of `src/repro_torch/csrc/` (one `nvcc` each, in
     parallel) into `build/repro_torch/`, timed.
  3. hold each kernel against its plain PyTorch version on the card at every
     AlexNet layer shape (batch 1 and 32) and at a few ragged shapes:
     max|kernel - plain| / max|plain| <= 1e-4.
  4. AlexNet (full width, random weights from a seed) end to end through
     `compile(program("alexnet", batch=B), EngineConfig(backend="cuda"))
     .apply(params, x)` at B = 1 and 32: every op on "cuda", 5 conv and 3
     matmul kernel launches per forward, logits finite and within
     1e-4 * max|logits| of the "torch" backend on the same weights, the
     batch-1 Table-4 row equal to tests/goldens/table4_alexnet.json; median ms per
     forward and images/s from CUDA events after warm-up.
     Then VGG-16 and ResNet-50 at B = 1 the same way: every op on "cuda", one
     launch per conv and FC op, logits within 1e-4 of the "torch" backend,
     Table-4 rows equal to their goldens.
  5. per kernel: its time over the main path's shapes beside its bound, its
     plain version's time and one library call's time (`F.conv2d` on NCHW,
     `torch.addmm`, each followed by relu, TF32 off).

The last lines are the card's name and power limit, a JSON object listing
the kernels, and `{"ok": true, "device": {...}}`.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                  # max|Δ| / max|reference|, kernels and logits
BATCHES = (1, 32)
DEVICE = "cuda"
# H100 SXM peaks from NVIDIA's data sheet (dense, 700 W): fp32 outside the
# tensor cores, and device-memory bandwidth.
PEAK_FP32_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi(query):
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters=20, warmup=3):
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
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


def bound_ms(n_bytes, flops):
    """The least time the card could take: bytes over the memory rate or
    fp32 operations over the fp32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_FP32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def conv_cases(cnn, batch, gen, dev):
    """(label, kwargs) for every AlexNet conv at `batch`: inputs, HWIO
    weights, a bias and relu, as the main path gives them."""
    convs, _ = cnn.analytics_layers("alexnet")
    cases = []
    for s in convs:
        cg = s.c_in // s.groups
        fan_in = s.h_f * s.w_f * cg
        cases.append((f"{s.name} B={batch}", s, dict(
            x=torch.randn((batch, s.h_in, s.w_in, s.c_in), generator=gen).to(dev),
            w=(torch.randn((s.h_f, s.w_f, cg, s.c_out), generator=gen)
               * (2.0 / fan_in) ** 0.5).to(dev),
            bias=(0.1 * torch.randn(s.c_out, generator=gen)).to(dev),
            stride=s.s, pad=s.pad, groups=s.groups, act="relu")))
    return cases


def fc_cases(cnn, batch, gen, dev):
    _, fcs = cnn.analytics_layers("alexnet")
    relu = {fd.name: fd.relu for fd in cnn.CNNS["alexnet"].fcs}
    return [(f"{f.name} B={batch}", f, dict(
        x=torch.randn((batch, f.n), generator=gen).to(dev),
        w=(torch.randn((f.n, f.m), generator=gen) * (2.0 / f.n) ** 0.5).to(dev),
        bias=(0.1 * torch.randn(f.m, generator=gen)).to(dev),
        act="relu" if relu[f.name] else None)) for f in fcs]


def ragged_cases(gen, dev):
    """Shapes off the main path: gelu, stride 2, groups, ragged channel and
    row counts, output rows wider than one 64-pixel pass, no bias."""
    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    conv = [
        dict(x=t(2, 13, 13, 5), w=t(3, 3, 5, 7), bias=None, stride=2, pad=1,
             groups=1, act="gelu"),
        dict(x=t(1, 20, 20, 12), w=t(5, 5, 6, 70), bias=t(70), stride=1,
             pad=2, groups=2, act="relu"),
        dict(x=t(3, 9, 130, 3), w=t(3, 3, 3, 16), bias=t(16), stride=1,
             pad=1, groups=1, act=None),
    ]
    mm = [
        dict(x=t(5, 300), w=t(300, 70), bias=t(70), act="gelu"),
        dict(x=t(1, 1000), w=t(1000, 33), bias=None, act=None),
        dict(x=t(17, 257), w=t(257, 129), bias=t(129), act="relu"),
    ]
    return conv, mm


def main():
    # -- phase 1: the card ---------------------------------------------------
    require(torch.cuda.is_available(), "no CUDA device: this script runs "
            "only on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import engine as E
    from repro_torch.kernels import build, gfid_conv, gfid_matmul
    from repro_torch.models import cnn

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    props = torch.cuda.get_device_properties(0)
    name_power = smi("name,power.limit")
    max_sm_mhz = float(smi("clocks.max.sm").split()[0])
    derived_peak = props.multi_processor_count * 128 * 2 * max_sm_mhz * 1e6
    print(f"[card] {torch.cuda.get_device_name(0)}, {props.multi_processor_count} SMs, "
          f"{props.total_memory / 2**30:.1f} GiB; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(f"[card] nvidia-smi: {name_power}; max SM clock {max_sm_mhz:.0f} MHz -> "
          f"fp32 FMA peak {derived_peak / 1e12:.1f} TFLOP/s "
          f"(SMs x 128 lanes x 2 x clock); bounds below use {PEAK_FP32_FLOP_S / 1e12:.0f} "
          f"TFLOP/s and {PEAK_BYTES_S / 1e12:.2f} TB/s")

    src = torch.empty(9216 * 4096, device=dev)     # the size of fc6's weights
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    print(f"[card] device copy of {src.numel() * 4 / 1e6:.1f} MB: {copy_ms:.4f} ms, "
          f"{2 * src.numel() * 4 / copy_ms / 1e9:.3f} TB/s read + write")
    del src, dst

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc, in parallel)")
    for kname, (secs, log) in built.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {kname}: {secs:.2f} s; " + " | ".join(usage))

    # -- phase 3: kernel vs plain on the card ----------------------------------
    gen = torch.Generator().manual_seed(0)
    checks = 0
    worst = {"gfid_conv2d_nhwc": 0.0, "gfid_matmul": 0.0}    # max |kernel - plain|
    conv_main, fc_main = {}, {}
    for batch in BATCHES:
        conv_main[batch] = conv_cases(cnn, batch, gen, dev)
        fc_main[batch] = fc_cases(cnn, batch, gen, dev)
    ragged_conv, ragged_mm = ragged_cases(gen, dev)
    conv_all = [(lbl, kw) for b in BATCHES for lbl, _, kw in conv_main[b]] \
        + [(f"ragged conv {i}", kw) for i, kw in enumerate(ragged_conv)]
    mm_all = [(lbl, kw) for b in BATCHES for lbl, _, kw in fc_main[b]] \
        + [(f"ragged matmul {i}", kw) for i, kw in enumerate(ragged_mm)]
    for kname, kernel, plain, cases in (
            ("gfid_conv2d_nhwc", gfid_conv.gfid_conv2d_nhwc,
             gfid_conv.gfid_conv2d_nhwc_plain, conv_all),
            ("gfid_matmul", gfid_matmul.gfid_matmul,
             gfid_matmul.gfid_matmul_plain, mm_all)):
        for label, kw in cases:
            got = kernel(**kw)
            want = plain(**kw)
            torch.cuda.synchronize()
            require(got.shape == want.shape and bool(torch.isfinite(got).all()),
                    f"{kname} {label}: bad output")
            err = rel_err(got, want)
            abs_err = (got - want).abs().max().item()
            print(f"[check] {kname} {label}: out {tuple(got.shape)}, max|d| = "
                  f"{abs_err:.3e}, max|d|/max|ref| = {err:.3e}")
            require(err <= TOL, f"{kname} {label}: error {err:.3e} > {TOL}")
            worst[kname] = max(worst[kname], abs_err)
            checks += 1
    print(f"[check] {checks} kernel checks passed (tolerance {TOL})")

    # -- phase 4: AlexNet end to end -------------------------------------------
    golden = json.loads((ROOT / "tests/goldens/table4_alexnet.json").read_text())
    params = cnn.init_cnn("alexnet", seed=0, device=DEVICE)
    main_launches = None
    for batch in BATCHES:
        x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                        generator=torch.Generator().manual_seed(batch)).to(dev)
        compiled = E.compile(cnn.program("alexnet", batch=batch),
                             E.EngineConfig(backend="cuda"))
        require(compiled.backends() == ("cuda",) * 8,
                f"backends {compiled.backends()}")
        if batch == 1:
            require(compiled.cost == golden,
                    f"Table-4 row {compiled.cost} != golden {golden}")
        gfid_conv.gfid_conv2d_nhwc.launches = 0
        gfid_matmul.gfid_matmul.launches = 0
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = (gfid_conv.gfid_conv2d_nhwc.launches,
                    gfid_matmul.gfid_matmul.launches)
        require(launches == (5, 3), f"B={batch}: launches (conv, matmul) = "
                f"{launches}, expected (5, 3)")
        if main_launches is None:
            main_launches = launches
        require(tuple(logits.shape) == (batch, 1000)
                and bool(torch.isfinite(logits).all()), "bad logits")
        plain = E.compile(cnn.program("alexnet", batch=batch),
                          E.EngineConfig(backend="torch"))
        ref = plain.apply(params, x)
        err = rel_err(logits, ref)
        require(err <= TOL, f"B={batch}: logits vs torch backend {err:.3e} > {TOL}")
        ms = time_ms(lambda: compiled.apply(params, x))
        ms_torch = time_ms(lambda: plain.apply(params, x), iters=5)
        print(f"[alexnet] B={batch}: backends all cuda, launches conv={launches[0]} "
              f"matmul={launches[1]}, logits max|d|/max|ref| vs torch backend = "
              f"{err:.3e}" + (", Table-4 row == golden" if batch == 1 else ""))
        print(f"[alexnet] B={batch}: {ms:.4f} ms/forward (median of 20), "
              f"{batch / ms * 1e3:.1f} images/s; torch backend "
              f"{ms_torch:.4f} ms/forward (median of 5)")

    # -- phase 4b: VGG-16 and ResNet-50 through the same kernels, batch 1 -------
    del params
    for net in ("vgg16", "resnet50"):
        golden = json.loads((ROOT / f"tests/goldens/table4_{net}.json").read_text())
        params = cnn.init_cnn(net, seed=0, device=DEVICE)
        x = torch.randn((1, *cnn.CNNS[net].input_hw_c),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        compiled = E.compile(cnn.program(net), E.EngineConfig(backend="cuda"))
        kinds = [op.kind for op, _ in compiled.exec_pairs]
        require(set(compiled.backends()) == {"cuda"},
                f"{net}: backends {compiled.backends()}")
        require(compiled.cost == golden, f"{net}: Table-4 row {compiled.cost} "
                f"!= golden {golden}")
        gfid_conv.gfid_conv2d_nhwc.launches = 0
        gfid_matmul.gfid_matmul.launches = 0
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = (gfid_conv.gfid_conv2d_nhwc.launches,
                    gfid_matmul.gfid_matmul.launches)
        want = (kinds.count("conv2d"), kinds.count("dense"))
        require(launches == want, f"{net}: launches (conv, matmul) = {launches}, "
                f"expected {want}")
        require(tuple(logits.shape) == (1, 1000)
                and bool(torch.isfinite(logits).all()), f"{net}: bad logits")
        ref = E.compile(cnn.program(net), E.EngineConfig(backend="torch")
                        ).apply(params, x)
        err = rel_err(logits, ref)
        require(err <= TOL, f"{net}: logits vs torch backend {err:.3e} > {TOL}")
        ms = time_ms(lambda: compiled.apply(params, x), iters=5)
        print(f"[{net}] B=1: backends all cuda, launches conv={launches[0]} "
              f"matmul={launches[1]}, logits max|d|/max|ref| vs torch backend = "
              f"{err:.3e}, Table-4 row == golden; {ms:.4f} ms/forward (median of 5)")
        del params, compiled

    # -- phase 5: kernel times at the main path's shapes -----------------------
    def lib_conv(x, w, bias, stride, pad, groups, act):
        out = F.conv2d(x, w, bias, stride=stride, padding=pad, groups=groups)
        return torch.relu(out) if act == "relu" else out

    def lib_mm(x, w, bias, act):
        out = torch.addmm(bias, x, w)
        return torch.relu(out) if act == "relu" else out

    totals = {}
    for kname, kernel, plain, per_batch in (
            ("gfid_conv2d_nhwc", gfid_conv.gfid_conv2d_nhwc,
             gfid_conv.gfid_conv2d_nhwc_plain, conv_main),
            ("gfid_matmul", gfid_matmul.gfid_matmul,
             gfid_matmul.gfid_matmul_plain, fc_main)):
        for batch in BATCHES:
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       n_bytes=0, flops=0)
            for label, spec, kw in per_batch[batch]:
                flops = 2 * batch * spec.macs
                if kname == "gfid_conv2d_nhwc":
                    out_elems = batch * spec.h_out * spec.w_out * spec.c_out
                    lib_kw = dict(x=kw["x"].permute(0, 3, 1, 2).contiguous(),
                                  w=kw["w"].permute(3, 2, 0, 1).contiguous(),
                                  bias=kw["bias"], stride=kw["stride"],
                                  pad=kw["pad"], groups=kw["groups"], act=kw["act"])
                    lib = lib_conv
                else:
                    out_elems = batch * spec.m
                    lib_kw, lib = kw, lib_mm
                n_bytes = 4 * (kw["x"].numel() + kw["w"].numel()
                               + kw["bias"].numel() + out_elems)
                b_ms, _ = bound_ms(n_bytes, flops)
                k_ms = time_ms(lambda: kernel(**kw))
                p_ms = time_ms(lambda: plain(**kw))
                l_ms = time_ms(lambda: lib(**lib_kw))
                print(f"[time] {kname} {label}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} ms "
                      f"({n_bytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP)")
                for key, val in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                                 ("bound_ms", b_ms), ("n_bytes", n_bytes),
                                 ("flops", flops)):
                    tot[key] += val
            tot["bound_by"] = bound_ms(tot["n_bytes"], tot["flops"])[1]
            totals[(kname, batch)] = tot
            print(f"[time] {kname} B={batch} total over the path's layers: kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
                  f"{tot['library_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms "
                  f"({tot['bound_by']})")

    sources = {"gfid_conv2d_nhwc": ("src/repro_torch/csrc/gfid_conv.cu",
                                    "src/repro/kernels/gfid_conv.py:79"),
               "gfid_matmul": ("src/repro_torch/csrc/gfid_matmul.cu",
                               "src/repro/kernels/gfid_matmul.py:85")}
    kernels = []
    for i, kname in enumerate(("gfid_conv2d_nhwc", "gfid_matmul")):
        tot = totals[(kname, 1)]
        kernels.append({
            "name": kname, "route": "cuda", "source": sources[kname][0],
            "replaces": sources[kname][1], "launches": main_launches[i],
            "max_abs_err": worst[kname],
            # one measured number under both names the line is read by
            **dict.fromkeys(("ms", "kernel_ms"), tot["ms"]),
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"]})
    print(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
