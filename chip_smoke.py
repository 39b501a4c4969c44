#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU and check it.

Run from the root of a checkout, on a machine with a CUDA card and `nvcc`:

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit and no result:

  1. the card: name, SM count, `nvidia-smi` name and power limit; TF32 off.
  2. build every kernel of `src/repro_torch/csrc/` (one `nvcc` each, in
     parallel) into `build/repro_torch/`, timed, with ptxas's register and
     shared-memory use.
  3. hold each kernel against its plain PyTorch version on the card at every
     AlexNet layer shape (batch 1 and 32) and at a few ragged shapes. fp32:
     max|kernel - plain| / max|plain| <= 1e-4. int8 (operands quantized on
     the card by `core/quant`): max|kernel - plain| == 0 for act None and
     relu, <= 1e-6 * max|plain| for gelu.
  4. AlexNet (full width, random weights from a seed) end to end through
     `compile(program("alexnet", batch=B), EngineConfig(backend="cuda"))
     .apply(params, x)` at B = 1 and 32: every op on "cuda", 5 conv and 3
     matmul kernel launches per forward, logits finite and within
     1e-4 * max|logits| of the "torch" backend on the same weights, the
     batch-1 Table-4 row equal to tests/goldens/table4_alexnet.json; median ms per
     forward and images/s from CUDA events after warm-up.
     Then the same under `EngineConfig(backend="cuda", precision="int8")`:
     every op int8 on "cuda", 5 int8 conv and 3 int8 matmul launches and no
     fp32 launch per forward, logits bitwise equal to the "torch" backend
     under int8, SNR against the fp32 logits >= 28 dB, the Table-4 row still
     the golden; ms per forward, images/s, and the time of the forward's
     quantization alone (the `core/quant` calls at the path's shapes).
     Then VGG-16 and ResNet-50 at B = 1, fp32 and int8: every op on "cuda",
     one launch per conv and FC op, fp32 logits within 1e-4 of the "torch"
     backend, int8 logits bitwise equal to it, Table-4 rows equal to their
     goldens. Then AlexNet with `precisions={"fc6": "int8"}` under an fp32
     config: one int8 matmul launch beside 5 fp32 conv and 2 fp32 matmul
     launches.
  5. per kernel: its time over the main path's shapes beside its bound, its
     plain version's time and one library call's time where one PyTorch call
     computes the same function (`F.conv2d` on NCHW and `torch.addmm`, each
     followed by relu, TF32 off; `torch._int_mm` for the int8 product where
     it accepts the shape; none for the int8 conv).

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
GELU_TOL = 1e-6             # int8 kernels with gelu: max|Δ| / max|plain|
SNR_FLOOR_DB = 28.0         # AlexNet int8 against fp32 (the reference's floor)
BATCHES = (1, 32)
OTHER_NETS = ("vgg16", "resnet50")   # driven at batch 1 after AlexNet
DEVICE = "cuda"
# H100 SXM peaks from NVIDIA's data sheet (dense, 700 W): fp32 outside the
# tensor cores, int8 in them, and device-memory bandwidth.
PEAK_FP32_FLOP_S = 67e12
PEAK_INT8_OP_S = 1979e12
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


def bound_ms(n_bytes, ops, peak_ops=PEAK_FP32_FLOP_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
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


def quantized(kind, kw, quant):
    """The int8 kernel's kwargs for one fp32 case: operands quantized on the
    card by the port's `core/quant`, scales shaped as the kernels take them."""
    kw = dict(kw)
    x, w = kw.pop("x"), kw.pop("w")
    if kind == "conv":
        xq, wq, sx, sw = quant.quantize_conv_operands(x, w)
        return dict(kw, xq=xq, wq=wq, sx=sx.reshape(-1, 1),
                    sw=sw.reshape(1, -1))
    xq, wq, sx, sw = quant.quantize_matmul_operands(x, w)
    return dict(kw, xq=xq, wq=wq, sx=sx, sw=sw)


def ragged_int8_cases(gen, dev, quant):
    """int8 shapes off the main path: C_in = 3 with stride 4 and pad 2,
    groups 2, gelu, no bias, rows wider than a pixel tile; K = 1025 (past
    the 1024 fp32 chunk, not a multiple of 4), N = 1000, N not a multiple of
    4, one row."""
    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    conv = [
        dict(x=t(2, 31, 31, 3), w=t(11, 11, 3, 20), bias=t(20), stride=4,
             pad=2, groups=1, act="relu"),
        dict(x=t(1, 20, 20, 12), w=t(5, 5, 6, 70), bias=t(70), stride=1,
             pad=2, groups=2, act="relu"),
        dict(x=t(2, 13, 13, 5), w=t(3, 3, 5, 7), bias=None, stride=2, pad=1,
             groups=1, act="gelu"),
        dict(x=t(3, 9, 130, 8), w=t(3, 3, 4, 16), bias=None, stride=1,
             pad=1, groups=2, act=None),
    ]
    mm = [
        dict(x=t(3, 1025), w=t(1025, 1000), bias=t(1000), act="relu"),
        dict(x=t(5, 300), w=t(300, 70), bias=t(70), act="gelu"),
        dict(x=t(17, 257), w=t(257, 129), bias=None, act=None),
        dict(x=t(1, 1000), w=t(1000, 33), bias=t(33), act=None),
    ]
    return ([quantized("conv", kw, quant) for kw in conv],
            [quantized("fc", kw, quant) for kw in mm])


def zero_counts(*wrappers):
    for fn in wrappers:
        fn.launches = 0


def counts(*wrappers):
    return tuple(fn.launches for fn in wrappers)


def int_mm_accepts(m, k, n):
    """Whether `torch._int_mm` takes an (m, k) @ (k, n) int8 product on the
    card: more than 16 rows and k, n multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def main():
    # -- phase 1: the card ---------------------------------------------------
    require(torch.cuda.is_available(), "no CUDA device: this script runs "
            "only on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import engine as E
    from repro_torch.core import quant
    from repro_torch.kernels import build, gfid_conv, gfid_matmul
    from repro_torch.models import cnn

    conv32, mm32 = gfid_conv.gfid_conv2d_nhwc, gfid_matmul.gfid_matmul
    conv8, mm8 = gfid_conv.gfid_conv2d_nhwc_int8, gfid_matmul.gfid_matmul_int8
    all_kernels = (conv32, mm32, conv8, mm8)

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
    worst = {}                                  # max |kernel - plain|
    conv_main, fc_main, conv8_main, fc8_main = {}, {}, {}, {}
    for batch in BATCHES:
        conv_main[batch] = conv_cases(cnn, batch, gen, dev)
        fc_main[batch] = fc_cases(cnn, batch, gen, dev)
        conv8_main[batch] = [(lbl, spec, quantized("conv", kw, quant))
                             for lbl, spec, kw in conv_main[batch]]
        fc8_main[batch] = [(lbl, spec, quantized("fc", kw, quant))
                           for lbl, spec, kw in fc_main[batch]]
    ragged_conv, ragged_mm = ragged_cases(gen, dev)
    ragged_conv8, ragged_mm8 = ragged_int8_cases(gen, dev, quant)

    def all_cases(main_cases, ragged, what):
        return [(lbl, kw) for b in BATCHES for lbl, _, kw in main_cases[b]] \
            + [(f"ragged {what} {i}", kw) for i, kw in enumerate(ragged)]

    for kname, kernel, plain, cases, int8 in (
            ("gfid_conv2d_nhwc", conv32, gfid_conv.gfid_conv2d_nhwc_plain,
             all_cases(conv_main, ragged_conv, "conv"), False),
            ("gfid_matmul", mm32, gfid_matmul.gfid_matmul_plain,
             all_cases(fc_main, ragged_mm, "matmul"), False),
            ("gfid_conv2d_nhwc_int8", conv8,
             gfid_conv.gfid_conv2d_nhwc_int8_plain,
             all_cases(conv8_main, ragged_conv8, "conv"), True),
            ("gfid_matmul_int8", mm8, gfid_matmul.gfid_matmul_int8_plain,
             all_cases(fc8_main, ragged_mm8, "matmul"), True)):
        worst[kname] = 0.0
        for label, kw in cases:
            got = kernel(**kw)
            want = plain(**kw)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == want.dtype
                    and bool(torch.isfinite(got).all()),
                    f"{kname} {label}: bad output")
            err = rel_err(got, want)
            abs_err = (got - want).abs().max().item()
            if int8:
                limit = GELU_TOL if kw["act"] == "gelu" else 0.0
            else:
                limit = TOL
            print(f"[check] {kname} {label}: out {tuple(got.shape)}, act "
                  f"{kw['act']}, max|d| = {abs_err:.3e}, max|d|/max|ref| = "
                  f"{err:.3e} (limit {limit:g})")
            require(err <= limit, f"{kname} {label}: error {err:.3e} > {limit}")
            worst[kname] = max(worst[kname], abs_err)
            checks += 1
    print(f"[check] {checks} kernel checks passed (fp32 {TOL}; int8 exact, "
          f"gelu {GELU_TOL})")

    # -- phase 4: AlexNet end to end -------------------------------------------
    golden = json.loads((ROOT / "tests/goldens/table4_alexnet.json").read_text())
    params = cnn.init_cnn("alexnet", seed=0, device=DEVICE)
    main_launches = {}
    forward_ms = {}
    fp32_logits = {}
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
        zero_counts(*all_kernels)
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = counts(*all_kernels)
        require(launches == (5, 3, 0, 0), f"B={batch}: launches (conv, matmul, "
                f"conv int8, matmul int8) = {launches}, expected (5, 3, 0, 0)")
        main_launches.setdefault("fp32", launches)
        require(tuple(logits.shape) == (batch, 1000)
                and bool(torch.isfinite(logits).all()), "bad logits")
        fp32_logits[batch] = logits
        plain = E.compile(cnn.program("alexnet", batch=batch),
                          E.EngineConfig(backend="torch"))
        ref = plain.apply(params, x)
        err = rel_err(logits, ref)
        require(err <= TOL, f"B={batch}: logits vs torch backend {err:.3e} > {TOL}")
        ms = time_ms(lambda: compiled.apply(params, x))
        ms_torch = time_ms(lambda: plain.apply(params, x), iters=5)
        forward_ms[("fp32", batch)] = ms
        print(f"[alexnet] B={batch}: backends all cuda, launches conv={launches[0]} "
              f"matmul={launches[1]}, logits max|d|/max|ref| vs torch backend = "
              f"{err:.3e}" + (", Table-4 row == golden" if batch == 1 else ""))
        print(f"[alexnet] B={batch}: {ms:.4f} ms/forward (median of 20), "
              f"{batch / ms * 1e3:.1f} images/s; torch backend "
              f"{ms_torch:.4f} ms/forward (median of 5)")

    # -- phase 4a: AlexNet int8 end to end --------------------------------------
    int8_cfg = E.EngineConfig(backend="cuda", precision="int8")
    for batch in BATCHES:
        x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                        generator=torch.Generator().manual_seed(batch)).to(dev)
        compiled = E.compile(cnn.program("alexnet", batch=batch), int8_cfg)
        require(compiled.backends() == ("cuda",) * 8
                and compiled.precisions() == ("int8",) * 8,
                f"int8: backends {compiled.backends()}, precisions "
                f"{compiled.precisions()}")
        if batch == 1:
            require(compiled.cost == golden,
                    f"int8 Table-4 row {compiled.cost} != golden {golden}")
        zero_counts(*all_kernels)
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = counts(*all_kernels)
        require(launches == (0, 0, 5, 3), f"int8 B={batch}: launches (conv, "
                f"matmul, conv int8, matmul int8) = {launches}, expected "
                "(0, 0, 5, 3)")
        main_launches.setdefault("int8", launches)
        require(tuple(logits.shape) == (batch, 1000)
                and bool(torch.isfinite(logits).all()), "bad int8 logits")
        plain = E.compile(cnn.program("alexnet", batch=batch),
                          E.EngineConfig(backend="torch", precision="int8"))
        ref = plain.apply(params, x)
        n_diff = int((logits != ref).sum().item())
        require(n_diff == 0, f"int8 B={batch}: {n_diff} logits differ from the "
                "torch backend under int8")
        snr = quant.snr_db(fp32_logits[batch], logits).item()
        require(snr >= SNR_FLOOR_DB, f"int8 B={batch}: SNR {snr:.2f} dB < "
                f"{SNR_FLOOR_DB}")
        ms = time_ms(lambda: compiled.apply(params, x))
        forward_ms[("int8", batch)] = ms

        # the forward's quantization alone: the core/quant calls at the
        # path's shapes (activations of each layer's input shape)
        q_inputs = [("conv", kw["x"], kw["w"]) for _, _, kw in conv_main[batch]] \
            + [("fc", kw["x"], kw["w"]) for _, _, kw in fc_main[batch]]

        def quantize_all():
            for kind, qx, qw in q_inputs:
                if kind == "conv":
                    quant.quantize_conv_operands(qx, qw)
                else:
                    quant.quantize_matmul_operands(qx, qw)

        q_ms = time_ms(quantize_all)
        forward_ms[("quant", batch)] = q_ms
        print(f"[alexnet int8] B={batch}: precisions all int8 on cuda, launches "
              f"conv int8={launches[2]} matmul int8={launches[3]} (fp32 "
              f"{launches[0]}+{launches[1]}), logits bitwise equal to the torch "
              f"backend, SNR vs fp32 {snr:.2f} dB"
              + (f", Table-4 row == golden, exec_ma_words "
                 f"{compiled.plan.exec_ma_words} (fp32 "
                 f"{compiled.plan.conv_ma_words + compiled.plan.fc_ma_words})"
                 if batch == 1 else ""))
        print(f"[alexnet int8] B={batch}: {ms:.4f} ms/forward (median of 20), "
              f"{batch / ms * 1e3:.1f} images/s; quantization alone "
              f"{q_ms:.4f} ms ({100 * q_ms / ms:.1f}% of the forward); fp32 "
              f"forward {forward_ms[('fp32', batch)]:.4f} ms")

    # -- phase 4b: VGG-16 and ResNet-50 through the same kernels, batch 1 -------
    del params
    for net in OTHER_NETS:
        golden_net = json.loads((ROOT / f"tests/goldens/table4_{net}.json").read_text())
        params = cnn.init_cnn(net, seed=0, device=DEVICE)
        x = torch.randn((1, *cnn.CNNS[net].input_hw_c),
                        generator=torch.Generator().manual_seed(1)).to(dev)
        net_fp32 = None
        for prec in ("fp32", "int8"):
            cfg = E.EngineConfig(backend="cuda", precision=prec)
            compiled = E.compile(cnn.program(net), cfg)
            kinds = [op.kind for op, _ in compiled.exec_pairs]
            require(set(compiled.backends()) == {"cuda"}
                    and set(compiled.precisions()) == {prec},
                    f"{net} {prec}: backends {compiled.backends()}, "
                    f"precisions {compiled.precisions()}")
            require(compiled.cost == golden_net, f"{net} {prec}: Table-4 row "
                    f"{compiled.cost} != golden {golden_net}")
            zero_counts(*all_kernels)
            logits = compiled.apply(params, x)
            torch.cuda.synchronize()
            launches = counts(*all_kernels)
            per_op = (kinds.count("conv2d"), kinds.count("dense"))
            want = per_op + (0, 0) if prec == "fp32" else (0, 0) + per_op
            require(launches == want, f"{net} {prec}: launches {launches}, "
                    f"expected {want}")
            require(tuple(logits.shape) == (1, 1000)
                    and bool(torch.isfinite(logits).all()),
                    f"{net} {prec}: bad logits")
            ref = E.compile(cnn.program(net), cfg.replace(backend="torch")
                            ).apply(params, x)
            ms = time_ms(lambda: compiled.apply(params, x), iters=5)
            if prec == "fp32":
                net_fp32 = logits
                err = rel_err(logits, ref)
                require(err <= TOL, f"{net}: logits vs torch backend "
                        f"{err:.3e} > {TOL}")
                parity = f"logits max|d|/max|ref| vs torch backend = {err:.3e}"
            else:
                n_diff = int((logits != ref).sum().item())
                require(n_diff == 0, f"{net} int8: {n_diff} logits differ "
                        "from the torch backend under int8")
                parity = (f"logits bitwise equal to the torch backend, SNR vs "
                          f"fp32 {quant.snr_db(net_fp32, logits).item():.2f} dB")
            print(f"[{net}] {prec} B=1: backends all cuda, launches {launches}, "
                  f"{parity}, Table-4 row == golden; {ms:.4f} ms/forward "
                  "(median of 5)")
            del compiled
        del params

    # -- phase 4c: one layer int8 inside an fp32 AlexNet -------------------------
    params = cnn.init_cnn("alexnet", seed=0, device=DEVICE)
    x = torch.randn((1, *cnn.ALEXNET_INPUT),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    mixed = E.compile(cnn.program("alexnet", precisions={"fc6": "int8"}),
                      E.EngineConfig(backend="cuda"))
    require(mixed.precisions() == ("fp32",) * 5 + ("int8", "fp32", "fp32"),
            f"mixed precisions {mixed.precisions()}")
    zero_counts(*all_kernels)
    logits = mixed.apply(params, x)
    torch.cuda.synchronize()
    launches = counts(*all_kernels)
    require(launches == (5, 2, 0, 1), f"mixed: launches {launches}, expected "
            "(5, 2, 0, 1)")
    require(bool(torch.isfinite(logits).all()), "mixed: bad logits")
    print(f"[alexnet mixed] fc6 int8 in an fp32 config: launches (conv, matmul, "
          f"conv int8, matmul int8) = {launches}")
    del params

    # -- phase 5: kernel times at the main path's shapes -----------------------
    def lib_conv(x, w, bias, stride, pad, groups, act):
        out = F.conv2d(x, w, bias, stride=stride, padding=pad, groups=groups)
        return torch.relu(out) if act == "relu" else out

    def lib_mm(x, w, bias, act):
        out = torch.addmm(bias, x, w)
        return torch.relu(out) if act == "relu" else out

    def lib_int_mm(xq, wq, **_):
        return torch._int_mm(xq, wq)

    totals = {}
    for kname, kernel, plain, per_batch in (
            ("gfid_conv2d_nhwc", conv32, gfid_conv.gfid_conv2d_nhwc_plain,
             conv_main),
            ("gfid_matmul", mm32, gfid_matmul.gfid_matmul_plain, fc_main),
            ("gfid_conv2d_nhwc_int8", conv8,
             gfid_conv.gfid_conv2d_nhwc_int8_plain, conv8_main),
            ("gfid_matmul_int8", mm8, gfid_matmul.gfid_matmul_int8_plain,
             fc8_main)):
        int8 = kname.endswith("_int8")
        peak = PEAK_INT8_OP_S if int8 else PEAK_FP32_FLOP_S
        for batch in BATCHES:
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       n_bytes=0, ops=0)
            for label, spec, kw in per_batch[batch]:
                ops = 2 * batch * spec.macs
                conv = kname.startswith("gfid_conv")
                out_elems = (batch * spec.h_out * spec.w_out * spec.c_out if conv
                             else batch * spec.m)
                if int8:
                    n_bytes = (kw["xq"].numel() + kw["wq"].numel()
                               + 4 * (kw["sx"].numel() + kw["sw"].numel()
                                      + kw["bias"].numel() + out_elems))
                    lib = None
                    if not conv and int_mm_accepts(batch, spec.n, spec.m):
                        lib, lib_kw = lib_int_mm, kw
                elif conv:
                    n_bytes = 4 * (kw["x"].numel() + kw["w"].numel()
                                   + kw["bias"].numel() + out_elems)
                    lib_kw = dict(x=kw["x"].permute(0, 3, 1, 2).contiguous(),
                                  w=kw["w"].permute(3, 2, 0, 1).contiguous(),
                                  bias=kw["bias"], stride=kw["stride"],
                                  pad=kw["pad"], groups=kw["groups"], act=kw["act"])
                    lib = lib_conv
                else:
                    n_bytes = 4 * (kw["x"].numel() + kw["w"].numel()
                                   + kw["bias"].numel() + out_elems)
                    lib, lib_kw = lib_mm, kw
                b_ms, _ = bound_ms(n_bytes, ops, peak)
                k_ms = time_ms(lambda: kernel(**kw))
                p_ms = time_ms(lambda: plain(**kw))
                l_ms = None if lib is None else time_ms(lambda: lib(**lib_kw))
                print(f"[time] {kname} {label}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, library "
                      + ("none" if l_ms is None else f"{l_ms:.4f} ms")
                      + f", bound {b_ms:.4f} ms ({n_bytes / 1e6:.2f} MB, "
                      f"{ops / 1e9:.3f} G{'op' if int8 else 'FLOP'})")
                for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                                 ("bound_ms", b_ms), ("n_bytes", n_bytes),
                                 ("ops", ops)):
                    tot[key] += val
                tot["library_ms"] = (None if l_ms is None or tot["library_ms"] is None
                                     else tot["library_ms"] + l_ms)
            tot["bound_by"] = bound_ms(tot["n_bytes"], tot["ops"], peak)[1]
            totals[(kname, batch)] = tot
            lib_txt = ("none" if tot["library_ms"] is None
                       else f"{tot['library_ms']:.4f} ms")
            print(f"[time] {kname} B={batch} total over the path's layers: kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
                  f"{lib_txt}, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']})")

    for batch in BATCHES:
        fwd = forward_ms[("int8", batch)]
        k8 = (totals[("gfid_conv2d_nhwc_int8", batch)]["ms"]
              + totals[("gfid_matmul_int8", batch)]["ms"])
        q = forward_ms[("quant", batch)]
        print(f"[time] alexnet int8 B={batch}: forward {fwd:.4f} ms = int8 kernels "
              f"{k8:.4f} ms ({100 * k8 / fwd:.1f}%) + quantization {q:.4f} ms "
              f"({100 * q / fwd:.1f}%) + rest {fwd - k8 - q:.4f} ms")

    sources = {
        "gfid_conv2d_nhwc": ("src/repro_torch/csrc/gfid_conv.cu",
                             "src/repro/kernels/gfid_conv.py:79", "fp32"),
        "gfid_matmul": ("src/repro_torch/csrc/gfid_matmul.cu",
                        "src/repro/kernels/gfid_matmul.py:85", "fp32"),
        "gfid_conv2d_nhwc_int8": ("src/repro_torch/csrc/gfid_conv_int8.cu",
                                  "src/repro/kernels/gfid_conv.py:218", "int8"),
        "gfid_matmul_int8": ("src/repro_torch/csrc/gfid_matmul_int8.cu",
                             "src/repro/kernels/gfid_matmul.py:199", "int8")}
    slot = {"gfid_conv2d_nhwc": 0, "gfid_matmul": 1, "gfid_conv2d_nhwc_int8": 2,
            "gfid_matmul_int8": 3}
    kernels = []
    for kname, (source, replaces, path) in sources.items():
        tot = totals[(kname, 1)]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[path][slot[kname]],
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
