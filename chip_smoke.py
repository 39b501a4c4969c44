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
     AlexNet layer shape (batch 1 and 32), at a few ragged shapes and, for
     `gfid_matmul`, at every GEMM shape of the serving path (the five of a
     decode step at M = 8, the four layer GEMMs of a prompt-128 prefill at
     M = 1024); the fp32 conv also at every distinct conv shape of VGG-16
     and ResNet-50 at batch 1, its cases reaching every block tile, split
     and load path of `gfid_conv.f32_plan` (required). fp32:
     max|kernel - plain| / max|plain| <= 1e-4. int8 (operands quantized on
     the card by `core/quant`): max|kernel - plain| == 0 for act None and
     relu, <= 1e-6 * max|plain| for gelu; the int8 conv's cases reach every
     (tile, split) pair of `gfid_conv.int8_plan` and both load paths of x
     and w (required), the int8 GEMM's every (tile, split) pair of
     `gfid_matmul.int8_mm_plan`, both load paths of xq (one case an xq 1
     byte past a 16-byte boundary) and the 16-byte, 8-byte and gathered
     loads of wq (required), with M = 16 and 17, K = 1028 and N = 100 and
     520 among its ragged cases. bf16 operands (`gfid_matmul_bf16`,
     `gfid_conv2d_nhwc_bf16`) at every AlexNet conv and FC shape (bf16 bias,
     relu), the ragged cases (fp32 bias, gelu, none), smollm's GEMMs at
     decode (M = 8) and prefill (M = 1024, and 15,872 for w_in/w_gate)
     and further conv and GEMM shapes chosen so that the cases reach every
     block tile, split and load path of the wrappers' launch plans
     (required), each stored in fp32 (within 1e-4 * max|plain|) and in
     bf16 (every element within one bf16 step of the plain version's).
     The fp32 `gfid_matmul` (`csrc/gfid_matmul.cu`) also at w_in/w_gate
     at M = 15,872, a wide tile with K in one split, 20 rows under a split,
     40 in a cluster and unaligned views, so that its cases reach every
     block tile, split mode (one, a workspace, a cluster, a fold) and load
     path of `gfid_matmul.f32_plan` and every kernel the source
     instantiates (required). Then the GEMM's row invariance on the kernel itself: one
     fixed row of x at M = 1, 8, 13, 20, 40, 1024 and 15,872, in first,
     last and other tiles' and warps' rows, bitwise equal to the row alone
     in one K order at every M: on bf16 operands in both stores at each
     smollm GEMM shape and a ragged one, on fp32 operands at those shapes
     and AlexNet's fc6-fc8. Then the conv's batch invariance: one fixed
     image, first, in the middle and last of batches of 1, 2, 4, 8, 16 and
     32, bitwise equal to the image alone, on fp32 and bf16 operands (both
     stores) at every AlexNet conv shape and every distinct VGG-16 and
     ResNet-50 conv shape, and on int8 operands at AlexNet's (the checked
     fp32 and bf16 plans must reach a split through the workspace and a
     fold); and, read only, whether ResNet-50's global average pool gives
     an image other bits in a batch.
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
     launches. Then (4d) AlexNet with bf16 parameters through
     `program("alexnet", batch=B, dtype=torch.bfloat16)` at B = 1 and 32:
     every op on "cuda", 5 `gfid_conv2d_nhwc_bf16` and 3 `gfid_matmul_bf16`
     launches and no other per forward, bf16 logits within 2e-2 *
     max|logits| of the "torch" backend, SNR >= 28 dB against the fp32
     forward from the same weights, the Table-4 row still the golden; ms per
     forward and images/s.
     Phase 3 also holds `paged_gather` against its plain version, bitwise:
     smollm-135m's full-width pool (257, 16, 30, 3, 64) bf16 with tables of
     1 and 8 rows x 32 blocks, the four cases of tests/test_kv_pool.py, an
     fp32 pool, and block byte lengths that are not multiples of 8; and, in
     a child process, that a block id outside the pool stops the kernel
     with an error that the next synchronisation reports. And it holds
     `flash_attention` against its plain version: smollm-135m's prefill
     heads (1, S, 9 / 3, 64) causal at S = 1025, 1280, 1664, 1984 and 2048,
     the four cases of tests/test_kernels.py, a prime length (1031), B = 2,
     D = 128 causal and not, lengths that are no multiple of the fp32 kv
     tile at D = 8, 64 and 128 and D = 10, each in fp32 on
     `flash_attention.cu` (within 1e-4 x max|plain|; reaching both copy
     paths) and on bf16 operands on `flash_attention_bf16.cu`
     (within 8e-3, two calls bitwise equal), with bf16 cases at D = 40, at
     D = 20 and on unaligned views that must reach every padded head dim
     (16, 32, 64, 128) and both copy paths; and that an input which
     requires grad raises.
  5. per kernel: its time over the main path's shapes beside its bound, its
     plain version's time and one library call's time where one PyTorch call
     computes the same function (`F.conv2d` on NCHW and `torch.addmm`, each
     followed by relu, TF32 off; `torch._int_mm` for the int8 product where
     it accepts the shape; none for the int8 conv); every kernel also for
     the device alone (a CUDA graph of 100 calls), beside cuDNN, cuBLAS or
     `torch._int_mm` timed the same way ("none" where there is no call). The host part of one call of the lean launch path,
     piece by piece beside the piece it replaced, for `gfid_matmul` at the
     decode's wq/wo (8, 576) @ (576, 576) fp32, `paged_gather` at the
     full-width pool and a table of 8 x 32, `gfid_matmul_int8` at fc8 at
     batch 1 and `gfid_conv1d_depthwise` at (1, 384, 1536), and each whole
     call on the host clock, with the host and for the device alone beside
     `torch.mm`, `index_select` and `F.conv1d` (none for the int8 GEMM at
     one row).
     `flash_attention` at (1, 1984, 9 / 3, 64) causal on fp32 and on bf16
     q, k, v (`flash_attention_bf16`), a launch (with the host's launch
     inside, and the device alone) and one prefill's 30, beside
     `F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)` in
     the same dtype with TF32 off (timed here only; nothing on the path
     calls it), and flash (fp32 and bf16) and SDPA at B = 4 for the device
     alone (how far too few warps an SM hold back B = 1). The bf16 kernels at AlexNet's shapes as the path runs them
     (bf16 in and out), beside `F.conv2d` and `torch.addmm` in bf16, each
     with relu, also timed for the device alone; `gfid_matmul` on bf16 and
     on fp32 operands at smollm's four layer GEMMs at M = 1024 and 15,872
     (prompts 128 and 1984), with the host and for the device alone,
     beside `torch.mm` in the same dtype.
     A bound takes the card's peak for the operands' type: 67 TFLOP/s in
     fp32, 989 TFLOP/s in bf16, 1,979 TOP/s in int8, and 3.35 TB/s.
  6. serving: smollm-135m at full width and depth (fp32 parameters from
     `init_params(cfg, seed=0, device="cuda", dtype=torch.float32)`), a
     bf16 paged pool of 257
     blocks of 16 slots (max_len 512, max_batch 8: no preemption), 16
     requests with prompts of 16-256 tokens and 16, 32 or 64 steps from a
     seeded `torch.Generator`, served by `ContinuousScheduler` under
     `EngineConfig(backend="cuda", row_align=8)` with admission
     "continuous", then "drain", then solo (max_batch 1; the first 4
     requests only). Checks: every request done without preemption; every
     decode step at the one 8-row bucket (the scheduler's row_align floor);
     tokens bitwise equal across the three runs and equal to the
     dense-cache `greedy_generate` for the first 4 requests; every op of every compiled program on "cuda"; the programs
     record 2 + 30 x 7 + 1 ops; each decode step launches 2 `paged_gather`
     and 211 `gfid_matmul` kernels and nothing else; one decode step at
     bucket 8 replayed on the "torch" backend on the same pool snapshot
     gives logits within 1e-4 x max|logits|. Prints tokens/s and p50/p95
     request latency of the continuous run, ms per decode step with 8 and
     with 1 live rows, a batch-1 prefill at prompt 128, one program's capture time,
     `paged_gather` at the step's shapes beside its bound and
     `index_select`, `gfid_matmul` at the five decode GEMM shapes (M = 8)
     beside its bound and `torch.mm` (each also for the device alone, so
     that the host part shows), and the tied unembedding's transpose
     copy.
  7. xLSTM serving: first `gfid_conv1d_depthwise` against its plain version,
     bitwise, at the xLSTM prefill's shapes ((1, L, 1536) and (1, L, 768),
     L = 16, 243, 384, causal, 4 taps), a ragged (3, 37, 100) causal and
     centred, hubert's (2, 64, 1280) with 128 centred taps, bf16
     operands, D % 4 != 0, 1, 9, 12 and 70 taps and an unaligned x, so that
     the cases reach the register window and the shared-memory tile, each
     with float4 and scalar loads, and bf16 x on both (required); and
     `gfid_matmul` within TOL at every xLSTM GEMM shape, at
     M = 8 and at a prompt-384 prefill's padded rows. Then xlstm-125m at
     full width and depth (12 layers, mLSTM x 5 + sLSTM a group, d_model
     768, 155.7 M fp32 parameters from seed 0) is served on the same pool
     geometry and 16-request workload as phase 6, continuous, drain and
     solo (the first 4 requests). Every decode-state leaf is a slot store, so nothing is paged.
     Checks: every request done without preemption; one 8-row decode
     bucket; tokens bitwise equal across the three runs and to
     `greedy_generate` for 4 requests; every compiled op on "cuda", 67 GEMMs
     a program and 12 depthwise convs a prefill program; launches of 67
     `gfid_matmul` a decode step, 67 + 12 `gfid_conv1d_depthwise` a prefill
     and no `paged_gather`; a decode step of one row alone bitwise equal,
     logits and new state, to that row in the 8-row bucket; "torch" logits
     within TOL of "cuda" for a prompt-384 prefill and for a bucket-8
     decode step from the same state held in fp32, and within
     BF16_STATE_TOL from the served bf16 state (a decode step rounds its
     new conv input to bf16, and a value on a rounding boundary moves the
     logits by more than the arithmetic). Prints tokens/s, p50/p95,
     the decode step with 8 and with 1 live rows, the prefill at prompt 384
     (two mLSTM chunks), `torch.profiler` breakdowns of both, the conv at the
     prefill's shapes (CUDA events around a call, and the device alone from
     a CUDA graph of 100 calls) beside its bound, its plain version and
     `F.conv1d` (groups = D, TF32 off; timed both ways), and `gfid_matmul`
     at the decode shapes.

  8. long prompts: smollm-135m as in phase 6 on a bf16 paged pool of 1025
     blocks of 16 slots (max_len 2048, the model's published context; 128
     blocks a request, max_batch 8: no preemption), 12 requests, three at
     each prompt length 1025, 1280, 1664 and 1984, 16 or 32 steps, from a
     seeded `torch.Generator`, served continuous, drain and solo. Every
     prefill is past the dense attention's 1024 tokens, so each of its 30
     attention layers launches the flash kernel. Checks: every request
     done without preemption, one 8-row decode bucket; tokens bitwise
     equal across the three runs and to `greedy_generate` at one row for a
     1025- and a 1984-token request; every compiled op on "cuda"; launches
     of 211 `gfid_matmul` + 30 `flash_attention` and no `paged_gather` a
     prefill, 211 + 2 `paged_gather` and no flash a decode step; "torch"
     logits (chunked attention in torch ops) within 1e-4 of "cuda" for a
     prompt-1984 prefill and for an 8-row decode step at depth >= 1984 on
     the same pool snapshot. Prints tokens/s and p50/p95 of the continuous
     run, the prompt-1984 prefill with a `torch.profiler` split of flash
     against GEMM device time, and the decode step with 8 and 1 live rows.
  9. smollm-135m with its config's bf16 parameters (`init_params(cfg,
     seed=0, device="cuda", dtype=torch.bfloat16)`, 269 MB), phase 6's pool
     and 16 requests, served continuous, drain and solo (the first 4): the
     checks and
     numbers of phase 6 with 211 `gfid_matmul_bf16` launches a decode step
     and a prefill, no fp32 `gfid_matmul`, and "torch" logits within
     2.5e-2 of "cuda" (bf16 roundings of each projection, in other sum
     orders). Then one batch-1 prefill at prompt 1984 on phase 8's pool:
     211 `gfid_matmul_bf16` + 30 `flash_attention_bf16` launches and no
     fp32 `flash_attention`, its time and a profiler split of its device
     time between the two kernels (each found by name, with non-zero
     time). At prompts 1025, 1280, 1664 and 1984, the "cuda" and
     "torch" logits: within 2.5e-2 of each other in bf16, within 1e-4 from
     the same weights widened to fp32, and each about as far from those
     fp32 logits as the other (ratio within 1.5 either way).
 10. the static `Scheduler`: one for AlexNet under `EngineConfig(backend=
     "cuda", row_align=8)`, one under the same with `precision="int8"` and
     one for `program("alexnet", dtype=torch.bfloat16)`, each `max_batch`
     8 (buckets 1, 2, 4, 8), each run once under "spf" and once under
     "fifo"; the fp32 one also serves smollm-135m (fp32, full width and
     depth) through `decode_program(cfg, batch=1, max_len=256)` (shared
     parameters and position 64, a per-request dense state from a seeded
     64-token prefill and its next token) and `prefill_program(cfg,
     batch=1, seq=128, logits_only=True)` (scoring), in one queue with the
     AlexNet requests. Four waves of seeded requests, each submitted at once
     and drained, make every program run every bucket and pad a batch.
     Checks: every AlexNet result (fp32, int8, bf16) bitwise equal to the
     request alone through the batch-1 `CompiledNet.apply`; every compiled
     op on "cuda"; each AlexNet dispatch launches 5 conv and 3 matmul
     kernels of its precision and nothing else, each smollm dispatch 211
     fp32 `gfid_matmul`; every ticket's ledger the batch-1 plan's ops; spf
     serves a wave's programs in order of their batch-1 plan latency, fifo
     in order of arrival; the smollm results within 5e-4 x max|logits| of
     the request alone with the same argmax (the largest gap printed). Prints
     requests/s of dispatch time, p50/p95 latency and bucket occupancy per
     program and policy, and AlexNet at bucket 8 through the scheduler
     against `compile(program.with_batch(8)).apply` on the same images.
     Last, each phase's seconds.

The last lines are the card's name and power limit, a JSON object listing
the kernels, and `{"ok": true, "device": {...}}`.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
TOL = 1e-4                  # max|Δ| / max|reference|, kernels and logits
# xLSTM decode logits, "cuda" vs "torch", from the served bf16 state: about
# 10x the largest reading on the H100 (8.6e-4), where one conv input that
# rounds to the other bf16 neighbour moves the logits
BF16_STATE_TOL = 1e-2
GELU_TOL = 1e-6             # int8 kernels with gelu: max|Δ| / max|plain|
SNR_FLOOR_DB = 28.0         # AlexNet int8 against fp32 (the reference's floor)
BATCHES = (1, 32)
# Phase 6: the served model, pool and workload.
SERVE_MODEL = "smollm_135m"
SERVE_MAX_LEN, SERVE_BLOCK, SERVE_BLOCKS, SERVE_BATCH = 512, 16, 257, 8
SERVE_REQUESTS, SERVE_PROMPT, SERVE_STEPS = 16, (16, 256), (16, 32, 64)
SERVE_DENSE_CHECKS = 4      # requests also run through greedy_generate
SERVE_PREFILL = 128         # the prompt length of the timed prefill
# Phase 7: xlstm-125m on the same pool geometry and workload.
SSM_MODEL = "xlstm_125m"
SSM_SLOTS = 2 * SERVE_BATCH + 1   # state slots (slot 0 is the reserved dummy)
SSM_PREFILL = 384           # the timed prefill: two 256-token mLSTM chunks
SSM_CONV_LENS = (16, 243, 384)    # prefill lengths of the conv checks
# Phase 8: smollm-135m on prompts past the dense attention's 1024 tokens
# (three at each length, 16 or 32 steps) on a pool of max_len 2048, the
# model's published context: 128 blocks a request, 8 requests at once.
LONG_LENS, LONG_REPEAT, LONG_STEPS = (1025, 1280, 1664, 1984), 3, (16, 32)
LONG_MAX_LEN, LONG_BLOCKS = 2048, 1025
LONG_PREFILL = 1984         # the timed prefill, and the flash kernel's timed shape
BF16_FLASH_TOL = 8e-3       # flash on bf16 operands: max|Δ| / max|plain|
# gfid_matmul_bf16's row invariance: the row counts a fixed row is computed
# at (every block-row tile of the plan, and a prompt-1984 prefill's M)
INVARIANCE_ROWS = (1, 8, 13, 20, 40, 1024, 8 * LONG_PREFILL)
# the conv's batch invariance: the batches a fixed image is computed in
INVARIANCE_BATCHES = (1, 2, 4, 8, 16, 32)
# bf16 GEMM and conv kernels: an fp32 store within TOL of the plain version;
# a bf16 store within one bf16 step of the plain version's bf16 element (the
# step at the larger magnitude, TOL * max|plain| near zero): the two fp32
# sums can round to neighbouring bf16 values
# AlexNet in bf16: logits vs the "torch" backend, and SNR vs fp32 logits
# from the same (bf16-representable) weights
CNN_BF16_TOL = 2e-2
# smollm-135m with bf16 parameters: "torch" logits vs "cuda" (each bf16
# projection rounds once in both, its sums in other orders, through 30
# layers). On the H100 the gap read 9.1e-3 in decode and 1.42e-2 to
# 1.59e-2 at prompts of 1025-1984 tokens, where each backend lay 1.16e-2
# to 1.47e-2 from the fp32 logits of the same weights: the gap is the two
# paths' own bf16 rounding. The limit leaves 1.6x room over the largest
# reading and stays under half the reference's own bf16 bound of 5e-2.
BF16_LOGITS_TOL = 2.5e-2
# ... and the two paths round alike: the "cuda" distance from those fp32
# logits over the "torch" one lies in [1 / BF16_FP32_RATIO,
# BF16_FP32_RATIO] (read 0.917-1.190)
BF16_FP32_RATIO = 1.5
OTHER_NETS = ("vgg16", "resnet50")   # driven at batch 1 after AlexNet
# Phase 10: the static Scheduler. smollm-135m decode rows (a dense state of
# SCHED_MAX_LEN slots after a SCHED_DECODE_POS-token prompt) and scoring
# prefills of SCHED_SCORE_LEN tokens beside AlexNet; each wave's requests
# (alexnet, decode, score) are submitted at once, then drained, so that
# every program runs every bucket and pads at least one batch
SCHED_MAX_LEN, SCHED_DECODE_POS, SCHED_SCORE_LEN = 256, 64, 128
SCHED_BUCKETS = (1, 2, 4, 8)
SCHED_WAVES = ((8, 3, 2), (3, 2, 1), (2, 1, 8), (1, 8, 3))
# a smollm request in a bucket against the request alone: the decode
# attention's batched products run on cuBLAS, whose algorithm may follow the
# row count (read 1.106e-04 at 2048 slots); the argmax must not move
SCHED_LM_TOL = 5e-4
DEVICE = "cuda"
# H100 SXM peaks from NVIDIA's data sheet (dense, 700 W): fp32 outside the
# tensor cores, bf16 and int8 in them, and device-memory bandwidth. A bound
# takes the peak of the operands' type, whatever units a kernel uses.
PEAK_FP32_FLOP_S = 67e12
PEAK_BF16_FLOP_S = 989e12
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


def graph_ms(fn, calls=100):
    """The device's time for one call of fn, without the host's launch: a
    CUDA graph of `calls` calls, replayed between CUDA events (median of
    10), over `calls`."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                    # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return time_ms(graph.replay, iters=10) / calls


def bound_ms(n_bytes, ops, peak_ops=PEAK_FP32_FLOP_S):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def bf16_steps(got, want):
    """The largest |got - want| of two bf16 tensors in units of the bf16
    step at the larger magnitude of each pair (at least TOL * max|want|):
    <= 1 means every element is within one bf16 rounding."""
    g, w = got.float(), want.float()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    step = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    limit = torch.maximum(step, TOL * w.abs().max())
    return ((g - w).abs() / limit).max().item()


def kernel_check(got, want):
    """(ok, max|d|, reading, limit): an fp32 result within TOL x max|want|,
    a bf16 one within one bf16 step of each element (`bf16_steps`)."""
    abs_err = (got.float() - want.float()).abs().max().item()
    if got.dtype == torch.bfloat16:
        steps = bf16_steps(got, want)
        return steps <= 1.0, abs_err, steps, 1.0
    err = rel_err(got, want)
    return err <= TOL, abs_err, err, TOL


def as_bf16(kw, keep_bias=False):
    """A case's kwargs with its tensors in bf16 (the bias kept fp32 when
    `keep_bias`: the kernels take either)."""
    return {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor)
            and not (keep_bias and k == "bias") else v for k, v in kw.items()}


def conv_cases(cnn, batch, gen, dev, net="alexnet"):
    """(label, spec, kwargs) for every conv of `net` at `batch` (one for
    each distinct shape): inputs, HWIO weights, a bias and relu, as the main
    path gives them."""
    convs, _ = cnn.analytics_layers(net)
    cases, shapes = [], set()
    for s in convs:
        shape = (s.h_in, s.w_in, s.c_in, s.c_out, s.h_f, s.w_f, s.s, s.pad, s.groups)
        if shape in shapes:
            continue
        shapes.add(shape)
        cg = s.c_in // s.groups
        fan_in = s.h_f * s.w_f * cg
        label = s.name if net == "alexnet" else f"{net} {s.name}"
        cases.append((f"{label} B={batch}", s, dict(
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
        # x a view one element past a 16-byte boundary: element copies of x
        # at cg % 4 == 0
        dict(x=t(1 + 2 * 15 * 15 * 8)[1:].view(2, 15, 15, 8), w=t(3, 3, 8, 24),
             bias=t(24), stride=1, pad=1, groups=1, act="relu"),
    ]
    mm = [
        dict(x=t(5, 300), w=t(300, 70), bias=t(70), act="gelu"),
        dict(x=t(1, 1000), w=t(1000, 33), bias=None, act=None),
        dict(x=t(17, 257), w=t(257, 129), bias=t(129), act="relu"),
    ]
    return conv, mm


def serve_gemm_shapes(cfg):
    """(label, k, n) of the serving path's GEMMs: the four of a layer (wq and
    wo, wk and wv, w_in and w_gate, w_out) and the tied unembedding."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, kvd = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    return (("wq/wo", d, hd), ("wk/wv", d, kvd), ("w_in/w_gate", d, f),
            ("w_out", f, d), ("unembed", d, v))


def serve_mm_cases(gen, dev):
    """gfid_matmul at the serving path's shapes, no bias and no act: every
    GEMM of a decode step (M = 8, the row_align bucket) and the layer GEMMs
    of a batch-1 prefill at prompt SERVE_PREFILL (its one row padded to 8,
    so M = 8 x SERVE_PREFILL; its unembedding reads the last position only,
    at M = 8)."""
    from repro_torch.configs.base import get_config
    shapes = serve_gemm_shapes(get_config(SERVE_MODEL))
    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev)
    return [(f"serve decode {lbl} M=8", dict(x=t(8, k), w=t(k, n), bias=None,
                                             act=None)) for lbl, k, n in shapes] \
        + [(f"serve prefill {lbl} M={8 * SERVE_PREFILL}",
            dict(x=t(8 * SERVE_PREFILL, k), w=t(k, n), bias=None, act=None))
           for lbl, k, n in shapes[:-1]]


def bf16_mm_cases(gen, dev):
    """(label, kwargs) for `gfid_matmul` on bf16 operands beyond the AlexNet
    and ragged cases: smollm-135m's five GEMMs at a decode step (M = 8), its
    four layer GEMMs at a prompt-128 prefill (M = 1024) and w_in/w_gate at a
    prompt-1984 prefill (M = 15,872), the 32- and 64-row tiles (M = 20 and
    40) under a split of K at both tile widths, and x and w as views one
    element past a 16-byte boundary (element loads at K and N multiples of
    8)."""
    from repro_torch.configs.base import get_config
    shapes = serve_gemm_shapes(get_config(SERVE_MODEL))

    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev).to(torch.bfloat16)

    def unaligned(*shape):
        return t(math.prod(shape) + 1)[1:].view(shape)

    cases = [(f"serve decode {lbl} M=8", dict(x=t(8, k), w=t(k, n), bias=None,
                                              act=None)) for lbl, k, n in shapes]
    cases += [(f"serve prefill {lbl} M={m}", dict(x=t(m, k), w=t(k, n), bias=None,
                                                  act=None))
              for m, sel in ((8 * SERVE_PREFILL, shapes[:-1]),
                             (8 * LONG_PREFILL, shapes[2:3]))
              for lbl, k, n in sel]
    cases += [(f"M={m} (4096, {n}) split K", dict(x=t(m, 4096), w=t(4096, n),
                                                  bias=t(n), act="gelu"))
              for m, n in ((20, 512), (40, 512), (40, 192))]
    cases.append(("unaligned views (24, 512) @ (512, 256)",
                  dict(x=unaligned(24, 512), w=unaligned(512, 256), bias=None,
                       act="relu")))
    return cases


def bf16_conv_cases(gen, dev):
    """(label, kwargs) for `gfid_conv2d_nhwc` on bf16 operands beyond the
    AlexNet and ragged cases: cg = 3 at stride 4 with og = 20 (element loads
    of x and w), cg = 8 and og = 16 with pad and 2 groups (16-byte loads of
    both) on 14-wide rows, 150-wide rows past a 128-row tile, a batch-1
    conv whose K is split, and 64-row tiles."""
    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev).to(torch.bfloat16)

    return [
        ("cg=3 stride 4 pad 2 og=20", dict(x=t(2, 31, 31, 3), w=t(11, 11, 3, 20),
                                          bias=t(20), stride=4, pad=2, groups=1,
                                          act="relu")),
        ("cg=8 og=16 pad 1 2 groups W_out=14", dict(
            x=t(1, 14, 14, 16), w=t(3, 3, 8, 32), bias=t(32).float(), stride=1,
            pad=1, groups=2, act="relu")),
        ("W_out=150", dict(x=t(1, 5, 150, 16), w=t(3, 3, 16, 64), bias=None,
                           stride=1, pad=1, groups=1, act=None)),
        ("batch 1 split K (1, 7, 7, 64) og=40", dict(
            x=t(1, 7, 7, 64), w=t(3, 3, 64, 40), bias=t(40), stride=1, pad=1,
            groups=1, act="gelu")),
        ("64-row tiles (4, 50, 50, 8)", dict(x=t(4, 50, 50, 8), w=t(3, 3, 8, 16),
                                             bias=t(16), stride=1, pad=1,
                                             groups=1, act="relu")),
    ]


def launch_plan(kind, kw):
    """The launch plan the wrapper takes for a case of `kind` "conv" or
    "mm" (fp32, bf16 or int8 operands): the wrappers' own plan functions on
    the case's shapes and addresses."""
    from repro_torch.kernels import build, gfid_conv, gfid_matmul
    x, w = (kw["x"], kw["w"]) if "x" in kw else (kw["xq"], kw["wq"])
    sms = build.sm_count(x.device.index or 0) if x.is_cuda else 132
    if kind == "mm" and x.dtype == torch.int8:
        return gfid_matmul.int8_mm_plan(x.shape[0], x.shape[1], w.shape[1],
                                        x.data_ptr(), w.data_ptr(), sms)
    if kind == "mm" and x.dtype == torch.bfloat16:
        return gfid_matmul.bf16_plan(x.shape[0], x.shape[1], w.shape[1],
                                     x.data_ptr(), w.data_ptr())
    if kind == "mm":
        return gfid_matmul.f32_plan(x.shape[0], x.shape[1], w.shape[1],
                                    x.data_ptr(), w.data_ptr(), sms)
    b, h, wd, _ = x.shape
    h_f, w_f, cg, c_out = w.shape
    s, p, groups = kw["stride"], kw["pad"], kw["groups"]
    pixels = b * ((h + 2 * p - h_f) // s + 1) * ((wd + 2 * p - w_f) // s + 1)
    if x.dtype == torch.int8:
        return gfid_conv.int8_plan(pixels, h_f * w_f * cg, c_out // groups,
                                   groups, cg, x.data_ptr(), w.data_ptr(), sms)
    plan = gfid_conv.bf16_plan if x.dtype == torch.bfloat16 else gfid_conv.f32_plan
    return plan(pixels, h_f * w_f * cg, c_out // groups, groups, cg,
                x.data_ptr(), w.data_ptr(), sms, image_pixels=pixels // b)


def require_plan_coverage(kname, plans, tiles, fold=False):
    """Every block tile of `tiles`, one and several splits of K (with
    `fold`, both through the workspace and folded in each block), and both
    load paths of x and of w were among the checked `plans`."""
    seen = dict(tile={(p.bm, p.bn) for p in plans},
                split={"fold" if getattr(p, "fold", False) else
                       "split" if p.splits > 1 else "one" for p in plans},
                vec_x={p.vec_x for p in plans}, vec_w={p.vec_w for p in plans})
    want = dict(tile=set(tiles),
                split={"one", "split"} | ({"fold"} if fold else set()),
                vec_x={False, True}, vec_w={False, True})
    require(seen == want, f"{kname}: the checked cases reach {seen}, not {want}")
    print(f"[check] {kname}: the cases reach block tiles "
          f"{', '.join(f'{m}x{n}' for m, n in sorted(seen['tile']))}, K in "
          f"{', '.join(sorted(seen['split']))} split(s), element and 16-byte "
          "loads of x and w")


def require_int8_conv_coverage(plans):
    """Every (tile, split) pair `gfid_conv.int8_plan` can pick (the wide
    tile with x gathered byte by byte and K in one split; the 64 x 64 and
    32 x 64 tiles in one split; the 32 x 64 tile with K split across a
    cluster) and both load paths of x and of w were among the checked
    plans."""
    from repro_torch.kernels.gfid_conv import INT8_TILES
    seen = dict(mode={(p.bm, p.bn, p.splits > 1) for p in plans},
                vec_x={p.vec_x for p in plans}, vec_w={p.vec_w for p in plans})
    want = dict(mode={(m, n, False) for m, n in INT8_TILES}
                | {INT8_TILES[-1] + (True,)},
                vec_x={False, True}, vec_w={False, True})
    require(seen == want, f"gfid_conv2d_nhwc_int8: the checked cases reach "
            f"{seen}, not {want}")
    print("[check] gfid_conv2d_nhwc_int8: the cases reach block tiles "
          + ", ".join(f"{m}x{n} {'in a cluster of K splits' if c else 'one split'}"
                      for m, n, c in sorted(seen["mode"]))
          + ", byte and 16-byte loads of x and w")


def require_int8_mm_coverage(plans):
    """Every (tile, split) pair `gfid_matmul.int8_mm_plan` can pick (each
    tile of INT8_MM_TILES in one split and with K split across a cluster),
    both load paths of xq and the three of wq (16- and 8-byte copies,
    bytes gathered) were among the checked plans."""
    from repro_torch.kernels.gfid_matmul import INT8_MM_TILES, INT8_MM_W_COPIES
    seen = dict(mode={(p.bm, p.bn, p.splits > 1) for p in plans},
                vec_x={p.vec_x for p in plans}, vec_w={p.vec_w for p in plans})
    want = dict(mode={t + (c,) for t in INT8_MM_TILES for c in (False, True)},
                vec_x={False, True}, vec_w=set(INT8_MM_W_COPIES) | {0})
    require(seen == want, f"gfid_matmul_int8: the checked cases reach {seen}, "
            f"not {want}")
    print("[check] gfid_matmul_int8: the cases reach block tiles "
          + ", ".join(f"{m}x{n} {'in a cluster of K splits' if c else 'one split'}"
                      for m, n, c in sorted(seen["mode"]))
          + ", byte and 16-byte loads of xq, 16-, 8-byte and byte loads of wq")


def f32_mode(plan):
    """How a fp32 GEMM plan adds the splits of K: "one" split, "split" (one
    a block, through a workspace), "cluster" (a tile's splits as one
    cluster) or "fold" (every split in each block)."""
    return "one" if plan.splits == 1 else plan.mode


def require_f32_gemm_coverage(plans):
    """Every kernel `gfid_matmul_f32` instantiates and its plan can pick
    (each block tile of F32_TILES in the split mode, the 64-column ones
    also as a cluster, the two many-row tiles also folded) and every way of
    adding the splits were among the checked plans."""
    from repro_torch.kernels.gfid_matmul import F32_TILES
    seen = {(p.bm, p.bn, p.mode) for p in plans}
    want = {(m, n, "split") for m, n in F32_TILES} \
        | {(m, n, "cluster") for m, n in F32_TILES if n == 64} \
        | {(m, n, "fold") for m, n in F32_TILES[:2]}
    modes = {f32_mode(p) for p in plans}
    require(seen == want and modes == {"one", "split", "cluster", "fold"},
            f"gfid_matmul: the checked cases reach kernels {sorted(seen)} and "
            f"modes {sorted(modes)}, not {sorted(want)} and one, split, "
            "cluster, fold")
    print(f"[check] gfid_matmul: the cases reach every kernel of the source "
          f"({', '.join(f'{m}x{n} {mode}' for m, n, mode in sorted(seen))}) "
          "and K in one split, split through a workspace, split in a cluster "
          "and folded")


def f32_mm_cases(gen, dev):
    """(label, kwargs) for the fp32 `gfid_matmul` beyond the AlexNet, ragged
    and serving cases: w_in/w_gate at a prompt-1984 prefill (M = 15,872, the
    wide tile folding K), a wide tile with K in one split, the 32-row tile
    under a split, the 64-row tile's splits in a cluster, and x and w as
    views one element past a 16-byte boundary (element loads at K and N
    multiples of 4)."""
    from repro_torch.configs.base import get_config
    d, f = get_config(SERVE_MODEL).d_model, get_config(SERVE_MODEL).d_ff

    def t(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def unaligned(*shape):
        return t(math.prod(shape) + 1)[1:].view(shape)

    return [
        (f"serve prefill w_in/w_gate M={8 * LONG_PREFILL}",
         dict(x=t(8 * LONG_PREFILL, d), w=t(d, f), bias=None, act=None)),
        ("M=2048 (64, 8192) one split", dict(x=t(2048, 64), w=t(64, 8192),
                                             bias=t(8192), act="relu")),
        ("M=20 (4096, 512) split K", dict(x=t(20, 4096), w=t(4096, 512),
                                          bias=t(512), act="gelu")),
        ("M=40 (576, 192) a cluster of splits", dict(x=t(40, 576), w=t(576, 192),
                                                     bias=None, act="gelu")),
        ("unaligned views (24, 512) @ (512, 256)",
         dict(x=unaligned(24, 512), w=unaligned(512, 256), bias=None, act="relu")),
    ]


def row_invariance_check(dev, mm, gen, dtype=torch.bfloat16):
    """The GEMM's hard rule, on the kernel itself: one fixed row of x,
    placed in other rows of an x of every M in INVARIANCE_ROWS (first and
    last rows, other warps and tiles), comes out bitwise equal to the same
    row alone (M = 1), in one K order at every M. On bf16 operands
    (`gfid_matmul_bf16`): in fp32 and bf16 stores, at each smollm-135m GEMM
    shape and a ragged one. On fp32 operands (`gfid_matmul_f32`): at the
    same shapes and AlexNet's fc6-fc8. Returns the count of checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import gfid_matmul as G
    bf16 = dtype == torch.bfloat16
    kname = "gfid_matmul_bf16" if bf16 else "gfid_matmul"
    stores = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    shapes = serve_gemm_shapes(get_config(SERVE_MODEL)) + (("ragged", 300, 70),)
    if not bf16:
        shapes += (("alexnet fc6", 9216, 4096), ("alexnet fc7", 4096, 4096),
                   ("alexnet fc8", 4096, 1000))
    # fp32's large operands (fc6's x at M = 15,872 is 585 MB) are drawn on
    # the card, from a seed of their own
    dgen = None if bf16 else torch.Generator(device=dev).manual_seed(32)
    sms = build.sm_count(dev.index or 0) if dev.type == "cuda" else 132
    checks = 0
    for label, k, n in shapes:
        w = torch.randn((k, n), generator=gen).to(dev).to(dtype)
        row = torch.randn((1, k), generator=gen).to(dev).to(dtype)
        want = {dt: mm(row, w, out_dtype=dt) for dt in stores}
        orders, tiles = set(), set()
        for m in INVARIANCE_ROWS:
            x = (torch.randn((m, k), generator=gen).to(dev).to(dtype) if bf16
                 else torch.randn((m, k), generator=dgen, device=dev))
            at = sorted({0, m - 1} | {r for r in (5, 17, 70, 200, 5000) if r < m})
            x[at] = row
            if bf16:
                plan = G.bf16_plan(m, k, n, x.data_ptr(), w.data_ptr())
                tiles.add(plan.bm)
            else:
                plan = G.f32_plan(m, k, n, x.data_ptr(), w.data_ptr(), sms)
                tiles.add(f"{plan.bm}x{plan.bn} {f32_mode(plan)}")
            orders.add((plan.splits, plan.chunks_per_split))
            for dt, ref in want.items():
                got = mm(x, w, out_dtype=dt)[at]
                require(torch.equal(got, ref.expand_as(got)),
                        f"{kname} row invariance {label} M={m} {dt}: "
                        f"rows {at} differ from the row alone")
                checks += 1
            del x
        require(len(orders) == 1, f"{kname} {label}: K order by M {orders}")
        print(f"[check] {kname} row invariance {label} ({k}, {n}): one row "
              f"at M = {', '.join(map(str, INVARIANCE_ROWS))} (block "
              f"{'rows' if bf16 else 'tiles'} {sorted(tiles)}; splits, chunks "
              f"{orders.pop()}) bitwise equal to the row alone, "
              f"{' and '.join(str(dt)[6:] for dt in stores)} stores")
    return checks


def batch_invariance_check(dev, cnn, conv, conv8, quant, gen):
    """The conv's hard rule for the static Scheduler, on the kernels
    themselves: one fixed image, placed first, in the middle and last of
    batches of INVARIANCE_BATCHES images, comes out bitwise equal to the
    image alone. On fp32 and on bf16 operands (fp32 and bf16 stores) at
    every AlexNet conv shape and every distinct VGG-16 and ResNet-50 conv
    shape of the functional path (strides and projections included); the
    int8 conv (operands quantized by `core/quant`, a scale per image) at
    AlexNet's. Also reads, without failing, whether ResNet-50's global
    average pool (`x.mean(dim=(1, 2))` at (B, 7, 7, 2048)) gives the image
    other bits in a batch. Returns (checks, the fp32 plans, the bf16
    plans)."""
    shapes = {}
    for net in ("alexnet", "vgg16", "resnet50"):
        for sp in cnn.analytics_layers(net, main_path_only=False)[0]:
            key = (sp.h_in, sp.w_in, sp.c_in, sp.c_out, sp.h_f, sp.w_f, sp.s,
                   sp.pad, sp.groups)
            shapes.setdefault(key, (f"{net} {sp.name}", net == "alexnet"))
    checks, plans = 0, {torch.float32: [], torch.bfloat16: []}
    n_max = max(INVARIANCE_BATCHES)
    t0 = time.perf_counter()
    for (h, wd, c_in, c_out, h_f, w_f, st, pad, groups), (label, alex) \
            in shapes.items():
        cg = c_in // groups
        fan_in = h_f * w_f * cg
        # image 0 is the fixed one; the others fill the batches around it
        xs = torch.randn((n_max + 1, h, wd, c_in), generator=gen).to(dev)
        w = (torch.randn((h_f, w_f, cg, c_out), generator=gen)
             * (2.0 / fan_in) ** 0.5).to(dev)
        bias = (0.1 * torch.randn(c_out, generator=gen)).to(dev)
        geo = dict(stride=st, pad=pad, groups=groups, act="relu")
        variants = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                    (torch.bfloat16, torch.bfloat16)]
        for dtype, out_dtype in variants:
            xd, wdt, bd = xs.to(dtype), w.to(dtype), bias.to(dtype)
            kw = dict(geo, out_dtype=out_dtype) if dtype == torch.bfloat16 else geo
            alone = conv(xd[:1], wdt, bias=bd, **kw)
            for b in INVARIANCE_BATCHES:
                at = sorted({0, b // 2, b - 1})
                x = xd[1:b + 1].clone()
                x[at] = xd[:1]
                got = conv(x, wdt, bias=bd, **kw)[at]
                require(torch.equal(got, alone.expand_as(got)),
                        f"gfid_conv2d_nhwc {label} {str(dtype)[6:]} -> "
                        f"{str(out_dtype)[6:]}: images {at} of a batch of {b} "
                        "differ from the image alone")
                if out_dtype == torch.float32:
                    plans[dtype].append(launch_plan("conv", dict(
                        geo, x=x, w=wdt)))
                checks += 1
        if alex:
            q = lambda x: quantized("conv", dict(geo, x=x, w=w, bias=bias), quant)
            alone = conv8(**q(xs[:1]))
            for b in INVARIANCE_BATCHES:
                at = sorted({0, b // 2, b - 1})
                x = xs[1:b + 1].clone()
                x[at] = xs[:1]
                got = conv8(**q(x))[at]
                require(torch.equal(got, alone.expand_as(got)),
                        f"gfid_conv2d_nhwc_int8 {label}: images {at} of a batch "
                        f"of {b} differ from the image alone")
                checks += 1
        del xs
    torch.cuda.synchronize()
    for dtype, ps in plans.items():
        modes = sorted({(p.bm, p.bn, "fold" if p.fold else
                         "split" if p.splits > 1 else "one") for p in ps})
        require(any(m[2] == "fold" for m in modes)
                and any(m[2] == "split" for m in modes),
                f"batch invariance {dtype}: the cases reach {modes}, not a fold "
                "and a split through the workspace")
        print(f"[check] gfid_conv2d_nhwc batch invariance {str(dtype)[6:]}: the "
              f"cases reach tile and K-split modes "
              f"{', '.join(f'{m}x{n} {md}' for m, n, md in modes)}")
    print(f"[check] gfid_conv2d_nhwc batch invariance: {len(shapes)} conv shapes "
          f"(AlexNet, VGG-16, ResNet-50), one image first, middle and last in "
          f"batches of {', '.join(map(str, INVARIANCE_BATCHES))} bitwise equal "
          f"to the image alone, fp32 and bf16 (fp32 and bf16 stores), int8 at "
          f"AlexNet's; {checks} checks in {time.perf_counter() - t0:.1f} s")
    # ResNet-50's pooled features: a torch reduction, read here, not required
    feats = torch.randn((n_max + 1, 7, 7, 2048), generator=gen).to(dev)
    alone = feats[:1].mean(dim=(1, 2))
    moved = []
    for b in INVARIANCE_BATCHES:
        at = sorted({0, b // 2, b - 1})
        x = feats[1:b + 1].clone()
        x[at] = feats[:1]
        got = x.mean(dim=(1, 2))[at]
        if not torch.equal(got, alone.expand_as(got)):
            moved.append((b, (got - alone).abs().max().item()))
    print("[check] resnet50 global average pool (B, 7, 7, 2048).mean((1, 2)): "
          + ("one image bitwise the same in every batch" if not moved else
             "the image's pooled features move in batches "
             + ", ".join(f"{b} (max|d| {d:.3e})" for b, d in moved)))
    return checks, plans[torch.float32], plans[torch.bfloat16]


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
    4, one row, M = 16 and 17, K = 1028, N = 100 and 520, M = 600 (many
    row blocks of the GEMM's 32-row tile), and an xq that is not 16-byte
    aligned."""
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
        # the 16- and 32-row tiles at their edge, in a cluster of K splits
        dict(x=t(16, 512), w=t(512, 640), bias=t(640), act="relu"),
        dict(x=t(17, 1024), w=t(1024, 4096), bias=None, act="gelu"),
        # K % 16 != 0 with K % 4 == 0; N % 8 != 0 with N % 4 == 0; N % 16 != 0
        dict(x=t(4, 1028), w=t(1028, 100), bias=t(100), act="relu"),
        dict(x=t(2, 2048), w=t(2048, 520), bias=None, act=None),
        # many rows: 19 row blocks of the 32-row tile
        dict(x=t(600, 256), w=t(256, 4096), bias=t(4096), act="relu"),
    ]
    mm8 = [quantized("fc", kw, quant) for kw in mm]
    # xq a contiguous view 1 byte past a 16-byte boundary: gathered A words
    kw = quantized("fc", dict(x=t(16, 1024), w=t(1024, 4096), bias=t(4096),
                              act="relu"), quant)
    buf = torch.empty(kw["xq"].numel() + 1, dtype=torch.int8, device=dev)
    buf[1:].copy_(kw["xq"].reshape(-1))
    mm8.append(dict(kw, xq=buf[1:].view(kw["xq"].shape)))
    return [quantized("conv", kw, quant) for kw in conv], mm8


def paged_cases(gen, dev):
    """(label, pool, table) for the gather: smollm-135m's full-width bf16
    pool with tables of 8 and 1 rows x 32 blocks (block 0 included), the
    four cases of tests/test_kv_pool.py, an fp32 pool, and blocks of 30 and
    15 bytes (copied 2 and 1 bytes at a time)."""
    def case(label, shape, dtype, b, npr):
        if dtype.is_floating_point:
            pool = torch.randn(shape, generator=gen).to(dtype)
        else:
            pool = torch.randint(0, 256, shape, generator=gen).to(dtype)
        table = torch.randint(0, shape[0], (b, npr), generator=gen,
                              dtype=torch.int32)
        table[0, 0] = 0
        return label, pool.to(dev), table.to(dev)
    bf16 = torch.bfloat16
    return [
        case("full width B=8", (257, 16, 30, 3, 64), bf16, 8, 32),
        case("full width B=1", (257, 16, 30, 3, 64), bf16, 1, 32),
        case("kv_pool case 1", (10, 4, 3, 2, 5), bf16, 2, 3),
        case("kv_pool case 2", (16, 8, 4, 16), bf16, 3, 4),
        case("kv_pool case 3", (5, 2), bf16, 1, 2),
        case("kv_pool case 4", (12, 8, 7), bf16, 4, 1),
        case("fp32", (9, 4, 3, 5), torch.float32, 3, 2),
        case("30-byte blocks", (7, 3, 5), bf16, 2, 4),
        case("15-byte blocks", (6, 3, 5), torch.uint8, 2, 3),
    ]


TRAP_CHILD = """
import sys
import torch
sys.path.insert(0, "src")
from repro_torch.kernels import paged
pool = torch.zeros((4, 2, 8), device="cuda")
table = torch.tensor([[1, 4]], dtype=torch.int32, device="cuda")
try:
    paged.paged_gather(pool, table)
    torch.cuda.synchronize()
except Exception as e:  # the trap surfaces as a CUDA error
    print("stopped:", type(e).__name__, str(e).splitlines()[0])
    sys.exit(0)
print("not stopped")
sys.exit(1)
"""


def paged_trap_check():
    """Run `paged_gather` on a table that names block 4 of a 4-block pool
    in a child process (the kernel's __trap() ends that process's CUDA
    context) and require that the error surfaced there."""
    proc = subprocess.run([sys.executable, "-c", TRAP_CHILD], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    out = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and out and out[-1].startswith("stopped:"),
            f"paged_gather with an out-of-range id was not stopped: exit "
            f"{proc.returncode}, {proc.stdout[-500:]} {proc.stderr[-500:]}")
    return out[-1]


def zero_counts(*wrappers):
    for fn in wrappers:
        fn.launches = 0


def counts(*wrappers):
    return tuple(fn.launches for fn in wrappers)


def int_mm_accepts(m, k, n):
    """Whether `torch._int_mm` takes an (m, k) @ (k, n) int8 product on the
    card: more than 16 rows and k, n multiples of 8."""
    return m > 16 and k % 8 == 0 and n % 8 == 0


def serve_phase(dev, E, gfid_matmul, paged, other_kernels, worst,
                dtype=torch.float32):
    """Phase 6 (fp32 parameters) and phase 9 (`dtype=torch.bfloat16`, the
    config's own): smollm-135m served through `ContinuousScheduler` on the
    paged pool (see the module docstring). The GEMM launches counted are
    `gfid_matmul`'s or `gfid_matmul_bf16`'s by the dtype; `other_kernels` must
    launch nothing. Returns the numbers the kernels line and the summary
    print (and the parameters); folds the kernel-vs-plain errors at the
    timed shapes into `worst`."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             latency_percentiles)

    bf16 = dtype == torch.bfloat16
    tag = "[serve bf16]" if bf16 else "[serve]"
    mm_name = "gfid_matmul_bf16" if bf16 else "gfid_matmul"
    # the launch count of the GEMM kernel of this dtype; `mm` takes both
    counted, gather = getattr(gfid_matmul, mm_name), paged.paged_gather
    mm = gfid_matmul.gfid_matmul
    logits_tol = BF16_LOGITS_TOL if bf16 else TOL
    cfg = get_config(SERVE_MODEL)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=DEVICE, dtype=dtype)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} "
          f"{str(dtype)[6:]} parameters "
          f"({sum(p.numel() * p.element_size() for p in _leaves(params)) / 1e6:.1f} "
          f"MB) made in {time.perf_counter() - t0:.2f} s")
    per_pass = cfg.n_layers * 7 + 1     # GEMMs of a decode step or a prefill
    gen = torch.Generator().manual_seed(0)
    work = []
    for _ in range(SERVE_REQUESTS):
        n = int(torch.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, (1,),
                              generator=gen))
        steps = SERVE_STEPS[int(torch.randint(len(SERVE_STEPS), (1,),
                                              generator=gen))]
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
        work.append((prompt, steps))
    print(f"{tag} workload: {len(work)} requests, prompts "
          f"{sorted(len(p) for p, _ in work)} tokens, steps "
          f"{[n for _, n in work]} ({sum(n for _, n in work)} tokens to generate)")
    conf = E.EngineConfig(backend="cuda", row_align=8)

    def scheduler(max_batch, admission):
        return ContinuousScheduler(
            cfg, params, max_len=SERVE_MAX_LEN, num_blocks=SERVE_BLOCKS,
            block_size=SERVE_BLOCK, max_batch=max_batch, config=conf,
            admission=admission)

    runs = {}
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        # solo (one row a step, host-bound) serves only the requests that
        # greedy_generate checks too
        served = work[:SERVE_DENSE_CHECKS] if mode == "solo" else work
        t0 = time.perf_counter()
        prefills = [s.prefill_compiled(n)
                    for n in sorted({len(p) for p, _ in served})]
        decodes = [s.decode_compiled(b) for b in s.buckets]
        compile_s = time.perf_counter() - t0
        for c, want_ops in [(c, per_pass) for c in prefills] \
                + [(c, 2 + per_pass) for c in decodes]:
            kinds = [op.kind for op in c.program.ops]
            require(set(c.backends()) == {"cuda"} and len(kinds) == want_ops
                    and len(c.exec_pairs) == want_ops
                    and kinds.count("gather") == want_ops - per_pass,
                    f"{mode} {c.program.name}: backends {set(c.backends())}, "
                    f"{len(kinds)} ops, expected {want_ops}")
        compiled = prefills + decodes
        tickets = [s.submit(p, n) for p, n in served]
        zero_counts(counted, gather, *other_kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = s.stats()
        launches = counts(counted, gather, *other_kernels)
        require(all(t.status == "done" and t.preemptions == 0 for t in tickets)
                and st["evicted"] == 0, f"{mode}: not every request done "
                "without preemption")
        require(st["compiled_decode_buckets"] == [SERVE_BATCH], f"{mode}: decode "
                f"buckets {st['compiled_decode_buckets']}, expected [{SERVE_BATCH}]")
        want = (per_pass * (st["steps"] + st["admitted"]), 2 * st["steps"]) \
            + (0,) * len(other_kernels)
        require(launches == want, f"{mode}: launches "
                f"(gfid_matmul, paged_gather, others) = {launches}, expected "
                f"{want} for {st['steps']} decode steps and {st['admitted']} "
                "prefills")
        n_tok = sum(len(t.tokens) for t in tickets)
        lat = latency_percentiles(tickets)
        runs[mode] = dict(tokens=[t.tokens for t in tickets], wall=wall,
                          n_tok=n_tok, lat=lat, stats=st, compile_s=compile_s)
        print(f"{tag} {mode}: {st['steps']} decode steps (buckets "
              f"{st['compiled_decode_buckets']}, fill {st['decode_fill']:.3f}), "
              f"{st['admitted']} prefills, {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s; latency p50 {lat['p50_ms']:.1f} ms, "
              f"p95 {lat['p95_ms']:.1f} ms; launches {mm_name} {launches[0]}, "
              f"paged_gather {launches[1]} (= {per_pass} per step and prefill, 2 "
              f"per step), others {sum(launches[2:])}; {len(compiled)} programs "
              f"captured and compiled in {compile_s:.2f} s beforehand; pool "
              f"free low-water {st['pool']['free_low_water']}")
    base = runs["continuous"]["tokens"]
    for mode in ("drain", "solo"):
        require(runs[mode]["tokens"] == base[:len(runs[mode]["tokens"])],
                f"{mode} tokens differ from the continuous run")
    with E.using_config(conf):
        for i, (prompt, steps) in enumerate(work[:SERVE_DENSE_CHECKS]):
            dense = SE.greedy_generate(cfg, params, {"tokens": torch.tensor(
                [prompt], device=dev)}, steps, SERVE_MAX_LEN)
            require(dense[0].tolist() == base[i], f"request {i}: paged tokens "
                    "differ from greedy_generate's dense-cache tokens")
    print(f"{tag} tokens bitwise equal across continuous, drain and solo, and "
          f"equal to greedy_generate for {SERVE_DENSE_CHECKS} requests")

    # one decode step with 8 and with 1 live rows (both at the one bucket of
    # SERVE_BATCH rows; a fresh scheduler with 8 requests admitted):
    # launches, timing, profile, "torch" replay
    s8 = scheduler(SERVE_BATCH, "continuous")
    rows = [s8.submit(work[i % len(work)][0],
                      SERVE_MAX_LEN - len(work[i % len(work)][0]))
            for i in range(SERVE_BATCH)]
    s8.step()                              # admits 8, runs one decode step
    require(all(t.status == "running" for t in rows) and
            s8.running() == SERVE_BATCH, f"{s8.running()} rows running")
    step_ms, step_launches, profiles = {}, {}, {}
    logits = {}
    dec = s8.decode_compiled(SERVE_BATCH)
    for live in (SERVE_BATCH, 1):
        pad = SERVE_BATCH - live
        rids = [t.rid for t in rows[:live]]
        args = (params, s8.pool.arrays, s8.pool.table_rows(rids, SERVE_BATCH),
                s8.pool.slot_rows(rids, SERVE_BATCH),
                torch.tensor([[t.tokens[-1]] for t in rows[:live]] + [[0]] * pad,
                             dtype=torch.int32, device=dev),
                torch.tensor([t.pos for t in rows[:live]] + [0] * pad,
                             dtype=torch.int32, device=dev))
        zero_counts(counted, gather, *other_kernels)
        dec.apply(*args)
        torch.cuda.synchronize()
        one = step_launches[live] = counts(counted, gather, *other_kernels)
        require(one == (per_pass, 2) + (0,) * len(other_kernels),
                f"{live} live rows: one decode step launched {one}")
        # each call rewrites the same slot with the same values
        step_ms[live] = time_ms(lambda: dec.apply(*args))
        profiles[live] = device_profile(lambda: dec.apply(*args))
        if live == SERVE_BATCH:
            snap = [a.clone() for a in _leaves(s8.pool.arrays)]
            for backend in ("cuda", "torch"):
                with E.using_config(conf.replace(backend=backend)), \
                        torch.no_grad():
                    state = s8.layout.gather(s8.pool.arrays, args[2], args[3])
                    logits[backend], _ = T.decode_step(cfg, params, state,
                                                       args[4], args[5])
                for a, b in zip(_leaves(s8.pool.arrays), snap):
                    a.copy_(b)
    err = rel_err(logits["cuda"], logits["torch"])
    require(bool(torch.isfinite(logits["cuda"]).all()) and err <= logits_tol,
            f"{tag} decode step: cuda logits vs torch backend {err:.3e} > "
            f"{logits_tol}")
    print(f"{tag} one decode step at bucket {SERVE_BATCH}: {per_pass} {mm_name} + 2 "
          f"paged_gather launches with {SERVE_BATCH} and with 1 live rows; logits with "
          f"{SERVE_BATCH} live rows max|d|/max|ref| vs the torch backend on the same "
          f"pool = {err:.3e} (limit {logits_tol})")
    print(f"{tag} decode step at bucket {SERVE_BATCH}: {SERVE_BATCH} live rows "
          f"{step_ms[SERVE_BATCH]:.4f} ms, 1 live row {step_ms[1]:.4f} ms (median of "
          "20, CUDA events around CompiledNet.apply)")
    for live, prof in profiles.items():
        if prof is None:
            print(f"[profile] {tag} {live} live rows: the profiler recorded no "
                  "device time; device busy share not measured")
            continue
        busy_ms, n_kernels, top = prof
        print(f"[profile] {tag} decode step with {live} live rows: {n_kernels} device "
              f"kernels, {busy_ms:.4f} ms of device time per step (sum of kernel "
              f"times, torch.profiler over 3 steps) = {100 * busy_ms / step_ms[live]:.1f}% "
              f"of the step; idle {100 * (1 - busy_ms / step_ms[live]):.1f}%; "
              "by kernel: " + "; ".join(f"{n[:60]} x{c} {ms:.4f} ms"
                                         for n, c, ms in top[:6]))

    # prefill and capture at prompt SERVE_PREFILL
    t0 = time.perf_counter()
    pre = E.compile(SE.prefill_ingest_program(cfg, s8.layout, SERVE_PREFILL,
                                              dtype), conf)
    capture_s = time.perf_counter() - t0
    row = s8.pool.table_rows([rows[0].rid], 1)[0]
    slot = s8.pool.slot_rows([rows[0].rid], 1)[0]
    prompt = torch.tensor([work[0][0][:1] * SERVE_PREFILL], dtype=torch.int32,
                          device=dev)
    snap = [a.clone() for a in _leaves(s8.pool.arrays)]
    prefill_ms = time_ms(lambda: pre.apply(params, s8.pool.arrays, row, slot,
                                           prompt), iters=10)
    for a, b in zip(_leaves(s8.pool.arrays), snap):
        a.copy_(b)
    del snap
    print(f"{tag} batch-1 prefill at prompt {SERVE_PREFILL}: {prefill_ms:.4f} ms (median "
          f"of 10); capture and compile of its program: {capture_s:.3f} s")

    # the kernels at the decode step's shapes
    pool = s8.pool.arrays["groups"]["0"]["k"]
    table = s8.pool.table_rows([t.rid for t in rows], SERVE_BATCH)
    g_bytes = 2 * table.shape[0] * table.shape[1] * pool[0].numel() \
        * pool.element_size() + table.numel() * 4
    g_bound, g_by = bound_ms(g_bytes, 0)
    g = dict(ms=time_ms(lambda: gather(pool, table)),
             device_ms=graph_ms(lambda: gather(pool, table)),
             plain_ms=time_ms(lambda: paged.paged_gather_plain(pool, table)),
             library_ms=time_ms(lambda: pool.index_select(0, table.view(-1))),
             library_device_ms=graph_ms(lambda: pool.index_select(0, table.view(-1))),
             bound_ms=g_bound, bound_by=g_by)
    print(f"[time] paged_gather pool {tuple(pool.shape)} bf16, table "
          f"{tuple(table.shape)}: kernel {g['ms']:.4f} ms, the device alone "
          f"{g['device_ms']:.4f} ms (host part {g['ms'] - g['device_ms']:.4f} ms), "
          f"plain {g['plain_ms']:.4f} ms, library index_select {g['library_ms']:.4f} "
          f"ms, the device alone {g['library_device_ms']:.4f} ms (host part "
          f"{g['library_ms'] - g['library_device_ms']:.4f} ms), bound {g_bound:.4f} "
          f"ms ({g_bytes / 1e6:.2f} MB, {g_by}); {g_bytes / g['device_ms'] / 1e9:.3f} "
          "TB/s for the device alone")
    got = gather(pool, table)
    require(torch.equal(got, paged.paged_gather_plain(pool, table)),
            "paged_gather at the decode step's shapes differs from its plain version")
    mm_rows = []
    for label, k, n in serve_gemm_shapes(cfg):
        x = torch.randn((8, k), generator=gen).to(dev).to(dtype)
        w = torch.randn((k, n), generator=gen).to(dev).to(dtype)
        # as on the path: a projection stores the operands' dtype, the tied
        # unembedding fp32
        out = torch.float32 if label == "unembed" else dtype
        kw = dict(out_dtype=out) if bf16 else {}
        want = gfid_matmul.gfid_matmul_plain(x, w, **kw)
        got = mm(x, w, **kw)
        ok, abs_err, reading, limit = kernel_check(got, want)
        require(ok, f"{mm_name} decode {label}: {reading:.3e} > {limit}")
        worst[mm_name] = max(worst[mm_name], abs_err)
        el, out_el = x.element_size(), got.element_size()
        b_ms, by = bound_ms(el * (8 * k + k * n) + out_el * 8 * n, 2 * 8 * k * n,
                            PEAK_BF16_FLOP_S if bf16 else PEAK_FP32_FLOP_S)
        row_t = dict(label=label, k=k, n=n, ms=time_ms(lambda: mm(x, w, **kw)),
                     device_ms=graph_ms(lambda: mm(x, w, **kw)),
                     plain_ms=time_ms(lambda: gfid_matmul.gfid_matmul_plain(
                         x, w, **kw)),
                     library_ms=time_ms(lambda: torch.mm(x, w)),
                     library_device_ms=graph_ms(lambda: torch.mm(x, w)),
                     bound_ms=b_ms, bound_by=by)
        mm_rows.append(row_t)
        print(f"[time] {mm_name} decode {label} (8, {k}) @ ({k}, {n}) -> "
              f"{str(got.dtype)[6:]}: kernel {row_t['ms']:.4f} ms, the device alone "
              f"{row_t['device_ms']:.4f} ms (host part "
              f"{row_t['ms'] - row_t['device_ms']:.4f} ms), plain "
              f"{row_t['plain_ms']:.4f} ms, library torch.mm "
              f"{row_t['library_ms']:.4f} ms, the device alone "
              f"{row_t['library_device_ms']:.4f} ms (host part "
              f"{row_t['library_ms'] - row_t['library_device_ms']:.4f} ms), bound "
              f"{b_ms:.4f} ms ({by}); vs plain "
              f"{reading:.3e} (limit {limit:g}{' bf16 steps' if limit == 1.0 else ''})")
    embed = params["embed"]
    copy_ms = time_ms(lambda: embed.T.contiguous())
    per_step = {"wq/wo": 2, "wk/wv": 2, "w_in/w_gate": 2, "w_out": 1, "unembed": 0}
    layer_ms = sum(r["ms"] * per_step[r["label"]] for r in mm_rows)
    print(f"[time] {tag} tied unembedding: the (vocab, d_model) table's transpose "
          f"copy before the GEMM {copy_ms:.4f} ms "
          f"({embed.numel() * embed.element_size() / 1e6:.1f} MB "
          f"read and written); per decode step at bucket {SERVE_BATCH}: {cfg.n_layers} layers "
          f"x {layer_ms:.4f} ms of layer GEMMs + unembed {mm_rows[-1]['ms']:.4f} ms "
          f"+ copy {copy_ms:.4f} ms + 2 gathers = "
          f"{cfg.n_layers * layer_ms + mm_rows[-1]['ms'] + copy_ms + 2 * g['ms']:.4f} "
          f"ms of these kernels, against a step of {step_ms[SERVE_BATCH]:.4f} ms")
    cont = runs["continuous"]
    return dict(gather=g, mm_rows=mm_rows, step_ms=step_ms, prefill_ms=prefill_ms,
                per_pass=per_pass, step_launches=step_launches[SERVE_BATCH],
                capture_s=capture_s, tps=cont["n_tok"] / cont["wall"],
                lat=cont["lat"], copy_ms=copy_ms, params=params)


def ssm_conv_cases(gen, dev):
    """(label, x, w, causal) for `gfid_conv1d_depthwise`: the xLSTM prefill's
    mLSTM (1, L, 1536) and sLSTM (1, L, 768) convs at L = 16, 243 and 384,
    causal, 4 taps; a ragged (3, 37, 100) in both modes; hubert's centred
    128-tap positional conv at (2, 64, 1280); bf16 operands; D % 4 != 0 on
    the register window and the shared-memory tile; bf16 on the tile; 1 tap;
    an unaligned x."""
    def t(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(dtype).to(dev)
    cases = [(f"xlstm (1, {l}, {d}) W_f 4 causal", t(1, l, d), t(4, d), True)
             for l in SSM_CONV_LENS for d in (1536, 768)]
    cases += [("ragged (3, 37, 100) W_f 4 causal", t(3, 37, 100), t(4, 100), True),
              ("ragged (3, 37, 100) W_f 4 centred", t(3, 37, 100), t(4, 100), False),
              ("ragged (3, 37, 100) W_f 5 centred", t(3, 37, 100), t(5, 100), False),
              ("hubert (2, 64, 1280) W_f 128 centred", t(2, 64, 1280),
               t(128, 1280), False),
              ("bf16 (2, 17, 96) W_f 4 causal", t(2, 17, 96, dtype=torch.bfloat16),
               t(4, 96, dtype=torch.bfloat16), True),
              # D % 4 != 0: scalar loads, in both paths
              ("ragged (2, 21, 30) W_f 8 causal", t(2, 21, 30), t(8, 30), True),
              ("ragged (2, 40, 30) W_f 9 centred", t(2, 40, 30), t(9, 30), False),
              ("bf16 (2, 33, 70) W_f 70 centred", t(2, 33, 70, dtype=torch.bfloat16),
               t(70, 70, dtype=torch.bfloat16), False),
              ("bf16 x, fp32 w (1, 50, 256) W_f 12 causal",
               t(1, 50, 256, dtype=torch.bfloat16), t(12, 256), True),
              ("W_f 1 (1, 19, 8)", t(1, 19, 8), t(1, 8), True)]
    # x a contiguous view one element past a 16-byte boundary: scalar loads
    # at D % 4 == 0
    x = t(1 + 2 * 21 * 32)[1:].view(2, 21, 32)
    cases.append(("unaligned x (2, 21, 32) W_f 4 causal", x, t(4, 32), True))
    return cases


def require_conv1d_coverage(plans):
    """The checked `gfid_conv1d_depthwise` cases reach the register window
    and the shared-memory tile, each with vector and scalar loads, and bf16
    x on both paths; `plans` holds (launch plan, x dtype) pairs."""
    seen = {(p.staged, p.vec) for p, _ in plans}
    bf16 = {p.staged for p, dt in plans if dt == torch.bfloat16}
    want = {(a, b) for a in (False, True) for b in (False, True)}
    require(seen == want and bf16 == {False, True},
            f"gfid_conv1d_depthwise: the checked cases reach {seen} (bf16 x on "
            f"{bf16}), not {want} with bf16 x on both paths")
    print("[check] gfid_conv1d_depthwise: the cases reach the register window "
          "and the shared-memory tile, each with float4 and scalar loads, bf16 "
          "x on both")


def ssm_gemm_shapes(cfg):
    """(label, k, n) of every GEMM of an xLSTM decode step or prefill: the
    mLSTM's w_up, wq/wk/wv, w_if and w_down, the sLSTM's w_gates, w_up and
    w_down, and the tied unembedding."""
    d = cfg.d_model
    di = cfg.ssm.expand * d
    dff = int(d * 4 / 3 / 64) * 64 * 2
    return (("mlstm w_up / slstm w_gates", d, 2 * di), ("wq/wk/wv", di, di),
            ("w_if", di, 2 * cfg.n_heads), ("w_down", di, d),
            ("slstm w_up", d, dff), ("slstm w_down", dff // 2, d),
            ("unembed", d, cfg.vocab_size))


def ssm_phase(dev, E, gfid_matmul, conv1d, paged, other_kernels, worst):
    """Phase 7: xlstm-125m served through `ContinuousScheduler` (see the
    module docstring). Holds `gfid_conv1d_depthwise` bitwise and
    `gfid_matmul` within TOL against their plain versions at the path's
    shapes first. Returns the numbers the kernels line and the summary
    print; folds the kernel-vs-plain errors into `worst`."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             latency_percentiles)

    mm, conv, gather = (gfid_matmul.gfid_matmul, conv1d.gfid_conv1d_depthwise,
                        paged.paged_gather)
    cfg = get_config(SSM_MODEL)
    gen = torch.Generator().manual_seed(7)

    # the kernels against their plain versions at the path's shapes
    worst["gfid_conv1d_depthwise"] = 0.0
    plans = []
    for label, x, w, causal in ssm_conv_cases(gen, dev):
        got = conv(x, w, causal=causal)
        want = conv1d.gfid_conv1d_depthwise_plain(x, w, causal=causal)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype
                and bool(torch.isfinite(got).all()),
                f"gfid_conv1d_depthwise {label}: bad output")
        equal = torch.equal(got, want)
        abs_err = (got - want).abs().max().item()
        plan = conv1d.launch_plan(*x.shape, w.shape[0], causal, x.data_ptr())
        plans.append((plan, x.dtype))
        print(f"[check] gfid_conv1d_depthwise {label}: bitwise equal {equal} "
              f"(max|d| = {abs_err:.3e}, limit 0), "
              f"{'shared-memory tile' if plan.staged else 'register window'}, "
              f"{'float4' if plan.vec else 'scalar'} loads, grid {plan.grid}")
        require(equal, f"gfid_conv1d_depthwise {label}: differs from its plain "
                "version")
        worst["gfid_conv1d_depthwise"] = max(worst["gfid_conv1d_depthwise"],
                                             abs_err)
    require_conv1d_coverage(plans)
    shapes = ssm_gemm_shapes(cfg)
    for rows, what in ((8, "decode"), (8 * SSM_PREFILL, "prefill")):
        for label, k, n in shapes[:-1] if what == "prefill" else shapes:
            x = torch.randn((rows, k), generator=gen).to(dev)
            w = torch.randn((k, n), generator=gen).to(dev)
            got, want = mm(x, w), gfid_matmul.gfid_matmul_plain(x, w)
            err = rel_err(got, want)
            print(f"[check] gfid_matmul xlstm {what} {label} ({rows}, {k}) @ "
                  f"({k}, {n}): max|d|/max|ref| = {err:.3e} (limit {TOL})")
            require(err <= TOL, f"gfid_matmul xlstm {what} {label}: error "
                    f"{err:.3e} > {TOL}")
            worst["gfid_matmul"] = max(worst["gfid_matmul"],
                                       (got - want).abs().max().item())

    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=DEVICE, dtype=torch.float32)
    n_params = sum(p.numel() for p in _leaves(params))
    print(f"[ssm] {cfg.name}: {cfg.n_layers} layers ({cfg.pattern.count('mlstm')} "
          f"mLSTM + {cfg.pattern.count('slstm')} sLSTM a group, {cfg.n_groups} "
          f"groups), d_model {cfg.d_model}, {cfg.n_heads} heads, expand "
          f"{cfg.ssm.expand}, d_conv {cfg.ssm.d_conv}, vocab {cfg.vocab_size}; "
          f"{n_params} fp32 parameters made in {time.perf_counter() - t0:.2f} s")
    n_mlstm = cfg.n_groups * cfg.pattern.count("mlstm")
    n_slstm = cfg.n_groups * cfg.pattern.count("slstm")
    per_pass = 6 * n_mlstm + 3 * n_slstm + 1   # GEMMs of a decode step or prefill
    convs = n_mlstm + n_slstm                   # depthwise convs of a prefill
    gen = torch.Generator().manual_seed(0)
    work = []
    for _ in range(SERVE_REQUESTS):
        n = int(torch.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, (1,),
                              generator=gen))
        steps = SERVE_STEPS[int(torch.randint(len(SERVE_STEPS), (1,),
                                              generator=gen))]
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
        work.append((prompt, steps))
    print(f"[ssm] workload: {len(work)} requests, prompts "
          f"{sorted(len(p) for p, _ in work)} tokens, steps "
          f"{[n for _, n in work]} ({sum(n for _, n in work)} tokens to generate)")
    conf = E.EngineConfig(backend="cuda", row_align=8)

    def scheduler(max_batch, admission):
        return ContinuousScheduler(
            cfg, params, max_len=SERVE_MAX_LEN, num_blocks=SERVE_BLOCKS,
            block_size=SERVE_BLOCK, max_batch=max_batch, config=conf,
            admission=admission, max_slots=SSM_SLOTS)

    runs = {}
    kernels = (mm, gather, conv) + tuple(other_kernels)
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        require(not any(sp.paged for sp in _leaves(s.layout.specs)),
                "an xLSTM state leaf is paged")
        # solo (one row a step, host-bound) serves only the requests that
        # greedy_generate checks too
        served = work[:SERVE_DENSE_CHECKS] if mode == "solo" else work
        t0 = time.perf_counter()
        prefills = [s.prefill_compiled(n)
                    for n in sorted({len(p) for p, _ in served})]
        decodes = [s.decode_compiled(b) for b in s.buckets]
        compile_s = time.perf_counter() - t0
        for c, want_ops, want_convs in [(c, per_pass + convs, convs) for c in prefills] \
                + [(c, per_pass, 0) for c in decodes]:
            kinds = [op.kind for op in c.program.ops]
            require(set(c.backends()) == {"cuda"} and len(kinds) == want_ops
                    and len(c.exec_pairs) == want_ops
                    and kinds.count("conv1d_dw") == want_convs
                    and kinds.count("dense") == per_pass,
                    f"{mode} {c.program.name}: backends {set(c.backends())}, "
                    f"{len(kinds)} ops ({kinds.count('conv1d_dw')} convs), "
                    f"expected {want_ops} ({want_convs})")
        tickets = [s.submit(p, n) for p, n in served]
        zero_counts(*kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = s.stats()
        launches = counts(*kernels)
        require(all(t.status == "done" and t.preemptions == 0 for t in tickets)
                and st["evicted"] == 0, f"{mode}: not every request done "
                "without preemption")
        require(st["compiled_decode_buckets"] == [SERVE_BATCH], f"{mode}: decode "
                f"buckets {st['compiled_decode_buckets']}, expected [{SERVE_BATCH}]")
        want = (per_pass * (st["steps"] + st["admitted"]), 0,
                convs * st["admitted"]) + (0,) * len(other_kernels)
        require(launches == want and launches[0] and launches[2],
                f"{mode}: launches (gfid_matmul, paged_gather, "
                f"gfid_conv1d_depthwise, others) = {launches}, expected {want} "
                f"for {st['steps']} decode steps and {st['admitted']} prefills")
        n_tok = sum(len(t.tokens) for t in tickets)
        lat = latency_percentiles(tickets)
        runs[mode] = dict(tokens=[t.tokens for t in tickets], wall=wall,
                          n_tok=n_tok, lat=lat, stats=st, launches=launches)
        print(f"[ssm] {mode}: {st['steps']} decode steps (buckets "
              f"{st['compiled_decode_buckets']}, fill {st['decode_fill']:.3f}), "
              f"{st['admitted']} prefills, {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s; latency p50 {lat['p50_ms']:.1f} ms, "
              f"p95 {lat['p95_ms']:.1f} ms; launches gfid_matmul {launches[0]}, "
              f"paged_gather {launches[1]}, gfid_conv1d_depthwise {launches[2]} "
              f"(= {per_pass} GEMMs a step and a prefill, {convs} convs a "
              f"prefill), others {sum(launches[3:])}; {len(prefills) + len(decodes)} "
              f"programs captured and compiled in {compile_s:.2f} s beforehand")
        del s
    base = runs["continuous"]["tokens"]
    for mode in ("drain", "solo"):
        require(runs[mode]["tokens"] == base[:len(runs[mode]["tokens"])],
                f"{mode} tokens differ from the continuous run")
    with E.using_config(conf):
        for i, (prompt, steps) in enumerate(work[:SERVE_DENSE_CHECKS]):
            dense = SE.greedy_generate(cfg, params, {"tokens": torch.tensor(
                [prompt], device=dev)}, steps, SERVE_MAX_LEN)
            require(dense[0].tolist() == base[i], f"request {i}: served tokens "
                    "differ from greedy_generate's")
    print(f"[ssm] tokens bitwise equal across continuous, drain and solo, and "
          f"equal to greedy_generate for {SERVE_DENSE_CHECKS} requests")

    # one decode step with 8 and with 1 live rows (one 8-row program)
    s8 = scheduler(SERVE_BATCH, "continuous")
    rows = [s8.submit(work[i % len(work)][0],
                      SERVE_MAX_LEN - len(work[i % len(work)][0]))
            for i in range(SERVE_BATCH)]
    s8.step()                              # admits 8, runs one decode step
    require(all(t.status == "running" for t in rows) and
            s8.running() == SERVE_BATCH, f"{s8.running()} rows running")
    step_ms, step_launches, profiles, logits = {}, {}, {}, {}
    dec = s8.decode_compiled(SERVE_BATCH)
    for live in (SERVE_BATCH, 1):
        pad = SERVE_BATCH - live
        rids = [t.rid for t in rows[:live]]
        args = (params, s8.pool.arrays, s8.pool.table_rows(rids, SERVE_BATCH),
                s8.pool.slot_rows(rids, SERVE_BATCH),
                torch.tensor([[t.tokens[-1]] for t in rows[:live]] + [[0]] * pad,
                             dtype=torch.int32, device=dev),
                torch.tensor([t.pos for t in rows[:live]] + [0] * pad,
                             dtype=torch.int32, device=dev))
        snap = [a.clone() for a in _leaves(s8.pool.arrays)]
        zero_counts(*kernels)
        dec.apply(*args)
        torch.cuda.synchronize()
        one = step_launches[live] = counts(*kernels)
        require(one == (per_pass, 0, 0) + (0,) * len(other_kernels),
                f"{live} live rows: one decode step launched {one}")
        step_ms[live] = time_ms(lambda: dec.apply(*args))
        profiles[live] = device_profile(lambda: dec.apply(*args))
        for a, b in zip(_leaves(s8.pool.arrays), snap):
            a.copy_(b)
        if live == SERVE_BATCH:
            # the same decode step on both backends from the same state: as
            # served (bf16 conv tails), and held in fp32. A decode step
            # rounds its new conv input to the tail's dtype, and where the
            # two backends' fp32 inputs straddle a bf16 rounding boundary
            # the logits move by far more than the arithmetic; the fp32
            # copy compares the arithmetic alone, and is the one held to TOL
            for backend in ("cuda", "torch"):
                for held in ("bf16", "fp32"):
                    with E.using_config(conf.replace(backend=backend)), \
                            torch.no_grad():
                        state = s8.layout.gather(s8.pool.arrays, args[2],
                                                 args[3])
                        if held == "fp32":
                            state = tree_map(lambda a: a.float(), state)
                        logits[backend, held], _ = T.decode_step(
                            cfg, params, state, args[4], args[5])
            # one row alone against row 0 of the bucket: greedy_generate
            # decodes a request at one row, the scheduler in the bucket
            with E.using_config(conf), torch.no_grad():
                st = [s8.layout.gather(s8.pool.arrays, t, sl) for t, sl in (
                    (args[2], args[3]), (s8.pool.table_rows(rids[:1], 1),
                                         s8.pool.slot_rows(rids[:1], 1)))]
                l8, st8 = T.decode_step(cfg, params, st[0], args[4], args[5])
                l1, st1 = T.decode_step(cfg, params, st[1], args[4][:1],
                                        args[5][:1])
            row_err = (l1 - l8[:1]).abs().max().item()
            state_same = [torch.equal(a, b[:, :1]) for a, b in zip(
                _leaves(st1["groups"]), _leaves(st8["groups"]), strict=True)]
            require(not st1["rem"] and torch.equal(l1, l8[:1])
                    and all(state_same), f"decode step: one row alone differs "
                    f"from row 0 of the {SERVE_BATCH}-row bucket: logits "
                    f"max|d| {row_err:.3e}, state leaves equal {state_same}")
            del st, st1, st8
        del snap
    err = rel_err(logits["cuda", "fp32"], logits["torch", "fp32"])
    err_bf16 = rel_err(logits["cuda", "bf16"], logits["torch", "bf16"])
    require(bool(torch.isfinite(logits["cuda", "bf16"]).all()) and err <= TOL,
            f"xlstm decode step: cuda logits vs torch backend {err:.3e} > {TOL}")
    require(err_bf16 <= BF16_STATE_TOL, f"xlstm decode step from the bf16 "
            f"state: cuda logits vs torch backend {err_bf16:.3e} > "
            f"{BF16_STATE_TOL}")
    print(f"[ssm] one decode step at bucket {SERVE_BATCH}: {per_pass} gfid_matmul "
          f"launches, no gather and no conv, with {SERVE_BATCH} and with 1 live "
          f"rows; logits with {SERVE_BATCH} live rows max|d|/max|ref| vs the torch "
          f"backend from the same state held in fp32 = {err:.3e} (limit {TOL}); "
          f"from the served bf16 state {err_bf16:.3e} (limit {BF16_STATE_TOL}: "
          "bf16 rounding of the new conv input); one row alone bitwise equal "
          f"to row 0 of the bucket, logits and {len(state_same)} state leaves")
    print(f"[ssm] decode step at bucket {SERVE_BATCH}: {SERVE_BATCH} live rows "
          f"{step_ms[SERVE_BATCH]:.4f} ms, 1 live row {step_ms[1]:.4f} ms (median of "
          "20, CUDA events around CompiledNet.apply)")
    for live, prof in profiles.items():
        if prof is None:
            print(f"[profile] xlstm {live} live rows: the profiler recorded no "
                  "device time; device busy share not measured")
            continue
        busy_ms, n_kernels, top = prof
        print(f"[profile] xlstm decode step with {live} live rows: {n_kernels} "
              f"device kernels, {busy_ms:.4f} ms of device time per step (sum of "
              f"kernel times, torch.profiler over 3 steps) = "
              f"{100 * busy_ms / step_ms[live]:.1f}% of the step; idle "
              f"{100 * (1 - busy_ms / step_ms[live]):.1f}%; by kernel: "
              + "; ".join(f"{n[:60]} x{c} {ms:.4f} ms" for n, c, ms in top[:6]))

    # prefill at prompt SSM_PREFILL (two mLSTM chunks): launches, "torch"
    # logits, time, profile
    t0 = time.perf_counter()
    pre = E.compile(SE.prefill_ingest_program(cfg, s8.layout, SSM_PREFILL,
                                              torch.float32), conf)
    capture_s = time.perf_counter() - t0
    row = s8.pool.table_rows([rows[0].rid], 1)[0]
    slot = s8.pool.slot_rows([rows[0].rid], 1)[0]
    prompt = torch.randint(0, cfg.vocab_size, (1, SSM_PREFILL), generator=gen,
                           dtype=torch.int32).to(dev)
    snap = [a.clone() for a in _leaves(s8.pool.arrays)]
    zero_counts(*kernels)
    pre.apply(params, s8.pool.arrays, row, slot, prompt)
    torch.cuda.synchronize()
    pre_launches = counts(*kernels)
    require(pre_launches == (per_pass, 0, convs) + (0,) * len(other_kernels),
            f"prefill({SSM_PREFILL}) launched {pre_launches}")
    pre_logits = {}
    for backend in ("cuda", "torch"):
        with E.using_config(conf.replace(backend=backend)), torch.no_grad():
            pre_logits[backend], _ = T.prefill(cfg, params, {"tokens": prompt},
                                               SERVE_MAX_LEN)
    pre_err = rel_err(pre_logits["cuda"], pre_logits["torch"])
    require(bool(torch.isfinite(pre_logits["cuda"]).all()) and pre_err <= TOL,
            f"xlstm prefill: cuda logits vs torch backend {pre_err:.3e} > {TOL}")
    prefill_ms = time_ms(lambda: pre.apply(params, s8.pool.arrays, row, slot,
                                           prompt), iters=5, warmup=1)
    pre_prof = device_profile(lambda: pre.apply(params, s8.pool.arrays, row,
                                                slot, prompt), steps=1)
    for a, b in zip(_leaves(s8.pool.arrays), snap):
        a.copy_(b)
    del snap
    print(f"[ssm] batch-1 prefill at prompt {SSM_PREFILL}: {per_pass} gfid_matmul + "
          f"{convs} gfid_conv1d_depthwise launches; logits max|d|/max|ref| vs the "
          f"torch backend {pre_err:.3e} (limit {TOL}); {prefill_ms:.4f} ms (median "
          f"of 5); capture and compile of its program: {capture_s:.3f} s")
    if pre_prof is None:
        print("[profile] xlstm prefill: the profiler recorded no device time")
    else:
        busy_ms, n_kernels, top = pre_prof
        print(f"[profile] xlstm prefill({SSM_PREFILL}): {n_kernels} device kernels, "
              f"{busy_ms:.4f} ms of device time = {100 * busy_ms / prefill_ms:.1f}% "
              f"of the prefill; by kernel: "
              + "; ".join(f"{n[:60]} x{c} {ms:.4f} ms" for n, c, ms in top[:6]))

    # the conv kernel at the timed prefill's shapes: kernel, plain, library,
    # bound
    conv_rows = []
    cudnn = torch.backends.cudnn
    for d, per_prefill in ((cfg.ssm.expand * cfg.d_model, n_mlstm),
                           (cfg.d_model, n_slstm)):
        x = torch.randn((1, SSM_PREFILL, d), generator=gen).to(dev)
        w = torch.randn((cfg.ssm.d_conv, d), generator=gen).to(dev)
        w_lib = w.T[:, None, :].contiguous()       # (D, 1, W_f), made once
        got, want = conv(x, w), conv1d.gfid_conv1d_depthwise_plain(x, w)
        require(torch.equal(got, want), f"gfid_conv1d_depthwise (1, "
                f"{SSM_PREFILL}, {d}) differs from its plain version")
        lib_out = F.conv1d(x.permute(0, 2, 1), w_lib, padding=cfg.ssm.d_conv - 1,
                           groups=d)[..., :SSM_PREFILL].permute(0, 2, 1)
        lib_err = rel_err(lib_out, want)
        require(lib_err <= TOL, f"F.conv1d differs from the plain conv: {lib_err:.3e}")
        n_bytes = 4 * (2 * x.numel() + w.numel())
        ops = 2 * cfg.ssm.d_conv * x.numel()
        b_ms, by = bound_ms(n_bytes, ops)
        row_t = dict(d=d, per_prefill=per_prefill,
                     ms=time_ms(lambda: conv(x, w)),
                     plain_ms=time_ms(lambda: conv1d.gfid_conv1d_depthwise_plain(x, w)),
                     library_ms=time_ms(lambda: F.conv1d(
                         x.permute(0, 2, 1), w_lib, padding=cfg.ssm.d_conv - 1,
                         groups=d)),
                     bound_ms=b_ms, bound_by=by, n_bytes=n_bytes)
        # CUDA events around one call also time the host's launch; a CUDA
        # graph of many calls times the device alone
        row_t["device_ms"] = graph_ms(lambda: conv(x, w))
        row_t["library_device_ms"] = graph_ms(lambda: F.conv1d(
            x.permute(0, 2, 1), w_lib, padding=cfg.ssm.d_conv - 1, groups=d))
        conv_rows.append(row_t)
        print(f"[time] gfid_conv1d_depthwise (1, {SSM_PREFILL}, {d}) W_f "
              f"{cfg.ssm.d_conv}: kernel {row_t['ms']:.4f} ms (device alone "
              f"{row_t['device_ms']:.4f} ms, {n_bytes / row_t['device_ms'] / 1e9:.3f} "
              f"TB/s), plain {row_t['plain_ms']:.4f} ms, library "
              f"F.conv1d(groups={d}, TF32 {'on' if cudnn.allow_tf32 else 'off'}) "
              f"{row_t['library_ms']:.4f} ms (device alone "
              f"{row_t['library_device_ms']:.4f} ms), bound {b_ms:.4f} ms "
              f"({n_bytes / 1e6:.2f} MB, {by})")
    conv_tot = {key: sum(r[key] * r["per_prefill"] for r in conv_rows)
                for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "device_ms", "library_device_ms")}
    conv_tot["bound_by"] = conv_rows[0]["bound_by"]
    print(f"[time] gfid_conv1d_depthwise per prefill({SSM_PREFILL}) ({n_mlstm} x "
          f"{conv_rows[0]['d']} + {n_slstm} x {conv_rows[1]['d']} channels): "
          f"kernel {conv_tot['ms']:.4f} ms (device alone "
          f"{conv_tot['device_ms']:.4f} ms), plain {conv_tot['plain_ms']:.4f} ms, "
          f"library {conv_tot['library_ms']:.4f} ms (device alone "
          f"{conv_tot['library_device_ms']:.4f} ms), bound "
          f"{conv_tot['bound_ms']:.4f} ms")

    # gfid_matmul at the decode step's shapes (M = 8)
    mm_rows = []
    for label, k, n in shapes:
        x = torch.randn((8, k), generator=gen).to(dev)
        w = torch.randn((k, n), generator=gen).to(dev)
        b_ms, by = bound_ms(4 * (8 * k + k * n + 8 * n), 2 * 8 * k * n)
        row_t = dict(label=label, k=k, n=n, ms=time_ms(lambda: mm(x, w)),
                     plain_ms=time_ms(lambda: gfid_matmul.gfid_matmul_plain(x, w)),
                     library_ms=time_ms(lambda: torch.mm(x, w)), bound_ms=b_ms,
                     bound_by=by)
        mm_rows.append(row_t)
        print(f"[time] gfid_matmul xlstm decode {label} (8, {k}) @ ({k}, {n}): "
              f"kernel {row_t['ms']:.4f} ms, plain {row_t['plain_ms']:.4f} ms, "
              f"library torch.mm {row_t['library_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({by})")
    cont = runs["continuous"]
    return dict(conv_rows=conv_rows, conv_tot=conv_tot, mm_rows=mm_rows,
                step_ms=step_ms, prefill_ms=prefill_ms, per_pass=per_pass,
                convs=convs, step_launches=step_launches[SERVE_BATCH],
                capture_s=capture_s, tps=cont["n_tok"] / cont["wall"],
                lat=cont["lat"], run_launches=cont["launches"])


def flash_cases(gen, dev):
    """(label, q, k, v, causal) for `flash_attention`, fp32: smollm-135m's
    prefill heads (1, S, 9 / 3, 64) causal at S = 1025, 1280, 1664, 1984 and
    2048; the four cases of tests/test_kernels.py (non-causal, H/KV = 2 and
    D = 8 among them); a prime length; B = 2; D = 128 causal and not; Sq
    not a multiple of the fp32 kernel's kv tile at D = 8, 64 and 128; D =
    10 (element copies in fp32). Phase 3 runs each on fp32 and on bf16
    operands."""
    def qkv(b, s, h, kv, d):
        return tuple(torch.randn(shape, generator=gen).to(dev)
                     for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    cases = [(f"smollm (1, {s}, 9/3, 64) causal", *qkv(1, s, 9, 3, 64), True)
             for s in LONG_LENS + (2048,)]
    cases += [(f"test_kernels ({b}, {s}, {h}/{kv}, {d}) "
               f"{'causal' if c else 'non-causal'}", *qkv(b, s, h, kv, d), c)
              for b, s, h, kv, d, c in ((2, 64, 4, 2, 16, True),
                                        (1, 128, 8, 8, 32, True),
                                        (2, 96, 4, 4, 16, False),
                                        (1, 64, 6, 3, 8, True))]
    cases += [("prime length (1, 1031, 9/3, 64) causal", *qkv(1, 1031, 9, 3, 64), True),
              ("B=2 (2, 700, 9/3, 64) causal", *qkv(2, 700, 9, 3, 64), True),
              ("D=128 (1, 300, 4/2, 128) causal", *qkv(1, 300, 4, 2, 128), True),
              ("D=128 (1, 300, 4/2, 128) non-causal", *qkv(1, 300, 4, 2, 128), False),
              ("ragged D=8 (1, 1000, 4/2, 8) causal", *qkv(1, 1000, 4, 2, 8), True),
              ("ragged D=64 (1, 777, 9/3, 64) causal", *qkv(1, 777, 9, 3, 64), True),
              ("ragged D=128 (1, 333, 4/2, 128) non-causal", *qkv(1, 333, 4, 2, 128),
               False),
              ("D=10 (1, 150, 4/2, 10) causal", *qkv(1, 150, 4, 2, 10), True)]
    return cases


def flash_bf16_cases(gen, dev):
    """(label, q, k, v, causal) on bf16 operands only: D = 40 (padded to
    64), D = 20 (element loads: D % 8 != 0) and q, k, v as views one element
    past a 16-byte boundary (element loads at D = 64)."""
    def t(*shape, skip=0):
        flat = torch.randn(math.prod(shape) + skip, generator=gen)
        return flat.to(dev).to(torch.bfloat16)[skip:].view(shape)

    return [("D=40 (2, 77, 4/1, 40) non-causal",
             t(2, 77, 4, 40), t(2, 77, 1, 40), t(2, 77, 1, 40), False),
            ("D=20 (1, 333, 6/2, 20) causal",
             t(1, 333, 6, 20), t(1, 333, 2, 20), t(1, 333, 2, 20), True),
            ("unaligned views (1, 200, 9/3, 64) causal",
             t(1, 200, 9, 64, skip=1), t(1, 200, 3, 64, skip=1),
             t(1, 200, 3, 64, skip=1), True)]


def flash_bound(b, sq, skv, h, kv, d, causal, elem=4, peak=PEAK_FP32_FLOP_S):
    """(bound ms, bound_by) of one attention forward: q, k, v read once and
    out written once; 4 flops (two multiply-adds) per visible (query, key)
    pair and column (the causal pairs alone), at the peak of the operands'
    type."""
    n_bytes = elem * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    return bound_ms(n_bytes, 4 * b * h * d * pairs, peak)


def long_phase(dev, E, gfid_matmul, paged, flash, other_kernels, worst):
    """Phase 8: smollm-135m served through `ContinuousScheduler` on prompts
    of 1025-1984 tokens, whose prefills run the flash kernel (see the module
    docstring). Returns the numbers the kernels line and the summary
    print."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             latency_percentiles)

    t_phase = time.perf_counter()
    mm, gather, fa = gfid_matmul.gfid_matmul, paged.paged_gather, flash.flash_attention
    kernels = (mm, gather, fa) + tuple(other_kernels)
    cfg = get_config(SERVE_MODEL)
    params = T.init_params(cfg, seed=0, device=DEVICE, dtype=torch.float32)
    per_pass = cfg.n_layers * 7 + 1     # GEMMs of a decode step or a prefill
    n_attn = cfg.n_layers               # flash launches of a long prefill
    gen = torch.Generator().manual_seed(8)
    lens = [n for n in LONG_LENS for _ in range(LONG_REPEAT)]
    lens = [lens[i] for i in torch.randperm(len(lens), generator=gen).tolist()]
    work = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
             LONG_STEPS[int(torch.randint(len(LONG_STEPS), (1,), generator=gen))])
            for n in lens]
    print(f"[long] workload: {len(work)} requests, prompts {lens} tokens, steps "
          f"{[n for _, n in work]} ({sum(n for _, n in work)} tokens to "
          f"generate); pool {LONG_BLOCKS} blocks of {SERVE_BLOCK} slots, max_len "
          f"{LONG_MAX_LEN}, max_batch {SERVE_BATCH}")
    conf = E.EngineConfig(backend="cuda", row_align=8)

    def scheduler(max_batch, admission):
        return ContinuousScheduler(
            cfg, params, max_len=LONG_MAX_LEN, num_blocks=LONG_BLOCKS,
            block_size=SERVE_BLOCK, max_batch=max_batch, config=conf,
            admission=admission)

    runs = {}
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        t0 = time.perf_counter()
        prefills = [s.prefill_compiled(n) for n in sorted(set(lens))]
        decodes = [s.decode_compiled(b) for b in s.buckets]
        compile_s = time.perf_counter() - t0
        for c, want_ops in [(c, per_pass) for c in prefills] \
                + [(c, 2 + per_pass) for c in decodes]:
            kinds = [op.kind for op in c.program.ops]
            require(set(c.backends()) == {"cuda"} and len(kinds) == want_ops
                    and len(c.exec_pairs) == want_ops
                    and kinds.count("gather") == want_ops - per_pass,
                    f"long {mode} {c.program.name}: backends "
                    f"{set(c.backends())}, {len(kinds)} ops, expected {want_ops}")
        tickets = [s.submit(p, n) for p, n in work]
        zero_counts(*kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = s.stats()
        launches = counts(*kernels)
        require(all(t.status == "done" and t.preemptions == 0 for t in tickets)
                and st["evicted"] == 0, f"long {mode}: not every request done "
                "without preemption")
        require(st["compiled_decode_buckets"] == [SERVE_BATCH], f"long {mode}: "
                f"decode buckets {st['compiled_decode_buckets']}, expected "
                f"[{SERVE_BATCH}]")
        want = (per_pass * (st["steps"] + st["admitted"]), 2 * st["steps"],
                n_attn * st["admitted"]) + (0,) * len(other_kernels)
        require(launches == want, f"long {mode}: launches (gfid_matmul, "
                f"paged_gather, flash_attention, others) = {launches}, expected "
                f"{want} for {st['steps']} decode steps and {st['admitted']} "
                "prefills")
        n_tok = sum(len(t.tokens) for t in tickets)
        lat = latency_percentiles(tickets)
        runs[mode] = dict(tokens=[t.tokens for t in tickets], wall=wall,
                          n_tok=n_tok, lat=lat, launches=launches)
        print(f"[long] {mode}: {st['steps']} decode steps (buckets "
              f"{st['compiled_decode_buckets']}, fill {st['decode_fill']:.3f}), "
              f"{st['admitted']} prefills, {n_tok} tokens in {wall:.3f} s = "
              f"{n_tok / wall:.1f} tokens/s; latency p50 {lat['p50_ms']:.1f} ms, "
              f"p95 {lat['p95_ms']:.1f} ms; launches gfid_matmul {launches[0]}, "
              f"paged_gather {launches[1]}, flash_attention {launches[2]} (= "
              f"{per_pass} GEMMs a step and a prefill, 2 gathers a step, "
              f"{n_attn} flash a prefill), others {sum(launches[3:])}; "
              f"{len(prefills) + len(decodes)} programs captured and compiled in "
              f"{compile_s:.2f} s beforehand")
        del s
    base = runs["continuous"]["tokens"]
    for mode in ("drain", "solo"):
        require(runs[mode]["tokens"] == base, f"long {mode} tokens differ from "
                "the continuous run")
    checked = [lens.index(min(LONG_LENS)), lens.index(max(LONG_LENS))]
    with E.using_config(conf):
        for i in checked:
            prompt, steps = work[i]
            dense = SE.greedy_generate(cfg, params, {"tokens": torch.tensor(
                [prompt], device=dev)}, steps, LONG_MAX_LEN)
            require(dense[0].tolist() == base[i], f"long request {i} (prompt "
                    f"{len(prompt)}): served tokens differ from greedy_generate's")
    print(f"[long] tokens bitwise equal across continuous, drain and solo, and "
          f"equal to greedy_generate at one row for requests {checked} (prompts "
          f"{[lens[i] for i in checked]})")

    # 8 rows at depth >= LONG_PREFILL: a decode step's launches, times and
    # "torch" replay; then the prefill at LONG_PREFILL
    long_prompts = [p for p, _ in work if len(p) == LONG_PREFILL]
    s8 = scheduler(SERVE_BATCH, "continuous")
    rows = [s8.submit(long_prompts[i % len(long_prompts)],
                      LONG_MAX_LEN - LONG_PREFILL) for i in range(SERVE_BATCH)]
    s8.step()                              # admits 8, runs one decode step
    require(all(t.status == "running" for t in rows) and
            s8.running() == SERVE_BATCH, f"long: {s8.running()} rows running")
    dec = s8.decode_compiled(SERVE_BATCH)
    step_ms, profiles, logits = {}, {}, {}
    for live in (SERVE_BATCH, 1):
        pad = SERVE_BATCH - live
        rids = [t.rid for t in rows[:live]]
        args = (params, s8.pool.arrays, s8.pool.table_rows(rids, SERVE_BATCH),
                s8.pool.slot_rows(rids, SERVE_BATCH),
                torch.tensor([[t.tokens[-1]] for t in rows[:live]] + [[0]] * pad,
                             dtype=torch.int32, device=dev),
                torch.tensor([t.pos for t in rows[:live]] + [0] * pad,
                             dtype=torch.int32, device=dev))
        zero_counts(*kernels)
        dec.apply(*args)
        torch.cuda.synchronize()
        one = counts(*kernels)
        require(one == (per_pass, 2, 0) + (0,) * len(other_kernels),
                f"long: {live} live rows: one decode step launched {one}")
        step_ms[live] = time_ms(lambda: dec.apply(*args), iters=10)
        if live == SERVE_BATCH:
            profiles[live] = device_profile(lambda: dec.apply(*args))
            snap = [a.clone() for a in _leaves(s8.pool.arrays)]
            for backend in ("cuda", "torch"):
                with E.using_config(conf.replace(backend=backend)), \
                        torch.no_grad():
                    state = s8.layout.gather(s8.pool.arrays, args[2], args[3])
                    logits[backend], _ = T.decode_step(cfg, params, state,
                                                       args[4], args[5])
                for a, b in zip(_leaves(s8.pool.arrays), snap):
                    a.copy_(b)
            # one row alone against row 0 of the bucket (greedy_generate
            # decodes at one row): printed, not required bitwise
            with E.using_config(conf), torch.no_grad():
                st1 = s8.layout.gather(s8.pool.arrays,
                                       s8.pool.table_rows(rids[:1], 1),
                                       s8.pool.slot_rows(rids[:1], 1))
                l1, _ = T.decode_step(cfg, params, st1, args[4][:1], args[5][:1])
            for a, b in zip(_leaves(s8.pool.arrays), snap):
                a.copy_(b)
            row_d = (l1 - logits["cuda"][:1]).abs().max().item()
            del snap, state, st1
            depth = min(t.pos for t in rows)
    err = rel_err(logits["cuda"], logits["torch"])
    require(bool(torch.isfinite(logits["cuda"]).all()) and err <= TOL,
            f"long decode step: cuda logits vs torch backend {err:.3e} > {TOL}")
    print(f"[long] one decode step at bucket {SERVE_BATCH}, rows at depth >= "
          f"{depth}: {per_pass} gfid_matmul + 2 paged_gather launches and no "
          f"flash_attention, with {SERVE_BATCH} and with 1 live rows; logits "
          f"max|d|/max|ref| vs the torch backend on the same pool = {err:.3e} "
          f"(limit {TOL}); one row decoded alone vs row 0 of the bucket: max|d| "
          f"{row_d:.3e} (bitwise {row_d == 0}); {SERVE_BATCH} live rows "
          f"{step_ms[SERVE_BATCH]:.4f} ms, 1 live row {step_ms[1]:.4f} ms (median "
          "of 10, CUDA events)")

    t0 = time.perf_counter()
    pre = E.compile(SE.prefill_ingest_program(cfg, s8.layout, LONG_PREFILL,
                                              torch.float32),
                    conf)
    capture_s = time.perf_counter() - t0
    row = s8.pool.table_rows([rows[0].rid], 1)[0]
    slot = s8.pool.slot_rows([rows[0].rid], 1)[0]
    prompt = torch.tensor([long_prompts[0]], dtype=torch.int32, device=dev)
    snap = [a.clone() for a in _leaves(s8.pool.arrays)]
    zero_counts(*kernels)
    pre.apply(params, s8.pool.arrays, row, slot, prompt)
    torch.cuda.synchronize()
    pre_launches = counts(*kernels)
    require(pre_launches == (per_pass, 0, n_attn) + (0,) * len(other_kernels),
            f"long: prefill({LONG_PREFILL}) launched {pre_launches}")
    pre_logits = {}
    for backend in ("cuda", "torch"):
        with E.using_config(conf.replace(backend=backend)), torch.no_grad():
            pre_logits[backend], _ = T.prefill(cfg, params, {"tokens": prompt},
                                               LONG_MAX_LEN)
    pre_err = rel_err(pre_logits["cuda"], pre_logits["torch"])
    require(bool(torch.isfinite(pre_logits["cuda"]).all()) and pre_err <= TOL,
            f"long prefill: cuda logits vs torch backend {pre_err:.3e} > {TOL}")
    prefill_ms = time_ms(lambda: pre.apply(params, s8.pool.arrays, row, slot,
                                           prompt), iters=5, warmup=1)
    pre_prof = device_profile(lambda: pre.apply(params, s8.pool.arrays, row,
                                                slot, prompt), steps=1)
    for a, b in zip(_leaves(s8.pool.arrays), snap):
        a.copy_(b)
    del snap, s8, rows
    print(f"[long] batch-1 prefill at prompt {LONG_PREFILL}: {per_pass} gfid_matmul "
          f"+ {n_attn} flash_attention launches; logits max|d|/max|ref| vs the "
          f"torch backend (chunked attention in torch ops) {pre_err:.3e} (limit "
          f"{TOL}); {prefill_ms:.4f} ms (median of 5); capture and compile of "
          f"its program: {capture_s:.3f} s")
    by_name = {}
    for what, prof, ms in (("prefill", pre_prof, prefill_ms),
                           ("decode step (8 live rows)", profiles[SERVE_BATCH],
                            step_ms[SERVE_BATCH])):
        if prof is None:
            print(f"[profile] long {what}: the profiler recorded no device time; "
                  "device busy share not measured")
            continue
        busy_ms, n_kernels, rows_p = prof
        split = {key: sum(r[2] for r in rows_p if key in r[0])
                 for key in ("flash_attention_kernel", "gfid_matmul_kernel",
                             "split_reduce_kernel")}
        by_name[what] = split
        print(f"[profile] long {what}: {n_kernels} device kernels, {busy_ms:.4f} "
              f"ms of device time = {100 * busy_ms / ms:.1f}% of its {ms:.4f} ms; "
              f"flash_attention {split['flash_attention_kernel']:.4f} ms, "
              f"gfid_matmul {split['gfid_matmul_kernel']:.4f} ms (+ its split "
              f"reductions {split['split_reduce_kernel']:.4f} ms), rest "
              f"{busy_ms - sum(split.values()):.4f} ms; by kernel: "
              + "; ".join(f"{n[:60]} x{c} {t:.4f} ms" for n, c, t in rows_p[:6]))
    print(f"[long] phase 8 took {time.perf_counter() - t_phase:.1f} s")
    cont = runs["continuous"]
    return dict(tps=cont["n_tok"] / cont["wall"], lat=cont["lat"],
                step_ms=step_ms, prefill_ms=prefill_ms, capture_s=capture_s,
                run_launches=cont["launches"], n_attn=n_attn, by_name=by_name)


def bf16_logits_witness(E, T, cfg, conf, params, prompt):
    """What the "cuda" and "torch" bf16 logits' gap is made of, at each of
    LONG_LENS (prefixes of `prompt`): the gap itself (held to
    BF16_LOGITS_TOL); the same prefill from the same weights widened to fp32
    (held to TOL: the two backends compute one function); and each bf16
    backend's distance from those fp32 logits (their ratio held within
    BF16_FP32_RATIO either way: neither path rounds more than the other).
    Returns the gap at the longest prompt."""
    from repro_torch.models.layers import tree_map
    params32 = tree_map(lambda a: a.float(), params)
    gap = None
    for n in LONG_LENS:
        logits = {}
        for name, tree in (("bf16", params), ("fp32", params32)):
            for backend in ("cuda", "torch"):
                with E.using_config(conf.replace(backend=backend)), \
                        torch.no_grad():
                    out, _ = T.prefill(cfg, tree, {"tokens": prompt[:, :n]},
                                       LONG_MAX_LEN)
                logits[(name, backend)] = out.float()
        require(all(bool(torch.isfinite(v).all()) for v in logits.values()),
                f"bf16 witness at prompt {n}: logits not finite")
        ref32 = logits[("fp32", "torch")]
        gap = rel_err(logits[("bf16", "cuda")], logits[("bf16", "torch")])
        gap32 = rel_err(logits[("fp32", "cuda")], ref32)
        dist = {b: rel_err(logits[("bf16", b)], ref32) for b in ("cuda", "torch")}
        print(f"[serve bf16] logits at prompt {n}: cuda vs torch backend "
              f"{gap:.3e} in bf16 (limit {BF16_LOGITS_TOL}), {gap32:.3e} from "
              f"the same weights in fp32 (limit {TOL}); distance from those "
              f"fp32 logits: cuda {dist['cuda']:.3e}, torch {dist['torch']:.3e} "
              f"(ratio {dist['cuda'] / dist['torch']:.3f}, limits "
              f"{1 / BF16_FP32_RATIO:.3f} and {BF16_FP32_RATIO})")
        require(gap <= BF16_LOGITS_TOL, f"long bf16 prefill({n}): cuda logits "
                f"vs torch backend {gap:.3e} > {BF16_LOGITS_TOL}")
        require(gap32 <= TOL, f"long prefill({n}) from the bf16 weights in "
                f"fp32: cuda vs torch {gap32:.3e} > {TOL}")
        require(1 / BF16_FP32_RATIO <= dist["cuda"] / dist["torch"]
                <= BF16_FP32_RATIO, f"long bf16 prefill({n}): cuda is "
                f"{dist['cuda']:.3e} from the fp32 logits, torch "
                f"{dist['torch']:.3e}")
    del params32
    return gap


def long_prefill_bf16(dev, E, gfid_matmul, paged, flash, other_kernels, params):
    """Phase 9's long prompt: one batch-1 prefill at LONG_PREFILL tokens of
    smollm-135m with bf16 parameters on phase 8's pool geometry: 211
    `gfid_matmul_bf16` and 30 `flash_attention_bf16` launches (bf16 q, k, v)
    and nothing else (no fp32 `flash_attention`), "torch" logits within
    BF16_LOGITS_TOL, its time and a `torch.profiler` split of its device
    time between the two kernels, each found by name with non-zero time."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import ContinuousScheduler

    mm, gather, fa = (gfid_matmul.gfid_matmul_bf16, paged.paged_gather,
                      flash.flash_attention_bf16)
    kernels = (mm, gather, fa) + tuple(other_kernels)
    cfg = get_config(SERVE_MODEL)
    per_pass, n_attn = cfg.n_layers * 7 + 1, cfg.n_layers
    conf = E.EngineConfig(backend="cuda", row_align=8)
    s = ContinuousScheduler(cfg, params, max_len=LONG_MAX_LEN,
                            num_blocks=LONG_BLOCKS, block_size=SERVE_BLOCK,
                            max_batch=SERVE_BATCH, config=conf)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (1, LONG_PREFILL), generator=gen,
                           dtype=torch.int32)
    t = s.submit(prompt[0].tolist(), LONG_MAX_LEN - LONG_PREFILL)
    s.step()                               # admits it: blocks, a slot, a prefill
    require(t.status == "running", f"long bf16: request {t.status}")
    pre = s.prefill_compiled(LONG_PREFILL)
    row = s.pool.table_rows([t.rid], 1)[0]
    slot = s.pool.slot_rows([t.rid], 1)[0]
    prompt = prompt.to(dev)
    snap = [a.clone() for a in _leaves(s.pool.arrays)]
    zero_counts(*kernels)
    pre.apply(params, s.pool.arrays, row, slot, prompt)
    torch.cuda.synchronize()
    launches = counts(*kernels)
    require(launches == (per_pass, 0, n_attn) + (0,) * len(other_kernels),
            f"long bf16: prefill({LONG_PREFILL}) launched {launches}")
    err = bf16_logits_witness(E, T, cfg, conf, params, prompt)
    prefill_ms = time_ms(lambda: pre.apply(params, s.pool.arrays, row, slot,
                                           prompt), iters=5, warmup=1)
    prof = device_profile(lambda: pre.apply(params, s.pool.arrays, row, slot,
                                            prompt), steps=1)
    for a, b in zip(_leaves(s.pool.arrays), snap):
        a.copy_(b)
    del snap, s
    print(f"[serve bf16] batch-1 prefill at prompt {LONG_PREFILL} on a pool of "
          f"{LONG_BLOCKS} x {SERVE_BLOCK} (max_len {LONG_MAX_LEN}): {per_pass} "
          f"gfid_matmul_bf16 + {n_attn} flash_attention_bf16 launches and no fp32 "
          f"flash_attention; "
          f"logits max|d|/max|ref| vs the torch backend {err:.3e} (limit "
          f"{BF16_LOGITS_TOL}); {prefill_ms:.4f} ms (median of 5)")
    require(prof is not None, "long bf16 prefill: the profiler recorded no "
            "device time")
    busy_ms, n_kernels, rows_p = prof
    split = {key: sum(r[2] for r in rows_p if key in r[0])
             for key in ("flash_attention_bf16_kernel", "gfid_matmul_bf16_kernel")}
    require(all(ms > 0 for ms in split.values()), f"long bf16 prefill: the "
            f"profiler found {split} ms of the two kernels")
    print(f"[profile] long bf16 prefill: {n_kernels} device kernels, "
          f"{busy_ms:.4f} ms of device time = "
          f"{100 * busy_ms / prefill_ms:.1f}% of its {prefill_ms:.4f} ms; "
          f"flash_attention_bf16 {split['flash_attention_bf16_kernel']:.4f} ms, "
          f"gfid_matmul_bf16 {split['gfid_matmul_bf16_kernel']:.4f} ms, rest "
          f"{busy_ms - sum(split.values()):.4f} ms; by kernel: "
          + "; ".join(f"{n[:60]} x{c} {t_:.4f} ms" for n, c, t_ in rows_p[:6]))
    return dict(prefill_ms=prefill_ms, launches=launches, err=err, split=split)


def scheduler_phase(dev, E, cnn, kernels, other_kernels):
    """Phase 10: the static `Scheduler` (see the module docstring). `kernels`
    maps "fp32", "int8" and "bf16" to the (conv, matmul) launch counters of
    that precision's AlexNet kernels; `other_kernels` (the gather, both
    flash kernels, the depthwise conv) must launch nothing. Returns the
    launches of each counter over the phase's served dispatches and the
    numbers of its summary."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import Scheduler, latency_percentiles

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_MODEL)
    per_pass = cfg.n_layers * 7 + 1    # GEMMs of a decode step or a prefill
    fp32_mm = kernels["fp32"][1]
    counters = tuple(dict.fromkeys(
        [k for pair in kernels.values() for k in pair] + [fp32_mm]
        + list(other_kernels)))
    conf32 = E.EngineConfig(backend="cuda", row_align=8)
    configs = {"fp32": conf32, "int8": conf32.replace(precision="int8"),
               "bf16": conf32}
    gen = torch.Generator().manual_seed(10)
    cnn_params = {"fp32": cnn.init_cnn("alexnet", seed=0, device=DEVICE)}
    cnn_params["int8"] = cnn_params["fp32"]
    cnn_params["bf16"] = cnn.init_cnn("alexnet", seed=0, device=DEVICE,
                                      dtype=torch.bfloat16)
    programs = {"fp32": cnn.program("alexnet"), "int8": cnn.program("alexnet"),
                "bf16": cnn.program("alexnet", dtype=torch.bfloat16)}
    lm = T.init_params(cfg, seed=0, device=DEVICE, dtype=torch.float32)
    dec_prog = SE.decode_program(cfg, batch=1, max_len=SCHED_MAX_LEN,
                                 param_dtype=torch.float32)
    score_prog = SE.prefill_program(cfg, batch=1, seq=SCHED_SCORE_LEN,
                                    logits_only=True, param_dtype=torch.float32)
    pos = torch.tensor(SCHED_DECODE_POS, dtype=torch.int32, device=dev)
    print(f"[sched] programs: alexnet (fp32, int8, bf16), {cfg.name} "
          f"decode at max_len {SCHED_MAX_LEN} (position {SCHED_DECODE_POS}) and "
          f"scoring prefill of {SCHED_SCORE_LEN} tokens, both fp32; buckets "
          f"{SCHED_BUCKETS}; waves of (alexnet, decode, score) requests "
          f"{SCHED_WAVES}")

    # the requests, seeded: images, decode rows (a dense state from a prefill
    # of a seeded prompt, and the next token) and scoring prompts
    n_req = {m: sum(w[i] for w in SCHED_WAVES)
             for i, m in enumerate(("alexnet", "decode", "score"))}
    images = [torch.randn((1, *cnn.ALEXNET_INPUT), generator=gen).to(dev)
              for _ in range(n_req["alexnet"])]
    rows = []
    with E.using_config(conf32), torch.no_grad():
        for _ in range(n_req["decode"]):
            prompt = torch.randint(0, cfg.vocab_size, (1, SCHED_DECODE_POS),
                                   generator=gen).to(dev)
            logits, state = T.prefill(cfg, lm, {"tokens": prompt},
                                      SCHED_MAX_LEN)
            rows.append((state, torch.argmax(logits, -1, keepdim=True).to(
                torch.int32)))
    prompts = [torch.randint(0, cfg.vocab_size, (1, SCHED_SCORE_LEN),
                             generator=gen, dtype=torch.int32).to(dev)
               for _ in range(n_req["score"])]

    # each request alone through its program's batch-1 CompiledNet
    solo = {}
    for prec, prog in programs.items():
        one = E.compile(prog, configs[prec])
        require(set(one.backends()) == {"cuda"}
                and set(one.precisions()) == {"int8" if prec == "int8" else "fp32"},
                f"sched alexnet {prec}: backends {set(one.backends())}, "
                f"precisions {set(one.precisions())}")
        solo[prec] = [one.apply(cnn_params[prec], x.to(
            torch.bfloat16 if prec == "bf16" else torch.float32)) for x in images]
    dec1, score1 = E.compile(dec_prog, conf32), E.compile(score_prog, conf32)
    # a decode step writes its key and value into the state it is given
    solo["decode"] = [dec1.apply(lm, tree_map(torch.clone, st), tok, pos)
                      for st, tok in rows]
    solo["score"] = [score1.apply(lm, {"tokens": p}) for p in prompts]
    torch.cuda.synchronize()

    def requests(prec, k):
        """Wave k's requests, the programs interleaved in arrival order."""
        n_a, n_d, n_s = SCHED_WAVES[k]
        lists = [[("alexnet", (images[i].to(torch.bfloat16 if prec == "bf16"
                                            else torch.float32),), i)
                  for i in range(sum(w[0] for w in SCHED_WAVES[:k]),
                                 sum(w[0] for w in SCHED_WAVES[:k]) + n_a)]]
        if prec == "fp32":
            d0 = sum(w[1] for w in SCHED_WAVES[:k])
            s0 = sum(w[2] for w in SCHED_WAVES[:k])
            lists.append([("decode", (rows[i][0], rows[i][1]), i)
                          for i in range(d0, d0 + n_d)])
            lists.append([("score", ({"tokens": prompts[i]},), i)
                          for i in range(s0, s0 + n_s)])
        out = []
        for j in range(max(len(x) for x in lists)):
            out += [x[j] for x in lists if j < len(x)]
        return out

    want_launch = {}
    for prec, (conv_k, mm_k) in kernels.items():
        want_launch[("alexnet", prec)] = tuple(
            5 if c is conv_k else 3 if c is mm_k else 0 for c in counters)
    want_launch[("lm", "fp32")] = tuple(per_pass if c is fp32_mm else 0
                                        for c in counters)
    totals = [0] * len(counters)
    summary = {}
    gaps = {}
    for prec in ("fp32", "int8", "bf16"):
        for policy in ("spf", "fifo"):
            sched = Scheduler(config=configs[prec], policy=policy, max_batch=8)
            require(sched.buckets == SCHED_BUCKETS, f"buckets {sched.buckets}")
            units = {"alexnet": sched.register(
                "alexnet", programs[prec],
                shared_args=(cnn_params[prec],)).unit_plan}
            if prec == "fp32":
                units["decode"] = sched.register(
                    "decode", dec_prog, shared_args=(lm, pos)).unit_plan
                units["score"] = sched.register(
                    "score", score_prog, shared_args=(lm,)).unit_plan
            t0 = time.perf_counter()
            sched.warmup()
            warm_s = time.perf_counter() - t0
            for name in units:
                for b in SCHED_BUCKETS:
                    c = sched.compiled(name, b)
                    require(set(c.backends()) == {"cuda"},
                            f"sched {prec} {name} bucket {b}: backends "
                            f"{set(c.backends())}")
            served, walls, order = [], {m: 0.0 for m in units}, []
            for k in range(len(SCHED_WAVES)):
                tickets = [(m, i, sched.submit(m, *args))
                           for m, args, i in requests(prec, k)]
                served += tickets
                while sched.pending():
                    zero_counts(*counters)
                    t0 = time.perf_counter()
                    batch = sched.step()
                    walls[batch[0].model] += time.perf_counter() - t0
                    got = counts(*counters)
                    model = batch[0].model
                    want = want_launch[("alexnet", prec) if model == "alexnet"
                                       else ("lm", "fp32")]
                    require(got == want, f"sched {prec} {policy} {model} bucket "
                            f"{batch[0].batch_bucket}: launches {got}, expected "
                            f"{want}")
                    totals = [a + b for a, b in zip(totals, got)]
                    order.append((k, model))
                # spf: within a wave, the programs in order of their batch-1
                # plan latency; fifo: in order of first arrival
                wave_models = [m for kk, m in order if kk == k]
                if policy == "spf":
                    lat = [units[m].total_latency_s for m in wave_models]
                    require(lat == sorted(lat), f"sched {prec} spf wave {k}: "
                            f"served {wave_models} by plan latency {lat}")
                else:
                    first = list(dict.fromkeys(m for m, _, _ in requests(prec, k)))
                    require(list(dict.fromkeys(wave_models)) == first,
                            f"sched {prec} fifo wave {k}: served {wave_models}")
            st = sched.stats()
            buckets_run = {m: sorted({t.batch_bucket for mm, _, t in served
                                      if mm == m}) for m in units}
            require(all(b == list(SCHED_BUCKETS) for b in buckets_run.values())
                    and all(st["models"][m]["padded_slots"] > 0 for m in units),
                    f"sched {prec} {policy}: buckets served {buckets_run}, "
                    f"padded {[st['models'][m]['padded_slots'] for m in units]}")
            for m, i, t in served:
                unit = units[m]
                require(t.done and len(t.ledger) == len(unit.plans)
                        and [r.plan for r in t.ledger] == list(unit.plans),
                        f"sched {prec} {m} request {i}: ledger is not the "
                        "batch-1 plan")
                want = solo[prec][i] if m == "alexnet" else solo[m][i]
                if m == "alexnet":
                    require(torch.equal(t.result, want), f"sched {prec} {policy} "
                            f"alexnet request {i} (bucket {t.batch_bucket}, row "
                            f"{t.batch_index}): result differs from the request "
                            "alone")
                else:
                    gap = (t.result.float() - want.float()).abs().max().item() \
                        / want.float().abs().max().item()
                    same = torch.equal(t.result.argmax(-1), want.argmax(-1))
                    gaps.setdefault(m, []).append((gap, t.batch_bucket))
                    require(gap <= SCHED_LM_TOL and same, f"sched {policy} {m} "
                            f"request {i} (bucket {t.batch_bucket}): logits "
                            f"{gap:.3e} of max from the request alone (limit "
                            f"{SCHED_LM_TOL}), argmax equal {same}")
            for m in units:
                ts = [t for mm, _, t in served if mm == m]
                lat = latency_percentiles(ts)
                rps = len(ts) / walls[m]
                summary[(prec, policy, m)] = dict(
                    rps=rps, p50=lat["p50_ms"], p95=lat["p95_ms"],
                    occupancy=st["models"][m]["occupancy"])
                print(f"[sched] {prec} {policy} {m}: {len(ts)} requests in "
                      f"{st['models'][m]['batches']} batches (buckets "
                      f"{buckets_run[m]}, occupancy "
                      f"{st['models'][m]['occupancy']:.3f}), {rps:.1f} requests/s "
                      f"of dispatch time, latency p50 {lat['p50_ms']:.2f} ms, p95 "
                      f"{lat['p95_ms']:.2f} ms; batch-1 plan "
                      f"{units[m].total_latency_s * 1e3:.4f} ms (MMIE)")
            print(f"[sched] {prec} {policy}: {st['served']} served in "
                  f"{st['batches']} batches, {st['throughput_rps']:.1f} requests/s "
                  f"of dispatch time; order {[m for _, m in order]}; warm-up "
                  f"(every bucket compiled and run once) {warm_s:.2f} s")
            if policy == "spf":
                # bucket 8 through the scheduler against the compiled
                # batch-8 apply on the same images (the cost of packing)
                xs = [x.to(torch.bfloat16 if prec == "bf16" else torch.float32)
                      for x in images[:8]]
                c8 = sched.compiled("alexnet", 8)
                x8 = torch.cat(xs)

                def direct():
                    c8.apply(cnn_params[prec], x8)
                    torch.cuda.synchronize()

                def through():
                    for x in xs:
                        sched.submit("alexnet", x)
                    sched.step()

                sched_ms = host_us(through, calls=10) / 1e3
                direct_ms = host_us(direct, calls=10) / 1e3
                summary[(prec, "bucket8")] = dict(sched_ms=sched_ms,
                                                  direct_ms=direct_ms)
                print(f"[sched] {prec} alexnet bucket 8: {sched_ms:.4f} ms a "
                      f"batch through the scheduler ({8e3 / sched_ms:.1f} "
                      f"images/s) against {direct_ms:.4f} ms for "
                      f"compile(program.with_batch(8)).apply on the same "
                      f"images ({8e3 / direct_ms:.1f} images/s); packing and "
                      f"unpacking {sched_ms - direct_ms:.4f} ms (host clock, "
                      "least of 5 runs of 10 synchronized batches)")
            del sched
    for m, gs in gaps.items():
        worst_gap = max(gs)
        exact = all(g == 0.0 for g, _ in gs)
        summary[("gap", m)] = worst_gap[0]
        print(f"[sched] {cfg.name} {m}: " + (
            "every request bitwise equal to the request alone" if exact else
            f"largest gap {worst_gap[0]:.3e} of max|logits| (bucket "
            f"{worst_gap[1]}) from the request alone, argmax equal (limit "
            f"{SCHED_LM_TOL}); bitwise in {sum(g == 0.0 for g, _ in gs)} of "
            f"{len(gs)}"))
    launched = dict(zip((getattr(k, "__name__", None) or k.kernel
                         for k in counters), totals))
    for prec, (conv_k, mm_k) in kernels.items():
        require(totals[counters.index(conv_k)] > 0
                and totals[counters.index(mm_k)] > 0,
                f"sched: the {prec} kernels were not launched")
    print(f"[sched] launches over the phase's served dispatches: {launched}")
    print(f"[sched] phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return dict(launches=launched, summary=summary)


def flash_timing(dev, flash, worst):
    """Phase 5's flash rows: the kernels at smollm's longest served prefill
    shape (1, LONG_PREFILL, 9/3, 64) causal, on fp32 q/k/v (entry
    `flash_attention`) and on bf16 q/k/v (entry `flash_attention_bf16`),
    beside the bound at the peak of that type, the plain version and
    `F.scaled_dot_product_attention` (TF32 off, GQA in the call; timed only
    here), per launch with CUDA events around each call and for the device
    alone (a CUDA graph of 100 calls), and for one prefill's launches.
    Returns {dtype name: the numbers}."""
    from repro_torch.configs.base import get_config
    cfg = get_config(SERVE_MODEL)
    h, kv, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, LONG_PREFILL
    out = {}
    t0 = time.perf_counter()
    for dtype, tol, peak in ((torch.float32, TOL, PEAK_FP32_FLOP_S),
                             (torch.bfloat16, BF16_FLASH_TOL, PEAK_BF16_FLOP_S)):
        name = str(dtype)[6:]
        kname = "flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention"
        gen = torch.Generator().manual_seed(5)
        q, k, v = (torch.randn(shape, generator=gen).to(dev).to(dtype)
                   for shape in ((1, s, h, d), (1, s, kv, d), (1, s, kv, d)))
        got, want = flash.flash_attention(q, k, v), flash.flash_attention_plain(q, k, v)
        err = rel_err(got, want)
        require(err <= tol, f"{kname} at the timed shape: {err:.3e} > {tol}")
        worst[kname] = max(worst[kname], (got.float() - want.float()).abs().max().item())
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # (B, H, S, D) views

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

        lib_err = rel_err(sdpa().transpose(1, 2), want)
        if dtype == torch.float32:      # in bf16 the reading is only printed
            require(lib_err <= TOL, f"sdpa differs from the plain flash: {lib_err:.3e}")
        b_ms, by = flash_bound(1, s, s, h, kv, d, True, q.element_size(), peak)
        row_t = dict(ms=time_ms(lambda: flash.flash_attention(q, k, v)),
                     device_ms=graph_ms(lambda: flash.flash_attention(q, k, v)),
                     plain_ms=time_ms(lambda: flash.flash_attention_plain(q, k, v),
                                      iters=5),
                     library_ms=time_ms(sdpa), library_device_ms=graph_ms(sdpa),
                     bound_ms=b_ms, bound_by=by)
        # the same heads at B = 4 (four times the blocks, for the device
        # alone): how far the rate at B = 1 is held back by too few warps
        # an SM rather than by the work of each
        q4, k4, v4 = (t.expand(4, -1, -1, -1).contiguous() for t in (q, k, v))
        qt4, kt4, vt4 = (t.transpose(1, 2) for t in (q4, k4, v4))
        ops = 4 * h * d * sum(i + 1 for i in range(s))     # causal pairs, B = 1
        b4 = dict(device_ms=graph_ms(lambda: flash.flash_attention(q4, k4, v4)),
                  library_device_ms=graph_ms(
                      lambda: F.scaled_dot_product_attention(
                          qt4, kt4, vt4, is_causal=True, enable_gqa=True)))
        print(f"[time] {kname} (B, {s}, {h}/{kv}, {d}) causal {name}, the device "
              f"alone: B = 1 kernel {row_t['device_ms']:.4f} ms, library "
              f"{row_t['library_device_ms']:.4f} ms; B = 4 kernel "
              f"{b4['device_ms']:.4f} ms ({4 * ops / b4['device_ms'] / 1e9:.1f} "
              f"TFLOP/s against {ops / row_t['device_ms'] / 1e9:.1f} at B = 1), "
              f"library {b4['library_device_ms']:.4f} ms "
              f"({4 * ops / b4['library_device_ms'] / 1e9:.1f} against "
              f"{ops / row_t['library_device_ms'] / 1e9:.1f})")
        row_t["b4"] = b4
        del q4, k4, v4, qt4, kt4, vt4
        per = {key: row_t[key] * cfg.n_layers for key in
               ("ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
                "bound_ms")}
        print(f"[time] {kname} (1, {s}, {h}/{kv}, {d}) causal {name}: kernel "
              f"{row_t['ms']:.4f} ms, plain {row_t['plain_ms']:.4f} ms, library "
              f"scaled_dot_product_attention(enable_gqa, TF32 "
              f"{'on' if torch.backends.cuda.matmul.allow_tf32 else 'off'}) "
              f"{row_t['library_ms']:.4f} ms, bound {b_ms:.4f} ms ({by}); the device "
              f"alone: kernel {row_t['device_ms']:.4f} ms, library "
              f"{row_t['library_device_ms']:.4f} ms; max|d|/max|ref| vs plain "
              f"{err:.3e}, sdpa vs plain {lib_err:.3e} (limit {tol:g})")
        print(f"[time] {kname} {name} per prefill({s}) ({cfg.n_layers} launches): "
              f"kernel {per['ms']:.4f} ms, plain {per['plain_ms']:.4f} ms, library "
              f"{per['library_ms']:.4f} ms, bound {per['bound_ms']:.4f} ms; the device "
              f"alone: kernel {per['device_ms']:.4f} ms, library "
              f"{per['library_device_ms']:.4f} ms")
        out[name] = dict(launch=row_t, per_prefill=per, bound_by=by)
    print(f"[time] flash timings took {time.perf_counter() - t0:.1f} s")
    return out


def prefill_gemm_timing(dev, mm, gen, dtype):
    """Phase 5's rows for the GEMM at the prefill shapes: smollm-135m's four
    layer GEMMs at M = 1024 (a prompt-128 prefill) and M = 15,872 (prompt
    1984) in `dtype` in and out as on the path (`gfid_matmul_bf16` on bf16,
    `gfid_matmul_f32` on fp32), with the host and for the device alone (a
    CUDA graph), beside the plain version, `torch.mm` (fp32 sums, TF32 off)
    and the bound at the peak of the type. Returns {M: {key: ms of one
    prefill's 30 layers}}."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import gfid_matmul as G
    bf16 = dtype == torch.bfloat16
    kname = "gfid_matmul_bf16" if bf16 else "gfid_matmul"
    kw = dict(out_dtype=dtype) if bf16 else {}
    peak = PEAK_BF16_FLOP_S if bf16 else PEAK_FP32_FLOP_S
    el = 2 if bf16 else 4
    cfg = get_config(SERVE_MODEL)
    per_layer = {"wq/wo": 2, "wk/wv": 2, "w_in/w_gate": 2, "w_out": 1}
    per_prefill = {}
    for m in (8 * SERVE_PREFILL, 8 * LONG_PREFILL):
        tot = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0,
                   library_device_ms=0.0, bound_ms=0.0)
        calls = 10 if m > 4096 else 50
        for label, k, n in serve_gemm_shapes(cfg)[:-1]:
            x = torch.randn((m, k), generator=gen).to(dev).to(dtype)
            w = torch.randn((k, n), generator=gen).to(dev).to(dtype)
            b_ms, by = bound_ms(el * (m * k + k * n + m * n), 2 * m * k * n, peak)
            row_t = dict(ms=time_ms(lambda: mm(x, w, **kw)),
                         device_ms=graph_ms(lambda: mm(x, w, **kw), calls),
                         plain_ms=time_ms(lambda: G.gfid_matmul_plain(x, w, **kw),
                                          iters=5),
                         library_ms=time_ms(lambda: torch.mm(x, w)),
                         library_device_ms=graph_ms(lambda: torch.mm(x, w), calls),
                         bound_ms=b_ms)
            for key in tot:
                tot[key] += per_layer[label] * cfg.n_layers * row_t[key]
            print(f"[time] {kname} prefill {label} ({m}, {k}) @ ({k}, {n}) -> "
                  f"{str(dtype)[6:]}: kernel {row_t['ms']:.4f} ms "
                  f"({2 * m * k * n / row_t['ms'] / 1e9:.1f} TFLOP/s), the device "
                  f"alone {row_t['device_ms']:.4f} ms, plain {row_t['plain_ms']:.4f} "
                  f"ms, library torch.mm {row_t['library_ms']:.4f} ms, the device "
                  f"alone {row_t['library_device_ms']:.4f} ms, bound {b_ms:.4f} ms "
                  f"({by})")
            del x, w
        per_prefill[m] = tot
        print(f"[time] {kname} per prefill at M = {m} ({cfg.n_layers} x 7 layer "
              f"GEMMs): kernel {tot['ms']:.4f} ms, the device alone "
              f"{tot['device_ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
              f"{tot['library_ms']:.4f} ms, the device alone "
              f"{tot['library_device_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    return per_prefill


def host_us(fn, calls=2000, repeats=5):
    """The host's time for one call of fn in microseconds: the least of
    `repeats` runs of `calls` back-to-back calls on the host clock, each run
    followed by a synchronisation. Where the device keeps up (a short
    kernel), this is the call's host part."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return best


def launch_path_timing(dev, G, paged, C, build):
    """Phase 5: the host part of one `gfid_matmul` call at the smollm decode's
    wq/wo (8, 576) @ (576, 576) fp32, one `paged_gather` of the full-width
    bf16 pool at a table of 8 x 32, one `gfid_matmul_int8` at AlexNet's fc8
    at batch 1 and one `gfid_conv1d_depthwise` (module C) at the xLSTM
    prefill's (1, 384, 1536), piece by piece: each piece of the lean launch
    path beside the piece it replaced, then the whole call with the host
    (host clock, and CUDA events) and for the device alone (a CUDA graph),
    beside `torch.mm`, `index_select` and `F.conv1d` (no library call takes
    the int8 product at one row). Returns the numbers the kernels line
    carries."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((8, 576), generator=gen).to(dev)
    w = torch.randn((576, 576), generator=gen).to(dev)
    index = x.get_device()
    sms = build.sm_count(index)
    plan = G.f32_plan(8, 576, 576, x.data_ptr(), w.data_ptr(), sms)

    def with_device():
        with torch.cuda.device(x.device):
            pass

    def on_device():
        with build.on_device(index):
            pass

    pieces = (
        ("operand checks", lambda: (build.check_operands("gfid_matmul", x=(x, (f32, bf16))),
                                    build.check_operands("gfid_matmul", x=(x, x.dtype),
                                                         w=(w, x.dtype), bias=(None, f32))),
         lambda: build.check_float_operands("gfid_matmul", x, w, None)),
        ("shape checks", None, lambda: G._check_shapes(x, w, None, None)),
        ("plan (was: none; now f32_plan, uncached before)",
         lambda: G._f32_plan.__wrapped__(8, 576, 576, True, True, sms),
         lambda: G.f32_plan(8, 576, 576, x.data_ptr(), w.data_ptr(), sms)),
        ("allocation of the output", lambda: torch.empty((8, 576), device=x.device,
                                                         dtype=f32),
         lambda: x.new_empty((8, 576))),
        ("device context", with_device, on_device),
        ("stream", lambda: torch.cuda.current_stream().cuda_stream,
         lambda: build.raw_stream(index)),
        ("build.check", None, lambda: build.check(None, 0, "gfid_matmul")),
    )
    out = {"gemm_pieces_us": {}, "gather_pieces_us": {}}
    for label, before, after in pieces:
        now = host_us(after)
        was = None if before is None else host_us(before)
        out["gemm_pieces_us"][label] = dict(before=was, after=now)
        print(f"[host] gfid_matmul decode wq/wo, {label}: "
              + ("" if was is None else f"was {was:.2f} us, ") + f"now {now:.2f} us")
    lib, fn = G._launcher()
    o = torch.empty((8, 576), device=dev)
    args = (x.data_ptr(), w.data_ptr(), None, o.data_ptr(), None, 8, 576,
            576, plan.bm, plan.bn, plan.splits, plan.chunks_per_split,
            G.F32_MODES[plan.mode], 0, int(plan.vec_x), int(plan.vec_w),
            build.raw_stream(index))
    ctypes_us = host_us(lambda: fn(*args))
    out["gemm_pieces_us"]["ctypes call with its launch"] = dict(before=None,
                                                                 after=ctypes_us)
    print(f"[host] gfid_matmul decode wq/wo, the ctypes call with its launch "
          f"({plan.splits} splits, {plan.mode}): {ctypes_us:.2f} us")

    def whole(label, call, library, lib_name, key):
        k_host, k_ms, k_dev = host_us(call), time_ms(call), graph_ms(call)
        row = dict(host_us=k_host, ms=k_ms, device_ms=k_dev,
                   host_part_ms=k_ms - k_dev)
        lib_txt = f"no library call ({lib_name})"
        if library is not None:
            l_host, l_ms, l_dev = host_us(library), time_ms(library), graph_ms(library)
            row.update(library_host_us=l_host, library_ms=l_ms,
                       library_device_ms=l_dev, library_host_part_ms=l_ms - l_dev)
            lib_txt = (f"{lib_name} {l_host:.2f} us on the host clock, ratio "
                       f"{k_host / l_host:.3f}; with the host {l_ms:.4f} ms, alone "
                       f"{l_dev:.4f} ms, host part {l_ms - l_dev:.4f} ms")
        out[key] = row
        print(f"[host] {label}: the call on the host clock {k_host:.2f} us; with the "
              f"host {k_ms:.4f} ms, the device alone {k_dev:.4f} ms, host part "
              f"{k_ms - k_dev:.4f} ms ({lib_txt})")

    whole("gfid_matmul decode wq/wo (8, 576) @ (576, 576) fp32",
          lambda: G.gfid_matmul(x, w), lambda: torch.mm(x, w), "torch.mm", "gemm")
    pool = torch.randn((257, 16, 30, 3, 64), generator=gen).to(bf16).to(dev)
    table = torch.randint(0, 257, (8, 32), generator=gen, dtype=torch.int32).to(dev)
    out_g = torch.empty((8, 32 * 16, 30, 3, 64), dtype=bf16, device=dev)
    block_bytes = pool[0].numel() * pool.element_size()
    g_pieces = (
        ("allocation of the output",
         lambda: torch.empty(out_g.shape, dtype=bf16, device=pool.device),
         lambda: pool.new_empty(out_g.shape)),
        ("operand checks", lambda: build.check_operands(
            "paged_gather", pool=(pool, pool.dtype), table=(table, torch.int32)),
         lambda: paged._check(pool, table)),
        ("copy unit", lambda: next(
            u for u in paged.UNITS if block_bytes % u == 0
            and all(q % u == 0 for q in (pool.data_ptr(), out_g.data_ptr()))),
         lambda: paged.copy_unit(block_bytes, pool.data_ptr(), out_g.data_ptr())),
        ("device context", with_device, on_device),
        ("stream", lambda: torch.cuda.current_stream().cuda_stream,
         lambda: build.raw_stream(index)),
    )
    for label, before, after in g_pieces:
        was, now = host_us(before), host_us(after)
        out["gather_pieces_us"][label] = dict(before=was, after=now)
        print(f"[host] paged_gather 8 x 32, {label}: was {was:.2f} us, now {now:.2f} us")
    whole("paged_gather pool (257, 16, 30, 3, 64) bf16, table (8, 32)",
          lambda: paged.paged_gather(pool, table),
          lambda: pool.index_select(0, table.view(-1)), "index_select", "gather")

    # the int8 GEMM at AlexNet's fc8 at batch 1, and the depthwise conv at the
    # xLSTM prefill's mLSTM conv: the pieces of the lean path beside those
    # of the parent's path, then the whole call
    i8 = torch.int8
    xq = torch.randint(-127, 128, (1, 4096), generator=gen, dtype=i8).to(dev)
    wq = torch.randint(-127, 128, (4096, 1000), generator=gen, dtype=i8).to(dev)
    sx = torch.rand((1, 1), generator=gen).to(dev)
    sw = torch.rand((1, 1000), generator=gen).to(dev)
    b8 = torch.randn(1000, generator=gen).to(dev)
    plan8 = G.int8_mm_plan(1, 4096, 1000, xq.data_ptr(), wq.data_ptr(), sms)
    tiles8 = plan8.grid[0] * plan8.grid[1]
    x1 = torch.randn((1, SSM_PREFILL, 1536), generator=gen).to(dev)
    w1 = torch.randn((4, 1536), generator=gen).to(dev)
    w1_lib = w1.T[:, None, :].contiguous()
    for key, name, pieces in (
            ("mm8_pieces_us", "gfid_matmul_int8 fc8 B=1", (
                ("operand checks", lambda: build.check_operands(
                    "gfid_matmul_int8", xq=(xq, i8), wq=(wq, i8), sx=(sx, f32),
                    sw=(sw, f32), bias=(b8, f32)),
                 lambda: build.check_int8_operands("gfid_matmul_int8", xq, wq,
                                                   sx, sw, b8)),
                ("plan (before: uncached)",
                 lambda: G._int8_mm_tiling.__wrapped__(1, 4096, 1000, sms),
                 lambda: G.int8_mm_plan(1, 4096, 1000, xq.data_ptr(), wq.data_ptr(),
                                        sms)),
                ("allocations (before: the output and a zeroed int32 workspace "
                 "of sums and tickets)",
                 lambda: (torch.empty((1, 1000), device=dev),
                          torch.zeros(1000 + tiles8, dtype=torch.int32, device=dev)),
                 lambda: xq.new_empty((1, 1000), dtype=f32)),
                ("device context", with_device, on_device),
                ("stream", lambda: torch.cuda.current_stream().cuda_stream,
                 lambda: build.raw_stream(index)))),
            ("conv1d_pieces_us", f"gfid_conv1d_depthwise (1, {SSM_PREFILL}, 1536)", (
                ("operand checks", lambda: build.check_operands(
                    "gfid_conv1d_depthwise", x=(x1, x1.dtype), w=(w1, w1.dtype)),
                 lambda: C._check(x1, w1)),
                ("plan (before: none; uncached)",
                 lambda: C._tiling.__wrapped__(1, SSM_PREFILL, 1536, 4, True),
                 lambda: C.launch_plan(1, SSM_PREFILL, 1536, 4, True, x1.data_ptr())),
                ("allocation of the output",
                 lambda: torch.empty(x1.shape, dtype=f32, device=x1.device),
                 lambda: x1.new_empty(x1.shape, dtype=f32)),
                ("device context", with_device, on_device),
                ("stream", lambda: torch.cuda.current_stream().cuda_stream,
                 lambda: build.raw_stream(index))))):
        out[key] = {}
        for label, before, after in pieces:
            was, now = host_us(before), host_us(after)
            out[key][label] = dict(before=was, after=now)
            print(f"[host] {name}, {label}: was {was:.2f} us, now {now:.2f} us")
    whole("gfid_matmul_int8 fc8 (1, 4096) @ (4096, 1000) int8, relu",
          lambda: G.gfid_matmul_int8(xq, wq, sx, sw, bias=b8, act="relu"), None,
          "torch._int_mm takes no M <= 16", "mm8")
    whole(f"gfid_conv1d_depthwise (1, {SSM_PREFILL}, 1536) W_f 4 causal",
          lambda: C.gfid_conv1d_depthwise(x1, w1),
          lambda: F.conv1d(x1.permute(0, 2, 1), w1_lib, padding=3, groups=1536),
          "F.conv1d", "conv1d")
    return {"gfid_matmul": dict(out["gemm"], pieces_us=out["gemm_pieces_us"]),
            "paged_gather": dict(out["gather"], pieces_us=out["gather_pieces_us"]),
            "gfid_matmul_int8": dict(out["mm8"], pieces_us=out["mm8_pieces_us"]),
            "gfid_conv1d_depthwise": dict(out["conv1d"],
                                          pieces_us=out["conv1d_pieces_us"])}


def device_profile(fn, steps=3):
    """(device ms per call, kernels per call, every kernel as (name, count
    per call, ms per call), most device time first) from torch.profiler over
    `steps` calls of fn; None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0 and getattr(e, "device_type", None) is not None \
                and "CUDA" in str(e.device_type):
            rows.append((e.key, e.count / steps, us / 1e3 / steps))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[2])
    return (sum(r[2] for r in rows), int(round(sum(r[1] for r in rows))),
            rows)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def main():
    started = {}                    # phase -> its start on the host clock
    # -- phase 1: the card ---------------------------------------------------
    started["1"] = time.perf_counter()
    require(torch.cuda.is_available(), "no CUDA device: this script runs "
            "only on a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import engine as E
    from repro_torch.core import quant
    from repro_torch.kernels import (build, conv1d, flash_attention, gfid_conv,
                                     gfid_matmul, paged)
    from repro_torch.models import cnn

    conv32, mm32 = gfid_conv.gfid_conv2d_nhwc, gfid_matmul.gfid_matmul
    conv8, mm8 = gfid_conv.gfid_conv2d_nhwc_int8, gfid_matmul.gfid_matmul_int8
    # launch counts of the bf16 entries, which conv32 and mm32 launch on bf16
    conv16, mm16 = gfid_conv.gfid_conv2d_nhwc_bf16, gfid_matmul.gfid_matmul_bf16
    all_kernels = (conv32, mm32, conv8, mm8)
    bf16_kernels = (conv16, mm16)

    dev = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the "torch" backend's and the library's bf16 products sum in fp32
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
          f"TFLOP/s (fp32), {PEAK_BF16_FLOP_S / 1e12:.0f} TFLOP/s (bf16), "
          f"{PEAK_INT8_OP_S / 1e12:.0f} TOP/s (int8) and "
          f"{PEAK_BYTES_S / 1e12:.2f} TB/s")

    src = torch.empty(9216 * 4096, device=dev)     # the size of fc6's weights
    dst = torch.empty_like(src)
    copy_ms = time_ms(lambda: dst.copy_(src))
    print(f"[card] device copy of {src.numel() * 4 / 1e6:.1f} MB: {copy_ms:.4f} ms, "
          f"{2 * src.numel() * 4 / copy_ms / 1e9:.3f} TB/s read + write")
    del src, dst

    # -- phase 2: build --------------------------------------------------------
    started["2"] = time.perf_counter()
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc, in parallel)")
    for kname, (secs, log) in built.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"[build] {kname}: {secs:.2f} s; " + " | ".join(usage))

    # -- phase 3: kernel vs plain on the card ----------------------------------
    started["3"] = time.perf_counter()
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

    # the fp32 conv also at every distinct conv shape of VGG-16 and
    # ResNet-50 at batch 1; its cases must reach every path of f32_plan, and
    # the fp32 GEMM's every path of its f32_plan (the cases added for that
    # drawn from a generator of their own)
    gen32 = torch.Generator().manual_seed(32)
    t_conv = time.perf_counter()
    for kname, kernel, plain, cases, int8 in (
            ("gfid_conv2d_nhwc", conv32, gfid_conv.gfid_conv2d_nhwc_plain,
             all_cases(conv_main, ragged_conv, "conv")
             + [(lbl, kw) for net in OTHER_NETS
                for lbl, _, kw in conv_cases(cnn, 1, gen, dev, net)], False),
            ("gfid_matmul", mm32, gfid_matmul.gfid_matmul_plain,
             all_cases(fc_main, ragged_mm, "matmul") + serve_mm_cases(gen, dev)
             + f32_mm_cases(gen32, dev), False),
            ("gfid_conv2d_nhwc_int8", conv8,
             gfid_conv.gfid_conv2d_nhwc_int8_plain,
             all_cases(conv8_main, ragged_conv8, "conv"), True),
            ("gfid_matmul_int8", mm8, gfid_matmul.gfid_matmul_int8_plain,
             all_cases(fc8_main, ragged_mm8, "matmul"), True)):
        worst[kname] = 0.0
        plans = []
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
            plan = ""
            if kname == "gfid_matmul_int8":
                plans.append(launch_plan("mm", kw))
                plan = (f", tile {plans[-1].bm}x{plans[-1].bn}, K splits "
                        f"{plans[-1].splits}"
                        + (" (a cluster)" if plans[-1].splits > 1 else "")
                        + f", 16-byte loads x {int(plans[-1].vec_x)}, bytes a "
                        f"copy of w {plans[-1].vec_w}")
            if kname == "gfid_conv2d_nhwc_int8":
                plans.append(launch_plan("conv", kw))
                plan = (f", tile {plans[-1].bm}x{plans[-1].bn}, K splits "
                        f"{plans[-1].splits}"
                        + (" (a cluster)" if plans[-1].splits > 1 else "")
                        + f", 16-byte loads x {int(plans[-1].vec_x)} "
                        f"w {int(plans[-1].vec_w)}")
            if kname in ("gfid_conv2d_nhwc", "gfid_matmul"):
                plans.append(launch_plan("conv" if kname == "gfid_conv2d_nhwc"
                                         else "mm", kw))
                plan = (f", tile {plans[-1].bm}x{plans[-1].bn}, K splits "
                        f"{plans[-1].splits}"
                        + (f" ({f32_mode(plans[-1])})" if kname == "gfid_matmul"
                           else " (fold)" if plans[-1].fold else "")
                        + f", 16-byte loads x {int(plans[-1].vec_x)} "
                        f"w {int(plans[-1].vec_w)}")
            print(f"[check] {kname} {label}: out {tuple(got.shape)}, act "
                  f"{kw['act']}, max|d| = {abs_err:.3e}, max|d|/max|ref| = "
                  f"{err:.3e} (limit {limit:g}){plan}")
            require(err <= limit, f"{kname} {label}: error {err:.3e} > {limit}")
            worst[kname] = max(worst[kname], abs_err)
            checks += 1
        if kname == "gfid_conv2d_nhwc":
            require_plan_coverage(kname, plans, gfid_conv.F32_TILES, fold=True)
            print(f"[check] gfid_conv2d_nhwc: {len(plans)} cases in "
                  f"{time.perf_counter() - t_conv:.1f} s")
        if kname == "gfid_matmul":
            require_plan_coverage(kname, plans, gfid_matmul.F32_TILES)
            require_f32_gemm_coverage(plans)
        if kname == "gfid_conv2d_nhwc_int8":
            require_int8_conv_coverage(plans)
        if kname == "gfid_matmul_int8":
            require_int8_mm_coverage(plans)
    # bf16 operands: the AlexNet shapes (bias bf16) and the ragged ones (bias
    # fp32), then the cases of bf16_conv_cases and bf16_mm_cases, each stored
    # in fp32 and in bf16; the cases must reach every plan the wrappers make
    bf16_cases = {
        "gfid_conv2d_nhwc_bf16": (conv32, gfid_conv.gfid_conv2d_nhwc_plain, "conv",
                                  gfid_conv.BF16_TILES, [
            (lbl, as_bf16(kw)) for b in BATCHES for lbl, _, kw in conv_main[b]]
            + [(f"ragged conv {i}", as_bf16(kw, keep_bias=True))
               for i, kw in enumerate(ragged_conv)]
            + bf16_conv_cases(gen, dev)),
        "gfid_matmul_bf16": (mm32, gfid_matmul.gfid_matmul_plain, "mm",
                             gfid_matmul.BF16_TILES, [
            (lbl, as_bf16(kw)) for b in BATCHES for lbl, _, kw in fc_main[b]]
            + [(f"ragged matmul {i}", as_bf16(kw, keep_bias=True))
               for i, kw in enumerate(ragged_mm)]
            + bf16_mm_cases(gen, dev))}
    for kname, (kernel, plain, kind, tiles, cases) in bf16_cases.items():
        worst[kname] = 0.0
        plans = []
        for label, kw in cases:
            plan = launch_plan(kind, kw)
            plans.append(plan)
            for out_dtype in (torch.float32, torch.bfloat16):
                got = kernel(**kw, out_dtype=out_dtype)
                want = plain(**kw, out_dtype=out_dtype)
                torch.cuda.synchronize()
                require(got.shape == want.shape and got.dtype == out_dtype
                        and bool(torch.isfinite(got).all()),
                        f"{kname} {label}: bad output")
                ok, abs_err, reading, limit = kernel_check(got, want)
                unit = "bf16 steps" if out_dtype == torch.bfloat16 \
                    else "max|d|/max|ref|"
                print(f"[check] {kname} {label} -> {str(out_dtype)[6:]}: act "
                      f"{kw['act']}, bias "
                      f"{'none' if kw['bias'] is None else str(kw['bias'].dtype)[6:]}, "
                      f"tile {plan.bm}x{plan.bn}, K splits {plan.splits}, 16-byte "
                      f"loads x {int(plan.vec_x)} w {int(plan.vec_w)}, "
                      f"max|d| = {abs_err:.3e}, {unit} {reading:.3e} (limit "
                      f"{limit:g})")
                require(ok, f"{kname} {label} {out_dtype}: {unit} {reading:.3e} "
                        f"> {limit}")
                worst[kname] = max(worst[kname], abs_err)
                checks += 1
        require_plan_coverage(kname, plans, tiles, fold=kind == "conv")
    del bf16_cases
    checks += row_invariance_check(dev, mm32, gen)
    checks += row_invariance_check(dev, mm32, gen32, torch.float32)
    checks += batch_invariance_check(dev, cnn, conv32, conv8, quant,
                                     torch.Generator().manual_seed(33))[0]
    worst["paged_gather"] = 0.0
    for label, pool, table in paged_cases(gen, dev):
        got = paged.paged_gather(pool, table)
        want = paged.paged_gather_plain(pool, table)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"paged_gather {label}: bad output")
        equal = torch.equal(got, want)
        abs_err = 0.0 if equal else (got.float() - want.float()).abs().max().item()
        block_bytes = pool[0].numel() * pool.element_size()
        print(f"[check] paged_gather {label}: pool {tuple(pool.shape)} "
              f"{pool.dtype}, table {tuple(table.shape)}, {block_bytes} B a "
              f"block (unit {paged.copy_unit(block_bytes, pool.data_ptr(), got.data_ptr())} B), "
              f"bitwise equal {equal} (max|d| = {abs_err:.3e}, limit 0)")
        require(equal, f"paged_gather {label}: differs from its plain version")
        worst["paged_gather"] = max(worst["paged_gather"], abs_err)
        checks += 1
    # flash: every fp32 case on the fp32 kernel and again on bf16 operands on
    # the tensor-core kernel (bitwise repeatable), then the bf16-only cases;
    # the bf16 cases must reach every padded head dim and both copy paths
    t_flash = time.perf_counter()
    fa32, fa16 = flash_attention.flash_attention, flash_attention.flash_attention_bf16
    worst["flash_attention"] = worst["flash_attention_bf16"] = 0.0
    fp32_cases = flash_cases(gen, dev)
    bf16_cases = [(lbl, *(t.to(torch.bfloat16) for t in (q, k, v)), c)
                  for lbl, q, k, v, c in fp32_cases] + flash_bf16_cases(gen, dev)
    launches16, launches32 = [], []
    for label, q, k, v, causal in fp32_cases + bf16_cases:
        is16 = q.dtype == torch.bfloat16
        zero_counts(fa32, fa16)
        got = fa32(q, k, v, causal=causal)
        torch.cuda.synchronize()
        one = counts(fa32, fa16)
        require(one == ((0, 1) if is16 else (1, 0)), f"flash_attention {label} "
                f"{q.dtype}: launches (fp32, bf16) = {one}")
        want = flash_attention.flash_attention_plain(q, k, v, causal=causal)
        require(got.shape == want.shape and got.dtype == want.dtype
                and bool(torch.isfinite(got).all()),
                f"flash_attention {label}: bad output")
        err = rel_err(got.float(), want.float())
        abs_err = (got.float() - want.float()).abs().max().item()
        limit = BF16_FLASH_TOL if is16 else TOL
        extra = ""
        if not is16:
            plan = flash_attention.f32_launch(q.shape[0], q.shape[1], q.shape[2],
                                              q.shape[3], q.data_ptr(), k.data_ptr(),
                                              v.data_ptr())
            launches32.append(plan)
            extra = f", {'16-byte' if plan.vec else 'element'} copies"
        if is16:
            plan = flash_attention.bf16_launch(q.shape[0], q.shape[1], q.shape[2],
                                               q.shape[3], q.data_ptr(),
                                               k.data_ptr(), v.data_ptr())
            launches16.append(plan)
            again = fa32(q, k, v, causal=causal)
            torch.cuda.synchronize()
            require(torch.equal(got, again), f"flash_attention_bf16 {label}: two "
                    "calls on one input differ")
            extra = (f", head dim padded to {plan.d_pad}, "
                     f"{'16-byte' if plan.vec else 'element'} copies, a second "
                     "call bitwise equal")
        kname = "flash_attention_bf16" if is16 else "flash_attention"
        print(f"[check] {kname} {label}: {q.dtype}, max|d| = {abs_err:.3e}, "
              f"max|d|/max|ref| = {err:.3e} (limit {limit:g}){extra}")
        require(err <= limit, f"{kname} {label}: error {err:.3e} > {limit}")
        worst[kname] = max(worst[kname], abs_err)
        checks += 1
    seen = {p.vec for p in launches32}
    require(seen == {False, True}, f"flash_attention: the checked cases reach "
            f"copies {seen}")
    print("[check] flash_attention: the cases reach both element and 16-byte copies")
    seen = ({p.d_pad for p in launches16}, {p.vec for p in launches16})
    require(seen == ({16, 32, 64, 128}, {False, True}), f"flash_attention_bf16: "
            f"the checked cases reach head dims {seen[0]} and copies {seen[1]}")
    print(f"[check] flash_attention_bf16: the cases reach head dims padded to 16, "
          f"32, 64 and 128 and both element and 16-byte copies; flash checks took "
          f"{time.perf_counter() - t_flash:.1f} s")
    q = q.detach().clone().requires_grad_(True)
    try:
        flash_attention.flash_attention(q, k, v)
        require(False, "flash_attention took an input that requires grad")
    except NotImplementedError as e:
        print(f"[check] flash_attention on an input that requires grad raises: {e}")
    checks += 1
    del q, k, v, got, want, again, fp32_cases, bf16_cases
    trapped = paged_trap_check()
    print(f"[check] paged_gather with a block id outside the pool, in a child "
          f"process: {trapped}")
    checks += 1
    print(f"[check] {checks} kernel checks passed (fp32 {TOL}; bf16 GEMM and "
          f"conv: fp32 stores {TOL}, bf16 stores one bf16 step; int8 exact, "
          f"gelu {GELU_TOL}; paged_gather bitwise; flash_attention bf16 "
          f"{BF16_FLASH_TOL})")

    # -- phase 4: AlexNet end to end -------------------------------------------
    started["4"] = time.perf_counter()
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
    started["4a"] = time.perf_counter()
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
    started["4b"] = time.perf_counter()
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
    started["4c"] = time.perf_counter()
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

    # -- phase 4d: AlexNet with bf16 parameters ----------------------------------
    started["4d"] = time.perf_counter()
    bf16 = torch.bfloat16
    params = cnn.init_cnn("alexnet", seed=0, device=DEVICE, dtype=bf16)
    params32 = {kind: {name: {k: v.float() for k, v in layer.items()}
                       for name, layer in group.items()}
                for kind, group in params.items()}
    for batch in BATCHES:
        x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                        generator=torch.Generator().manual_seed(batch)).to(dev)
        x = x.to(bf16)
        compiled = E.compile(cnn.program("alexnet", batch=batch, dtype=bf16),
                             E.EngineConfig(backend="cuda"))
        require(compiled.backends() == ("cuda",) * 8,
                f"bf16: backends {compiled.backends()}")
        if batch == 1:
            require(compiled.cost == golden,
                    f"bf16 Table-4 row {compiled.cost} != golden {golden}")
        zero_counts(*all_kernels, *bf16_kernels)
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = counts(*all_kernels, *bf16_kernels)
        require(launches == (0, 0, 0, 0, 5, 3), f"bf16 B={batch}: launches "
                f"(conv, matmul, conv int8, matmul int8, conv bf16, matmul "
                f"bf16) = {launches}, expected (0, 0, 0, 0, 5, 3)")
        main_launches.setdefault("bf16", launches[4:])
        require(tuple(logits.shape) == (batch, 1000) and logits.dtype == bf16
                and bool(torch.isfinite(logits).all()), "bad bf16 logits")
        plain = E.compile(cnn.program("alexnet", batch=batch, dtype=bf16),
                          E.EngineConfig(backend="torch"))
        err = rel_err(logits, plain.apply(params, x))
        require(err <= CNN_BF16_TOL, f"bf16 B={batch}: logits vs torch backend "
                f"{err:.3e} > {CNN_BF16_TOL}")
        f32 = E.compile(cnn.program("alexnet", batch=batch),
                        E.EngineConfig(backend="cuda")).apply(params32, x.float())
        snr = quant.snr_db(f32, logits).item()
        require(snr >= SNR_FLOOR_DB, f"bf16 B={batch}: SNR {snr:.2f} dB < "
                f"{SNR_FLOOR_DB}")
        ms = time_ms(lambda: compiled.apply(params, x))
        forward_ms[("bf16", batch)] = ms
        print(f"[alexnet bf16] B={batch}: backends all cuda, launches conv bf16="
              f"{launches[4]} matmul bf16={launches[5]} (fp32 and int8 "
              f"{sum(launches[:4])}), logits bf16, max|d|/max|ref| vs torch "
              f"backend = {err:.3e} (limit {CNN_BF16_TOL}), SNR vs the fp32 "
              f"forward from the same weights {snr:.2f} dB (floor {SNR_FLOOR_DB})"
              + (", Table-4 row == golden" if batch == 1 else ""))
        print(f"[alexnet bf16] B={batch}: {ms:.4f} ms/forward (median of 20), "
              f"{batch / ms * 1e3:.1f} images/s; fp32 forward "
              f"{forward_ms[('fp32', batch)]:.4f} ms")
    del params, params32

    # -- phase 5: kernel times at the main path's shapes -----------------------
    started["5"] = time.perf_counter()
    def lib_conv(x, w, bias, stride, pad, groups, act):
        out = F.conv2d(x, w, bias, stride=stride, padding=pad, groups=groups)
        return torch.relu(out) if act == "relu" else out

    def lib_mm(x, w, bias, act):
        out = torch.addmm(bias, x, w)
        return torch.relu(out) if act == "relu" else out

    def lib_int_mm(xq, wq, **_):
        return torch._int_mm(xq, wq)

    # bf16 as on the path: bf16 operands and bias, bf16 stored
    conv16_main, fc16_main = (
        {b: [(lbl, spec, dict(as_bf16(kw), out_dtype=torch.bfloat16))
             for lbl, spec, kw in main[b]] for b in BATCHES}
        for main in (conv_main, fc_main))
    totals = {}
    for kname, kernel, plain, per_batch in (
            ("gfid_conv2d_nhwc", conv32, gfid_conv.gfid_conv2d_nhwc_plain,
             conv_main),
            ("gfid_matmul", mm32, gfid_matmul.gfid_matmul_plain, fc_main),
            ("gfid_conv2d_nhwc_int8", conv8,
             gfid_conv.gfid_conv2d_nhwc_int8_plain, conv8_main),
            ("gfid_matmul_int8", mm8, gfid_matmul.gfid_matmul_int8_plain,
             fc8_main),
            ("gfid_conv2d_nhwc_bf16", conv32, gfid_conv.gfid_conv2d_nhwc_plain,
             conv16_main),
            ("gfid_matmul_bf16", mm32, gfid_matmul.gfid_matmul_plain,
             fc16_main)):
        int8, bf16 = kname.endswith("_int8"), kname.endswith("_bf16")
        # every kernel for the device alone too (a CUDA graph of 100 calls),
        # and the library call where there is one
        elem = 2 if bf16 else 4     # bytes an element
        peak = (PEAK_INT8_OP_S if int8 else PEAK_BF16_FLOP_S if bf16
                else PEAK_FP32_FLOP_S)
        for batch in BATCHES:
            tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                       n_bytes=0, ops=0, device_ms=0.0, library_device_ms=0.0)
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
                    n_bytes = elem * (kw["x"].numel() + kw["w"].numel()
                                      + kw["bias"].numel() + out_elems)
                    lib_kw = dict(x=kw["x"].permute(0, 3, 1, 2).contiguous(),
                                  w=kw["w"].permute(3, 2, 0, 1).contiguous(),
                                  bias=kw["bias"], stride=kw["stride"],
                                  pad=kw["pad"], groups=kw["groups"], act=kw["act"])
                    lib = lib_conv
                else:
                    n_bytes = elem * (kw["x"].numel() + kw["w"].numel()
                                      + kw["bias"].numel() + out_elems)
                    lib = lib_mm
                    lib_kw = {k: kw[k] for k in ("x", "w", "bias", "act")}
                b_ms, _ = bound_ms(n_bytes, ops, peak)
                k_ms = time_ms(lambda: kernel(**kw))
                p_ms = time_ms(lambda: plain(**kw))
                l_ms = None if lib is None else time_ms(lambda: lib(**lib_kw))
                # the device alone, without the host's launch
                d_ms = graph_ms(lambda: kernel(**kw))
                ld_ms = None if lib is None else graph_ms(lambda: lib(**lib_kw))
                tot["device_ms"] += d_ms
                tot["library_device_ms"] = (None if ld_ms is None
                                            or tot["library_device_ms"] is None
                                            else tot["library_device_ms"] + ld_ms)
                device = (f"; the device alone: kernel {d_ms:.4f} ms, library "
                          + ("none" if ld_ms is None else f"{ld_ms:.4f} ms"))
                print(f"[time] {kname} {label}: kernel {k_ms:.4f} ms, plain "
                      f"{p_ms:.4f} ms, library "
                      + ("none" if l_ms is None else f"{l_ms:.4f} ms")
                      + f", bound {b_ms:.4f} ms ({n_bytes / 1e6:.2f} MB, "
                      f"{ops / 1e9:.3f} G{'op' if int8 else 'FLOP'}){device}")
                for key, val in (("ms", k_ms), ("plain_ms", p_ms),
                                 ("bound_ms", b_ms), ("n_bytes", n_bytes),
                                 ("ops", ops)):
                    tot[key] += val
                tot["library_ms"] = (None if l_ms is None or tot["library_ms"] is None
                                     else tot["library_ms"] + l_ms)
            tot["bound_by"] = bound_ms(tot["n_bytes"], tot["ops"], peak)[1]
            totals[(kname, batch)] = tot
            lib_txt, lib_dev_txt = ("none" if tot[key] is None else f"{tot[key]:.4f} ms"
                                    for key in ("library_ms", "library_device_ms"))
            print(f"[time] {kname} B={batch} total over the path's layers: kernel "
                  f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, library "
                  f"{lib_txt}, bound {tot['bound_ms']:.4f} ms ({tot['bound_by']}); the "
                  f"device alone: kernel {tot['device_ms']:.4f} ms, library "
                  f"{lib_dev_txt}")

    for batch in BATCHES:
        fwd = forward_ms[("int8", batch)]
        k8 = (totals[("gfid_conv2d_nhwc_int8", batch)]["ms"]
              + totals[("gfid_matmul_int8", batch)]["ms"])
        q = forward_ms[("quant", batch)]
        print(f"[time] alexnet int8 B={batch}: forward {fwd:.4f} ms = int8 kernels "
              f"{k8:.4f} ms ({100 * k8 / fwd:.1f}%) + quantization {q:.4f} ms "
              f"({100 * q / fwd:.1f}%) + rest {fwd - k8 - q:.4f} ms")
        fwd = forward_ms[("bf16", batch)]
        k16 = (totals[("gfid_conv2d_nhwc_bf16", batch)]["ms"]
               + totals[("gfid_matmul_bf16", batch)]["ms"])
        print(f"[time] alexnet bf16 B={batch}: forward {fwd:.4f} ms = bf16 kernels "
              f"{k16:.4f} ms ({100 * k16 / fwd:.1f}%) + rest {fwd - k16:.4f} ms")

    flash_t = flash_timing(dev, flash_attention, worst)
    prefill_mm16 = prefill_gemm_timing(dev, mm32, gen, torch.bfloat16)
    prefill_mm32 = prefill_gemm_timing(dev, mm32, gen, torch.float32)
    launch_path = launch_path_timing(dev, gfid_matmul, paged, conv1d, build)

    # -- phase 6: serving smollm-135m on the paged pool -----------------------
    started["6"] = time.perf_counter()
    flash_kernels = (flash_attention.flash_attention,
                     flash_attention.flash_attention_bf16)
    others = all_kernels[:1] + all_kernels[2:] + bf16_kernels + flash_kernels
    torch.cuda.empty_cache()
    served = serve_phase(dev, E, gfid_matmul, paged, others, worst,
                         dtype=torch.float32)
    del served["params"]

    # -- phase 7: serving xlstm-125m (the depthwise conv kernel's path) -------
    started["7"] = time.perf_counter()
    torch.cuda.empty_cache()
    ssm = ssm_phase(dev, E, gfid_matmul, conv1d, paged, others, worst)

    # -- phase 8: smollm-135m on prompts of 1025-1984 tokens (flash) ----------
    started["8"] = time.perf_counter()
    torch.cuda.empty_cache()
    long = long_phase(dev, E, gfid_matmul, paged, flash_attention,
                      all_kernels[:1] + all_kernels[2:] + bf16_kernels
                      + (conv1d.gfid_conv1d_depthwise,
                         flash_attention.flash_attention_bf16), worst)

    # -- phase 9: smollm-135m with its config's bf16 parameters ---------------
    started["9"] = time.perf_counter()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    served16 = serve_phase(dev, E, gfid_matmul, paged,
                           all_kernels + (conv16, conv1d.gfid_conv1d_depthwise)
                           + flash_kernels,
                           worst, dtype=torch.bfloat16)
    long16 = long_prefill_bf16(dev, E, gfid_matmul, paged, flash_attention,
                               all_kernels + (conv16, conv1d.gfid_conv1d_depthwise,
                                              flash_attention.flash_attention),
                               served16.pop("params"))
    print(f"[serve bf16] phase 9 took {time.perf_counter() - t_phase:.1f} s")

    # -- phase 10: the static Scheduler over AlexNet and smollm-135m ----------
    started["10"] = time.perf_counter()
    torch.cuda.empty_cache()
    sched = scheduler_phase(
        dev, E, cnn, {"fp32": (conv32, mm32), "int8": (conv8, mm8),
                      "bf16": (conv16, mm16)},
        (paged.paged_gather, conv1d.gfid_conv1d_depthwise) + flash_kernels)
    ends = list(started.values())[1:] + [time.perf_counter()]
    print("[time] phases (s): " + ", ".join(
        f"{name} {end - start:.1f}" for (name, start), end
        in zip(started.items(), ends)))

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
        if kname == "gfid_matmul_int8":
            kernels[-1]["launch_path"] = launch_path["gfid_matmul_int8"]
        if kname == "gfid_matmul":
            kernels[-1]["launches_per_decode_step"] = served["step_launches"][0]
            # one prefill's layer GEMMs at M = 1024 and 15,872, summed, with
            # the host and the device alone; the decode wq/wo call's host part
            kernels[-1]["prefill_ms"] = {str(m): v["ms"] for m, v in prefill_mm32.items()}
            kernels[-1]["prefill_device_ms"] = {str(m): v["device_ms"]
                                                for m, v in prefill_mm32.items()}
            kernels[-1]["launch_path"] = launch_path["gfid_matmul"]
        # the device alone; batch 32
        t32 = totals[(kname, BATCHES[-1])]
        kernels[-1].update(
            device_ms=tot["device_ms"], library_device_ms=tot["library_device_ms"],
            **{f"batch{BATCHES[-1]}": {key: t32[key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms")}})
    g = served["gather"]
    kernels.append({
        "name": "paged_gather", "route": "cuda",
        "source": "src/repro_torch/csrc/paged_gather.cu",
        "replaces": "src/repro/kernels/paged.py:41",
        **dict.fromkeys(("launches", "launches_per_decode_step"),
                        served["step_launches"][1]),
        "max_abs_err": worst["paged_gather"],
        **dict.fromkeys(("ms", "kernel_ms"), g["ms"]),
        "plain_ms": g["plain_ms"], "bound_ms": g["bound_ms"],
        "bound_by": g["bound_by"], "library_ms": g["library_ms"],
        "device_ms": g["device_ms"], "library_device_ms": g["library_device_ms"],
        "launch_path": launch_path["paged_gather"]})
    ct = ssm["conv_tot"]
    kernels.append({
        "name": "gfid_conv1d_depthwise", "route": "cuda",
        "source": "src/repro_torch/csrc/conv1d_depthwise.cu",
        "replaces": "src/repro/kernels/conv1d.py:28",
        "launches": ssm["run_launches"][2],
        "launches_per_prefill": ssm["convs"],
        "max_abs_err": worst["gfid_conv1d_depthwise"],
        # one prefill's convs at prompt SSM_PREFILL, summed
        **dict.fromkeys(("ms", "kernel_ms"), ct["ms"]),
        "device_ms": ct["device_ms"],
        "library_device_ms": ct["library_device_ms"],
        "plain_ms": ct["plain_ms"], "bound_ms": ct["bound_ms"],
        "bound_by": ct["bound_by"], "library_ms": ct["library_ms"],
        "launch_path": launch_path["gfid_conv1d_depthwise"]})
    for kname, source, timing, launches in (
            ("flash_attention", "flash_attention.cu", flash_t["float32"],
             long["run_launches"][2]),
            ("flash_attention_bf16", "flash_attention_bf16.cu", flash_t["bfloat16"],
             long16["launches"][2])):
        per = timing["per_prefill"]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": "src/repro/kernels/flash_attention.py:58",
            # fp32: phase 8's continuous run; bf16: phase 9's prompt-1984 prefill
            "launches": launches, "launches_per_prefill": long["n_attn"],
            "max_abs_err": worst[kname],
            # one prefill's launches at prompt LONG_PREFILL, summed
            **dict.fromkeys(("ms", "kernel_ms"), per["ms"]),
            "launch_ms": timing["launch"]["ms"], "device_ms": per["device_ms"],
            "plain_ms": per["plain_ms"], "bound_ms": per["bound_ms"],
            "bound_by": timing["bound_by"], "library_ms": per["library_ms"],
            "library_device_ms": per["library_device_ms"]})
        if "b4" in timing["launch"]:    # one launch at B = 4, the device alone
            kernels[-1]["batch4_launch"] = timing["launch"]["b4"]
    for kname, source, replaces, k in (
            ("gfid_conv2d_nhwc_bf16", "src/repro_torch/csrc/gfid_conv_bf16.cu",
             "src/repro/kernels/gfid_conv.py:79", 0),
            ("gfid_matmul_bf16", "src/repro_torch/csrc/gfid_matmul_bf16.cu",
             "src/repro/kernels/gfid_matmul.py:85", 1)):
        tot = totals[(kname, 1)]                # one AlexNet bf16 forward
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches["bf16"][k],
            "max_abs_err": worst[kname],
            **dict.fromkeys(("ms", "kernel_ms"), tot["ms"]),
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": tot["bound_by"],
            "library_ms": tot["library_ms"], "device_ms": tot["device_ms"],
            "library_device_ms": tot["library_device_ms"]})
    kernels[-1]["launches_per_decode_step"] = served16["step_launches"][0]
    kernels[-1]["launches_per_long_prefill"] = long16["launches"][0]
    # one prefill's layer GEMMs at M = 1024 and 15,872, summed
    kernels[-1]["prefill_ms"] = {str(m): v["ms"] for m, v in prefill_mm16.items()}
    kernels[-1]["prefill_device_ms"] = {str(m): v["device_ms"]
                                        for m, v in prefill_mm16.items()}
    print(f"[serve bf16] summary: {served16['tps']:.1f} tokens/s, p50 "
          f"{served16['lat']['p50_ms']:.1f} ms, p95 {served16['lat']['p95_ms']:.1f} "
          f"ms; decode step {served16['step_ms'][SERVE_BATCH]:.4f} ms with "
          f"{SERVE_BATCH} live rows, {served16['step_ms'][1]:.4f} ms with 1; "
          f"prefill({SERVE_PREFILL}) {served16['prefill_ms']:.4f} ms, "
          f"prefill({LONG_PREFILL}) {long16['prefill_ms']:.4f} ms; capture "
          f"{served16['capture_s']:.3f} s")
    print(f"[long] summary: {long['tps']:.1f} tokens/s, p50 "
          f"{long['lat']['p50_ms']:.1f} ms, p95 {long['lat']['p95_ms']:.1f} ms; "
          f"decode step {long['step_ms'][SERVE_BATCH]:.4f} ms with {SERVE_BATCH} live "
          f"rows, {long['step_ms'][1]:.4f} ms with 1; prefill({LONG_PREFILL}) "
          f"{long['prefill_ms']:.4f} ms; capture {long['capture_s']:.3f} s")
    print(f"[ssm] summary: {ssm['tps']:.1f} tokens/s, p50 "
          f"{ssm['lat']['p50_ms']:.1f} ms, p95 {ssm['lat']['p95_ms']:.1f} ms; "
          f"decode step {ssm['step_ms'][SERVE_BATCH]:.4f} ms with {SERVE_BATCH} live "
          f"rows, {ssm['step_ms'][1]:.4f} ms with 1; prefill({SSM_PREFILL}) "
          f"{ssm['prefill_ms']:.4f} ms; capture {ssm['capture_s']:.3f} s")
    print(f"[serve] summary: {served['tps']:.1f} tokens/s, p50 "
          f"{served['lat']['p50_ms']:.1f} ms, p95 {served['lat']['p95_ms']:.1f} ms; "
          f"decode step {served['step_ms'][SERVE_BATCH]:.4f} ms with {SERVE_BATCH} live "
          f"rows, {served['step_ms'][1]:.4f} ms with 1; prefill({SERVE_PREFILL}) "
          f"{served['prefill_ms']:.4f} ms; capture {served['capture_s']:.3f} s")
    print(name_power)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
