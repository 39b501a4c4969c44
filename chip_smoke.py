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
     an image other bits in a batch. Then the grouped launch of both GEMM
     entries (x (G, M, K) @ w (G, K, N), one launch, counted on the
     entry's and the grouped counter) at granite-moe-1b's expert GEMMs
     (32 experts, (1024, 512) and (512, 1024)) at T = 8 and 1,024 rows
     and a ragged (3, 5, 72) @ (3, 72, 40) with a bias and relu, fp32 and
     bf16 (both stores): within 1e-4 of the plain version (bf16 stores
     one bf16 step), bitwise equal to the G separate 2-D launches, the
     fp32 cases reaching the workspace, the fold and the cluster
     (required); and a row at T = 1 bitwise the same row at T = 8 and
     1,024.
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
     forward and images/s. Then (4e) the same bf16 parameters under
     `EngineConfig(backend="cuda", precision="int8")` at B = 1 and 32: every
     op int8 on "cuda", 5 `gfid_conv2d_nhwc_int8` and 3 `gfid_matmul_int8`
     launches and no other per forward, bf16 logits bitwise equal to the
     "torch" backend under int8, SNR >= 28 dB against the fp32 forward from
     the same weights; ms per forward beside phase 4a's int8 forward on fp32
     inputs, and the quantization's share. Then (4f) AlexNet fp32 under
     `EngineConfig(backend=<fallback>, policy="auto")` for the fallbacks
     "torch" and "ref" at B = 1 and 32: `backends()` equal to
     `auto_backend` of each op, conv and matmul launches equal to the count
     of "cuda" ops, logits within 1e-4 x max|logits| of the all-fallback
     apply; ms per forward beside phase 4's all-"cuda" forward; and each
     AlexNet layer as one engine op on "cuda", "torch" and "ref" (the
     rule's grounds).
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
     requires grad raises. The flash cases include llama-3.2-vision's cross
     layer at Skv != Sq, not causal: q (1, 1100, 32/8, 128) and (4, 1100,
     ...) against k, v of 1,601 image tokens, a short q (Sq 17) against
     1,601, and a ragged pair (Sq 333, Skv 77), on both kernels. Then both
     flash kernels with a window, a softcap and a q offset
     (`flash_local_cases`): a window under a kv tile, one that is no
     multiple of a tile, one >= Skv, q_offset > 0 at Sq < Skv (with and
     without a window), GQA 8/1, a window without causal masking, and
     gemma2-27b's shape q (1, 4500, 32, 128) against k, v (1, 4500, 16,
     128), causal, softcap 50: window 4,096, none, and 512 (the band skip
     bites); each within 1e-4 (fp32) or 8e-3 (bf16, two calls bitwise
     equal) of the plain version, counted on the `_local` counters exactly
     when 0 < window < Skv, and requests 0, 3 and 7 of a batch of 8
     bitwise the request alone. The bf16
     GEMM cases include llama's five GEMM shapes ((4096, 4096), (4096,
     1024), (4096, 14336), (14336, 4096) and the lm_head (4096, 128256)) at
     a decode step's M = 4 and a prompt's M = 1,100, and the image K/V at
     M = 1,601, both stores; and its row invariance at those shapes at M =
     1, 4, 13, 1,100, 1,601 and 4,400.
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
     full width (12 layers, mLSTM x 5 + sLSTM a group, d_model 768, 155.7 M
     fp32 parameters from seed 0), its depth cut to SSM_LAYERS = 6 (one
     group) for the script's time, is served on the same pool
     geometry and 16-request workload as phase 6, continuous, drain and
     solo (the first 4 requests). Every decode-state leaf is a slot store, so nothing is paged.
     Checks: every request done without preemption; one 8-row decode
     bucket; tokens bitwise equal across the three runs and to
     `greedy_generate` for 4 requests; every compiled op on "cuda", 34 GEMMs
     a program and 6 depthwise convs a prefill program (67 and 12 at the
     full 12 layers); launches of 34 `gfid_matmul` a decode step, 34 + 6
     `gfid_conv1d_depthwise` a prefill
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
     Then the int8 AlexNet scheduler again (fifo) under `Scheduler(faults=
     FaultInjector(10, rates={"latency": 0.25}, schedule={("kernel",
     "conv2d:cuda"): (17,)}), config=EngineConfig(backend="cuda",
     row_align=8, precision="int8", fallback="chain"))`: the fault meets
     bucket 8's conv3 in warm-up's first apply and hops to "torch" (bitwise
     for int8 with relu), pinned in that bucket's `backends()` and in
     `stats()["fallbacks"]`; bucket 8's dispatches launch 4 int8 convs, the
     others 5; every result bitwise equal to the request alone through the
     batch-1 apply; the latency spikes counted.
 11. smollm-135m fp32 at full width under faults: phase 6's 16 requests,
     pool and max_batch 8, continuous, under `EngineConfig(backend="cuda",
     row_align=8, fallback="chain")` and a `FaultInjector(2, rates=
     {"numerics": 0.01, "pool": 0.02, "latency": 0.05}, max_fires=4)`
     whose schedule pins two kernel faults: the first `gather:cuda` visit
     (it hops to "torch", bitwise) and `dense:cuda` visit 20, a GEMM of the
     first prefill's first apply (fp32: no hop; the admission is retried).
     Checks: every ticket terminates exactly once, "done" or "failed"; the
     allocator and slots back to fresh; every "done" ticket not preempted
     (the retried ones included) bitwise equal to phase 6's continuous
     run; the gather hop the only fallback, pinned in the decode program;
     a guarded decode step launches 211 `gfid_matmul` + 1 `paged_gather`;
     phase 6's clean schedulers compiled no `-guard` program. First the
     same work runs with the guard programs and no injector: tokens
     bitwise phase 6's. Prints the goodput (tokens/s of "done" tickets)
     beside that guarded clean run's tokens/s, retries, failures,
     fallbacks, spikes, and a guarded decode step's ms beside phase 6's
     clean step.
 12. granite-moe-1b (ibm-granite/granite-3.0-1b-a400m-base: 24 layers,
     d_model 1024, 16/8 heads of 64, 32 experts top-8 of d_ff 512,
     vocabulary 49,155, tied; 1,334.6 M parameters from seed 0) at full
     width, its depth cut to MOE_LAYERS = 12 for the script's time (the
     counts below are the full 24 layers'; each scales with the layers),
     fp32, then the same parameters rounded to bf16,
     each served through `ContinuousScheduler` on phase 6's pool and its
     first 8 requests, continuous, drain and solo (the first 2; the three
     schedulers share their compiled programs). The MoE
     block is the reference's dense dispatch: every expert sees every
     token, its three GEMMs a grouped launch each. Checks: every request
     done in the 8-row bucket; every compiled op on "cuda", 193 GEMMs a
     pass (4 projections, the router, 3 grouped a layer; the
     unembedding), 72 grouped; launches per decode step and prefill
     exactly those (fp32: 193 `gfid_matmul`; bf16: 24 fp32 router GEMMs +
     169 `gfid_matmul_bf16`), 2 gathers a step, nothing else; tokens
     bitwise across the three modes; each of 8 tokens through layer 0's
     MoE block alone bitwise that token in the 8-row bucket; 2 requests
     and one 1,100-token request (phase 8's pool of max_len 2048: 24
     flash launches, 16 query heads over 8 kv heads) against
     `greedy_generate` at one row: equal tokens, or else the first
     expert choice that differs (step, layer, the gap between the 8th and
     9th router probability) must be a near tie, its gap under the two
     runs' largest router-logit difference there. Prints tokens/s,
     p50/p95, a decode step's wall and device time (`torch.profiler`)
     beside its bound (every parameter read once), the 1,100-token
     prefill, and the grouped launches at a decode step's rows and a
     prompt-256 prefill's beside the plain version, `torch.bmm` (TF32
     off; also alone) and their bounds.
 13. llama-3.2-vision-11b (meta-llama/Llama-3.2-11B-Vision's text
     backbone: 40 layers, 32 self-attention and 8 gated cross-attention
     layers at 3, 8, ..., d_model 4096, 32/8 heads of 128, d_ff 14,336,
     vocabulary 128,256, untied lm_head; 1,601 precomputed image
     embeddings a request) at full width and depth, 9.77 B bf16 parameters.
     First the main path as a user runs it: `repro_torch.launch.serve.main`
     (the reference's `launch/serve.py`) with `--batch 4 --prompt-len 1100
     --gen 16`, its weights drawn from seed 0 on the card (every cross gate
     the config's 0): one compiled prefill (297 `gfid_matmul_bf16`, 40
     `flash_attention_bf16`: 32 causal, 8 non-causal at Sq 1,100 against
     Skv 1,601, counted apart) and 15 compiled decode steps (265 each),
     nothing else. Then the phase draws the same weights itself, holding at
     most one leaf in fp32 beside the bf16 ones (peak allocation checked).
     The gate: at the config's zero gate two images give bitwise equal
     logits; then every cross gate is set to 1.0 (this phase's own data)
     and they differ. The same batch through `launch/serve.py`'s
     `generate`: each request's prefill logits bitwise the request alone;
     each request alone through `greedy_generate`: equal tokens, or else
     at the first step that differs the top two logits lie closer than
     the two runs' largest logit difference there. "torch" logits within
     3.5e-2 (VLM_BF16_TOL) of "cuda" for the prefill and a decode step,
     argmax equal, while a control (layer 0's seven weights rounded
     through fp8) must read beyond it; the full-depth witness for request
     0: from the same weights widened to fp32 the two backends within
     1e-4, and each bf16 path's distance from those fp32 logits within 1.5
     times the other's. Then fp32 at full width on the first group (4 self
     layers and the cross layer, 8.6 GB): "torch" within 1e-4 of "cuda"
     for a prompt-1100 prefill and a decode step (38 and 34 fp32
     `gfid_matmul`, 5 fp32 flash a prefill, one non-causal), and phase 9's
     bf16 witness on the same weights. Prints a decode step's wall and
     device time (`torch.profiler`) beside its bound (the weights read
     once and the caches), the prefill's ms and tokens/s and its
     `torch.profiler` breakdown, each pass's GEMM device time from its
     trace beside its bound, the GEMM at llama's shapes alone (the lm_head
     beside bf16 `torch.mm`) and the cross flash launch beside SDPA
     (`enable_gqa`, non-causal), each with its bound.
 14. the kernel tuner (`engine/tune.py`), its cache in a fresh temporary
     directory: `engine.compile(tuning="autotune")` of AlexNet in fp32,
     int8 and bf16 at batch 1 and, on a second, empty cache, at batch 32,
     and of VGG-16 and ResNet-50 in fp32 at batch 1 (every conv and GEMM
     gets a tile); a line a tuned op (candidates, the rule's tile and its
     µs, the winner and its µs: CUDA-graph replays of the kernel alone).
     Every candidate of every tuned op bitwise equal to the rule's tile's
     output of the same launch on seeded operands. A compile under
     "cached" (memo dropped): `tiles()` the cache's winners, `backends()`
     and `precisions()` those of "off", 5 conv + 3 matmul launches of the
     precision's entries a forward, logits bitwise equal to the untuned
     net's, at batch 1 and 32 in each precision. The static `Scheduler`
     under "cached" (buckets 1-8, phase 10's AlexNet waves) in each
     precision: every result bitwise the request alone through the untuned
     batch-1 apply, every bucket on the batch-1 tiles, `stats()["tuning"]`
     "cached". A corrupted and a stale-versioned cache: `tiles()` all
     None, logits bitwise the untuned ones. Then AlexNet's forward tuned
     against untuned (median of 20 CUDA-event timings) at batch 1 and 32
     in each precision, and at batch 32 on the tiles tuned at batch 1 (the
     cost of keys that drop M), and `tune_program` over smollm-135m's fp32
     decode program at bucket 8 (its five GEMM shapes), recorded, not
     claimed.
 15. gemma2-27b (arXiv:2408.00118: 46 layers alternating local attention,
     window 4,096, and global attention; d_model 4,608, 32/16 heads of
     128, d_ff 36,864, vocabulary 256,000, tied; attention logits capped
     at 50, final logits at 30) at full width, its depth cut to
     LOCAL_LAYERS = 4 (two (local, global) groups: 3,444,650,496 bf16
     parameters from seed 0, drawn on the card, peak allocation checked);
     the full 46 layers captured on `meta` first: 27,227,128,320
     parameters, 323 GEMMs a decode step and a 4,500-token prefill. Served
     by `ContinuousScheduler` with max_len 4,608 (the local layers'
     caches 4,096-slot rings in the slot store, the global ones paged):
     prompts of 4,500, 1,100, 300 and 40 tokens, 16 steps each,
     continuous, drain and solo. Checks: tokens bitwise equal across the
     three modes and to `greedy_generate` for all four; exactly 29
     `gfid_matmul_bf16` a decode step and a prefill, 4
     `flash_attention_bf16` a prefill past 1,024 tokens (2 counted as
     local at 4,500, where the window cuts, none at 1,100), 2
     `paged_gather` a decode step (the global k and v), no flash in a
     decode step, nothing else; the "torch" against "cuda" witness at
     prompts 4,500 and 1,100 (from the same weights in fp32 within 1e-4,
     each bf16 path's distance from those fp32 logits within 1.5 times
     the other's; the bf16 gap read, not held). Prints the two flash
     prefills' ms, a decode step's wall and device time beside its bound,
     the local flash launch alone beside the global one at gemma2's shape
     and a band of LOCAL_BAND_WINDOW, each beside its bound (the visible
     pairs' operations), the plain version and eager `flex_attention`
     (softcap `score_mod`, window block mask), and the tied
     unembedding's transpose copy.
     Last, each phase's seconds.

The last lines are the card's name and power limit, a JSON object listing
the kernels, and `{"ok": true, "device": {...}}`.
"""
import dataclasses
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
SSM_LAYERS = 6              # one of its two groups: cut for the script's time
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
# Phase 10's faulted int8 scheduler: the "kernel" point's visit of site
# "conv2d:cuda" that faults (warm-up's first applies of buckets 1, 2, 4 and
# 8 visit it 0-4, 5-9, 10-14 and 15-19: 17 is bucket 8's conv3) and the
# rate of latency spikes a step
SCHED_FAULT_VISIT, SCHED_FAULT_OP, SCHED_SPIKE_RATE = 17, 2, 0.25
# Phase 11: phase 6's workload under faults: a seeded injector with these
# rates and fire cap, and two pinned kernel faults: the first gather visit
# (it hops) and a GEMM visit of the first prefill's first apply (no hop:
# that admission is retried)
CHAOS_SEED, CHAOS_MAX_FIRES, CHAOS_DENSE_VISIT = 2, 4, 20
CHAOS_RATES = {"numerics": 0.01, "pool": 0.02, "latency": 0.05}
# Phase 3's grouped GEMM (an MoE layer's stacked experts) and phase 12:
# granite-moe-1b on phase 6's pool and first MOE_REQUESTS requests (solo and
# against greedy_generate the first MOE_DENSE_CHECKS), then one
# MOE_LONG_PROMPT-token request (MOE_LONG_STEPS steps) on phase 8's pool; its
# grouped GEMMs timed at a decode step's rows and a prompt-MOE_TIMED_PROMPT
# prefill's
MOE_MODEL = "granite_moe_1b"
GROUPED_ROWS = (8, 1024)
GROUPED_RAGGED = (3, 5, 72, 40)     # groups, M, K, N
MOE_REQUESTS, MOE_DENSE_CHECKS = 8, 2
MOE_LONG_PROMPT, MOE_LONG_STEPS = 1100, 8
MOE_TIMED_PROMPT = 256
MOE_LAYERS = 12             # half its 24 layers: cut for the script's time
# Phase 3's cross-attention flash cases and llama GEMMs, and phase 13:
# llama-3.2-vision-11b served by `launch/serve.py` at VLM_BATCH requests of
# VLM_PROMPT tokens (past the dense attention's 1024) and VLM_GEN steps,
# every cross gate set to VLM_GATE (the config's 0 would hide the image);
# the GEMM's row invariance at its shapes at VLM_INVARIANCE_ROWS rows
VLM_MODEL = "llama32_vision_11b"
VLM_BATCH, VLM_PROMPT, VLM_GEN, VLM_GATE = 4, 1100, 16, 1.0
VLM_INVARIANCE_ROWS = (1, 4, 13, 1100, 1601, 4 * 1100)
# Its "torch" logits against "cuda" with bf16 parameters at full depth (40
# layers of width 4096). On the H100 the two backends read 3.9e-6 apart
# from the same weights in fp32 (one function); in bf16 each path's own
# rounding put them 2.43e-2 apart on the card's draw of seed 0 and 2.76e-2
# on the host's, each path 2.0e-2 to 2.4e-2 from the fp32 logits (the
# full-depth witness holds that). The limit sits above both draws and
# below a control the phase reads in every run, which must exceed it:
# layer 0's seven weights rounded through fp8 read 7.10e-2 (card's draw)
# and 7.39e-2 (host's)
VLM_BF16_TOL = 3.5e-2
# Phase 14: the tuner. The nets tuned in fp32 at batch 1 beside AlexNet
# (cut VGG-16 first if the script nears its time limit), the precisions
# AlexNet is tuned and held in, and the decode bucket of smollm-135m's
# tuned program
TUNE_OTHER_NETS = ("vgg16", "resnet50")
TUNE_PRECISIONS = ("fp32", "int8", "bf16")
TUNE_DECODE_BUCKET = 8
# Phase 15: gemma2-27b at full width and LOCAL_LAYERS of its 46 layers (two
# (local, global) groups, so that the stacked group state is exercised),
# served by the ContinuousScheduler on a pool of max_len LOCAL_MAX_LEN (the
# local layers' 4,096-slot rings wrap from the first decode step of the
# 4,500-token request) to requests of LOCAL_PROMPTS tokens, LOCAL_GEN steps
# each; phase 3's band case and phase 15's timed band launch take a window
# of LOCAL_BAND_WINDOW at gemma2's shape, where the band skip bites
LOCAL_MODEL = "gemma2_27b"
LOCAL_LAYERS = 4
LOCAL_MAX_LEN, LOCAL_BLOCK, LOCAL_BATCH = 4608, 16, 4
LOCAL_PROMPTS, LOCAL_GEN = (4500, 1100, 300, 40), 16
LOCAL_BAND_WINDOW = 512
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


def card_numerics():
    """TF32 off; the "torch" backend's and the library's bf16 products sum
    in fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


def vlm_gemm_shapes(cfg):
    """(label, k, n) of llama-3.2-vision-11b's GEMMs: a layer's four (wq and
    wo, wk and wv, which a cross layer runs on the image, w_in and w_gate,
    w_out) and the untied lm_head."""
    return serve_gemm_shapes(cfg)[:4] + (("lm_head", cfg.d_model, cfg.vocab_size),)


def vlm_mm_cases(dev):
    """(label, kwargs) for `gfid_matmul` on bf16 operands at llama's GEMM
    shapes: each at a decode step's M = VLM_BATCH and a prompt's M =
    VLM_PROMPT, and the image K/V projection at M = 1,601 (no multiple of
    any tile); drawn on the card from a seed of their own."""
    from repro_torch.configs.base import get_config
    cfg = get_config(VLM_MODEL)
    dgen = torch.Generator(device=dev).manual_seed(29)

    def t(*shape):
        return torch.randn(shape, generator=dgen, device=dev).to(torch.bfloat16)

    cases = []
    for lbl, k, n in vlm_gemm_shapes(cfg):
        w = t(k, n)
        rows = (VLM_BATCH, VLM_PROMPT) + ((cfg.n_img_tokens,) if lbl == "wk/wv"
                                          else ())
        cases += [(f"llama {lbl} M={m}", dict(x=t(m, k), w=w, bias=None, act=None))
                  for m in rows]
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


def row_invariance_check(dev, mm, seed, dtype=torch.bfloat16, shapes=None,
                         rows=INVARIANCE_ROWS):
    """The GEMM's hard rule, on the kernel itself: one fixed row of x,
    placed in other rows of an x of every M in `rows` (first and
    last rows, other warps and tiles), comes out bitwise equal to the same
    row alone (M = 1), in one K order at every M. On bf16 operands
    (`gfid_matmul_bf16`): in fp32 and bf16 stores, at each smollm-135m GEMM
    shape and a ragged one. On fp32 operands (`gfid_matmul_f32`): at the
    same shapes and AlexNet's fc6-fc8. `shapes` ((label, k, n), ...)
    replaces those. Every operand is drawn on the card by a generator
    seeded with `seed` (fc6's x at M = 15,872 is 585 MB in fp32). Returns
    the count of checks."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import gfid_matmul as G
    bf16 = dtype == torch.bfloat16
    kname = "gfid_matmul_bf16" if bf16 else "gfid_matmul"
    stores = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if shapes is None:
        shapes = serve_gemm_shapes(get_config(SERVE_MODEL)) + (("ragged", 300, 70),)
        if not bf16:
            shapes += (("alexnet fc6", 9216, 4096), ("alexnet fc7", 4096, 4096),
                       ("alexnet fc8", 4096, 1000))
    dgen = torch.Generator(device=dev).manual_seed(seed)
    sms = build.sm_count(dev.index or 0) if dev.type == "cuda" else 132
    checks = 0

    def draw(*shape):
        return torch.randn(shape, generator=dgen, device=dev).to(dtype)

    for label, k, n in shapes:
        w, row = draw(k, n), draw(1, k)
        want = {dt: mm(row, w, out_dtype=dt) for dt in stores}
        orders, tiles = set(), set()
        for m in rows:
            x = draw(m, k)
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
              f"at M = {', '.join(map(str, rows))} (block "
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
    guard_programs = 0          # a clean scheduler compiles none
    # the three schedulers share one geometry and config, so they share the
    # compiled programs: each is captured once
    programs = ({}, {})
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        s._prefill, s._decode = programs
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
        guard_programs += sum("-guard" in c.program.name for c in
                              list(s._decode.values()) + list(s._prefill.values()))
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
              f"per step), others {sum(launches[2:])}; its {len(compiled)} programs "
              f"ready in {compile_s:.2f} s beforehand (each captured and compiled "
              f"once for the three modes); pool free low-water "
              f"{st['pool']['free_low_water']}")
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
                lat=cont["lat"], copy_ms=copy_ms, params=params, work=work,
                tokens=base, guard_programs=guard_programs)


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
    cfg = dataclasses.replace(get_config(SSM_MODEL), n_layers=SSM_LAYERS)
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
    # the three schedulers share one geometry and config, so they share the
    # compiled programs: each is captured once
    programs = ({}, {})
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        s._prefill, s._decode = programs
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
              f"prefill), others {sum(launches[3:])}; its {len(prefills) + len(decodes)} "
              f"programs ready in {compile_s:.2f} s beforehand (each captured and "
              "compiled once for the three modes)")
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


def flash_cross_cases(gen, dev):
    """(label, q, k, v, causal) at Skv != Sq, not causal: llama-3.2-vision's
    cross layer, q (B, Sq, 32, 128) against the image's k and v (B, 1601,
    8, 128), at B = 1 and 4 for Sq = VLM_PROMPT, a short q (Sq = 17), and
    a ragged pair (Sq 333, Skv 77). Phase 3 runs each on fp32 and on bf16
    operands."""
    from repro_torch.configs.base import get_config
    cfg = get_config(VLM_MODEL)
    h, kv, d, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_img_tokens

    def qkv(b, sq, skv):
        return tuple(torch.randn(shape, generator=gen).to(dev)
                     for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
    return [(f"cross ({b}, {sq}, {h}/{kv}, {d}) x Skv {skv} non-causal",
             *qkv(b, sq, skv), False)
            for b, sq, skv in ((1, VLM_PROMPT, n), (VLM_BATCH, VLM_PROMPT, n),
                               (1, 17, n), (1, 333, 77))]


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


def flash_local_cases(dev):
    """(label, (b, sq, skv, h, kv, d), causal, kw) for the window, softcap
    and q offset of both flash kernels, fp32 shapes checked again on bf16
    operands: a window under a kv tile (fp32 64, bf16 128 keys), one that
    is no multiple of a tile, one >= Skv, q_offset > 0 at Sq < Skv (with
    and without a window), GQA, a window without causal masking, and
    gemma2-27b's own layers, q (1, 4500, 32, 128) against k, v (1, 4500,
    16, 128), causal, softcap 50: the local layer (window 4,096), the
    global one, and LOCAL_BAND_WINDOW, where the band skip bites."""
    from repro_torch.configs.base import get_config
    cfg = get_config(LOCAL_MODEL)
    h, kv, d, cap = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.attn_softcap
    s = LOCAL_PROMPTS[0]
    return [
        ("window 20 < tile (1, 300, 4/2, 64)", (1, 300, 300, 4, 2, 64), True,
         dict(window=20)),
        ("window 100 ragged (1, 777, 9/3, 64) softcap 50",
         (1, 777, 777, 9, 3, 64), True, dict(window=100, softcap=50.0)),
        ("window 1000 >= Skv (2, 700, 4/2, 32) softcap 30",
         (2, 700, 700, 4, 2, 32), True, dict(window=1000, softcap=30.0)),
        ("q_offset 130, Sq 40 < Skv 170 (1, 40, 4/2, 16)",
         (1, 40, 170, 4, 2, 16), True, dict(q_offset=130)),
        ("q_offset 1100, window 300, Sq 333 < Skv 1433 (1, 333, 8/2, 128)",
         (1, 333, 1433, 8, 2, 128), True,
         dict(window=300, softcap=50.0, q_offset=1100)),
        ("GQA 8/1 window 200 (1, 1031, 8/1, 128) softcap 50",
         (1, 1031, 1031, 8, 1, 128), True, dict(window=200, softcap=50.0)),
        ("non-causal window 90 (1, 333, 4/2, 40) over Skv 400",
         (1, 333, 400, 4, 2, 40), False, dict(window=90)),
        (f"gemma2 local (1, {s}, {h}/{kv}, {d}) window {cfg.window_size} "
         f"softcap {cap:g}", (1, s, s, h, kv, d), True,
         dict(window=cfg.window_size, softcap=cap)),
        (f"gemma2 global (1, {s}, {h}/{kv}, {d}) softcap {cap:g}",
         (1, s, s, h, kv, d), True, dict(softcap=cap)),
        (f"gemma2 band (1, {s}, {h}/{kv}, {d}) window {LOCAL_BAND_WINDOW} "
         f"softcap {cap:g}", (1, s, s, h, kv, d), True,
         dict(window=LOCAL_BAND_WINDOW, softcap=cap))]


def local_flash_check(dev, flash, worst):
    """Phase 3's window, softcap and q offset cases (`flash_local_cases`) on
    both kernels against their plain versions (fp32 within TOL, bf16
    within BF16_FLASH_TOL and two calls bitwise equal), each launch counted
    on its dtype's counter and, where 0 < window < Skv, once more on its
    `_local` counter; then each case's row invariance: requests 0, 3 and 7
    of a batch of 8 bitwise the request alone. Returns the checks run."""
    fa32, fa16 = flash.flash_attention, flash.flash_attention_bf16
    l32, l16 = flash.flash_attention_local, flash.flash_attention_bf16_local
    dgen = torch.Generator(device=dev).manual_seed(41)
    checks = 0
    t0 = time.perf_counter()
    for label, (b, sq, skv, h, kv, d), causal, kw in flash_local_cases(dev):
        for dtype in (torch.float32, torch.bfloat16):
            is16 = dtype == torch.bfloat16
            kname = "flash_attention_bf16" if is16 else "flash_attention"
            q, k, v = (torch.randn(shape, generator=dgen, device=dev).to(dtype)
                       for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
            zero_counts(fa32, fa16, l32, l16)
            got = fa32(q, k, v, causal=causal, **kw)
            torch.cuda.synchronize()
            local = int(0 < kw.get("window", 0) < skv)
            want_n = (0, 1, 0, local) if is16 else (1, 0, local, 0)
            n = counts(fa32, fa16, l32, l16)
            require(n == want_n, f"{kname} {label}: launches (fp32, bf16, fp32 "
                    f"local, bf16 local) = {n}, expected {want_n}")
            want = flash.flash_attention_plain(q, k, v, causal=causal, **kw)
            require(got.shape == want.shape and got.dtype == want.dtype
                    and bool(torch.isfinite(got).all()), f"{kname} {label}: bad output")
            err = rel_err(got, want)
            limit = BF16_FLASH_TOL if is16 else TOL
            extra = ""
            if is16:
                again = fa32(q, k, v, causal=causal, **kw)
                require(torch.equal(got, again), f"{kname} {label}: two calls on "
                        "one input differ")
                extra = ", a second call bitwise equal"
            print(f"[check] {kname} {label}: max|d|/max|ref| = {err:.3e} (limit "
                  f"{limit:g}){extra}; launches counted {n}")
            require(err <= limit, f"{kname} {label}: error {err:.3e} > {limit}")
            worst[kname] = max(worst[kname],
                               (got.float() - want.float()).abs().max().item())
            # a request's rows are its own at B = 1 and 8
            q8, k8, v8 = (torch.randn((8,) + tuple(a.shape[1:]), generator=dgen,
                                      device=dev).to(dtype) for a in (q, k, v))
            all8 = fa32(q8, k8, v8, causal=causal, **kw)
            for r in (0, 3, 7):
                one = fa32(q8[r:r + 1], k8[r:r + 1], v8[r:r + 1], causal=causal, **kw)
                require(torch.equal(one, all8[r:r + 1]), f"{kname} {label}: request "
                        f"{r} of 8 differs from the request alone")
            print(f"[check] {kname} {label}: requests 0, 3 and 7 of a batch of 8 "
                  "bitwise the request alone")
            checks += 2
            del q, k, v, got, want, q8, k8, v8, all8
    print(f"[check] window, softcap and q_offset: {checks} checks on both flash "
          f"kernels in {time.perf_counter() - t0:.1f} s")
    return checks


def visible_pairs(sq, skv, causal, window=0):
    """The (query, key) pairs attention sees: row i sees the keys j < skv
    with j <= i when causal and i - j < window when windowed."""
    total = 0
    for i in range(sq):
        hi = min(skv - 1, i) if causal else skv - 1
        lo = max(0, i - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def flash_bound(b, sq, skv, h, kv, d, causal, elem=4, peak=PEAK_FP32_FLOP_S,
                window=0):
    """(bound ms, bound_by) of one attention forward: q, k, v read once and
    out written once; 4 flops (two multiply-adds) per visible (query, key)
    pair and column (the causal and windowed pairs alone), at the peak of
    the operands' type. A softcap's tanh is not counted."""
    n_bytes = elem * (2 * b * sq * h * d + 2 * b * skv * kv * d)
    pairs = visible_pairs(sq, skv, causal, window)
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
    LONG_LENS (prefixes of `prompt`): `witness_check`. Returns the gap at
    the longest prompt."""
    from repro_torch.models.layers import tree_map
    params32 = tree_map(lambda a: a.float(), params)
    gap = None
    for n in LONG_LENS:
        batch = {"tokens": prompt[:, :n]}
        gap = witness_check(E, T, cfg, conf, params, params32, batch, batch,
                            LONG_MAX_LEN, "[serve bf16]", f"prompt {n}")
    del params32
    return gap


def witness_logits(E, T, cfg, conf, params, params32, batch16, batch32, max_len,
                   what):
    """The witness's readings for one prefill: (the bf16 "cuda" vs "torch"
    gap, the same from the fp32 weights, each bf16 backend's distance from
    the fp32 "torch" logits), each as max|d| / max|ref|."""
    logits = {}
    for name, tree, batch in (("bf16", params, batch16), ("fp32", params32, batch32)):
        for backend in ("cuda", "torch"):
            with E.using_config(conf.replace(backend=backend)), torch.no_grad():
                out, _ = T.prefill(cfg, tree, batch, max_len)
            logits[(name, backend)] = out.float()
    require(all(bool(torch.isfinite(v).all()) for v in logits.values()),
            f"{what}: logits not finite")
    ref32 = logits[("fp32", "torch")]
    dist = {b: rel_err(logits[("bf16", b)], ref32) for b in ("cuda", "torch")}
    return (rel_err(logits[("bf16", "cuda")], logits[("bf16", "torch")]),
            rel_err(logits[("fp32", "cuda")], ref32), dist)


def witness_check(E, T, cfg, conf, params, params32, batch16, batch32, max_len,
                  tag, what, limit=BF16_LOGITS_TOL):
    """One prefill's bf16 witness: the "cuda" and "torch" logits from bf16
    `params` on `batch16` (held to `limit` of each other; read only when
    None); the same prefill from the weights widened to fp32, `params32`,
    on `batch32` (held to TOL: the two backends compute one function); and
    each bf16 backend's
    distance from those fp32 logits (their ratio held within
    BF16_FP32_RATIO either way: neither path rounds more than the other).
    Returns the bf16 gap."""
    gap, gap32, dist = witness_logits(E, T, cfg, conf, params, params32, batch16,
                                      batch32, max_len, f"{tag} bf16 witness at {what}")
    print(f"{tag} logits at {what}: cuda vs torch backend "
          f"{gap:.3e} in bf16 (limit {limit}), {gap32:.3e} from "
          f"the same weights in fp32 (limit {TOL}); distance from those "
          f"fp32 logits: cuda {dist['cuda']:.3e}, torch {dist['torch']:.3e} "
          f"(ratio {dist['cuda'] / dist['torch']:.3f}, limits "
          f"{1 / BF16_FP32_RATIO:.3f} and {BF16_FP32_RATIO})")
    require(limit is None or gap <= limit, f"{tag} bf16 prefill at {what}: cuda "
            f"logits vs torch backend {gap:.3e} > {limit}")
    require(gap32 <= TOL, f"{tag} prefill at {what} from the bf16 weights in "
            f"fp32: cuda vs torch {gap32:.3e} > {TOL}")
    require(1 / BF16_FP32_RATIO <= dist["cuda"] / dist["torch"]
            <= BF16_FP32_RATIO, f"{tag} bf16 prefill at {what}: cuda is "
            f"{dist['cuda']:.3e} from the fp32 logits, torch "
            f"{dist['torch']:.3e}")
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
    from repro_torch.serve.faults import FaultInjector
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

    # the int8 scheduler again, under faults: latency spikes, and one kernel
    # fault in warm-up's first apply of bucket 8, which the chain answers by
    # a hop of that conv to "torch" (bitwise for int8 with relu), pinned
    conv8, mm8 = kernels["int8"]
    inj = FaultInjector(10, rates={"latency": SCHED_SPIKE_RATE}, latency_s=0.001,
                        schedule={("kernel", "conv2d:cuda"): (SCHED_FAULT_VISIT,)})
    sched = Scheduler(config=configs["int8"].replace(fallback="chain"),
                      policy="fifo", max_batch=8, faults=inj)
    sched.register("alexnet", programs["int8"], shared_args=(cnn_params["int8"],))
    sched.warmup()
    hopped = ["cuda"] * 8
    hopped[SCHED_FAULT_OP] = "torch"
    for b in SCHED_BUCKETS:
        want_b = tuple(hopped) if b == 8 else ("cuda",) * 8
        require(sched.compiled("alexnet", b).backends() == want_b,
                f"faulted sched bucket {b}: backends "
                f"{sched.compiled('alexnet', b).backends()}, expected {want_b}")
    require(sched.stats()["fallbacks"] == [("conv2d", "cuda", "torch")],
            f"faulted sched: fallbacks {sched.stats()['fallbacks']}")
    fault_launches = {}
    for k in range(len(SCHED_WAVES)):
        tickets = [(i, sched.submit(m, *args)) for m, args, i in requests("int8", k)]
        while sched.pending():
            zero_counts(*counters)
            batch = sched.step()
            got = counts(*counters)
            bucket = batch[0].batch_bucket
            want = tuple((4 if bucket == 8 else 5) if c is conv8 else 3 if c is mm8
                         else 0 for c in counters)
            require(got == want, f"faulted sched bucket {bucket}: launches {got}, "
                    f"expected {want}")
            fault_launches[bucket] = (got[counters.index(conv8)],
                                      got[counters.index(mm8)])
        for i, t in tickets:
            require(t.done and torch.equal(t.result, solo["int8"][i]),
                    f"faulted sched alexnet request {i} (bucket {t.batch_bucket}): "
                    "result differs from the request alone")
    st = sched.stats()
    require(st["latency_spikes"] == inj.fired["latency"] > 0,
            f"faulted sched: {st['latency_spikes']} spikes counted, "
            f"{inj.fired['latency']} fired")
    summary["faults"] = dict(spikes=st["latency_spikes"], fallbacks=st["fallbacks"],
                             launches=fault_launches, served=st["served"])
    print(f"[sched] int8 under faults (fifo, fallback chain): {st['served']} "
          f"requests bitwise equal to the request alone; fallbacks "
          f"{st['fallbacks']}, pinned in bucket 8's backends "
          f"{' '.join(sched.compiled('alexnet', 8).backends())}; launches (conv "
          f"int8, matmul int8) a dispatch by bucket {fault_launches}; "
          f"{st['latency_spikes']} latency spikes of {inj.latency_s * 1e3:.1f} ms "
          f"({st['dispatch_wall_s']:.4f} s of dispatch time); injector "
          f"{st['faults']}")
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


def chaos_phase(dev, E, gfid_matmul, paged, other_kernels, served, params):
    """Phase 11: phase 6's smollm-135m workload (fp32 parameters `params`,
    the same pool) served continuous under a seeded `FaultInjector` (see the
    module docstring). `served` is phase 6's return; `other_kernels` must
    launch nothing. Returns the numbers of its summary."""
    from repro_torch.configs.base import get_config
    from repro_torch.serve.faults import FaultInjector
    from repro_torch.serve.scheduler import ContinuousScheduler

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_MODEL)
    per_pass = cfg.n_layers * 7 + 1    # GEMMs of a decode step or a prefill
    mm, gather = gfid_matmul.gfid_matmul, paged.paged_gather
    work, clean = served["work"], served["tokens"]
    require(served["guard_programs"] == 0, "phase 6's clean schedulers "
            f"compiled {served['guard_programs']} -guard programs")
    inj = FaultInjector(CHAOS_SEED, rates=CHAOS_RATES, latency_s=0.001,
                        max_fires=CHAOS_MAX_FIRES, schedule={
                            ("kernel", "gather:cuda"): (0,),
                            ("kernel", "dense:cuda"): (CHAOS_DENSE_VISIT,)})
    conf = E.EngineConfig(backend="cuda", row_align=8, fallback="chain")

    def scheduler(faults, guard):
        sched = ContinuousScheduler(
            cfg, params, max_len=SERVE_MAX_LEN, num_blocks=SERVE_BLOCKS,
            block_size=SERVE_BLOCK, max_batch=SERVE_BATCH, config=conf,
            faults=faults, guard=guard)
        # captured beforehand, as in phase 6: capture is not served time
        for n in sorted({len(p) for p, _ in work}):
            sched.prefill_compiled(n)
        for b in sched.buckets:
            sched.decode_compiled(b)
        return sched, [sched.submit(p, n) for p, n in work]

    # the guard alone (no injector): the guard programs at zero poison must
    # give phase 6's tokens, and the run sets the goodput's clean baseline
    g, g_tickets = scheduler(None, True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g.run()
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    require(all(t.status == "done" for t in g_tickets)
            and [t.tokens for t in g_tickets] == clean,
            "chaos: the guard programs with no fault changed a token")
    g_tps = sum(len(t.tokens) for t in g_tickets) / g_wall
    del g, g_tickets
    s, tickets = scheduler(inj, None)
    require(s.guard, "a scheduler with faults compiles the guard programs")
    fresh = (s.pool.allocator.free_blocks, len(s.pool._free_slots))
    zero_counts(mm, gather, *other_kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = s.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = s.stats()
    require(counts(*other_kernels) == (0,) * len(other_kernels),
            f"chaos: other kernels launched {counts(*other_kernels)}")
    events = [(e.point, e.site, e.visit) for e in inj.events]
    require(("kernel", "gather:cuda", 0) in events
            and ("kernel", "dense:cuda", CHAOS_DENSE_VISIT) in events,
            f"chaos: the pinned kernel faults did not both fire: {events}")
    # exactly once; no leaks
    require(all(t.status in ("done", "failed") for t in tickets)
            and sorted(id(t) for t in finished) == sorted(id(t) for t in tickets)
            and sorted(s._terminated) == sorted(t.rid for t in tickets),
            "chaos: not every ticket terminated exactly once: "
            f"{[t.status for t in tickets]}")
    require((s.pool.allocator.free_blocks, len(s.pool._free_slots)) == fresh
            and not s.pool.allocator.tables
            and s.pool.allocator.free_blocks == SERVE_BLOCKS - 1,
            "chaos: the allocator or the slots are not back to fresh")
    # the tokens: every done ticket not preempted (retried or not) is phase
    # 6's continuous run, bit for bit
    checked = 0
    for i, t in enumerate(tickets):
        if t.status == "done" and t.preemptions == 0:
            require(t.tokens == clean[i], f"chaos: request {i} (retries "
                    f"{t.retries}) tokens differ from phase 6's")
            checked += 1
    retried = [t for t in tickets if t.status == "done" and t.retries
               and t.preemptions == 0]
    require(retried, "chaos: no retried request finished to compare")
    require(st["fallbacks"] == [("gather", "cuda", "torch")],
            f"chaos: fallbacks {st['fallbacks']}")
    dec = s.decode_compiled(SERVE_BATCH)
    hop = [i for i, b in enumerate(dec.backends()) if b != "cuda"]
    require(len(hop) == 1 and dec.exec_pairs[hop[0]][0].kind == "gather"
            and dec.backends()[hop[0]] == "torch",
            f"chaos: decode backends {set(dec.backends())}, hop at {hop}")
    good = sum(len(t.tokens) for t in tickets if t.status == "done")
    print(f"[chaos] {cfg.name}, phase 6's {len(work)} requests, continuous, under "
          f"FaultInjector(seed {CHAOS_SEED}, rates {CHAOS_RATES}, max_fires "
          f"{CHAOS_MAX_FIRES}, kernel faults pinned at gather:cuda 0 and dense:cuda "
          f"{CHAOS_DENSE_VISIT}), EngineConfig(backend='cuda', row_align=8, "
          "fallback='chain'), guard on")
    print(f"[chaos] {sum(t.status == 'done' for t in tickets)} done, "
          f"{st['failed']} failed ({[t.error for t in tickets if t.error]}); "
          f"retries {st['retries']} (tickets "
          f"{[(t.rid, t.retries) for t in tickets if t.retries]}), preemptions "
          f"{sum(t.preemptions for t in tickets)}, decode faults "
          f"{st['decode_faults']}, fallbacks {st['fallbacks']}, latency spikes "
          f"{st['latency_spikes']}; fired {events}")
    print(f"[chaos] every ticket terminated once; allocator and slots fresh; "
          f"{checked} done tickets bitwise equal to phase 6's continuous run, "
          f"the retried ones included; decode bucket {SERVE_BATCH} runs its "
          f"gather {hop[0]} on torch (pinned on its first apply); phase 6 compiled "
          "no -guard program")
    print(f"[chaos] goodput {good} tokens of done tickets in {wall:.3f} s = "
          f"{good / wall:.1f} tokens/s; the same work with the guard and no "
          f"injector {g_wall:.3f} s = {g_tps:.1f} tokens/s, tokens bitwise phase "
          f"6's; phase 6's clean continuous run {served['tps']:.1f} tokens/s; "
          f"{st['steps']} decode steps")

    # one guarded decode step at 8 live rows, with the hop pinned: launches
    # and time beside phase 6's clean step
    s.faults = None                    # no more faults: the step is timed
    rows = [s.submit(work[i][0], SERVE_MAX_LEN - len(work[i][0]))
            for i in range(SERVE_BATCH)]
    s.step()
    require(s.running() == SERVE_BATCH, f"chaos: {s.running()} rows running")
    rids = [t.rid for t in rows]
    args = (params, s.pool.arrays, s.pool.table_rows(rids, SERVE_BATCH),
            s.pool.slot_rows(rids, SERVE_BATCH),
            torch.tensor([[t.tokens[-1]] for t in rows], dtype=torch.int32,
                         device=dev),
            torch.tensor([t.pos for t in rows], dtype=torch.int32, device=dev),
            torch.zeros(SERVE_BATCH, device=dev))
    zero_counts(mm, gather, *other_kernels)
    tok, ok, _ = dec.apply(*args)
    torch.cuda.synchronize()
    one = counts(mm, gather, *other_kernels)
    require(one == (per_pass, 1) + (0,) * len(other_kernels) and bool(ok.all()),
            f"chaos: a guarded decode step launched {one}, expected "
            f"({per_pass}, 1) and no other kernel")
    step_ms = time_ms(lambda: dec.apply(*args))
    for t in rows:
        s.cancel(t)
    print(f"[chaos] a guarded decode step at bucket {SERVE_BATCH} (8 live rows, "
          f"the gather hop pinned): {per_pass} gfid_matmul + 1 paged_gather "
          f"launches; {step_ms:.4f} ms (median of 20) against phase 6's clean step "
          f"{served['step_ms'][SERVE_BATCH]:.4f} ms")
    print(f"[chaos] phase 11 took {time.perf_counter() - t_phase:.1f} s")
    return dict(goodput_tps=good / wall, wall_s=wall, guard_tps=g_tps,
                retries=st["retries"],
                failed=st["failed"], fallbacks=st["fallbacks"],
                spikes=st["latency_spikes"], step_ms=step_ms)


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
            1, 8 * 576, 576 * 576, build.raw_stream(index))
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


def grouped_shapes(cfg):
    """(label, groups, k, n) of an MoE layer's grouped expert GEMMs: w_in
    and w_gate (E, D, F), and w_out (E, F, D)."""
    e, d, f = cfg.moe.n_experts, cfg.d_model, cfg.moe.d_ff_expert
    return (("w_in/w_gate", e, d, f), ("w_out", e, f, d))


def grouped_check(dev, gfid_matmul, gen, worst):
    """Phase 3's grouped launch, fp32 and bf16 (both stores): granite's
    expert GEMMs at GROUPED_ROWS tokens and the ragged GROUPED_RAGGED (with
    a bias and relu): one launch a call; within TOL of the plain version
    (bf16 stores within one bf16 step); bitwise equal to the groups'
    separate 2-D launches; the fp32 cases reaching the workspace, the fold
    and the cluster. Then a row at T = 1 bitwise the same row at every
    GROUPED_ROWS. Folds the errors into `worst`; returns the checks run."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build
    mm, plain = gfid_matmul.gfid_matmul, gfid_matmul.gfid_matmul_plain
    cfg = get_config(MOE_MODEL)
    checks, modes = 0, set()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        kname = "gfid_matmul_bf16_grouped" if bf16 else "gfid_matmul_grouped"
        counted = (getattr(gfid_matmul, "gfid_matmul_bf16" if bf16 else "gfid_matmul"),
                   getattr(gfid_matmul, kname))
        worst[kname] = 0.0
        stores = (torch.float32, torch.bfloat16) if bf16 else (None,)
        cases, rows = [], []
        for label, g, k, n in grouped_shapes(cfg):
            w = (torch.randn((g, k, n), generator=gen) / math.sqrt(k)).to(dev, dtype)
            x = torch.randn((g, max(GROUPED_ROWS), k), generator=gen).to(dev, dtype)
            rows.append((label, x, w))
            cases += [(f"{label} T={m}", x[:, :m].contiguous(), w, None, None)
                      for m in GROUPED_ROWS]
        g, m, k, n = GROUPED_RAGGED
        cases.append((f"ragged ({g}, {m}, {k}) @ ({g}, {k}, {n})",
                      torch.randn((g, m, k), generator=gen).to(dev, dtype),
                      torch.randn((g, k, n), generator=gen).to(dev, dtype),
                      torch.randn(n, generator=gen).to(dev), "relu"))
        for label, x, w, bias, act in cases:
            g, m, k = x.shape
            n = w.shape[2]
            if bf16:
                plan = gfid_matmul.bf16_plan(m, k, n, x.data_ptr(), w.data_ptr(), g)
                how = f"K splits {plan.splits}"
            else:
                plan = gfid_matmul.f32_plan(m, k, n, x.data_ptr(), w.data_ptr(),
                                            build.sm_count(dev.index or 0), g)
                alone = gfid_matmul.f32_plan(m, k, n, sms=build.sm_count(dev.index or 0))
                modes.add(plan.mode)
                how = (f"K splits {plan.splits} ({plan.mode}; a group alone "
                       f"{alone.mode})")
            for store in stores:
                kw = dict(bias=bias, act=act)
                if store is not None:
                    kw["out_dtype"] = store
                zero_counts(*counted)
                got = mm(x, w, **kw)
                torch.cuda.synchronize()
                one = counts(*counted)
                require(one == (1, 1), f"{kname} {label}: launches (entry, grouped) "
                        f"= {one}, expected one grouped launch")
                want = plain(x, w, **kw)
                require(got.shape == (g, m, n) and got.dtype == want.dtype
                        and bool(torch.isfinite(got).all()), f"{kname} {label}: bad output")
                ok, abs_err, reading, limit = kernel_check(got, want)
                apart = torch.stack([mm(x[i], w[i], **kw) for i in range(g)])
                same = torch.equal(got, apart)
                print(f"[check] {kname} {label} -> {str(got.dtype)[6:]}: tile "
                      f"{plan.bm}x{plan.bn}, {how}, grid {plan.grid}, 16-byte loads x "
                      f"{int(plan.vec_x)} w {int(plan.vec_w)}; vs plain max|d| = "
                      f"{abs_err:.3e}, {reading:.3e} (limit {limit:g}"
                      f"{' bf16 steps' if limit == 1.0 else ''}); bitwise equal to "
                      f"{g} separate 2-D launches: {same}")
                require(ok, f"{kname} {label}: {reading:.3e} > {limit}")
                require(same, f"{kname} {label}: differs from the groups' 2-D launches")
                worst[kname] = max(worst[kname], abs_err)
                checks += 2
        for label, x, w in rows:
            for store in stores:
                kw = {} if store is None else dict(out_dtype=store)
                one = mm(x[:, :1].contiguous(), w, **kw)[:, 0]
                same = all(torch.equal(one, mm(x[:, :m].contiguous(), w, **kw)[:, 0])
                           for m in GROUPED_ROWS)
                print(f"[check] {kname} {label}: row 0 at T = 1 bitwise the same "
                      f"row at T = {', '.join(map(str, GROUPED_ROWS))}: {same}")
                require(same, f"{kname} {label}: a row's bits follow T")
                checks += 1
    require(modes == {"split", "fold", "cluster"}, f"gfid_matmul_grouped: the "
            f"fp32 cases reach modes {modes}, not the workspace, fold and cluster")
    print("[check] gfid_matmul_grouped: the fp32 cases reach the workspace, the "
          "fold and the cluster")
    return checks


def grouped_timing(dev, gfid_matmul, cfg, dtype):
    """An MoE layer's grouped GEMMs at a decode step's rows (the 8-row
    bucket) and at a prompt-MOE_TIMED_PROMPT prefill's, as on the path
    (w_in and w_gate store fp32, w_out the parameters' dtype): the kernel
    with the host and for the device alone, its plain version, `torch.bmm`
    (TF32 off; with the host and alone) and the bound. Returns
    {rows: [a row a GEMM of the layer]}."""
    mm, plain = gfid_matmul.gfid_matmul, gfid_matmul.gfid_matmul_plain
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator().manual_seed(12)
    shapes = grouped_shapes(cfg)
    layer = (shapes[0], shapes[0], shapes[1])        # w_in, w_gate, w_out
    out = {}
    for t in (SERVE_BATCH, MOE_TIMED_PROMPT):
        rows = []
        for i, (label, g, k, n) in enumerate(layer):
            x = torch.randn((g, t, k), generator=gen).to(dev, dtype)
            w = (torch.randn((g, k, n), generator=gen) / math.sqrt(k)).to(dev, dtype)
            store = dtype if i == 2 else torch.float32
            kw = dict(out_dtype=store) if bf16 else {}
            el, out_el = x.element_size(), store.itemsize
            b_ms, by = bound_ms(el * (g * t * k + g * k * n) + out_el * g * t * n,
                                2 * g * t * k * n,
                                PEAK_BF16_FLOP_S if bf16 else PEAK_FP32_FLOP_S)
            row = dict(label=label, t=t, g=g, k=k, n=n, ops=2 * g * t * k * n,
                       n_bytes=el * (g * t * k + g * k * n) + out_el * g * t * n,
                       ms=time_ms(lambda: mm(x, w, **kw)),
                       device_ms=graph_ms(lambda: mm(x, w, **kw)),
                       plain_ms=time_ms(lambda: plain(x, w, **kw), iters=5),
                       library_ms=time_ms(lambda: torch.bmm(x, w)),
                       library_device_ms=graph_ms(lambda: torch.bmm(x, w)),
                       bound_ms=b_ms, bound_by=by)
            rows.append(row)
            print(f"[time] {'gfid_matmul_bf16' if bf16 else 'gfid_matmul'} grouped "
                  f"{label} ({g}, {t}, {k}) @ ({g}, {k}, {n}) -> {str(store)[6:]}: "
                  f"kernel {row['ms']:.4f} ms, the device alone {row['device_ms']:.4f} "
                  f"ms, plain {row['plain_ms']:.4f} ms, library torch.bmm "
                  f"{row['library_ms']:.4f} ms, the device alone "
                  f"{row['library_device_ms']:.4f} ms, bound {b_ms:.4f} ms ({by}); "
                  f"{(el * g * k * n) / row['device_ms'] / 1e9:.3f} TB/s of weights "
                  "for the device alone")
        out[t] = rows
    return out


def route_trace(moe_mod, fn):
    """fn() with every router's logits recorded on the host, (T, E) fp32 a
    call in call order (the `meta` calls of a program's capture skipped)."""
    calls, softmax = [], moe_mod._softmax

    def record(logits):
        if logits.device.type != "meta":
            calls.append(logits.detach().float().cpu())
        return softmax(logits)

    moe_mod._softmax = record
    try:
        fn()
    finally:
        moe_mod._softmax = softmax
    return calls


def first_route_difference(cfg, a, b):
    """The first router call where two runs' traces (`route_trace`) choose
    other experts, compared over the rows both hold (a decode step's first
    row): {step (-1 for the prefill), layer, row, gap (the k-th less the
    (k+1)-th probability, the smaller of the two runs'), logit_diff (the
    two runs' largest router-logit difference at that call)}; None where
    every choice agrees."""
    k, layers = cfg.moe.n_active, cfg.n_layers
    for c, (la, lb) in enumerate(zip(a, b)):
        r = min(la.shape[0], lb.shape[0])
        la, lb = la[:r], lb[:r]
        pa, pb = torch.softmax(la, -1), torch.softmax(lb, -1)
        sa, ia = torch.sort(pa, dim=-1, descending=True, stable=True)
        sb, ib = torch.sort(pb, dim=-1, descending=True, stable=True)
        differ = (ia[:, :k].sort(-1).values != ib[:, :k].sort(-1).values).any(-1)
        if bool(differ.any()):
            row = int(differ.nonzero()[0])
            gap = min(float(s[row, k - 1] - s[row, k]) for s in (sa, sb))
            return dict(step=c // layers - 1, layer=c % layers, row=row, gap=gap,
                        logit_diff=float((la - lb).abs().max()))
    return None


def moe_phase(dev, E, gfid_matmul, paged, flash, other_kernels):
    """Phase 12: granite-moe-1b at full width and depth served through
    `ContinuousScheduler`, fp32 parameters from seed 0, then the same
    parameters rounded to bf16 (what `init_params(..., dtype=torch.bfloat16)`
    makes: it draws in fp32 and casts). `other_kernels` must launch
    nothing. Returns {dtype: the numbers the kernels line and the summary
    print}."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_MODEL), n_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=DEVICE, dtype=torch.float32)
    print(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of {cfg.head_dim}, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.n_active} of d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab_size}; "
          f"{sum(p.numel() for p in _leaves(params))} fp32 parameters made in "
          f"{time.perf_counter() - t0:.2f} s")
    out = {torch.float32: moe_serve(dev, E, cfg, params, gfid_matmul, paged, flash,
                                    other_kernels)}
    params = tree_map(lambda a: a.to(torch.bfloat16), params)
    torch.cuda.empty_cache()
    out[torch.bfloat16] = moe_serve(dev, E, cfg, params, gfid_matmul, paged, flash,
                                    other_kernels)
    del params
    print(f"[moe] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return out


def moe_serve(dev, E, cfg, params, gfid_matmul, paged, flash, other_kernels):
    """Phase 12 for one parameter dtype (see the module docstring)."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as T
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             latency_percentiles)

    dtype = params["embed"].dtype
    bf16 = dtype == torch.bfloat16
    tag = "[moe bf16]" if bf16 else "[moe]"
    n_layers, n_experts = cfg.n_layers, cfg.moe.n_experts
    # the counters: the fp32 and bf16 entries, their grouped launches, the
    # gather, both flash kernels and the rest
    counted = (gfid_matmul.gfid_matmul, gfid_matmul.gfid_matmul_bf16,
               gfid_matmul.gfid_matmul_grouped, gfid_matmul.gfid_matmul_bf16_grouped,
               paged.paged_gather, flash.flash_attention,
               flash.flash_attention_bf16) + tuple(other_kernels)
    # a pass (a decode step or a prefill): 4 projections, the router (fp32
    # on every parameter dtype) and 3 grouped GEMMs a layer, the unembedding
    per_pass = n_layers * 8 + 1
    grouped = 3 * n_layers

    def want(steps, prefills, long_prefills=0):
        passes = steps + prefills + long_prefills
        gemm = (n_layers * passes, (per_pass - n_layers) * passes) if bf16 \
            else (per_pass * passes, 0)
        groups = (0, grouped * passes) if bf16 else (grouped * passes, 0)
        fa = (0, n_layers * long_prefills) if bf16 else (n_layers * long_prefills, 0)
        return gemm + groups + (2 * steps,) + fa + (0,) * len(other_kernels)

    n_params = sum(p.numel() for p in _leaves(params))
    w_bytes = sum(p.numel() * p.element_size() for p in _leaves(params))
    gen = torch.Generator().manual_seed(0)
    work = []
    for _ in range(SERVE_REQUESTS):
        n = int(torch.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1, (1,),
                              generator=gen))
        steps = SERVE_STEPS[int(torch.randint(len(SERVE_STEPS), (1,),
                                              generator=gen))]
        work.append((torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(),
                     steps))
    work = work[:MOE_REQUESTS]
    print(f"{tag} {n_params} {str(dtype)[6:]} parameters ({w_bytes / 1e9:.3f} GB); "
          f"phase 6's pool and first {len(work)} requests, prompts "
          f"{sorted(len(p) for p, _ in work)} tokens, steps {[n for _, n in work]}")
    conf = E.EngineConfig(backend="cuda", row_align=8)

    def scheduler(max_batch, admission, max_len=SERVE_MAX_LEN, blocks=SERVE_BLOCKS):
        return ContinuousScheduler(
            cfg, params, max_len=max_len, num_blocks=blocks, block_size=SERVE_BLOCK,
            max_batch=max_batch, config=conf, admission=admission)

    def check_programs(s, lens):
        compiled = [s.prefill_compiled(n) for n in lens] \
            + [s.decode_compiled(b) for b in s.buckets]
        for c in compiled:
            kinds = [op.kind for op in c.program.ops]
            specs = [op.spec for op in c.program.ops]
            n_gather = 2 if "decode" in c.program.name else 0
            require(set(c.backends()) == {"cuda"} and len(kinds) == per_pass + n_gather
                    and kinds.count("gather") == n_gather
                    and sum(s_ in ("ecd,edf->ecf", "ecf,efd->ecd") for s_ in specs)
                    == grouped, f"{tag} {c.program.name}: backends "
                    f"{set(c.backends())}, {len(kinds)} ops, expected "
                    f"{per_pass + n_gather} with {grouped} grouped")
        return len(compiled)

    runs = {}
    # the three modes' schedulers share one geometry and config, so they
    # share the compiled programs: each is captured once
    programs = ({}, {})
    for mode, max_batch, admission in (
            ("continuous", SERVE_BATCH, "continuous"),
            ("drain", SERVE_BATCH, "drain"), ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        s._prefill, s._decode = programs
        served = work[:MOE_DENSE_CHECKS] if mode == "solo" else work
        t0 = time.perf_counter()
        n_compiled = check_programs(s, sorted({len(p) for p, _ in served}))
        compile_s = time.perf_counter() - t0
        tickets = [s.submit(p, n) for p, n in served]
        zero_counts(*counted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = s.stats()
        launches = counts(*counted)
        require(all(t.status == "done" and t.preemptions == 0 for t in tickets)
                and st["compiled_decode_buckets"] == [SERVE_BATCH],
                f"{tag} {mode}: not every request done in the {SERVE_BATCH}-row bucket")
        require(launches == want(st["steps"], st["admitted"]), f"{tag} {mode}: "
                f"launches {launches}, expected {want(st['steps'], st['admitted'])} "
                "(gfid_matmul, gfid_matmul_bf16, grouped fp32, grouped bf16, "
                "paged_gather, flash fp32, flash bf16, others)")
        n_tok = sum(len(t.tokens) for t in tickets)
        lat = latency_percentiles(tickets)
        runs[mode] = dict(tokens=[t.tokens for t in tickets], wall=wall, n_tok=n_tok,
                          lat=lat, steps=st["steps"], launches=launches)
        print(f"{tag} {mode}: {st['steps']} decode steps (fill "
              f"{st['decode_fill']:.3f}), {st['admitted']} prefills, {n_tok} tokens "
              f"in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; latency p50 "
              f"{lat['p50_ms']:.1f} ms, p95 {lat['p95_ms']:.1f} ms; launches "
              f"{launches[:5]} (gfid_matmul, gfid_matmul_bf16, grouped fp32, grouped "
              f"bf16, paged_gather), others {sum(launches[5:])}; its {n_compiled} "
              f"programs ready in {compile_s:.2f} s beforehand (each captured and "
              "compiled once for the three modes)")
    base = runs["continuous"]["tokens"]
    for mode in ("drain", "solo"):
        require(runs[mode]["tokens"] == base[:len(runs[mode]["tokens"])],
                f"{tag} {mode} tokens differ from the continuous run")
    print(f"{tag} tokens bitwise equal across continuous, drain and solo")

    def dense_check(prompt, steps, served, max_len, blocks, what):
        """greedy_generate at one row against the served tokens; where they
        differ, the first router choice that differs must be a near tie."""
        tokens = {"tokens": torch.tensor([prompt], device=dev)}
        with E.using_config(conf):
            dense = SE.greedy_generate(cfg, params, tokens, steps, max_len)[0].tolist()
        if dense == served:
            return True
        with E.using_config(conf), torch.no_grad():
            a = route_trace(moe_mod, lambda: SE.greedy_generate(
                cfg, params, tokens, steps, max_len))
        s = scheduler(1, "continuous", max_len, blocks)
        b = route_trace(moe_mod, lambda: (s.submit(prompt, steps), s.run()))
        dif = first_route_difference(cfg, a, b)
        require(dif is not None, f"{tag} {what}: tokens differ from greedy_generate "
                "with every router choice equal")
        print(f"{tag} {what}: tokens differ from greedy_generate's at one row from "
              f"step {next(i for i, (u, v) in enumerate(zip(dense, served)) if u != v)}; "
              f"the first expert choice that differs: step {dif['step']} (-1: the "
              f"prefill), layer {dif['layer']}, row {dif['row']}: the {cfg.moe.n_active}th "
              f"less the {cfg.moe.n_active + 1}th router probability {dif['gap']:.3e}, "
              f"the two runs' largest router-logit difference there "
              f"{dif['logit_diff']:.3e}")
        require(dif["gap"] < dif["logit_diff"], f"{tag} {what}: an expert choice "
                "differs where the router's gap exceeds the runs' logit difference")
        return False

    equal = sum(dense_check(p, n, base[i], SERVE_MAX_LEN, SERVE_BLOCKS, f"request {i}")
                for i, (p, n) in enumerate(work[:MOE_DENSE_CHECKS]))
    print(f"{tag} greedy_generate at one row: {equal} of {MOE_DENSE_CHECKS} "
          "requests bitwise the served tokens (the rest a near tie, above)")

    # an MoE block: one token alone bitwise that token in the 8-row bucket
    p0 = {k: v[0] for k, v in params["groups"]["0"]["moe"].items()}
    x = torch.randn((SERVE_BATCH, 1, cfg.d_model), generator=gen).to(dev, dtype)
    with E.using_config(conf), torch.no_grad():
        y8, _ = moe_mod.moe_forward_dense(cfg, p0, x)
        alone = [torch.equal(moe_mod.moe_forward_dense(cfg, p0, x[i:i + 1])[0][0],
                             y8[i]) for i in range(SERVE_BATCH)]
    require(all(alone), f"{tag} MoE block: rows {alone} alone differ from the bucket")
    print(f"{tag} MoE block (layer 0): each of {SERVE_BATCH} tokens alone bitwise "
          f"equal to that token in the {SERVE_BATCH}-row bucket")

    # one decode step at the bucket with 8 live rows: launches, wall and
    # device time, the bound
    s8 = scheduler(SERVE_BATCH, "continuous")
    rows = [s8.submit(work[i % len(work)][0],
                      SERVE_MAX_LEN - len(work[i % len(work)][0]))
            for i in range(SERVE_BATCH)]
    s8.step()
    require(s8.running() == SERVE_BATCH, f"{tag} {s8.running()} rows running")
    dec = s8.decode_compiled(SERVE_BATCH)
    rids = [t.rid for t in rows]
    args = (params, s8.pool.arrays, s8.pool.table_rows(rids, SERVE_BATCH),
            s8.pool.slot_rows(rids, SERVE_BATCH),
            torch.tensor([[t.tokens[-1]] for t in rows], dtype=torch.int32, device=dev),
            torch.tensor([t.pos for t in rows], dtype=torch.int32, device=dev))
    zero_counts(*counted)
    dec.apply(*args)
    torch.cuda.synchronize()
    step_launches = counts(*counted)
    require(step_launches == want(1, 0), f"{tag} one decode step launched "
            f"{step_launches}, expected {want(1, 0)}")
    step_ms = time_ms(lambda: dec.apply(*args), iters=10)
    prof = device_profile(lambda: dec.apply(*args))
    step_bound, _ = bound_ms(w_bytes, 0)
    if prof is None:
        busy = None
        print(f"[profile] {tag} decode step: the profiler recorded no device time")
    else:
        busy, n_kernels, top = prof
        print(f"[profile] {tag} decode step with {SERVE_BATCH} live rows: {n_kernels} "
              f"device kernels, {busy:.4f} ms of device time (torch.profiler, 3 "
              f"steps) = {100 * busy / step_ms:.1f}% of the step; by kernel: "
              + "; ".join(f"{nm[:50]} x{c:g} {ms:.4f} ms" for nm, c, ms in top[:6]))
    print(f"{tag} decode step at bucket {SERVE_BATCH}, {SERVE_BATCH} live rows: "
          f"{sum(step_launches[:2])} GEMM launches ({sum(step_launches[2:4])} grouped) "
          f"+ {step_launches[4]} paged_gather; {step_ms:.4f} ms wall (median of 10), "
          f"{'not measured' if busy is None else f'{busy:.4f} ms'} of device time; "
          f"bound {step_bound:.4f} ms (the {w_bytes / 1e9:.3f} GB of parameters, "
          f"every expert's, read once at {PEAK_BYTES_S / 1e12:.2f} TB/s)")
    del s8, dec, args

    # one MOE_LONG_PROMPT-token request on phase 8's pool: flash at 16 query
    # heads over 8 kv heads
    prompt = torch.randint(0, cfg.vocab_size, (MOE_LONG_PROMPT,), generator=gen).tolist()
    s = scheduler(SERVE_BATCH, "continuous", LONG_MAX_LEN, LONG_BLOCKS)
    check_programs(s, [MOE_LONG_PROMPT])
    t = s.submit(prompt, MOE_LONG_STEPS)
    zero_counts(*counted)
    s.run()
    torch.cuda.synchronize()
    long_launches = counts(*counted)
    st = s.stats()
    require(t.status == "done" and long_launches == want(st["steps"], 0, 1),
            f"{tag} prompt {MOE_LONG_PROMPT}: launches {long_launches}, expected "
            f"{want(st['steps'], 0, 1)}")
    long_equal = dense_check(prompt, MOE_LONG_STEPS, t.tokens, LONG_MAX_LEN,
                             LONG_BLOCKS, f"prompt {MOE_LONG_PROMPT}")
    pre = s.prefill_compiled(MOE_LONG_PROMPT)
    row = torch.arange(1, s.layout.blocks_per_req + 1, dtype=torch.int32, device=dev)
    ptoks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    prefill_ms = time_ms(lambda: pre.apply(params, s.pool.arrays, row,
                                           torch.tensor(1, dtype=torch.int32,
                                                        device=dev), ptoks),
                         iters=5, warmup=1)
    print(f"{tag} prompt {MOE_LONG_PROMPT} on a pool of max_len {LONG_MAX_LEN}: "
          f"prefill {sum(long_launches[:2]) - st['steps'] * per_pass} GEMM + "
          f"{sum(long_launches[5:7])} flash launches, {st['steps']} decode steps; "
          f"tokens {'bitwise' if long_equal else 'not'} equal to greedy_generate; "
          f"prefill {prefill_ms:.4f} ms (median of 5, CUDA events around "
          "CompiledNet.apply)")
    del s, pre
    timing = grouped_timing(dev, gfid_matmul, cfg, dtype)
    cont = runs["continuous"]
    return dict(tps=cont["n_tok"] / cont["wall"], lat=cont["lat"], step_ms=step_ms,
                busy_ms=busy, step_bound_ms=step_bound, prefill_ms=prefill_ms,
                step_launches=step_launches, launches=cont["launches"],
                timing=timing)


def fp8_rounded(w):
    """w rounded through float8_e4m3fn with one scale for the tensor (its
    largest magnitude to the format's 448), back in w's dtype."""
    scale = w.float().abs().max() / 448.0
    return (w.float() / scale).to(torch.float8_e4m3fn).float().mul_(scale).to(w.dtype)


def top2_gap(logits):
    """Per row, the largest logit less the second."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def greedy_logits(T, cfg, params, batch, steps, max_len):
    """`greedy_generate`'s loop (eager, the ambient config) with each
    step's fp32 logits (B, V) returned in order, the prefill's first."""
    with torch.no_grad():
        logits, state = T.prefill(cfg, params, batch, max_len)
        out = [logits.float()]
        tok, pos0 = torch.argmax(logits, dim=-1)[:, None], batch["tokens"].shape[1]
        for i in range(steps - 1):
            logits_i, state = T.decode_step(cfg, params, state, tok, pos0 + i)
            out.append(logits_i[:, -1].float())
            tok = torch.argmax(logits_i[:, -1], dim=-1)[:, None]
    return out


def vlm_gemm_timing(dev, gfid_matmul, cfg):
    """Phase 13's GEMM rows: `gfid_matmul_bf16` at llama's shapes as the
    path runs them (bf16 in; bf16 stored, the lm_head fp32), a decode
    step's at M = VLM_BATCH and a prefill's at M = VLM_BATCH x VLM_PROMPT
    (the image K/V at VLM_BATCH x 1,601), with the host and for the device
    alone, beside the plain version, bf16 `torch.mm` (timed only here) and
    the bound. Returns {"decode"|"prefill": {label: row}}."""
    dgen = torch.Generator(device=dev).manual_seed(35)

    def t(*shape):
        return torch.randn(shape, generator=dgen, device=dev).to(torch.bfloat16)

    shapes = dict((lbl, (k, n)) for lbl, k, n in vlm_gemm_shapes(cfg))
    rows = {"decode": [(lbl, VLM_BATCH) for lbl in shapes],
            "prefill": [(lbl, VLM_BATCH * VLM_PROMPT) for lbl in list(shapes)[:4]]
            + [("image K/V", VLM_BATCH * cfg.n_img_tokens)]}
    out = {}
    for kind, cases in rows.items():
        out[kind] = {}
        for lbl, m in cases:
            k, n = shapes["wk/wv" if lbl == "image K/V" else lbl]
            x, w = t(m, k), t(k, n)
            store = torch.float32 if lbl == "lm_head" else torch.bfloat16

            def kernel():
                return gfid_matmul.gfid_matmul(x, w, out_dtype=store)

            def lib():
                return torch.mm(x, w)

            n_bytes = 2 * (m * k + k * n) + m * n * (4 if store == torch.float32 else 2)
            b_ms, by = bound_ms(n_bytes, 2 * m * k * n, PEAK_BF16_FLOP_S)
            row = dict(ms=time_ms(kernel), device_ms=graph_ms(kernel),
                       plain_ms=time_ms(lambda: gfid_matmul.gfid_matmul_plain(
                           x, w, out_dtype=store), iters=5),
                       library_ms=time_ms(lib), library_device_ms=graph_ms(lib),
                       bound_ms=b_ms, bound_by=by, n_bytes=n_bytes, ops=2 * m * k * n)
            out[kind][lbl] = row
            print(f"[time] gfid_matmul_bf16 llama {kind} {lbl} ({m}, {k}) @ ({k}, {n}) -> "
                  f"{str(store)[6:]}: kernel {row['ms']:.4f} ms, alone "
                  f"{row['device_ms']:.4f}; plain {row['plain_ms']:.4f}; bf16 torch.mm "
                  f"{row['library_ms']:.4f}, alone {row['library_device_ms']:.4f}; "
                  f"bound {b_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB, "
                  f"{2 * m * k * n / 1e9:.2f} GFLOP)")
            del x, w
    return out


def vlm_flash_timing(dev, flash, cfg, worst):
    """Phase 13's flash rows: the cross layer's launch, q (VLM_BATCH,
    VLM_PROMPT, 32, 128) against k, v (VLM_BATCH, 1601, 8, 128), not
    causal, on fp32 and bf16 operands, with the host and for the device
    alone, beside the plain version, `F.scaled_dot_product_attention(
    enable_gqa=True)` in the same dtype (TF32 off; timed only here) and the
    bound. Returns {dtype name: row}."""
    b, sq, skv = VLM_BATCH, VLM_PROMPT, cfg.n_img_tokens
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dgen = torch.Generator(device=dev).manual_seed(36)
    out = {}
    for dtype, tol, peak in ((torch.float32, TOL, PEAK_FP32_FLOP_S),
                             (torch.bfloat16, BF16_FLASH_TOL, PEAK_BF16_FLOP_S)):
        kname = "flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention"
        q, k, v = (torch.randn(shape, generator=dgen, device=dev).to(dtype)
                   for shape in ((b, sq, h, d), (b, skv, kv, d), (b, skv, kv, d)))
        got = flash.flash_attention(q, k, v, causal=False)
        want = flash.flash_attention_plain(q, k, v, causal=False)
        err = rel_err(got, want)
        require(err <= tol, f"{kname} at the cross shape: {err:.3e} > {tol}")
        worst[kname] = max(worst[kname], (got.float() - want.float()).abs().max().item())
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

        def kernel():
            return flash.flash_attention(q, k, v, causal=False)

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=False,
                                                  enable_gqa=True)

        b_ms, by = flash_bound(b, sq, skv, h, kv, d, False, q.element_size(), peak)
        row = dict(ms=time_ms(kernel), device_ms=graph_ms(kernel),
                   plain_ms=time_ms(lambda: flash.flash_attention_plain(
                       q, k, v, causal=False), iters=3),
                   library_ms=time_ms(sdpa), library_device_ms=graph_ms(sdpa),
                   bound_ms=b_ms, bound_by=by)
        out[str(dtype)[6:]] = row
        print(f"[time] {kname} cross ({b}, {sq}, {h}/{kv}, {d}) x Skv {skv} non-causal: "
              f"kernel {row['ms']:.4f} ms, alone {row['device_ms']:.4f}; plain "
              f"{row['plain_ms']:.4f}; sdpa(enable_gqa) {row['library_ms']:.4f}, alone "
              f"{row['library_device_ms']:.4f}; bound {b_ms:.4f} ms ({by}); "
              f"max|d|/max|ref| vs plain {err:.3e} (limit {tol:g})")
        del q, k, v, qt, kt, vt, got, want
    return out


def vlm_phase(dev, E, gfid_matmul, flash, other_kernels, worst, host_weights=False):
    """Phase 13: llama-3.2-vision-11b at full width (see the module
    docstring). `other_kernels` must launch nothing. The phase's own
    weights are drawn on the card, or on the host with `host_weights`
    (`scripts/vlm_phase.py --host-weights`). Returns the numbers the
    kernels line and the summary print."""
    from repro_torch.configs.base import CROSS_ATTN, GLOBAL_ATTN, get_config
    from repro_torch.launch import serve as LS
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import tree_map
    from repro_torch.serve import engine as SE

    t_phase = time.perf_counter()
    cfg = get_config(VLM_MODEL)
    cuda = dev.type == "cuda"
    mm16, mm32 = gfid_matmul.gfid_matmul_bf16, gfid_matmul.gfid_matmul
    fa16, fa32 = flash.flash_attention_bf16, flash.flash_attention
    counted = (mm16, fa16, mm32, fa32) + tuple(other_kernels)
    kinds = cfg.layer_kinds
    n_self, n_cross = kinds.count(GLOBAL_ATTN), kinds.count(CROSS_ATTN)
    # a decode step: 7 GEMMs a self layer, a cross layer's wq, wo and FFN, the
    # lm_head; a prefill adds the cross layer's wk, wv twice (the attention's
    # and the cache's, as the reference projects them) and one flash a layer
    per_step, per_prefill = (n_self * 7 + n_cross * 5 + 1, n_self * 7 + n_cross * 9 + 1)

    def want(steps, prefills, per=(per_step, per_prefill), layers=cfg.n_layers,
             bf16=True):
        gemm = per[0] * steps + per[1] * prefills
        fa = layers * prefills if VLM_PROMPT > 1024 else 0   # flash past 1024
        run = (gemm, fa, 0, 0) if bf16 else (0, 0, gemm, fa)
        return run + (0,) * len(other_kernels)

    conf = E.EngineConfig(backend="cuda")
    nc16, nc32 = flash.flash_attention_bf16_noncausal, flash.flash_attention_noncausal
    flashed = VLM_PROMPT > 1024             # a cross layer's non-causal flash

    # the main path: the reference's `launch/serve.py` as a user runs it, on
    # the config's own weights (seed 0, every cross gate 0): VLM_BATCH
    # requests of VLM_PROMPT tokens, VLM_GEN greedy steps
    argv = ["--arch", VLM_MODEL, "--batch", str(VLM_BATCH), "--prompt-len",
            str(VLM_PROMPT), "--gen", str(VLM_GEN), "--seed", "0", "--device",
            dev.type]
    zero_counts(*counted, nc16, nc32)
    t0 = time.perf_counter()
    tokens_main = LS.main(argv)
    if cuda:
        torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches, cross_launches = counts(*counted), counts(nc16, nc32)
    require(launches == want(VLM_GEN - 1, 1), f"[vlm] launch/serve.py launched "
            f"{launches}, expected {want(VLM_GEN - 1, 1)} (gfid_matmul_bf16, "
            "flash_attention_bf16, gfid_matmul, flash_attention, others)")
    require(cross_launches == (n_cross * flashed, 0), f"[vlm] launch/serve.py "
            f"launched {cross_launches} non-causal flash (bf16, fp32), expected "
            f"({n_cross * flashed}, 0)")
    require(tokens_main.shape == (VLM_BATCH, VLM_GEN)
            and 0 <= int(tokens_main.min()) and int(tokens_main.max()) < cfg.vocab_size,
            f"[vlm] launch/serve.py returned tokens {tuple(tokens_main.shape)} out of "
            "shape or vocabulary")
    print(f"[vlm] launch/serve.py main ({' '.join(argv)}) in {main_s:.2f} s, its "
          f"weights drawn and both programs captured: {launches[0]} gfid_matmul_bf16 "
          f"= {per_prefill} a prefill + {VLM_GEN - 1} x {per_step} a decode step, "
          f"{launches[1]} flash_attention_bf16 of which {cross_launches[0]} non-causal "
          f"(counted apart; Skv {cfg.n_img_tokens}), nothing else")
    del tokens_main

    # the phase's own weights: the same draw (or the host's), at most one
    # fp32 leaf beside the bf16 ones
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    if host_weights:
        params = tree_map(lambda a: a.to(dev), T.init_params(cfg, seed=0, device="cpu"))
    else:
        params = T.init_params(cfg, seed=0, device=dev)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(p.numel() for p in leaves)
    w_bytes = sum(p.numel() * p.element_size() for p in leaves)
    largest32 = 4 * max(p.numel() for p in leaves)
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - base
        require(peak <= w_bytes + largest32 + 64 * 2**20, f"[vlm] initialising the "
                f"parameters held {peak / 1e9:.3f} GB on the card, more than the "
                f"{w_bytes / 1e9:.3f} GB of bf16 weights and one fp32 leaf "
                f"({largest32 / 1e9:.3f} GB)")
        print(f"[vlm] parameters made with a peak of {peak / 1e9:.3f} GB allocated "
              f"on the card: the bf16 weights {w_bytes / 1e9:.3f} GB + at most the "
              f"largest leaf in fp32 ({largest32 / 1e9:.3f} GB)")
    print(f"[vlm] {cfg.name}: {cfg.n_layers} layers ({n_self} self, {n_cross} cross), "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads "
          f"of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (untied "
          f"lm_head), {cfg.n_img_tokens} image tokens; {n_params} bf16 parameters "
          f"({w_bytes / 1e9:.3f} GB) from seed 0, drawn "
          f"{'on the card' if cuda and not host_weights else 'on the host'}, in "
          f"{init_s:.2f} s")

    # the gate: at the config's 0 an image moves nothing, bitwise; at
    # VLM_GATE two images give other logits
    gen = torch.Generator().manual_seed(13)
    short = torch.randint(0, cfg.vocab_size, (1, 64), generator=gen,
                          dtype=torch.int32).to(dev)
    imgs = [(torch.randn((1, cfg.n_img_tokens, cfg.d_model), generator=gen)
             .to(torch.bfloat16) * 0.1).to(dev) for _ in range(2)]

    def two_images():
        with E.using_config(conf), torch.no_grad():
            return [T.prefill(cfg, params, {"tokens": short, "image_embeds": im},
                              64)[0] for im in imgs]

    a, b = two_images()
    require(torch.equal(a, b), "[vlm] at the zero gate two images give other logits")
    gates = [p["attn"]["gate"] for p in params["groups"].values()
             if "gate" in p.get("attn", {})]
    require(sum(g.shape[0] for g in gates) == n_cross, "[vlm] gates")
    for g in gates:
        g.fill_(VLM_GATE)
    a, b = two_images()
    require(not torch.equal(a, b), f"[vlm] at gate {VLM_GATE} two images give "
            "equal logits")
    print(f"[vlm] gate: at the config's 0 two images give bitwise equal logits "
          f"(prompt 64); with every cross gate set to {VLM_GATE} they differ by "
          f"{rel_err(a, b):.3e} of max|logits|")
    del a, b

    # the same batch served by `launch/serve.py`'s `generate` at the gate
    # VLM_GATE, each step's logits kept, then each request alone. A
    # request's prefill logits in the batch are bitwise its own: the
    # prefill's GEMMs are row-invariant, flash runs a block per (request,
    # head) and every other op works per row. Later steps may part at a
    # near tie: the decode attention's batched products follow the row count
    max_len = VLM_PROMPT + VLM_GEN + 8
    batch = LS.make_batch(cfg, VLM_BATCH, VLM_PROMPT, 0, dev)
    rows = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(VLM_BATCH)]
    record = []
    tokens, _, _ = LS.generate(cfg, params, batch, VLM_GEN, conf, record=record)
    pre1 = E.compile(LS.prefill_program(cfg, rows[0], max_len, torch.bfloat16), conf)
    for i, r in enumerate(rows):
        solo = pre1.apply(params, r)[0].float()
        require(torch.equal(record[0][i:i + 1], solo), f"[vlm] request {i}: its "
                f"prefill logits in the batch of {VLM_BATCH} differ from the request "
                f"alone by {float((record[0][i:i + 1] - solo).abs().max()):.4e}")
    del pre1
    print(f"[vlm] each of {VLM_BATCH} requests' prefill logits in the batch bitwise "
          "the request alone (compiled prefill at 1 row)")
    with E.using_config(conf):
        alone = [SE.greedy_generate(cfg, params, r, VLM_GEN, max_len)[0] for r in rows]
    differ = [i for i in range(VLM_BATCH) if not torch.equal(alone[i], tokens[i])]
    for i in differ:
        step = int((alone[i] != tokens[i]).nonzero()[0])
        with E.using_config(conf):
            solo = greedy_logits(T, cfg, params, rows[i], step + 1, max_len)[step][0]
        batched = record[step][i]
        gap = min(float(top2_gap(batched)), float(top2_gap(solo)))
        diff = float((batched - solo).abs().max())
        print(f"[vlm] request {i}: tokens differ from the row alone from step "
              f"{step}; the top two logits there {gap:.4e} apart, the two runs' "
              f"largest logit difference {diff:.4e}")
        require(gap < diff, f"[vlm] request {i}: a token differs where the top "
                "two logits lie further apart than the runs' logits")
    print(f"[vlm] each of {VLM_BATCH} requests alone through greedy_generate: "
          f"{VLM_BATCH - len(differ)} bitwise the batched tokens, the rest at a "
          "near tie (above)")
    del record

    # "torch" against "cuda": the prefill and one decode step from one state
    pre = E.compile(LS.prefill_program(cfg, batch, max_len, torch.bfloat16), conf)
    dec = E.compile(SE.decode_program(cfg, VLM_BATCH, max_len,
                                      param_dtype=torch.bfloat16), conf)
    zero_counts(*counted, nc16, nc32)
    logits_c, state = pre.apply(params, batch)
    if cuda:
        torch.cuda.synchronize()
    prefill_launches = counts(*counted)
    require(prefill_launches == want(0, 1)
            and counts(nc16, nc32) == (n_cross * flashed, 0),
            f"[vlm] one prefill launched {prefill_launches} ({counts(nc16, nc32)} "
            f"non-causal flash), expected {want(0, 1)} ({n_cross * flashed} "
            "non-causal)")
    with E.using_config(conf.replace(backend="torch")), torch.no_grad():
        logits_t, _ = T.prefill(cfg, params, batch, max_len)
    tok = torch.argmax(logits_c, dim=-1)[:, None].to(torch.int32)
    pos = torch.tensor(VLM_PROMPT, dtype=torch.int32, device=dev)
    state_t = tree_map(lambda a: a.clone(), state)
    zero_counts(*counted)
    step_c = dec.apply(params, state, tok, pos)
    if cuda:
        torch.cuda.synchronize()
    step_launches = counts(*counted)
    require(step_launches == want(1, 0), f"[vlm] one decode step launched "
            f"{step_launches}, expected {want(1, 0)}")
    with E.using_config(conf.replace(backend="torch")), torch.no_grad():
        step_t, _ = T.decode_step(cfg, params, state_t, tok, pos)
    del state_t
    gaps = {}
    for what, c, t in (("prefill", logits_c, logits_t),
                       ("decode step", step_c[:, -1], step_t[:, -1])):
        gaps[what] = rel_err(c, t)
        same = torch.equal(c.argmax(-1), t.argmax(-1))
        print(f"[vlm] {what} at prompt {VLM_PROMPT}, {VLM_BATCH} rows: torch backend "
              f"within {gaps[what]:.3e} of cuda (limit {VLM_BF16_TOL}), argmax "
              f"{'equal' if same else 'differs'}")
        gaps[what + " argmax"] = same
    for what in ("prefill", "decode step"):
        require(gaps[what] <= VLM_BF16_TOL and gaps[what + " argmax"],
                f"[vlm] {what}: torch vs cuda {gaps[what]:.3e}, argmax equal "
                f"{gaps[what + ' argmax']}")
    # the control: the same "cuda" prefill with one self layer's seven
    # weights rounded through fp8 (layer 0: a GEMM that lost precision)
    # must read beyond VLM_BF16_TOL from the "torch" logits
    layer0 = params["groups"]["0"]
    held = {(a, w): layer0[a][w][0].clone() for a, ws in (
        ("attn", ("wq", "wk", "wv", "wo")), ("ffn", ("w_in", "w_gate", "w_out")))
        for w in ws}
    for (a, w) in held:
        layer0[a][w][0].copy_(fp8_rounded(layer0[a][w][0]))
    ctrl, _ = pre.apply(params, batch)
    control = rel_err(ctrl, logits_t)
    for (a, w), keep in held.items():
        layer0[a][w][0].copy_(keep)
    del held, ctrl
    print(f"[vlm] control: layer 0's wq, wk, wv, wo, w_in, w_gate and w_out "
          f"rounded through float8_e4m3fn (a scale a tensor): the cuda prefill "
          f"{control:.3e} from the torch backend (must exceed {VLM_BF16_TOL})")
    require(control > VLM_BF16_TOL, f"[vlm] the fp8 control reads {control:.3e}, "
            f"within VLM_BF16_TOL {VLM_BF16_TOL}: the limit would not see it")
    del logits_t, step_t

    # times: a decode step (wall, device, bound), the prefill, a profile
    step_ms = time_ms(lambda: dec.apply(params, state, tok, pos), iters=10)
    prof = device_profile(lambda: dec.apply(params, state, tok, pos))
    group = cfg.pattern
    unread = params["embed"].numel() * 2 + sum(
        params["groups"][str(j)]["attn"][w].numel() * 2
        for j, kind in enumerate(group) if kind == CROSS_ATTN for w in ("wk", "wv"))
    cache = 2 * VLM_BATCH * cfg.n_kv_heads * cfg.head_dim * 2 * (
        n_self * (VLM_PROMPT + 1) + n_cross * cfg.n_img_tokens)
    step_bytes = w_bytes - unread + VLM_BATCH * cfg.d_model * 2 + cache
    step_bound, _ = bound_ms(step_bytes, 2 * VLM_BATCH * (n_params - unread // 2),
                             PEAK_BF16_FLOP_S)
    busy = None
    if prof is None:
        print("[profile] [vlm] decode step: the profiler recorded no device time")
    else:
        busy, n_kernels, top = prof
        print(f"[profile] [vlm] decode step with {VLM_BATCH} rows at depth "
              f"{VLM_PROMPT}: {n_kernels} device kernels, {busy:.4f} ms of device "
              f"time (torch.profiler, 3 steps) = {100 * busy / step_ms:.1f}% of the "
              f"step; by kernel: "
              + "; ".join(f"{nm[:50]} x{c:g} {ms:.4f} ms" for nm, c, ms in top[:8]))
    prefill_ms = time_ms(lambda: pre.apply(params, batch), iters=3, warmup=1)
    print(f"[vlm] decode step, {VLM_BATCH} rows: {step_ms:.4f} ms wall (median of "
          f"10), {'not measured' if busy is None else f'{busy:.4f} ms'} of device "
          f"time; bound {step_bound:.4f} ms ({step_bytes / 1e9:.3f} GB read: the "
          f"weights but the embedding table and the cross wk/wv, "
          f"{(w_bytes - unread) / 1e9:.3f} GB, and the caches, {cache / 1e9:.3f} GB, "
          f"at {PEAK_BYTES_S / 1e12:.2f} TB/s); {VLM_BATCH / step_ms * 1e3:.1f} "
          f"tokens/s decoding")
    print(f"[vlm] prefill, {VLM_BATCH} x {VLM_PROMPT} tokens and {VLM_BATCH} x "
          f"{cfg.n_img_tokens} image tokens: {prefill_ms:.4f} ms (median of 3), "
          f"{VLM_BATCH * VLM_PROMPT / prefill_ms * 1e3:.1f} prompt tokens/s")
    pprof = device_profile(lambda: pre.apply(params, batch), steps=1)
    # each pass's GEMM (the kernel and its split-K reduce, both launched by
    # the wrapper's one call) and flash device time, read from its trace
    traced = {}
    for what, p in (("decode", prof), ("prefill", pprof)):
        traced[what] = None if p is None else dict(
            busy_ms=p[0], gemm=kernel_time(p, "gfid_matmul_bf16_kernel"),
            reduce=kernel_time(p, "splitk::split_reduce_kernel"),
            flash=kernel_time(p, "flash_attention_bf16_kernel"))
    if pprof is None:
        print("[profile] [vlm] prefill: the profiler recorded no device time")
    else:
        t = traced["prefill"]
        print(f"[profile] [vlm] prefill {VLM_BATCH} x {VLM_PROMPT}: {pprof[1]} device "
              f"kernels, {pprof[0]:.4f} ms of device time (torch.profiler, 1 prefill) "
              f"= {100 * pprof[0] / prefill_ms:.1f}% of the prefill; gfid_matmul_bf16 "
              f"{t['gemm'][0]:.4f} ms in {t['gemm'][1]:g} launches and its split-K "
              f"reduce {t['reduce'][0]:.4f} ms in {t['reduce'][1]:g} "
              f"({100 * (t['gemm'][0] + t['reduce'][0]) / pprof[0]:.1f}% of the "
              "device time together), "
              f"flash_attention_bf16 {t['flash'][0]:.4f} ms in {t['flash'][1]:g}; by "
              "kernel: " + "; ".join(f"{nm[:50]} x{c:g} {ms:.4f} ms"
                                     for nm, c, ms in pprof[2][:8]))
    del pre, dec, state, logits_c, step_c
    torch.cuda.empty_cache()
    gemm = vlm_gemm_timing(dev, gfid_matmul, cfg)
    # each pass's GEMMs beside their bound, the timed shapes' bounds summed
    # over the pass's launches
    passes = {}
    for what, n in vlm_pass_counts(n_self, n_cross).items():
        got = (step_launches if what == "decode" else prefill_launches)[0]
        require(sum(n.values()) == got, f"[vlm] {what}: {got} GEMM launches, "
                f"{sum(n.values())} by shape")
        t = traced[what]
        passes[what] = dict(
            device_ms=None if t is None else t["gemm"][0] + t["reduce"][0],
            reduce_ms=None if t is None else t["reduce"][0],
            traced_launches=None if t is None else t["gemm"][1],
            bound_ms=sum(gemm[k][lbl]["bound_ms"] * c for (k, lbl), c in n.items()))
        print(f"[vlm] {what}: its {got} gfid_matmul_bf16 calls "
              + ("not traced" if t is None else
                 f"{passes[what]['device_ms']:.4f} ms of device time in the trace "
                 f"(split-K reduce {t['reduce'][0]:.4f} of it)")
              + f", bound {passes[what]['bound_ms']:.4f} ms")
    lm = gemm["decode"]["lm_head"]
    print(f"[time] lm_head alone ({VLM_BATCH}, {cfg.d_model}) @ ({cfg.d_model}, "
          f"{cfg.vocab_size}): gfid_matmul_bf16 {lm['device_ms']:.4f} ms against bf16 "
          f"torch.mm {lm['library_device_ms']:.4f} ms, bound {lm['bound_ms']:.4f} ms")
    cross = vlm_flash_timing(dev, flash, cfg, worst)

    # what the full-depth gap is made of: request 0's prefill from the
    # weights widened to fp32 (39 GB beside the bf16 ones) on both backends
    params32 = tree_map(lambda a: a.float(), params)
    b16 = rows[0]
    b32 = dict(b16, image_embeds=b16["image_embeds"].float())
    deep = witness_logits(E, T, cfg, conf, params, params32, b16, b32, max_len,
                          "[vlm] full-depth witness")
    ratio = deep[2]["cuda"] / deep[2]["torch"]
    print(f"[vlm] full depth, request 0 at prompt {VLM_PROMPT}: cuda vs torch "
          f"{deep[0]:.3e} in bf16 (limit {VLM_BF16_TOL}), {deep[1]:.3e} from the "
          f"same weights in fp32 (limit {TOL}); distance from those fp32 logits: "
          f"cuda {deep[2]['cuda']:.3e}, torch {deep[2]['torch']:.3e} (ratio "
          f"{ratio:.3f}, limits {1 / BF16_FP32_RATIO:.3f} and {BF16_FP32_RATIO})")
    require(deep[0] <= VLM_BF16_TOL and deep[1] <= TOL
            and 1 / BF16_FP32_RATIO <= ratio <= BF16_FP32_RATIO,
            f"[vlm] full-depth witness: bf16 gap {deep[0]:.3e}, fp32 gap "
            f"{deep[1]:.3e}, ratio {ratio:.3f}")

    # fp32 at full width, one group (4 self layers and the cross layer): the
    # first group's weights widened; "torch" within TOL of "cuda", then the
    # bf16 witness on the same weights
    cfg1 = dataclasses.replace(cfg, n_layers=len(cfg.pattern))
    p16 = dict(params, groups=tree_map(lambda a: a[:1], params["groups"]))
    p32 = dict(params32, groups=tree_map(lambda a: a[:1], params32["groups"]))
    n32 = sum(a.numel() * 4 for a in _leaves(p32))
    per1 = (4 * 7 + 5 + 1, 4 * 7 + 9 + 1)
    zero_counts(*counted, nc16, nc32)
    with E.using_config(conf), torch.no_grad():
        l32c, st32 = T.prefill(cfg1, p32, b32, max_len)
    torch.cuda.synchronize()
    want1 = want(0, 1, per1, len(cfg.pattern), bf16=False)
    cross32 = counts(nc16, nc32)
    require(counts(*counted) == want1 and cross32 == (0, flashed), f"[vlm fp32] prefill "
            f"launched {counts(*counted)} ({cross32} non-causal flash), expected "
            f"{want1} (one non-causal fp32 flash)")
    with E.using_config(conf.replace(backend="torch")), torch.no_grad():
        l32t, _ = T.prefill(cfg1, p32, b32, max_len)
    tok1 = torch.argmax(l32c, dim=-1)[:, None]
    st32t = tree_map(lambda a: a.clone(), st32)
    zero_counts(*counted)
    with E.using_config(conf), torch.no_grad():
        d32c, _ = T.decode_step(cfg1, p32, st32, tok1, VLM_PROMPT)
    torch.cuda.synchronize()
    want1 = want(1, 0, per1, len(cfg.pattern), bf16=False)
    require(counts(*counted) == want1, f"[vlm fp32] decode step launched "
            f"{counts(*counted)}, expected {want1}")
    with E.using_config(conf.replace(backend="torch")), torch.no_grad():
        d32t, _ = T.decode_step(cfg1, p32, st32t, tok1, VLM_PROMPT)
    err32 = {"prefill": rel_err(l32c, l32t), "decode step": rel_err(d32c, d32t)}
    for what, err in err32.items():
        print(f"[vlm fp32] one group ({n32 / 1e9:.3f} GB of fp32 weights), {what} at "
              f"prompt {VLM_PROMPT}: torch backend within {err:.3e} of cuda (limit "
              f"{TOL})")
        require(err <= TOL, f"[vlm fp32] {what}: {err:.3e} > {TOL}")
    del st32, st32t, l32c, l32t, d32c, d32t
    gap1 = witness_check(E, T, cfg1, conf, p16, p32, b16, b32, max_len, "[vlm]",
                         f"one group, prompt {VLM_PROMPT}")
    del p32, p16, params, params32
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    print(f"[vlm] phase 13 took {phase_s:.1f} s (parameters {init_s:.1f} s)")
    return dict(init_s=init_s, main_s=main_s, launches=launches,
                cross_launches={"bfloat16": cross_launches[0], "float32": cross32[1]},
                step_launches=step_launches, prefill_launches=prefill_launches,
                step_ms=step_ms, busy_ms=busy, step_bound_ms=step_bound,
                prefill_ms=prefill_ms, traced=traced, passes=passes, gemm=gemm,
                cross=cross, gaps=gaps, control=control, err32=err32,
                witness_gap=gap1, deep=deep)


def vlm_pass_counts(n_self, n_cross):
    """How many launches of each timed GEMM row, (kind, label) of
    `vlm_gemm_timing`, a llama decode step and a prefill make: a self
    layer's wq, wo, wk, wv, w_in, w_gate, w_out; a cross layer's wq, wo and
    FFN, at a prefill its wk and wv twice on the image; the lm_head once,
    at a prefill on the last position of each request (decode rows)."""
    layers = n_self + n_cross
    body = {"wq/wo": 2 * layers, "w_in/w_gate": 2 * layers, "w_out": layers,
            "wk/wv": 2 * n_self}
    prefill = {("prefill", k): c for k, c in body.items()}
    prefill[("prefill", "image K/V")] = 4 * n_cross
    prefill[("decode", "lm_head")] = 1
    return {"decode": {("decode", k): c for k, c in dict(body, lm_head=1).items()},
            "prefill": prefill}


def local_flash_timing(dev, flash, cfg, worst):
    """Phase 15's flash rows at gemma2-27b's prefill shape, q (1, 4500, 32,
    128) against k, v (1, 4500, 16, 128), causal, softcap 50: the local
    layer's launch (window 4,096), the global one, and a band of
    LOCAL_BAND_WINDOW, on fp32 and bf16 operands, with the host and for the
    device alone, beside the plain version, the bound (the visible pairs'
    operations at the operands' peak) and the library call: eager
    `flex_attention` with the softcap as a `score_mod` and the window as a
    block mask ("none" where it does not run; SDPA takes no softcap).
    Returns {dtype name: {"local", "global", "band": row}}."""
    s, h, kv, d = LOCAL_PROMPTS[0], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cap = cfg.attn_softcap
    dgen = torch.Generator(device=dev).manual_seed(43)
    try:
        from torch.nn.attention.flex_attention import create_block_mask, flex_attention
    except ImportError:
        flex_attention = None

    # one mask function each, with code of its own: on the card, one
    # function read with other captured windows gave the global and band
    # calls the local call's mask
    def causal(b, hh, qi, ki):
        return qi >= ki

    def local(b, hh, qi, ki):
        return (qi >= ki) & (qi - ki < cfg.window_size)

    def band(b, hh, qi, ki):
        return (qi >= ki) & (qi - ki < LOCAL_BAND_WINDOW)

    masks = {"local": local, "global": causal, "band": band}
    out = {}
    for dtype, tol, peak in ((torch.float32, TOL, PEAK_FP32_FLOP_S),
                             (torch.bfloat16, BF16_FLASH_TOL, PEAK_BF16_FLOP_S)):
        kname = "flash_attention_bf16" if dtype == torch.bfloat16 else "flash_attention"
        q, k, v = (torch.randn(shape, generator=dgen, device=dev).to(dtype)
                   for shape in ((1, s, h, d), (1, s, kv, d), (1, s, kv, d)))
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        rows = {}
        for what, window in (("local", cfg.window_size), ("global", 0),
                             ("band", LOCAL_BAND_WINDOW)):
            kw = dict(causal=True, window=window, softcap=cap)
            got = flash.flash_attention(q, k, v, **kw)
            want = flash.flash_attention_plain(q, k, v, **kw)
            err = rel_err(got, want)
            require(err <= tol, f"{kname} gemma2 {what}: {err:.3e} > {tol}")
            worst[kname] = max(worst[kname],
                               (got.float() - want.float()).abs().max().item())
            b_ms, by = flash_bound(1, s, s, h, kv, d, True, q.element_size(), peak,
                                   window=window)
            lib_ms = lib_dev = None
            lib_note = "none (SDPA takes no softcap)"
            if flex_attention is not None:
                def score_mod(score, b, hh, qi, ki):
                    return cap * torch.tanh(score / cap)

                try:
                    bm = create_block_mask(masks[what], None, None, s, s, device=dev)

                    def lib():
                        return flex_attention(qt, kt, vt, score_mod=score_mod,
                                              block_mask=bm, enable_gqa=True)
                    lerr = rel_err(lib().transpose(1, 2), want)
                    lib_ms = time_ms(lib, iters=3, warmup=1)
                    lib_note = (f"flex_attention (eager) {lib_ms:.4f} ms, vs plain "
                                f"{lerr:.3e}")
                except Exception as e:      # the library call is read, not held
                    lib_note = f"none (flex_attention raised {type(e).__name__}: " \
                               f"{str(e)[:120]})"

            def kernel():
                return flash.flash_attention(q, k, v, **kw)

            row = dict(ms=time_ms(kernel), device_ms=graph_ms(kernel, calls=20),
                       plain_ms=time_ms(lambda: flash.flash_attention_plain(
                           q, k, v, **kw), iters=3, warmup=1),
                       library_ms=lib_ms, library_device_ms=lib_dev,
                       bound_ms=b_ms, bound_by=by,
                       pairs=visible_pairs(s, s, True, window))
            rows[what] = row
            print(f"[time] {kname} gemma2 {what} (1, {s}, {h}/{kv}, {d}) causal, "
                  f"window {window}, softcap {cap:g} ({row['pairs']} visible pairs): "
                  f"kernel {row['ms']:.4f} ms, alone {row['device_ms']:.4f}; plain "
                  f"{row['plain_ms']:.4f}; library {lib_note}; bound "
                  f"{b_ms:.4f} ms ({by}); max|d|/max|ref| vs plain {err:.3e} "
                  f"(limit {tol:g})")
            del got, want
        loc, glo = rows["local"], rows["global"]
        print(f"[time] {kname} gemma2: the local launch alone {loc['device_ms']:.4f} "
              f"ms against the global one's {glo['device_ms']:.4f} at the same shape "
              f"({loc['device_ms'] / glo['device_ms']:.3f}x; visible pairs "
              f"{loc['pairs'] / glo['pairs']:.3f}x), bound {loc['bound_ms']:.4f} "
              f"ms; the band of {LOCAL_BAND_WINDOW} {rows['band']['device_ms']:.4f} "
              f"ms ({rows['band']['pairs'] / glo['pairs']:.3f}x the pairs)")
        out[str(dtype)[6:]] = rows
        del q, k, v, qt, kt, vt
    return out


def local_phase(dev, E, gfid_matmul, paged, flash, other_kernels, worst):
    """Phase 15: gemma2-27b at full width and LOCAL_LAYERS deep, bf16
    parameters from seed 0 drawn on the card, served by the
    ContinuousScheduler (see the module docstring). `other_kernels` must
    launch nothing. Returns the numbers the kernels line and the summary
    print."""
    from repro_torch.configs.base import LOCAL_ATTN, get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import count_params, tree_map
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import (ContinuousScheduler,
                                             latency_percentiles)

    t_phase = time.perf_counter()
    full = get_config(LOCAL_MODEL)
    cfg = dataclasses.replace(full, n_layers=LOCAL_LAYERS)
    cuda = dev.type == "cuda"
    mm16, fa16, gather = (gfid_matmul.gfid_matmul_bf16, flash.flash_attention_bf16,
                          paged.paged_gather)
    loc16 = flash.flash_attention_bf16_local
    counted = (mm16, fa16, loc16, gather) + tuple(other_kernels)
    per_pass = cfg.n_layers * 7 + 1        # GEMMs of a decode step or a prefill
    n_local = cfg.layer_kinds.count(LOCAL_ATTN)
    conf = E.EngineConfig(backend="cuda", row_align=8)

    def flash_of(prompt):
        """(flash, local flash) launches of one prefill: one a layer past
        1024 tokens, the local layers' counted apart where the window cuts."""
        if prompt <= 1024:
            return 0, 0
        return cfg.n_layers, n_local * (cfg.window_size < prompt)

    # the full model on `meta`: parameters and the 46-layer programs
    n_full = count_params(T.model_defs(full))
    dec46 = SE.decode_program(full, 8, LOCAL_MAX_LEN)
    pre46 = SE.prefill_program(full, 1, LOCAL_PROMPTS[0], max_len=LOCAL_MAX_LEN)
    for prog in (dec46, pre46):
        kinds = [op.kind for op in prog.ops]
        require(kinds == ["dense"] * (full.n_layers * 7 + 1), f"[local] {prog.name}: "
                f"{len(kinds)} ops ({set(kinds)}), expected {full.n_layers * 7 + 1} "
                "GEMMs")
    require(n_full == 27_227_128_320, f"[local] {full.name}: {n_full} parameters")
    print(f"[local] {full.name} at full depth on meta: {n_full} parameters (the "
          f"reference's count), {len(dec46.ops)} GEMMs a decode step and "
          f"{len(pre46.ops)} a {LOCAL_PROMPTS[0]}-token prefill")
    del dec46, pre46

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    if cuda:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = list(_leaves(params))
    n_params = sum(p.numel() for p in leaves)
    w_bytes = sum(p.numel() * p.element_size() for p in leaves)
    largest32 = 4 * max(p.numel() for p in leaves)
    require(n_params == count_params(T.model_defs(cfg)), "[local] parameters")
    if cuda:
        peak = torch.cuda.max_memory_allocated(dev) - mem0
        require(peak <= w_bytes + largest32 + 64 * 2**20, f"[local] initialising "
                f"the parameters held {peak / 1e9:.3f} GB on the card, more than "
                f"the {w_bytes / 1e9:.3f} GB of bf16 weights and one fp32 leaf")
        print(f"[local] parameters made with a peak of {peak / 1e9:.3f} GB allocated "
              f"on the card: the bf16 weights {w_bytes / 1e9:.3f} GB + at most the "
              f"largest leaf in fp32 ({largest32 / 1e9:.3f} GB)")
    print(f"[local] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers "
          f"({' '.join(cfg.layer_kinds)}; {cfg.n_groups} groups), d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (tied), window "
          f"{cfg.window_size}, softcaps {cfg.attn_softcap:g} / {cfg.logit_softcap:g}; "
          f"{n_params} bf16 parameters ({w_bytes / 1e9:.3f} GB) from seed 0 drawn on "
          f"the card in {init_s:.2f} s")

    gen = torch.Generator().manual_seed(15)
    work = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist(), LOCAL_GEN)
            for n in LOCAL_PROMPTS]
    blocks = LOCAL_BATCH * LOCAL_MAX_LEN // LOCAL_BLOCK + 1

    def scheduler(max_batch, admission):
        return ContinuousScheduler(
            cfg, params, max_len=LOCAL_MAX_LEN, num_blocks=blocks,
            block_size=LOCAL_BLOCK, max_batch=max_batch, config=conf,
            admission=admission, max_slots=2 * LOCAL_BATCH + 1)

    runs, programs = {}, ({}, {})
    for mode, max_batch, admission in (("continuous", LOCAL_BATCH, "continuous"),
                                       ("drain", LOCAL_BATCH, "drain"),
                                       ("solo", 1, "continuous")):
        s = scheduler(max_batch, admission)
        s._prefill, s._decode = programs
        t0 = time.perf_counter()
        compiled = [s.prefill_compiled(n) for n in sorted(set(LOCAL_PROMPTS))] \
            + [s.decode_compiled(b) for b in s.buckets]
        compile_s = time.perf_counter() - t0
        for c in compiled:
            kinds = [op.kind for op in c.program.ops]
            want_ops = per_pass + 2 * ("decode" in c.program.name)
            require(set(c.backends()) == {"cuda"} and len(kinds) == want_ops
                    and kinds.count("gather") == want_ops - per_pass,
                    f"[local] {mode} {c.program.name}: {len(kinds)} ops, expected "
                    f"{want_ops}")
        ring = s.layout.specs["groups"]["0"]["k"]
        require(not ring.paged and s.layout.specs["groups"]["1"]["k"].paged,
                "[local] the local ring must be a slot store, the global cache paged")
        tickets = [s.submit(p, n) for p, n in work]
        zero_counts(*counted)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.run()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = s.stats()
        launches = counts(*counted)
        require(all(t.status == "done" and t.preemptions == 0 for t in tickets),
                f"[local] {mode}: not every request done without preemption")
        fl = [flash_of(len(p)) for p, _ in work]
        want = (per_pass * (st["steps"] + st["admitted"]), sum(f for f, _ in fl),
                sum(lf for _, lf in fl), 2 * st["steps"]) + (0,) * len(other_kernels)
        require(launches == want, f"[local] {mode}: launches (gfid_matmul_bf16, "
                f"flash_attention_bf16, its local count, paged_gather, others) = "
                f"{launches}, expected {want} for {st['steps']} decode steps and "
                f"{st['admitted']} prefills")
        n_tok = sum(len(t.tokens) for t in tickets)
        lat = latency_percentiles(tickets)
        runs[mode] = dict(tokens=[t.tokens for t in tickets], wall=wall, n_tok=n_tok,
                          lat=lat, stats=st, launches=launches)
        print(f"[local] {mode}: {st['steps']} decode steps (buckets "
              f"{st['compiled_decode_buckets']}), {st['admitted']} prefills, {n_tok} "
              f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; latency p50 "
              f"{lat['p50_ms']:.1f} ms, p95 {lat['p95_ms']:.1f} ms; launches "
              f"gfid_matmul_bf16 {launches[0]} (= {per_pass} a step and a prefill), "
              f"flash_attention_bf16 {launches[1]} ({launches[2]} local: window "
              f"{cfg.window_size} < Skv), paged_gather {launches[3]} (2 a step: the "
              f"global k and v; the rings are slot rows), others {sum(launches[4:])}; "
              f"{len(compiled)} programs ready in {compile_s:.2f} s beforehand")
    base = runs["continuous"]["tokens"]
    for mode in ("drain", "solo"):
        require(runs[mode]["tokens"] == base, f"[local] {mode} tokens differ from the "
                "continuous run")
    with E.using_config(conf):
        for i, (prompt, steps) in enumerate(work):
            dense = SE.greedy_generate(cfg, params, {"tokens": torch.tensor(
                [prompt], device=dev)}, steps, LOCAL_MAX_LEN)
            require(dense[0].tolist() == base[i], f"[local] request {i} (prompt "
                    f"{len(prompt)}): paged tokens differ from greedy_generate's")
    print(f"[local] tokens bitwise equal across continuous, drain and solo, and "
          f"equal to greedy_generate for all {len(work)} requests (prompts "
          f"{LOCAL_PROMPTS})")

    # one decode step with the four requests live at the 8-row bucket, and
    # the two flash prefills through their compiled ingest programs
    s8 = scheduler(LOCAL_BATCH, "continuous")
    s8._prefill, s8._decode = programs
    rows = [s8.submit(p, LOCAL_MAX_LEN - len(p)) for p, _ in work]
    s8.step()                               # admits 4, runs one decode step
    require(s8.running() == LOCAL_BATCH, f"[local] {s8.running()} rows running")
    dec = s8.decode_compiled(8)
    rids = [t.rid for t in rows]
    args = (params, s8.pool.arrays, s8.pool.table_rows(rids, 8),
            s8.pool.slot_rows(rids, 8),
            torch.tensor([[t.tokens[-1]] for t in rows] + [[0]] * (8 - LOCAL_BATCH),
                         dtype=torch.int32, device=dev),
            torch.tensor([t.pos for t in rows] + [0] * (8 - LOCAL_BATCH),
                         dtype=torch.int32, device=dev))
    snap = [a.clone() for a in _leaves(s8.pool.arrays)]
    zero_counts(*counted)
    dec.apply(*args)
    if cuda:
        torch.cuda.synchronize()
    step_launches = counts(*counted)
    require(step_launches == (per_pass, 0, 0, 2) + (0,) * len(other_kernels),
            f"[local] one decode step launched {step_launches}")
    step_ms = time_ms(lambda: dec.apply(*args), iters=10)
    prof = device_profile(lambda: dec.apply(*args))
    busy = None if prof is None else prof[0]
    prefill_ms, prefill_bound = {}, {}
    embed_n = params["embed"].numel()
    for i, n in enumerate(LOCAL_PROMPTS[:2]):
        pre = s8.prefill_compiled(n)
        row = s8.pool.table_rows([rows[i].rid], 1)[0]
        slot = s8.pool.slot_rows([rows[i].rid], 1)[0]
        prompt = torch.tensor([work[i][0]], dtype=torch.int32, device=dev)
        zero_counts(*counted)
        pre.apply(params, s8.pool.arrays, row, slot, prompt)
        if cuda:
            torch.cuda.synchronize()
        one = counts(*counted)
        want = (per_pass, *flash_of(n), 0) + (0,) * len(other_kernels)
        require(one == want, f"[local] a {n}-token prefill launched {one}, expected "
                f"{want}")
        prefill_ms[n] = time_ms(lambda: pre.apply(params, s8.pool.arrays, row, slot,
                                                  prompt), iters=3, warmup=1)
        # the bound: every weight read once; the layers' GEMMs on the
        # prompt's rows (not the 8x of the padding), the unembedding on its
        # last row, and each attention's visible pairs
        pairs = sum(visible_pairs(n, n, True, cfg.window_size if kind == LOCAL_ATTN
                                  else 0) for kind in cfg.layer_kinds)
        ops = 2 * n * (n_params - embed_n) + 2 * embed_n \
            + 4 * cfg.n_heads * cfg.head_dim * pairs
        prefill_bound[n] = bound_ms(w_bytes, ops, PEAK_BF16_FLOP_S)[0]
        print(f"[local] batch-1 prefill at prompt {n}: {prefill_ms[n]:.4f} ms (median "
              f"of 3; its GEMMs padded to 8 rows by row_align), "
              f"{n / prefill_ms[n] * 1e3:.1f} prompt tokens/s, bound "
              f"{prefill_bound[n]:.4f} ms ({ops / 1e12:.3f} TFLOP at the prompt's rows); "
              f"launches {one[0]} gfid_matmul_bf16, {one[1]} flash_attention_bf16 "
              f"({one[2]} local)")
    for a, b in zip(_leaves(s8.pool.arrays), snap):
        a.copy_(b)
    del snap
    # a step reads every weight once (the tied table whole, by the
    # unembedding) and each live row's visible keys and values once: a
    # local layer's last min(pos + 1, window), a global layer's pos + 1
    kv_bytes = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    cache = kv_bytes * sum(
        n_local * min(t.pos + 1, cfg.window_size)
        + (cfg.n_layers - n_local) * (t.pos + 1) for t in rows)
    step_bytes = w_bytes + cache
    step_bound, _ = bound_ms(step_bytes, 2 * 8 * n_params, PEAK_BF16_FLOP_S)
    print(f"[local] decode step, {LOCAL_BATCH} live rows at bucket 8: {step_ms:.4f} ms "
          f"wall (median of 10), "
          + ("device time not measured" if busy is None else
             f"{busy:.4f} ms of device time (torch.profiler, 3 steps) = "
             f"{100 * busy / step_ms:.1f}% of the step")
          + f"; bound {step_bound:.4f} ms ({step_bytes / 1e9:.3f} GB: the weights and "
          f"the visible keys and values, at {PEAK_BYTES_S / 1e12:.2f} TB/s); launches "
          f"{step_launches[0]} gfid_matmul_bf16 + {step_launches[3]} paged_gather, no "
          "flash")
    if prof is not None:
        print(f"[profile] [local] decode step: {prof[1]} device kernels; by kernel: "
              + "; ".join(f"{nm[:50]} x{c:g} {ms:.4f} ms" for nm, c, ms in prof[2][:8]))
    embed = params["embed"]
    copy_ms = time_ms(lambda: embed.T.contiguous(), iters=5)
    print(f"[time] [local] tied unembedding: the (vocab, d_model) table's transpose "
          f"copy before the GEMM (kernels/ops.py) {copy_ms:.4f} ms "
          f"({embed.numel() * embed.element_size() / 1e9:.3f} GB read and written) of "
          f"a {step_ms:.4f} ms decode step")
    del dec, s8, args
    torch.cuda.empty_cache()

    # "torch" against "cuda": the witness at the two flash prompts, from
    # the bf16 weights and from the same weights widened to fp32
    params32 = tree_map(lambda a: a.float(), params)
    wconf = E.EngineConfig(backend="cuda")
    witness = {}
    for i, n in enumerate(LOCAL_PROMPTS[:2]):
        batch = {"tokens": torch.tensor([work[i][0]], dtype=torch.int32, device=dev)}
        witness[n] = witness_check(E, T, cfg, wconf, params, params32, batch, batch,
                                   LOCAL_MAX_LEN, "[local]", f"prompt {n}", limit=None)
    del params32
    torch.cuda.empty_cache()
    timing = local_flash_timing(dev, flash, cfg, worst)
    del params
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    cont = runs["continuous"]
    print(f"[local] phase 15 took {phase_s:.1f} s (parameters {init_s:.1f} s)")
    return dict(launches=cont["launches"], step_launches=step_launches,
                prefill_launches=per_pass, step_ms=step_ms, busy_ms=busy,
                step_bound_ms=step_bound, prefill_ms=prefill_ms,
                prefill_bound_ms=prefill_bound, copy_ms=copy_ms,
                tps=cont["n_tok"] / cont["wall"], lat=cont["lat"], witness=witness,
                timing=timing, init_s=init_s, n_params=n_params)


def tuner_phase(dev, E, cnn, kernels):
    """Phase 14: the kernel tuner (see the module docstring). `kernels`
    maps "fp32", "int8" and "bf16" to the (conv, matmul) launch counters of
    that precision's AlexNet entries. Returns the numbers of its
    summary."""
    import tempfile

    from repro_torch.configs.base import get_config
    from repro_torch.engine import tune
    from repro_torch.serve import engine as SE
    from repro_torch.serve.scheduler import Scheduler

    t_phase = time.perf_counter()
    counters = tuple(c for pair in kernels.values() for c in pair)
    dtypes = {"fp32": torch.float32, "int8": torch.float32,
              "bf16": torch.bfloat16}
    params = {p: cnn.init_cnn("alexnet", seed=0, device=DEVICE, dtype=dtypes[p])
              for p in TUNE_PRECISIONS}

    def config(prec, tuning, **kw):
        return E.EngineConfig(backend="cuda", tuning=tuning, precision=(
            "int8" if prec == "int8" else "fp32"), **kw)

    def image(batch, prec, seed=14):
        return torch.randn((batch, *cnn.ALEXNET_INPUT), generator=torch.Generator(
        ).manual_seed(seed + batch)).to(dev).to(dtypes[prec])

    def keyed(net, prec):
        """{key: (op, precision)} of the net's tuned ops, a key once."""
        out = {}
        for op, plan in net.exec_pairs:
            if plan.tile_config is not None:
                key = tune.tile_key(op, "cuda", None, plan.precision, dtypes[prec])
                out.setdefault(key, (op, plan.precision))
        return out

    def winners(net, prec):
        """The cache's tile of each op of `net` (None: not in the cache)."""
        entries = tune.load_cache()["entries"]
        return tuple(
            tuple(entries[key]["tile"]) if key in entries else None
            for key in (tune.tile_key(op, "cuda", None, plan.precision, dtypes[prec])
                        for op, plan in net.exec_pairs))

    with tempfile.TemporaryDirectory() as root:
        dirs = {b: Path(root) / f"batch{b}" for b in BATCHES}
        runs = [("alexnet", p, BATCHES[0]) for p in TUNE_PRECISIONS] \
            + [(n, "fp32", BATCHES[0]) for n in TUNE_OTHER_NETS] \
            + [("alexnet", p, b) for b in BATCHES[1:] for p in TUNE_PRECISIONS]
        # 1. autotune
        tuned, rows, tune_s = {}, [], {}
        for net_name, prec, batch in runs:
            tune.set_cache_dir(dirs[batch])
            t0 = time.perf_counter()
            net = E.compile(cnn.program(net_name, batch=batch, dtype=dtypes[prec]),
                            config(prec, "autotune"))
            tune_s[(net_name, prec, batch)] = time.perf_counter() - t0
            require(all(t is not None for t in net.tiles()),
                    f"tune {net_name} {prec} B={batch}: untuned ops in {net.tiles()}")
            tuned[(net_name, prec, batch)] = net
            entries = tune.load_cache()["entries"]
            for key, (op, p) in keyed(net, prec).items():
                e = entries[key]
                own = "x".join(map(str, e["default_tile"]))
                win = "x".join(map(str, e["tile"]))
                rows.append(dict(net=net_name, prec=prec, batch=batch, key=key,
                                 op=op, precision=p, desc=e["desc"],
                                 candidates=e["candidates"], default=own,
                                 default_us=e["timings_us"][own], winner=win,
                                 winner_us=e["device_us"]))
                print(f"[tune] {net_name} {prec} B={batch}: {e['desc']}, rows "
                      f"{e['rows']}: {e['candidates']} candidates; rule {own} "
                      f"{e['timings_us'][own]:.2f} µs, winner {win} "
                      f"{e['device_us']:.2f} µs; "
                      + " ".join(f"{t} {us:.2f}" for t, us in e["timings_us"].items()))
            print(f"[tune] {net_name} {prec} B={batch}: compile with autotune "
                  f"{tune_s[(net_name, prec, batch)]:.2f} s")
        # 2. every candidate bitwise the rule's tile
        n_bitwise = 0
        for r in rows:
            run = tune.tile_runner(r["op"], r["precision"], dtypes[r["prec"]],
                                   device=DEVICE, seed=14)
            want = run(None)
            for t in tune.candidates_for(r["op"], precision=r["precision"],
                                         dtype=dtypes[r["prec"]]):
                require(torch.equal(run(t), want),
                        f"tune {r['net']} {r['prec']} B={r['batch']} {r['desc']}: "
                        f"tile {t} is not bitwise the rule's tile's output")
                n_bitwise += 1
            del run, want
        print(f"[tune] every candidate of {len(rows)} tuned ops bitwise equal to "
              f"the rule's tile's output ({n_bitwise} launches)")
        # 3. a cached compile is the tuned net; its logits the untuned ones
        off, cached = {}, {}
        for batch in BATCHES:
            tune.set_cache_dir(dirs[batch])     # the memo dropped
            for prec in TUNE_PRECISIONS:
                prog = cnn.program("alexnet", batch=batch, dtype=dtypes[prec])
                o = E.compile(prog, config(prec, "off"))
                c = E.compile(prog, config(prec, "cached"))
                require(c.tiles() == winners(c, prec)
                        == tuned[("alexnet", prec, batch)].tiles()
                        and o.tiles() == (None,) * 8,
                        f"cached {prec} B={batch}: tiles {c.tiles()}, cache "
                        f"{winners(c, prec)}, off {o.tiles()}")
                require(c.backends() == o.backends()
                        and c.precisions() == o.precisions(),
                        f"cached {prec} B={batch}: backends or precisions moved")
                x = image(batch, prec)
                want = o.apply(params[prec], x)
                zero_counts(*counters)
                got = c.apply(params[prec], x)
                torch.cuda.synchronize()
                launches = counts(*counters)
                conv_k, mm_k = kernels[prec]
                expect = tuple(5 if k is conv_k else 3 if k is mm_k else 0
                               for k in counters)
                require(launches == expect, f"cached {prec} B={batch}: launches "
                        f"{launches}, expected {expect}")
                require(torch.equal(got, want), f"cached {prec} B={batch}: logits "
                        "not bitwise the untuned net's")
                off[(prec, batch)], cached[(prec, batch)] = o, c
        print(f"[tune] cached AlexNet at B={', '.join(map(str, BATCHES))} in "
              f"{', '.join(TUNE_PRECISIONS)}: tiles() the cache's winners, "
              "backends and precisions unchanged, 5 + 3 launches, logits bitwise "
              "the untuned net's")
        # 4. the static Scheduler under "cached"
        tune.set_cache_dir(dirs[BATCHES[0]])
        waves = [w[0] for w in SCHED_WAVES]
        gen = torch.Generator().manual_seed(140)
        images = [torch.randn((1, *cnn.ALEXNET_INPUT), generator=gen).to(dev)
                  for _ in range(sum(waves))]
        tiles1 = {p: tuned[("alexnet", p, BATCHES[0])].tiles() for p in TUNE_PRECISIONS}
        for prec in TUNE_PRECISIONS:
            solo = E.compile(cnn.program("alexnet", dtype=dtypes[prec]),
                             config(prec, "off", row_align=8))
            sched = Scheduler(config=config(prec, "cached", row_align=8),
                              max_batch=8)
            sched.register("alexnet", cnn.program("alexnet", dtype=dtypes[prec]),
                           shared_args=(params[prec],))
            sched.warmup()
            for b in sched.buckets:
                require(sched.compiled("alexnet", b).tiles() == tiles1[prec],
                        f"sched {prec} bucket {b}: tiles "
                        f"{sched.compiled('alexnet', b).tiles()}")
            served, i = [], 0
            for n in waves:
                served += [(j, sched.submit("alexnet", images[j].to(dtypes[prec])))
                           for j in range(i, i + n)]
                i += n
                sched.drain()
            for j, t in served:
                require(t.done and torch.equal(
                    t.result, solo.apply(params[prec], images[j].to(dtypes[prec]))),
                    f"sched {prec} cached: request {j} (bucket {t.batch_bucket}) "
                    "not bitwise the request alone untuned")
            require(sched.stats()["tuning"] == "cached",
                    f"sched stats tuning {sched.stats()['tuning']}")
            print(f"[tune] Scheduler {prec} under cached: {len(served)} requests "
                  f"in buckets {sorted({t.batch_bucket for _, t in served})}, "
                  "each bitwise the request alone untuned; every bucket on the "
                  "batch-1 tiles; stats tuning 'cached'")
        # 5. a corrupted and a stale cache degrade to the rules
        good = json.loads(tune.cache_path().read_text())
        bad = Path(root) / "bad"
        bad.mkdir()
        for label, text in (("corrupted", "{not json"), ("stale", json.dumps(
                dict(good, version=tune.CACHE_VERSION + 1)))):
            (bad / f"{tune.device_kind()}.json").write_text(text)
            tune.set_cache_dir(bad)
            for prec in TUNE_PRECISIONS:
                c = E.compile(cnn.program("alexnet", dtype=dtypes[prec]),
                              config(prec, "cached"))
                x = image(1, prec)
                require(c.tiles() == (None,) * 8 and torch.equal(
                    c.apply(params[prec], x), off[(prec, 1)].apply(params[prec], x)),
                    f"{label} cache {prec}: tiles {c.tiles()} or logits moved")
            print(f"[tune] a {label} cache: tiles() all None, logits bitwise the "
                  "untuned net's in each precision")
        # 6. AlexNet's forward, tuned and untuned
        fwd = {}
        for prec in TUNE_PRECISIONS:
            for batch in BATCHES:
                x = image(batch, prec)
                nets = {"untuned": off[(prec, batch)], "tuned": cached[(prec, batch)]}
                if batch != BATCHES[0]:
                    tune.set_cache_dir(dirs[BATCHES[0]])
                    nets["tiles of B=1"] = E.compile(
                        cnn.program("alexnet", batch=batch, dtype=dtypes[prec]),
                        config(prec, "cached"))
                for label, net in nets.items():
                    fwd[(prec, batch, label)] = time_ms(
                        lambda: net.apply(params[prec], x))
                print(f"[tune] alexnet {prec} B={batch}: forward "
                      + ", ".join(f"{label} {fwd[(prec, batch, label)]:.4f} ms"
                                  for label in nets)
                      + " (median of 20)")
        # 7. smollm-135m's decode GEMMs
        cfg = get_config(SERVE_MODEL)
        tune.set_cache_dir(dirs[BATCHES[0]])
        prog = SE.decode_program(cfg, TUNE_DECODE_BUCKET, SCHED_MAX_LEN,
                                 param_dtype=torch.float32)
        t0 = time.perf_counter()
        n_lm = tune.tune_program(prog.ops, E.EngineConfig(backend="cuda",
                                                          tuning="autotune"))
        lm_s = time.perf_counter() - t0
        entries = tune.load_cache()["entries"]
        lm_keys = {tune.tile_key(op, "cuda", None) for op in prog.ops} - {None}
        require(len(lm_keys) == 5 and n_lm == len(
            [op for op in prog.ops if tune.tile_key(op, "cuda", None)]),
            f"smollm decode: {len(lm_keys)} GEMM keys, {n_lm} ops tuned")
        lm_rows = []
        for key in sorted(lm_keys, key=lambda k: entries[k]["desc"]):
            e = entries[key]
            own = "x".join(map(str, e["default_tile"]))
            lm_rows.append((e["desc"], own, e["timings_us"][own],
                            "x".join(map(str, e["tile"])), e["device_us"]))
            print(f"[tune] {cfg.name} decode M={TUNE_DECODE_BUCKET} {e['desc']}: "
                  f"{e['candidates']} candidates; rule {own} "
                  f"{e['timings_us'][own]:.2f} µs, winner {lm_rows[-1][3]} "
                  f"{e['device_us']:.2f} µs")
        print(f"[tune] {cfg.name} decode program: {n_lm} GEMM ops tuned ({len(lm_keys)} "
              f"shapes) in {lm_s:.2f} s")
        tune.set_cache_dir(None)
    changed = sum(r["winner"] != r["default"] for r in rows)
    took = time.perf_counter() - t_phase
    print(f"[tune] phase 14 took {took:.1f} s: {len(rows)} tuned ops, {changed} "
          f"won by another tile than the rule's; autotune compiles "
          f"{sum(tune_s.values()):.2f} s")
    return dict(rows=rows, fwd=fwd, lm=lm_rows, changed=changed,
                n_bitwise=n_bitwise, tune_s=sum(tune_s.values()), took=took)


def kernel_time(prof, name):
    """(device ms, launches) a call of the kernels in a `device_profile`
    whose name holds `name`."""
    rows = [r for r in prof[2] if name in r[0]]
    return sum(r[2] for r in rows), sum(r[1] for r in rows)


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
    card_numerics()
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
            + bf16_mm_cases(gen, dev) + vlm_mm_cases(dev))}
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
    from repro_torch.configs.base import get_config
    checks += row_invariance_check(dev, mm32, 33)
    checks += row_invariance_check(dev, mm32, 31,
                                   shapes=vlm_gemm_shapes(get_config(VLM_MODEL)),
                                   rows=VLM_INVARIANCE_ROWS)
    checks += row_invariance_check(dev, mm32, 32, torch.float32)
    checks += grouped_check(dev, gfid_matmul, torch.Generator().manual_seed(28),
                            worst)
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
    fp32_cases = flash_cases(gen, dev) + flash_cross_cases(
        torch.Generator().manual_seed(30), dev)
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
    checks += local_flash_check(dev, flash_attention, worst)
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

    # -- phase 4e: AlexNet int8 on bf16 parameters -------------------------------
    started["4e"] = time.perf_counter()
    for batch in BATCHES:
        x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                        generator=torch.Generator().manual_seed(batch)).to(dev)
        x = x.to(bf16)
        prog = cnn.program("alexnet", batch=batch, dtype=bf16)
        compiled = E.compile(prog, int8_cfg)
        require(compiled.backends() == ("cuda",) * 8
                and compiled.precisions() == ("int8",) * 8,
                f"int8 on bf16: backends {compiled.backends()}, precisions "
                f"{compiled.precisions()}")
        zero_counts(*all_kernels, *bf16_kernels)
        logits = compiled.apply(params, x)
        torch.cuda.synchronize()
        launches = counts(*all_kernels, *bf16_kernels)
        require(launches == (0, 0, 5, 3, 0, 0), f"int8 on bf16 B={batch}: "
                f"launches (conv, matmul, conv int8, matmul int8, conv bf16, "
                f"matmul bf16) = {launches}, expected (0, 0, 5, 3, 0, 0)")
        main_launches.setdefault("int8 bf16", launches[2:4])
        require(tuple(logits.shape) == (batch, 1000) and logits.dtype == bf16
                and bool(torch.isfinite(logits).all()), "bad int8 bf16 logits")
        ref = E.compile(prog, int8_cfg.replace(backend="torch")).apply(params, x)
        n_diff = int((logits != ref).sum().item())
        require(n_diff == 0, f"int8 on bf16 B={batch}: {n_diff} logits differ "
                "from the torch backend under int8")
        f32 = E.compile(cnn.program("alexnet", batch=batch),
                        E.EngineConfig(backend="cuda")).apply(params32, x.float())
        snr = quant.snr_db(f32, logits).item()
        require(snr >= SNR_FLOOR_DB, f"int8 on bf16 B={batch}: SNR {snr:.2f} dB "
                f"< {SNR_FLOOR_DB}")
        ms = time_ms(lambda: compiled.apply(params, x))
        forward_ms[("int8 bf16", batch)] = ms
        # the forward's quantization alone, from bf16 inputs
        q16 = [(kind, qx.to(bf16), qw.to(bf16)) for kind, qx, qw in (
            [("conv", kw["x"], kw["w"]) for _, _, kw in conv_main[batch]]
            + [("fc", kw["x"], kw["w"]) for _, _, kw in fc_main[batch]])]

        def quantize_all16():
            for kind, qx, qw in q16:
                if kind == "conv":
                    quant.quantize_conv_operands(qx, qw)
                else:
                    quant.quantize_matmul_operands(qx, qw)

        q_ms = time_ms(quantize_all16)
        forward_ms[("quant bf16", batch)] = q_ms
        print(f"[alexnet int8 bf16] B={batch}: bf16 parameters under int8, every op "
              f"int8 on cuda, launches conv int8={launches[2]} matmul int8="
              f"{launches[3]} (others {sum(launches) - launches[2] - launches[3]}), "
              f"logits bf16 bitwise equal to the torch backend, SNR vs the fp32 "
              f"forward from the same weights {snr:.2f} dB (floor {SNR_FLOOR_DB})")
        print(f"[alexnet int8 bf16] B={batch}: {ms:.4f} ms/forward (median of 20), "
              f"{batch / ms * 1e3:.1f} images/s; quantization alone {q_ms:.4f} ms "
              f"({100 * q_ms / ms:.1f}% of the forward); phase 4a's int8 forward on "
              f"fp32 inputs {forward_ms[('int8', batch)]:.4f} ms (quantization "
              f"{forward_ms[('quant', batch)]:.4f} ms)")
    del params, params32

    # -- phase 4f: AlexNet fp32 under policy="auto" ------------------------------
    started["4f"] = time.perf_counter()
    params = cnn.init_cnn("alexnet", seed=0, device=DEVICE)
    for fallback in ("torch", "ref"):
        for batch in BATCHES:
            x = torch.randn((batch, *cnn.ALEXNET_INPUT),
                            generator=torch.Generator().manual_seed(batch)).to(dev)
            prog = cnn.program("alexnet", batch=batch)
            compiled = E.compile(prog, E.EngineConfig(backend=fallback,
                                                      policy="auto"))
            ops = [op for op, _ in compiled.exec_pairs]
            chosen = tuple(E.auto_backend(op, fallback) for op in ops)
            require(compiled.backends() == chosen, f"auto {fallback}: backends "
                    f"{compiled.backends()}, auto_backend {chosen}")
            on_cuda = [op.kind for op, b in zip(ops, chosen) if b == "cuda"]
            want = (on_cuda.count("conv2d"), on_cuda.count("dense"), 0, 0)
            zero_counts(*all_kernels)
            logits = compiled.apply(params, x)
            torch.cuda.synchronize()
            launches = counts(*all_kernels)
            require(launches == want, f"auto {fallback} B={batch}: launches "
                    f"{launches}, expected {want}")
            plain = E.compile(prog, E.EngineConfig(backend=fallback))
            err = rel_err(logits, plain.apply(params, x))
            require(err <= TOL, f"auto {fallback} B={batch}: logits vs the "
                    f"all-{fallback} apply {err:.3e} > {TOL}")
            ms = time_ms(lambda: compiled.apply(params, x))
            ms_plain = time_ms(lambda: plain.apply(params, x), iters=5)
            forward_ms[("auto " + fallback, batch)] = ms
            print(f"[alexnet auto] fallback {fallback} B={batch}: backends "
                  f"{' '.join(compiled.backends())} (auto_backend of each op), "
                  f"launches conv={launches[0]} matmul={launches[1]}, logits "
                  f"max|d|/max|ref| vs the all-{fallback} apply {err:.3e}; "
                  f"{ms:.4f} ms/forward (median of 20) against phase 4's all-cuda "
                  f"{forward_ms[('fp32', batch)]:.4f} and all-{fallback} "
                  f"{ms_plain:.4f} (median of 5)")
    # the rule's grounds: each AlexNet layer through the engine on each backend
    for batch in BATCHES:
        for label, spec, kw in conv_main[batch] + fc_main[batch]:
            conv = "stride" in kw

            def op_call():
                if conv:
                    return E.conv2d(kw["x"], kw["w"], stride=kw["stride"],
                                    pad=kw["pad"], groups=kw["groups"],
                                    bias=kw["bias"], act=kw["act"])
                return E.dense(kw["x"], kw["w"], bias=kw["bias"], act=kw["act"])

            per = {}
            for backend in E.backend_names():
                with E.using_config(E.EngineConfig(backend=backend)):
                    per[backend] = time_ms(op_call, iters=20 if backend == "cuda"
                                           else 5)
            op = E.OpSpec("conv2d" if conv else "dense", tuple(kw["x"].shape),
                          tuple(kw["w"].shape), spec="" if conv
                          else E.dense_spec(kw["x"].ndim),
                          stride=kw.get("stride", 1), pad=kw.get("pad", 0),
                          groups=kw.get("groups", 1))
            print(f"[auto] {label}: the engine op on cuda {per['cuda']:.4f} ms, "
                  f"torch {per['torch']:.4f} ms, ref {per['ref']:.4f} ms (median of "
                  f"20 / 5 / 5); auto_backend picks {E.auto_backend(op, 'torch')} "
                  f"over torch, {E.auto_backend(op, 'ref')} over ref")
    del params

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
    lm_params = served.pop("params")        # phase 11 serves them again

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

    # -- phase 11: smollm-135m fp32 under faults ------------------------------
    started["11"] = time.perf_counter()
    torch.cuda.empty_cache()
    chaos = chaos_phase(dev, E, gfid_matmul, paged, others, served, lm_params)
    del lm_params

    # -- phase 12: granite-moe-1b, the grouped GEMM's path ----------------------
    started["12"] = time.perf_counter()
    torch.cuda.empty_cache()
    moe = moe_phase(dev, E, gfid_matmul, paged, flash_attention,
                    all_kernels[:1] + all_kernels[2:]
                    + (conv16, conv1d.gfid_conv1d_depthwise))

    # -- phase 13: llama-3.2-vision-11b, cross attention at full width ---------
    started["13"] = time.perf_counter()
    torch.cuda.empty_cache()
    vlm = vlm_phase(dev, E, gfid_matmul, flash_attention,
                    all_kernels[2:] + (conv16, conv1d.gfid_conv1d_depthwise,
                                       paged.paged_gather,
                                       gfid_matmul.gfid_matmul_grouped,
                                       gfid_matmul.gfid_matmul_bf16_grouped), worst)

    # -- phase 14: the kernel tuner --------------------------------------------
    started["14"] = time.perf_counter()
    torch.cuda.empty_cache()
    tuner = tuner_phase(dev, E, cnn, {"fp32": (conv32, mm32), "int8": (conv8, mm8),
                                      "bf16": (conv16, mm16)})

    # -- phase 15: gemma2-27b, local attention at full width -------------------
    started["15"] = time.perf_counter()
    torch.cuda.empty_cache()
    local = local_phase(dev, E, gfid_matmul, paged, flash_attention,
                        all_kernels + (conv16, conv1d.gfid_conv1d_depthwise,
                                       flash_attention.flash_attention,
                                       flash_attention.flash_attention_local,
                                       gfid_matmul.gfid_matmul_grouped,
                                       gfid_matmul.gfid_matmul_bf16_grouped), worst)
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
        # phase 13's cross-attention launch, q (4, 1100, 32, 128) against k,
        # v (4, 1601, 8, 128), timed alone; the non-causal launches counted in
        # the main path's run (bf16) and the one-group fp32 prefill (fp32)
        dt = "bfloat16" if kname.endswith("bf16") else "float32"
        kernels[-1]["cross"] = dict(vlm["cross"][dt], launches=vlm["cross_launches"][dt])
        # phase 15's gemma2-27b launches, q (1, 4500, 32, 128) against k, v
        # (1, 4500, 16, 128), causal, softcap 50, each timed alone: the local
        # layer's (window 4,096), the global one's and a band of
        # LOCAL_BAND_WINDOW; the launches of phase 15's continuous run (bf16)
        kernels[-1]["gemma2"] = dict(local["timing"][dt])
        if dt == "bfloat16":
            kernels[-1]["gemma2"].update(launches=local["launches"][1],
                                         local_launches=local["launches"][2])
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
    # phase 13: llama-3.2-vision-11b's GEMMs, counted in the main path's run,
    # a decode step and a prefill; each pass's device time from its trace
    # beside its bound; each shape timed alone
    kernels[-1]["llama"] = dict(
        launches=vlm["launches"][0], launches_per_decode_step=vlm["step_launches"][0],
        launches_per_prefill=vlm["prefill_launches"][0],
        decode_step=vlm["passes"]["decode"], prefill=vlm["passes"]["prefill"],
        shapes=vlm["gemm"])
    # phase 15: gemma2-27b's GEMMs (4 layers), counted in its continuous run
    kernels[-1]["gemma2"] = dict(launches=local["launches"][0],
                                 launches_per_decode_step=local["step_launches"][0],
                                 launches_per_prefill=local["prefill_launches"])
    for kname, dtype in (("gfid_matmul_grouped", torch.float32),
                         ("gfid_matmul_bf16_grouped", torch.bfloat16)):
        m, slot = moe[dtype], 3 if dtype == torch.bfloat16 else 2
        sums = {t: {key: sum(r[key] for r in rows) for key in (
            "ms", "device_ms", "plain_ms", "library_ms", "library_device_ms",
            "bound_ms", "n_bytes", "ops")} for t, rows in m["timing"].items()}
        peak = PEAK_BF16_FLOP_S if dtype == torch.bfloat16 else PEAK_FP32_FLOP_S
        dec = sums[SERVE_BATCH]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "src/repro_torch/csrc/" + ("gfid_matmul_bf16.cu" if slot == 3
                                                  else "gfid_matmul.cu"),
            "replaces": "src/repro/kernels/gfid_matmul.py:85",
            # phase 12's continuous run; a decode step's
            "launches": m["launches"][slot],
            "launches_per_decode_step": m["step_launches"][slot],
            "max_abs_err": worst[kname],
            # one layer's three grouped launches at a decode step's 8 rows
            **dict.fromkeys(("ms", "kernel_ms"), dec["ms"]),
            "device_ms": dec["device_ms"], "plain_ms": dec["plain_ms"],
            "bound_ms": dec["bound_ms"],
            "bound_by": bound_ms(dec["n_bytes"], dec["ops"], peak)[1],
            "library_ms": dec["library_ms"],
            "library_device_ms": dec["library_device_ms"],
            f"prompt{MOE_TIMED_PROMPT}": {key: sums[MOE_TIMED_PROMPT][key] for key in (
                "ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                "library_device_ms")}})
    loc_t = local["timing"]["bfloat16"]
    print(f"[local] summary: {local['tps']:.1f} tokens/s, p50 "
          f"{local['lat']['p50_ms']:.1f} ms, p95 {local['lat']['p95_ms']:.1f} ms; "
          f"decode step {local['step_ms']:.4f} ms with {LOCAL_BATCH} rows, device time "
          + ("not measured" if local["busy_ms"] is None else f"{local['busy_ms']:.4f} ms")
          + f", bound {local['step_bound_ms']:.4f} ms; prefill "
          + ", ".join(f"({n}) {ms:.4f} ms" for n, ms in local["prefill_ms"].items())
          + f"; bf16 flash alone local {loc_t['local']['device_ms']:.4f} ms, global "
          f"{loc_t['global']['device_ms']:.4f} ms, bound "
          f"{loc_t['local']['bound_ms']:.4f} ms; transpose copy {local['copy_ms']:.4f} ms")
    print(f"[tune] summary: {len(tuner['rows'])} tuned ops, {tuner['changed']} won by "
          f"another tile than the rule's, {tuner['n_bitwise']} candidate launches "
          f"bitwise; AlexNet forward ms untuned/tuned: " + "; ".join(
              f"{p} B={b} {tuner['fwd'][(p, b, 'untuned')]:.4f}/"
              f"{tuner['fwd'][(p, b, 'tuned')]:.4f}" for p in TUNE_PRECISIONS
              for b in BATCHES) + f"; phase {tuner['took']:.1f} s")
    print(f"[vlm] summary: decode step {vlm['step_ms']:.4f} ms with {VLM_BATCH} rows, "
          "device time " + ("not measured" if vlm["busy_ms"] is None
                            else f"{vlm['busy_ms']:.4f} ms")
          + f", bound {vlm['step_bound_ms']:.4f} ms; prefill({VLM_BATCH} x "
          f"{VLM_PROMPT}) {vlm['prefill_ms']:.4f} ms; torch vs cuda "
          f"{vlm['gaps']['prefill']:.3e} (prefill), {vlm['gaps']['decode step']:.3e} "
          f"(step), fp8 control {vlm['control']:.3e}; prefill GEMMs "
          + ("not traced" if vlm["passes"]["prefill"]["device_ms"] is None
             else f"{vlm['passes']['prefill']['device_ms']:.4f} ms traced")
          + f"; fp32 one group {vlm['err32']['prefill']:.3e}, "
          f"{vlm['err32']['decode step']:.3e}; parameters {vlm['init_s']:.1f} s")
    for dtype, m in moe.items():
        print(f"[moe{' bf16' if dtype == torch.bfloat16 else ''}] summary: "
              f"{m['tps']:.1f} tokens/s, p50 {m['lat']['p50_ms']:.1f} ms, p95 "
              f"{m['lat']['p95_ms']:.1f} ms; decode step {m['step_ms']:.4f} ms with "
              f"{SERVE_BATCH} live rows, device time "
              + ("not measured" if m["busy_ms"] is None else f"{m['busy_ms']:.4f} ms")
              + f", bound {m['step_bound_ms']:.4f} ms; prefill({MOE_LONG_PROMPT}) "
              f"{m['prefill_ms']:.4f} ms")
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
