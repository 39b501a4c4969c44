// GFID convolution on int8 operands (NHWC x HWIO -> NHWC) with an exact int32
// accumulator and a fused dequant + bias + activation epilogue, fp32 out, for
// Hopper (sm_90a), as an implicit GEMM on the int8 tensor cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_conv.py
//   gfid_conv2d_nhwc_int8 (_accumulate_int8, _kernel_int8), together with the
//   quantize-then-pad and group glue of src/repro/kernels/ops.py::
//   _gfid_conv2d_int8 (the operands arrive quantized; padding and groups are
//   handled here).
//
// What bounds it on an H100: at AlexNet batch 1 the five convs do 666 M
//   multiply-adds on about 5 MB of traffic (int8 inputs and weights, fp32
//   outputs), at batch 32 21.3 G on 63 MB: under the card's 1,979 TOP/s
//   int8 tensor-core rate the bytes are the floor at both. In practice
//   shared-memory traffic (each A and B byte is staged once and read by
//   `ldmatrix`) and, at batch 1, the few output pixels of conv3-5 (169) and
//   the launch bound it.
//
// What the design does about it: the conv is one GEMM per group. Its rows
//   are the output pixels (b, h_out, w_out), flattened across rows and
//   images, so no tile idles on the 13-wide rows of conv3-5 or ends at an
//   image; its columns are the group's C_out; its K runs over (j, i, c),
//   H_f x W_f x C_in/groups in HWIO order, so the B tile is a slab of w
//   viewed as (H_f W_f cg, C_out) at column g * og. Each product is an
//   `mma.sync.m16n8k32` s8 x s8 -> s32 (512 multiply-adds an instruction,
//   against __dp4a's 4), through csrc/mma_int8.cuh: a 4-stage ring of A and
//   of B as it lies in w, B transposed one chunk ahead into channel-major
//   shared memory with `__byte_perm` (sm_90 has no 8-bit ldmatrix.trans),
//   both read by `ldmatrix.x4`. The A tile is gathered from x with bounds
//   masks for the padding (no padded copy): a block decodes its rows'
//   (b, h0, w0) once into shared memory; with cg % 16 == 0 (conv2-5: 48,
//   256, 192, 192) each 16 channels of one tap are one 16-byte `cp.async`,
//   zero-filled at the pad; conv1 (cg = 3, K = 363) and ragged shapes
//   gather byte by byte into words, zero past K. w goes by 16-byte
//   `cp.async` of 16 channels of one K row where og % 16 == 0 (all of
//   AlexNet's), else byte by byte. The group is a grid
//   axis beside the column blocks, each row decodes its image for sx[b],
//   and the wrapper picks the block tile (128 x 128, 64 x 64 or 32 x 64,
//   kernels/gfid_conv.py::int8_plan) to fill the 132 SMs. Where even 32-row
//   tiles leave the card idle (batch 1's conv2-5), K is split across at
//   most kMaxSplit = 4 blocks (kernels/gfid_conv.py INT8_MAX_SPLIT: the
//   splits that chip_smoke.py checks on the card; the entry refuses more)
//   that form one thread block cluster: each block adds a share of the
//   tile's int32 sums from every block through distributed shared memory
//   and runs the epilogue on that share. No workspace, no memset, one
//   launch; integer sums are exact in any order, so every tile and split
//   gives the same bits.
//   The epilogue is `dequant_epilogue` of epilogue.cuh with scale =
//   sx[b] * sw[c_out], one fp32 multiply: bitwise the plain version's for act
//   none and relu.
//
// int32 range: |acc| <= K * 127^2; AlexNet's largest K is conv3's 3 x 3 x 256
//   = 2304, at most 3.7e7, far below 2^31. The wrapper refuses K above
//   133,144.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_int8.cuh"

namespace {

// The widest block tile (kernels/gfid_conv.py TILE_INT8, the engine plan's
// tiling): output pixels, K bytes a chunk, output channels.
constexpr int kPixTile = 128;
constexpr int kKc = 64;
constexpr int kCoutTile = 128;
static_assert(kKc == mma8::kKc, "the chunk is the core's");
// The most splits of K (kernels/gfid_conv.py INT8_MAX_SPLIT), one cluster.
constexpr int kMaxSplit = 4;
static_assert(kMaxSplit <= mma8::kMaxCluster, "a tile's splits are one portable cluster");

struct Geometry {
  int B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups;
};

constexpr int kOffRow = -(1 << 29);  // h0 of a row past the last pixel: every tap misses

template <class T, bool kCluster>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gfid_conv_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                      const float* __restrict__ sx, const float* __restrict__ sw,
                      const float* __restrict__ bias, float* __restrict__ out, Geometry d,
                      int chunks_per_split, int act, int vec_x, int vec_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int4 rows[T::BM];  // (b, h_in of tap row 0, w_in of tap column 0, -)
  const int tid = threadIdx.x;
  const int cg = d.C_in / d.groups;
  const int og = d.C_out / d.groups;
  const int ncb = (og + T::BN - 1) / T::BN;
  const int m0 = blockIdx.x * T::BM;
  const int g = blockIdx.y / ncb;
  const int n0 = (blockIdx.y % ncb) * T::BN;  // within the group
  const int hw = d.H_out * d.W_out;
  const int P = d.B * hw;
  const int K = d.H_f * d.W_f * cg;
  const int n_chunks = (K + kKc - 1) / kKc;
  const int begin = blockIdx.z * chunks_per_split;
  const int end = min(n_chunks, begin + chunks_per_split);
  const int8_t* xg = x + (size_t)g * cg;
  const int8_t* wg = w + (size_t)g * og;

  for (int r = tid; r < T::BM; r += T::kThreads) {
    const int p = m0 + r;
    int4 v = make_int4(0, kOffRow, kOffRow, 0);
    if (p < P) {
      const int ho = (p % hw) / d.W_out;
      v = make_int4(p / hw, ho * d.stride - d.pad, (p % d.W_out) * d.stride - d.pad, 0);
    }
    rows[r] = v;
  }
  __syncthreads();

  // The x byte of row r at tap (j, i), channel c of the group, or null in
  // the padding.
  const int4* row_at = rows;
  auto tap = [&](int r, int j, int i, int c) -> const int8_t* {
    const int4 v = row_at[r];
    const int h = v.y + j;
    const int wi = v.z + i;
    if ((unsigned)h >= (unsigned)d.H_in || (unsigned)wi >= (unsigned)d.W_in) return nullptr;
    return xg + (((size_t)v.x * d.H_in + h) * d.W_in + wi) * d.C_in + c;
  };

  auto load = [&](int chunk, uint8_t* As, uint8_t* Bn) {
    const int k0 = chunk * kKc;
    if (vec_x) {  // a piece is 16 channels of one tap: cg % 16 == 0
      constexpr int kPer = kKc / 16;
      const int k = k0 + (tid % kPer) * 16;  // the same for each of this thread's rows
      const int ji = k / cg;
      const int j = ji / d.W_f;
      const int i = ji % d.W_f;
      const int c = k % cg;
      for (int idx = tid; idx < T::BM * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const int8_t* src = k < K ? tap(r, j, i, c) : nullptr;
        mma8::cp_async16(As + r * mma8::kAStride + k - k0, src != nullptr ? src : x,
                         src != nullptr);
      }
    } else {  // a word is 4 K bytes of one row, gathered byte by byte
      constexpr int kWords = kKc / 4;
      const int kw = 4 * (tid % kWords);  // the same for each of this thread's rows
      int tj[4], ti[4], tc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = k0 + kw + e;
        const int ji = k / cg;
        tc[e] = k % cg;
        tj[e] = k < K ? ji / d.W_f : kOffRow;  // past K: no tap
        ti[e] = ji % d.W_f;
      }
      static_assert(T::BM * kWords % T::kThreads == 0, "whole rounds of words");
#pragma unroll
      for (int it = 0; it < T::BM * kWords / T::kThreads; ++it) {  // every load in flight at once
        const int r = (tid + it * T::kThreads) / kWords;
        uint32_t word = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int8_t* src = tap(r, tj[e], ti[e], tc[e]);
          if (src != nullptr) word |= (uint32_t)(uint8_t)__ldg(src) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(As + r * mma8::kAStride + kw) = word;
      }
    }
    // B: K rows k0 .. k0 + kKc - 1 of the group's columns n0 .. n0 + BN - 1
    // as they lie in w; zeros past K or og
    if (vec_w) {  // og % 16 == 0: a piece is 16 columns, all in or all out
      constexpr int kPer = T::BN / 16;
      for (int idx = tid; idx < kKc * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const int n = n0 + (idx % kPer) * 16;
        const bool ok = k0 + r < K && n < og;
        mma8::cp_async16(Bn + r * T::kBStride + n - n0,
                         ok ? wg + (size_t)(k0 + r) * d.C_out + n : w, ok);
      }
    } else {  // a word is 4 columns of one K row, gathered byte by byte
      constexpr int kPer = T::BN / 4;
      for (int idx = tid; idx < kKc * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const int n = n0 + (idx % kPer) * 4;
        uint32_t word = 0u;
        if (k0 + r < K) {
          const int8_t* src = wg + (size_t)(k0 + r) * d.C_out + n;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < og) word |= (uint32_t)(uint8_t)__ldg(src + e) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(Bn + r * T::kBStride + n - n0) = word;
      }
    }
  };

  int acc[T::MT][T::NT][4];
  mma8::mainloop<T>(load, begin, end, smem, acc);
  mma8::Share share{0u, 1u};
  if constexpr (kCluster) share = mma8::cluster_sum<T>(acc, reinterpret_cast<int*>(smem));

  // out is (B H_out W_out, C_out): NHWC with the pixels flattened.
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = m0 + (warp % T::WM) * (T::BM / T::WM) + lane / 4;
  const int col0 = n0 + (warp / T::WM) * (T::BN / T::WN) + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // c0, c1: row g; c2, c3: row g + 8
      const int r = row0 + mt * 16 + half * 8;
      if (r >= P) continue;
      const int b = r / hw;
      float* orow = out + (size_t)r * d.C_out + (size_t)g * og;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col0 + nt * 8 + e;
          if (n >= og || !share.mine((mt * T::NT + nt) * 4 + half * 2 + e)) continue;
          const int col = g * og + n;
          orow[n] = dequant_epilogue(acc[mt][nt][half * 2 + e], __fmul_rn(sx[b], sw[col]), bias,
                                     col, act);
        }
    }
}

}  // namespace

// xq (B, H_in, W_in, C_in) and wq (H_f, W_f, C_in/groups, C_out) int8; sx (B,)
// and sw (C_out,) fp32; bias (C_out,) fp32 or null; out (B, H_out, W_out,
// C_out) fp32. (bm, bn) is a block tile of mma8::with_tile; K is cut into
// splits runs of chunks_per_split chunks of kKc bytes, and with splits > 1
// (at most kMaxSplit) the splits of each output tile run as one cluster. vec_x:
// 16-byte copies of x, for cg % 16 == 0 on a 16-byte aligned xq; vec_w:
// 16-byte copies of w, for og % 16 == 0 on a 16-byte aligned wq. act: 0 none,
// 1 relu, 2 gelu. Launches on `stream` and returns cudaGetLastError() (0
// when accepted; cudaErrorInvalidValue for another tile or split).
extern "C" int gfid_conv2d_nhwc_int8(const void* xq, const void* wq, const float* sx,
                                     const float* sw, const float* bias, float* out, int B,
                                     int H_in, int W_in, int C_in, int H_f, int W_f,
                                     int C_out, int H_out, int W_out, int stride, int pad,
                                     int groups, int bm, int bn, int splits,
                                     int chunks_per_split, int act, int vec_x, int vec_w,
                                     void* stream) {
  if (splits < 1 || splits > kMaxSplit) return (int)cudaErrorInvalidValue;
  const Geometry d{B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups};
  const int8_t* xb = static_cast<const int8_t*>(xq);
  const int8_t* wb = static_cast<const int8_t*>(wq);
  const long long P = (long long)B * H_out * W_out;
  const cudaStream_t s = (cudaStream_t)stream;
  return mma8::with_tile(bm, bn, [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid((unsigned)((P + T::BM - 1) / T::BM),
                    groups * ((C_out / groups + T::BN - 1) / T::BN), splits);
    if (splits > 1)
      return mma8::launch<T, true>(gfid_conv_int8_kernel<T, true>, grid, s, xb, wb, sx, sw,
                                   bias, out, d, chunks_per_split, act, vec_x, vec_w);
    return mma8::launch<T, false>(gfid_conv_int8_kernel<T, false>, grid, s, xb, wb, sx, sw,
                                  bias, out, d, chunks_per_split, act, vec_x, vec_w);
  });
}
