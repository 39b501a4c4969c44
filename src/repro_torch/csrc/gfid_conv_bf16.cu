// GFID convolution on bf16 operands (NHWC x HWIO -> NHWC) with fp32 sums and a
// fused bias + activation epilogue, stored in fp32 or rounded once to bf16,
// for Hopper (sm_90a), as an implicit GEMM on the tensor cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_conv.py
//   gfid_conv2d_nhwc (_accumulate, _kernel, _kernel_epilogue) on bf16
//   operands, together with the padding, group and output-cast glue of
//   src/repro/kernels/ops.py::gfid_conv2d.
//
// What bounds it on an H100: at AlexNet batch 32 the bf16 tensor cores: the
//   five convs do 21.3 G multiply-adds on 22 MB of bf16 traffic, above the
//   ~295 operations a byte where 989 TFLOP/s overtakes 3.35 TB/s. At batch 1
//   (0.67 G multiply-adds on 6.9 MB) the bytes, and in practice the latency
//   of a few small launches.
//
// What the design does about it: the conv is one GEMM per group. Its rows
//   are the output pixels (b, h_out, w_out), flattened across rows and
//   images, so no tile idles on the 13-wide rows of conv3-5; its columns
//   are the group's C_out; its K runs over (j, i, c), H_f x W_f x C_in/groups
//   in HWIO order, so the B tile is a plain slab of w viewed as
//   (H_f W_f cg, C_out) at column g * og. The A tile is gathered from x with
//   bounds masks for the padding (no padded copy): a block decodes its rows'
//   (b, h0, w0) once into shared memory, and with cg % 8 == 0 (conv2-5) each
//   8 channels of one tap are one 16-byte `cp.async`, zero-filled at the
//   pad; conv1 (cg = 3) and ragged shapes gather element by element. The
//   tiles, the 4-stage ring and the bf16 `mma.sync.m16n8k16` with fp32
//   accumulators are csrc/mma_bf16.cuh's. The group is a grid axis beside
//   the column blocks. The wrapper picks the tile (128 x 128, 64 x 64 or
//   32 x 64) to fill the 132 SMs and takes the split of K from one
//   image's plan: where one image's blocks leave the card idle (batch 1's
//   169-pixel conv3-5), K is split, at every batch the same. Where the
//   batch's blocks leave the card idle, each split is a block on grid z,
//   reduced in split order by split_reduce_kernel; where they fill it, each
//   block runs every split and adds them in the same order itself (a fold,
//   split_k.cuh's fold_split, on the 64- and 32-row tiles: the 128 x 128
//   tile's ring leaves no room for its running sums). No atomics, so a
//   result is deterministic, and an image's sums are the same at any
//   batch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::kBK;
using mma::kPieces;

struct Geometry {
  int B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups;
};

constexpr int kOffRow = -(1 << 29);  // h0 of a row past the last pixel: every tap misses

// The shared memory a fold adds after the ring: a thread's running sums.
template <class T>
constexpr size_t kFoldSums = sizeof(float) * T::MT * T::NT * 4 * T::kThreads;

// kFold: the block runs every split of K and folds them (grid z is 1);
// otherwise it runs split blockIdx.z.
template <class T, bool kFold>
__global__ void __launch_bounds__(T::kThreads)
gfid_conv_bf16_kernel(mma::Epilogue e, const uint16_t* __restrict__ x,
                      const uint16_t* __restrict__ w, Geometry d, int chunks_per_split,
                      int vec_x, int vec_w) {
  extern __shared__ __align__(16) uint16_t smem[];
  __shared__ int4 rows[T::BM];  // (b, h_in of tap row 0, w_in of tap column 0, -)
  const int tid = threadIdx.x;
  const int cg = d.C_in / d.groups;
  const int og = d.C_out / d.groups;
  const int ncb = (og + T::BN - 1) / T::BN;
  const int g = blockIdx.x / ncb;
  const int n0 = (blockIdx.x % ncb) * T::BN;  // within the group
  const int m0 = blockIdx.y * T::BM;
  const int P = d.B * d.H_out * d.W_out;
  const int K = d.H_f * d.W_f * cg;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int begin = kFold ? 0 : blockIdx.z * chunks_per_split;
  const int end = kFold ? n_chunks : min(n_chunks, begin + chunks_per_split);
  const uint16_t* xg = x + (size_t)g * cg;
  const uint16_t* wg = w + (size_t)g * og;

  for (int r = tid; r < T::BM; r += T::kThreads) {
    const int p = m0 + r;
    int4 v = make_int4(0, kOffRow, kOffRow, 0);
    if (p < P) {
      const int hw = d.H_out * d.W_out;
      const int ho = (p % hw) / d.W_out;
      v = make_int4(p / hw, ho * d.stride - d.pad, (p % d.W_out) * d.stride - d.pad, 0);
    }
    rows[r] = v;
  }
  __syncthreads();

  // The x element of row r at tap (j, i), channel c of the group, or null in
  // the padding.
  const int4* row_at = rows;
  auto tap = [&](int r, int j, int i, int c) -> const uint16_t* {
    const int4 v = row_at[r];
    const int h = v.y + j;
    const int wi = v.z + i;
    if ((unsigned)h >= (unsigned)d.H_in || (unsigned)wi >= (unsigned)d.W_in) return nullptr;
    return xg + (((size_t)v.x * d.H_in + h) * d.W_in + wi) * d.C_in + c;
  };

  auto load = [&](int chunk, uint16_t* As, uint16_t* Bs) {
    const int k0 = chunk * kBK;
    if (vec_x) {  // a piece is 8 channels of one tap: cg % 8 == 0
      constexpr int kPer = kBK / kPieces;
      const int k = k0 + (tid % kPer) * kPieces;  // the same for each of this thread's rows
      const int ji = k / cg;
      const int j = ji / d.W_f;
      const int i = ji % d.W_f;
      const int c = k % cg;
      for (int idx = tid; idx < T::BM * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const uint16_t* src = k < K ? tap(r, j, i, c) : nullptr;
        mma::cp_async16(As + r * mma::kAStride + k - k0, src != nullptr ? src : x,
                        src != nullptr);
      }
    } else {
      const int k = k0 + tid % kBK;  // kThreads % kBK == 0: fixed for the thread
      const int ji = k / cg;
      const int j = ji / d.W_f;
      const int i = ji % d.W_f;
      const int c = k % cg;
      for (int idx = tid; idx < T::BM * kBK; idx += T::kThreads) {
        const int r = idx / kBK;
        const uint16_t* src = k < K ? tap(r, j, i, c) : nullptr;
        As[r * mma::kAStride + k - k0] = src != nullptr ? __ldg(src) : (uint16_t)0;
      }
    }
    if (vec_w) {  // og % 8 == 0 and C_out % 8 == 0
      for (int idx = tid; idx < kBK * (T::BN / kPieces); idx += T::kThreads) {
        const int r = idx / (T::BN / kPieces);
        const int n = n0 + (idx % (T::BN / kPieces)) * kPieces;
        const bool ok = k0 + r < K && n < og;
        mma::cp_async16(Bs + r * T::kBStride + n - n0,
                        ok ? wg + (size_t)(k0 + r) * d.C_out + n : w, ok);
      }
    } else {
      for (int idx = tid; idx < kBK * T::BN; idx += T::kThreads) {
        const int r = idx / T::BN;
        const int n = n0 + idx % T::BN;
        Bs[r * T::kBStride + n - n0] = (k0 + r < K && n < og)
                                             ? __ldg(wg + (size_t)(k0 + r) * d.C_out + n)
                                             : (uint16_t)0;
      }
    }
  };

  float acc[T::MT][T::NT][4];
  auto& flat = reinterpret_cast<float(&)[T::MT * T::NT * 4]>(acc);
  // under a fold, after the ring (the ring's bf16 stages end 16-byte aligned)
  float* sum = reinterpret_cast<float*>(smem + mma::kStages * T::kStage);
  int split_end = chunks_per_split;
  mma::mainloop<T>(load, begin, end, smem, acc, [&](int t) {
    if constexpr (kFold)
      splitk::fold_split<T::kThreads>(sum, flat, t + 1, end - begin, chunks_per_split,
                                      split_end);
  });
  if constexpr (kFold)
    splitk::fold_finish<T::kThreads>(sum, flat, end - begin, chunks_per_split);
  float* ws = e.ws == nullptr ? nullptr : e.ws + (size_t)blockIdx.z * P * d.C_out;
  mma::store_tile<T>(acc, e, ws, m0, P, n0, og, g * og, d.C_out);
}

}  // namespace

// x (B, H_in, W_in, C_in) NHWC and w (H_f, W_f, C_in / groups, C_out) HWIO
// bf16; bias (C_out,) fp32 (bias_bf16 = 0), bf16 (1) or null; out (B, H_out,
// W_out, C_out) fp32 (out_bf16 = 0) or bf16 (1). (bm, bn) is a block tile of
// mma::with_tile. With splits > 1 and ws an fp32 workspace of splits x B
// H_out W_out x C_out (not zeroed: every element is written), each split is
// a block on grid z and a second kernel adds them; with splits > 1 and ws
// null, each block runs every split and adds them itself (a fold); with
// splits == 1, ws is not read. act: 0 none, 1 relu, 2 gelu. Launches on
// `stream` and returns cudaGetLastError() (0 when accepted;
// cudaErrorInvalidValue for another tile).
extern "C" int gfid_conv2d_nhwc_bf16(const void* x, const void* w, const void* bias,
                                     void* out, float* ws, int bias_bf16, int out_bf16,
                                     int B, int H_in, int W_in, int C_in, int H_f, int W_f,
                                     int C_out, int H_out, int W_out, int stride, int pad,
                                     int groups, int bm, int bn, int splits,
                                     int chunks_per_split, int act, int vec_x, int vec_w,
                                     void* stream) {
  const mma::Epilogue e{bias, bias_bf16, out, out_bf16, ws, act};
  const Geometry d{B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups};
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  const long long P = (long long)B * H_out * W_out;
  return mma::with_tile(bm, bn, [&](auto tile) {
    using T = decltype(tile);
    const bool fold = splits > 1 && ws == nullptr;
    const dim3 grid(groups * ((C_out / groups + T::BN - 1) / T::BN),
                    (unsigned)((P + T::BM - 1) / T::BM), fold ? 1 : splits);
    if (fold)  // one block a tile, no reduction
      return mma::launch<splitk::WithSmem<T, kFoldSums<T>>>(
          gfid_conv_bf16_kernel<T, true>, grid, (cudaStream_t)stream, e, 1, P * C_out, C_out,
          xb, wb, d, chunks_per_split, vec_x, vec_w);
    return mma::launch<T>(gfid_conv_bf16_kernel<T, false>, grid, (cudaStream_t)stream, e,
                          splits, P * C_out, C_out, xb, wb, d, chunks_per_split, vec_x,
                          vec_w);
  });
}
