// GFID convolution (NHWC x HWIO -> NHWC, fp32) with a fused bias + activation
// epilogue, for Hopper (sm_90a), as an implicit GEMM on the CUDA cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_conv.py
//   gfid_conv2d_nhwc (_accumulate, _kernel, _kernel_epilogue) on fp32
//   operands, together with the padding and group glue of
//   src/repro/kernels/ops.py::gfid_conv2d. The wrapper sends 16-bit
//   operands to their own tensor-core source and int8 ones to
//   gfid_conv_int8.cu.
//
// What bounds it on an H100: fp32 arithmetic. At AlexNet batch 1 the five
//   convs do 665.8 M multiply-adds on 13.8 MB of fp32 traffic, about 96
//   flops per byte, well above the ~20 flops per byte where the card's
//   67 TFLOP/s fp32 (non-tensor-core) peak overtakes its 3.35 TB/s. The port
//   keeps TF32 off on every fp32 path, so the tensor cores do not apply.
//
// What the design does about it: the FMA units are fed from registers, with
//   few shared loads per FMA and the loads in flight during the FMAs (the
//   SIMT SGEMM shape of simt_f32.cuh, shared with the fp32 GEMM). The conv
//   is one GEMM per group: its rows are the
//   output pixels (b, h_out, w_out) flattened across rows and images, its
//   columns the group's og output channels, its K the taps (j, i, c) in HWIO
//   order, so the B operand is a plain K x C_out slab of w at column g * og.
//   A block decodes its rows' (b, h0, w0) once into shared memory; the A
//   tile is gathered from x with bounds masks for the padding (no padded
//   copy of x). A block tile of BM x BN on BM / TM x BN / TN threads: each
//   thread holds TM x TN fp32 accumulators (8 x 8 on the 128 x 128 tile).
//   Chunks of kBK = 8 K rows stream through a kStages-deep ring of cp.async
//   copies (two chunks in flight while the FMAs run on a third): 16 bytes a
//   copy where 4 channels of a tap (cg % 4 == 0) or 4 columns (og % 4 == 0)
//   lie side by side on a 16-byte boundary, else 4 bytes; masked copies are
//   zero-filled (src-size 0, nothing read). A is kept row-major (pixels x
//   K, rows padded to 12 floats) and B row-major (K x BN), and every 4 K
//   steps a thread reads TM float4 of A (4 K values of each of its rows) and
//   4 x TN / 4 float4 of B: 16 shared loads for 256 FMAs on the 8 x 8 tile.
//   In a warp the A reads hit two rows 12 floats apart and the B reads one
//   contiguous 256-byte span, so neither conflicts on the banks. The
//   wrapper's plan (kernels/gfid_conv.py::f32_plan) picks the tile that
//   fills the 132 SMs and, where even the smallest does not (batch 1's
//   169-pixel conv3-5), splits K across blocks; split_k.cuh adds the
//   partials in split order (no atomics). The epilogue adds the bias,
//   applies the activation and stores once.
//
// Sum order: an output element is one fmaf chain over K in order, chunk by
//   chunk (within a split), whatever the tile; the splits are then added in
//   split order. Plain fp32 FMA: no TF32, no tensor cores.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "simt_f32.cuh"
#include "split_k.cuh"

namespace {

constexpr int kBK = 8;              // K rows of a chunk
constexpr int kStages = 3;          // the cp.async ring: 2 chunks in flight
// The widest block tile, output pixels x output channels (kernels/gfid_conv.py
// TILE, the engine plan's tiling).
constexpr int kPixTile = 128;
constexpr int kCoutTile = 128;

// A block tile of BM pixels x BN channels (simt_f32.cuh's Tile at this
// source's chunk and ring depth).
template <int BM, int BN, int TM, int TN>
using Tile = simt::Tile<BM, BN, TM, TN, kBK, kStages>;

struct Geometry {
  int B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups;
};

constexpr int kOffRow = -(1 << 29);  // h0 of a row past the last pixel: every tap misses

using simt::cp_async16;
using simt::cp_async4;

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gfid_conv2d_nhwc_kernel(splitk::Epilogue e, const float* __restrict__ x,
                        const float* __restrict__ w, Geometry d, int chunks_per_split,
                        int vec_x, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int4 rows[T::BM];  // (b, h_in of tap row 0, w_in of tap column 0, -)
  const int tid = threadIdx.x;
  const int ty = tid / T::kColThreads;
  const int tx = tid % T::kColThreads;
  const int cg = d.C_in / d.groups;
  const int og = d.C_out / d.groups;
  const int ncb = (og + T::BN - 1) / T::BN;
  // grid x: the column blocks of every group (fastest), then the row tiles
  const int col_block = blockIdx.x % (d.groups * ncb);
  const int g = col_block / ncb;
  const int n0 = (col_block % ncb) * T::BN;  // within the group
  const int m0 = (int)(blockIdx.x / (d.groups * ncb)) * T::BM;
  const int P = d.B * d.H_out * d.W_out;
  const int K = d.H_f * d.W_f * cg;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int begin = blockIdx.z * chunks_per_split;
  const int end = min(n_chunks, begin + chunks_per_split);
  const float* xg = x + (size_t)g * cg;
  const float* wg = w + (size_t)g * og;

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
  auto tap = [&](int r, int j, int i, int c) -> const float* {
    const int4 v = row_at[r];
    const int h = v.y + j;
    const int wi = v.z + i;
    if ((unsigned)h >= (unsigned)d.H_in || (unsigned)wi >= (unsigned)d.W_in) return nullptr;
    return xg + (((size_t)v.x * d.H_in + h) * d.W_in + wi) * d.C_in + c;
  };

  auto load = [&](int chunk, float* As, float* Bs) {
    const int k0 = chunk * kBK;
    // the K column this thread copies is the same for each of its rows
    const int k = k0 + (vec_x ? (tid % (kBK / 4)) * 4 : tid % kBK);
    const int ji = k / cg;
    const int j = ji / d.W_f;
    const int i = ji % d.W_f;
    const int c = k % cg;
    if (vec_x) {  // a piece is 4 channels of one tap: cg % 4 == 0
      for (int idx = tid; idx < T::BM * (kBK / 4); idx += T::kThreads) {
        const int r = idx / (kBK / 4);
        const float* src = k < K ? tap(r, j, i, c) : nullptr;
        cp_async16(As + r * T::kAStride + k - k0, src != nullptr ? src : x, src != nullptr);
      }
    } else {  // kThreads % kBK == 0
      for (int idx = tid; idx < T::BM * kBK; idx += T::kThreads) {
        const int r = idx / kBK;
        const float* src = k < K ? tap(r, j, i, c) : nullptr;
        cp_async4(As + r * T::kAStride + k - k0, src != nullptr ? src : x, src != nullptr);
      }
    }
    if (vec_w) {  // og % 4 == 0: a piece is 4 columns, all in or all out
      for (int idx = tid; idx < kBK * (T::BN / 4); idx += T::kThreads) {
        const int r = idx / (T::BN / 4);
        const int n = (idx % (T::BN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + n < og;
        cp_async16(Bs + r * T::BN + n, ok ? wg + (size_t)(k0 + r) * d.C_out + n0 + n : w, ok);
      }
    } else {
      for (int idx = tid; idx < kBK * T::BN; idx += T::kThreads) {
        const int r = idx / T::BN;
        const int n = idx % T::BN;
        const bool ok = k0 + r < K && n0 + n < og;
        cp_async4(Bs + r * T::BN + n, ok ? wg + (size_t)(k0 + r) * d.C_out + n0 + n : w, ok);
      }
    }
  };

  float acc[T::TM][T::TN];
  simt::run_chunks<T>(smem, begin, end - begin, ty, tx, acc, load, [](int) {});

  float* ws = e.ws == nullptr ? nullptr : e.ws + (size_t)blockIdx.z * P * d.C_out;
#pragma unroll
  for (int s = 0; s < T::TM; ++s) {
    const int r = m0 + ty + s * T::kRowThreads;
    if (r >= P) continue;
#pragma unroll
    for (int c = 0; c < T::TN; ++c) {
      const int col = n0 + (c / 4) * 4 * T::kColThreads + tx * 4 + c % 4;
      if (col >= og) continue;
      const size_t idx = (size_t)r * d.C_out + g * og + col;
      if (ws != nullptr)
        ws[idx] = acc[s][c];
      else
        splitk::finish(e, idx, g * og + col, acc[s][c]);
    }
  }
}

// Run f(Tile<...>{}) for the block tile (bm, bn), one of the three the
// wrapper's plan picks from (F32_TILES); cudaErrorInvalidValue for another.
template <class F>
int with_tile(int bm, int bn, F&& f) {
  if (bm == kPixTile && bn == kCoutTile) return f(Tile<kPixTile, kCoutTile, 8, 8>{});
  if (bm == 64 && bn == 64) return f(Tile<64, 64, 8, 4>{});
  if (bm == 32 && bn == 64) return f(Tile<32, 64, 4, 4>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (B, H_in, W_in, C_in) NHWC and w (H_f, W_f, C_in / groups, C_out) HWIO,
// bias (C_out,) or null, out (B, H_out, W_out, C_out); all fp32. (bm, bn) is
// a block tile of with_tile; K = H_f W_f C_in / groups is cut into splits
// runs of chunks_per_split chunks of kBK. With splits > 1, ws is an fp32
// workspace of splits x B H_out W_out x C_out (not zeroed: every element is
// written); with splits == 1 it may be null. vec_x (vec_w): 16-byte copies of
// x (w), for C_in / groups (C_out / groups) a multiple of 4 on a 16-byte
// aligned pointer. act: 0 none, 1 relu, 2 gelu (tanh). Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted;
// cudaErrorInvalidValue for another tile).
extern "C" int gfid_conv2d_nhwc_f32(const float* x, const float* w, const float* bias,
                                    float* out, float* ws, int B, int H_in, int W_in,
                                    int C_in, int H_f, int W_f, int C_out, int H_out,
                                    int W_out, int stride, int pad, int groups, int bm,
                                    int bn, int splits, int chunks_per_split, int act,
                                    int vec_x, int vec_w, void* stream) {
  const splitk::Epilogue e{bias, 0, out, 0, ws, act};
  const Geometry d{B, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups};
  const long long P = (long long)B * H_out * W_out;
  return with_tile(bm, bn, [&](auto tile) {
    using T = decltype(tile);
    const long long tiles =
        groups * ((C_out / groups + T::BN - 1) / T::BN) * ((P + T::BM - 1) / T::BM);
    if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)tiles, 1, splits);
    return splitk::launch<T>(gfid_conv2d_nhwc_kernel<T>, grid, (cudaStream_t)stream, e,
                             splits, P * C_out, C_out, x, w, d, chunks_per_split, vec_x,
                             vec_w);
  });
}
