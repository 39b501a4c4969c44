// GFID FC mode on int8 operands: (M, K) int8 @ (K, N) int8 with an exact int32
// accumulator and a fused dequant + bias + activation epilogue -> (M, N) fp32,
// for Hopper (sm_90a), on the int8 tensor cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul_int8 (_kernel_int8, _chunked_i32_dot). The TPU kernel sums
//   K-chunked fp32 dots, each exact below 2^24 (a device for speed under CPU
//   XLA); this kernel multiplies and adds integers, with no fp32 chunking.
//
// What bounds it on an H100: device memory. At AlexNet batch 1 the three FC
//   layers are matrix-vector products over 37.7 MB (fc6), 16.8 MB (fc7) and
//   4.1 MB (fc8) of int8 weights, 2 operations per weight byte: the floor is
//   the weight bytes over 3.35 TB/s, 17.5 us for the three. At batch 32 it is
//   still the bytes (3.7 G operations are 1.9 us at 1,979 TOP/s), as long as
//   each weight byte is read from device memory once.
//
// What the design does about it: a block tile of BM rows x BN = 128 columns
//   through the int8 tensor-core core of csrc/mma_int8.cuh (shared with the
//   int8 conv): a 4-stage `cp.async` ring of 64-byte K chunks, B transposed
//   one chunk ahead into channel-major shared memory with `__byte_perm`
//   (sm_90 has no 8-bit ldmatrix.trans), each product an
//   `mma.sync.m16n8k32` s8 x s8 -> s32 (512 multiply-adds an instruction).
//   This source's loader fills the ring:
//   * A, xq's rows with K contiguous: 16-byte `cp.async` where K % 16 == 0
//     and xq is 16-byte aligned, zero-filled past M and K; else words of 4 K
//     bytes gathered byte by byte, zero past the edge;
//   * B, a chunk of wq as it lies (64 K rows x 128 columns, N contiguous):
//     16-byte `cp.async` where N % 16 == 0 and wq is 16-byte aligned (fc6,
//     fc7), 8-byte `cp.async` where N % 8 == 0 and wq is 8-byte aligned
//     (fc8's N = 1000), zero-filled past K and N; else words of 4 columns
//     gathered byte by byte.
//   The tile follows M (kernels/gfid_matmul.py::int8_mm_plan): 16 rows up to
//   M = 16 (batch 1: a stream of weights, one m16 tile of the mma), else 32
//   rows (batch 32: every weight byte read and transposed once a forward;
//   more rows take more row blocks). The columns alone give few blocks (fc6 and fc7 32,
//   fc8 8), so K is split across up to kMaxSplit = 8 blocks that form one
//   thread block cluster along grid z, about two blocks an SM, each keeping
//   2 chunks of 64 x 128 bytes of w in flight; each block of a cluster adds
//   a share of the tile's int32 sums from all of them through distributed
//   shared memory and stores that share (`mma8::cluster_sum`). No
//   workspace, no memset, no atomic: one launch a call. Integer sums are
//   exact in any order, so every tile and split gives the same bits.
//   What holds it now (H100 probes): each block's chunk work (the B
//   transpose in shared memory, then the mma), not the bytes in flight: a
//   deeper ring (4 chunks in flight) ran no faster.
//   The epilogue is `dequant_epilogue` of epilogue.cuh with scale =
//   sx[row] * sw[col], one fp32 multiply, so the output is bitwise that of
//   the plain version for act none and relu.
//
// int32 range: |acc| <= K * 127^2; fc6 (K = 9216) gives at most 1.49e8, far
//   below 2^31. The wrapper refuses K above 2^31 / 127^2 = 133,144.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_int8.cuh"

namespace {

// The widest block tile (kernels/gfid_matmul.py TILE_INT8, the engine plan's
// tiling): rows of x, K bytes a chunk, columns.
constexpr int kBM = 32;
constexpr int kKT = 64;
constexpr int kBN = 128;
static_assert(kKT == mma8::kKc, "the chunk is the core's");
// The most splits of K (kernels/gfid_matmul.py INT8_MM_MAX_SPLIT), one cluster.
constexpr int kMaxSplit = 8;
static_assert(kMaxSplit <= mma8::kMaxCluster, "a tile's splits are one portable cluster");

// The B chunk of K rows k0 .. k0 + kKT - 1 and columns n0 .. n0 + BN - 1 as
// it lies in w, by `cp.async` copies of kBytes (16 or 8) columns, zeros past
// K or N: a piece is all in or all out, since N % kBytes == 0.
template <class T, int kBytes>
__device__ __forceinline__ void load_b(const int8_t* __restrict__ w, uint8_t* Bn, int k0,
                                       int n0, int K, int N) {
  static_assert(kBytes == 16 || kBytes == 8, "16- or 8-byte copies");
  constexpr int kPer = T::BN / kBytes;
  for (int idx = threadIdx.x; idx < kKT * kPer; idx += T::kThreads) {
    const int r = idx / kPer;
    const int n = n0 + (idx % kPer) * kBytes;
    const bool ok = k0 + r < K && n < N;
    uint8_t* dst = Bn + r * T::kBStride + n - n0;
    const int8_t* src = ok ? w + (size_t)(k0 + r) * N + n : w;
    if constexpr (kBytes == 16) {
      mma8::cp_async16(dst, src, ok);
    } else {
      smem::cp_async8(dst, src, ok);
    }
  }
}

template <class T, bool kCluster>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gfid_matmul_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        const float* __restrict__ bias, float* __restrict__ out, int M, int K,
                        int N, int chunks_per_split, int act, int vec_x, int vec_w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * T::BM;
  const int n0 = blockIdx.y * T::BN;
  const int n_chunks = (K + kKT - 1) / kKT;
  const int begin = blockIdx.z * chunks_per_split;
  const int end = min(n_chunks, begin + chunks_per_split);

  auto load = [&](int chunk, uint8_t* As, uint8_t* Bn) {
    const int k0 = chunk * kKT;
    // A: rows m0 .. m0 + BM - 1 of xq, K bytes k0 .. k0 + kKT - 1; zeros
    // past M or K
    if (vec_x) {  // K % 16 == 0: a piece is all in or all out
      constexpr int kPer = kKT / 16;
      for (int idx = tid; idx < T::BM * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const int k = k0 + (idx % kPer) * 16;
        const bool ok = m0 + r < M && k < K;
        mma8::cp_async16(As + r * mma8::kAStride + k - k0,
                         ok ? x + (size_t)(m0 + r) * K + k : x, ok);
      }
    } else {  // a word is 4 K bytes of one row, gathered byte by byte
      constexpr int kWords = kKT / 4;
      for (int idx = tid; idx < T::BM * kWords; idx += T::kThreads) {
        const int r = idx / kWords;
        const int k = k0 + 4 * (idx % kWords);
        uint32_t word = 0u;
        if (m0 + r < M) {
          const int8_t* src = x + (size_t)(m0 + r) * K + k;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < K) word |= (uint32_t)(uint8_t)__ldg(src + e) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(As + r * mma8::kAStride + k - k0) = word;
      }
    }
    // B: as it lies in w; zeros past K or N
    if (vec_w == 16) {
      load_b<T, 16>(w, Bn, k0, n0, K, N);
    } else if (vec_w == 8) {
      load_b<T, 8>(w, Bn, k0, n0, K, N);
    } else {  // a word is 4 columns of one K row, gathered byte by byte
      constexpr int kPer = T::BN / 4;
      for (int idx = tid; idx < kKT * kPer; idx += T::kThreads) {
        const int r = idx / kPer;
        const int n = n0 + (idx % kPer) * 4;
        uint32_t word = 0u;
        if (k0 + r < K) {
          const int8_t* src = w + (size_t)(k0 + r) * N + n;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) word |= (uint32_t)(uint8_t)__ldg(src + e) << (8 * e);
        }
        *reinterpret_cast<uint32_t*>(Bn + r * T::kBStride + n - n0) = word;
      }
    }
  };

  int acc[T::MT][T::NT][4];
  mma8::mainloop<T>(load, begin, end, smem, acc);
  mma8::Share share{0u, 1u};
  if constexpr (kCluster) share = mma8::cluster_sum<T>(acc, reinterpret_cast<int*>(smem));

  const int lane = tid % 32;
  const int warp = tid / 32;
  const int row0 = m0 + (warp % T::WM) * (T::BM / T::WM) + lane / 4;
  const int col0 = n0 + (warp / T::WM) * (T::BN / T::WN) + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // c0, c1: row g; c2, c3: row g + 8
      const int r = row0 + mt * 16 + half * 8;
      if (r >= M) continue;
      float* orow = out + (size_t)r * N;
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col0 + nt * 8 + e;
          if (n >= N || !share.mine((mt * T::NT + nt) * 4 + half * 2 + e)) continue;
          orow[n] = dequant_epilogue(acc[mt][nt][half * 2 + e], __fmul_rn(sx[r], sw[n]), bias,
                                     n, act);
        }
    }
}

// Run f(Tile<...>{}) for the tile of (bm, bn), one of the two that
// kernels/gfid_matmul.py::int8_mm_plan picks from (INT8_MM_TILES): 16 x 128
// on 4 warps side by side along N (warp tiles of 16 x 32), 32 x 128 on 8
// warps (16 x 32 each: on an H100 batch 32's fc8 ran faster this way than on 4
// warps of 32 x 32); cudaErrorInvalidValue for any other. Blocks an SM, for
// the register budget: three of the 16-row tile (its 57 KB ring fits three),
// two of the 32-row one. A tile's splits are one cluster, and a grid of more
// clusters than the card holds at once runs in two waves
// (cudaOccupancyMaxActiveClusters): three 16-row blocks an SM hold fc6's and
// fc7's 32 clusters of 8 at once on an H100, two do not.
template <class F>
int with_mm_tile(int bm, int bn, F&& f) {
  if (bn == 128 && bm == 16) return f(mma8::Tile<16, 128, 1, 4, 3>{});
  if (bn == kBN && bm == kBM) return f(mma8::Tile<kBM, kBN, 2, 4, 2>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// xq (M, K) and wq (K, N) int8; sx (M,) and sw (N,) fp32; bias (N,) fp32 or
// null; out (M, N) fp32. (bm, bn) is a block tile of with_mm_tile; K is cut
// into splits runs of chunks_per_split chunks of kKT bytes, and with splits
// > 1 (at most kMaxSplit) the splits of each output tile run as one cluster.
// vec_x: 16-byte copies of xq, for K % 16 == 0 on a 16-byte aligned xq;
// vec_w: the bytes a copy of wq, 16 (N % 16 == 0, 16-byte aligned), 8 (N % 8
// == 0, 8-byte aligned) or 0 (gathered byte by byte). act: 0 none, 1 relu, 2
// gelu. Launches on `stream` and returns cudaGetLastError() (0 when
// accepted; cudaErrorInvalidValue for another tile, split or copy width).
extern "C" int gfid_matmul_int8(const void* xq, const void* wq, const float* sx,
                                const float* sw, const float* bias, float* out, int M, int K,
                                int N, int bm, int bn, int splits, int chunks_per_split, int act,
                                int vec_x, int vec_w, void* stream) {
  if (splits < 1 || splits > kMaxSplit || (vec_w != 0 && vec_w != 8 && vec_w != 16))
    return (int)cudaErrorInvalidValue;
  const int8_t* xb = static_cast<const int8_t*>(xq);
  const int8_t* wb = static_cast<const int8_t*>(wq);
  const cudaStream_t s = (cudaStream_t)stream;
  return with_mm_tile(bm, bn, [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid((M + T::BM - 1) / T::BM, (N + T::BN - 1) / T::BN, splits);
    if (splits > 1)
      return mma8::launch<T, true>(gfid_matmul_int8_kernel<T, true>, grid, s, xb, wb, sx, sw,
                                   bias, out, M, K, N, chunks_per_split, act, vec_x, vec_w);
    return mma8::launch<T, false>(gfid_matmul_int8_kernel<T, false>, grid, s, xb, wb, sx, sw,
                                  bias, out, M, K, N, chunks_per_split, act, vec_x, vec_w);
  });
}
