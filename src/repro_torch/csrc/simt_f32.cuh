// The fp32 register-tiled SIMT machinery shared by the fp32 implicit-GEMM
// conv (gfid_conv.cu) and the fp32 GEMM (gfid_matmul.cu): a block tile of
// BM x BN outputs on BM / TM x BN / TN threads, each thread holding TM x TN
// fp32 accumulators; chunks of BK K rows stream through a STAGES-deep ring of
// cp.async copies into shared memory (STAGES - 1 chunks in flight while the
// FMAs run on one), and every 4 K steps a thread reads TM float4 of A and
// TN / 4 float4 of B for each K step. A is kept row-major (rows x K, rows
// padded to BK + 4 floats, float4-aligned) and B row-major (K x BN). The
// caller supplies the loader that fills one stage, so the conv gathers its
// A tile from NHWC taps and the GEMM reads plain rows of x.
//
// Sum order: each accumulator is one fmaf chain over the chunks in order
// and, within a chunk, over K in order, whatever the tile.
#pragma once
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "smem.cuh"

namespace simt {

// A block tile of BM rows x BN columns in chunks of BK K rows through a
// STAGES-deep ring; each of its BM / TM x BN / TN threads owns TM rows
// (strided by BM / TM) and TN / 4 runs of 4 columns (strided by 4 * BN / TN).
template <int BM_, int BN_, int TM_, int TN_, int BK_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, BK = BK_;
  static constexpr int kStages = STAGES_;
  static constexpr int kAStride = BK + 4;  // floats an A row, float4-aligned
  static constexpr int kRowThreads = BM / TM;
  static constexpr int kColThreads = BN / TN;
  static constexpr int kThreads = kRowThreads * kColThreads;
  // blocks an SM: 512 threads, so at most 128 registers a thread
  static constexpr int kMinBlocks = 512 / kThreads;
  static constexpr int kStage = BM * kAStride + BK * BN;  // floats
  static constexpr size_t kSmem = sizeof(float) * kStages * kStage;
  static_assert(TN % 4 == 0, "B is read as float4");
  static_assert(BK % 4 == 0, "A is read as float4");
  static_assert(kThreads % BK == 0, "a thread's K column of an element-loaded A is fixed");
};

using smem::cp_async16;
using smem::cp_async4;
using smem::cp_async_commit;
using smem::cp_async_wait;

// One chunk of the block tile from stage (As, Bs) into this thread's
// accumulators, K in order.
template <class T>
__device__ __forceinline__ void fma_chunk(const float* As, const float* Bs, int ty, int tx,
                                          float (&acc)[T::TM][T::TN]) {
#pragma unroll
  for (int kq = 0; kq < T::BK; kq += 4) {
    float a[T::TM][4];
#pragma unroll
    for (int s = 0; s < T::TM; ++s) {
      const float4 v =
          *reinterpret_cast<const float4*>(As + (ty + s * T::kRowThreads) * T::kAStride + kq);
      a[s][0] = v.x;
      a[s][1] = v.y;
      a[s][2] = v.z;
      a[s][3] = v.w;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float b[T::TN];
#pragma unroll
      for (int q = 0; q < T::TN / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            Bs + (kq + kk) * T::BN + q * 4 * T::kColThreads + tx * 4);
        b[4 * q] = v.x;
        b[4 * q + 1] = v.y;
        b[4 * q + 2] = v.z;
        b[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < T::TM; ++s)
#pragma unroll
        for (int n = 0; n < T::TN; ++n) acc[s][n] = fmaf(a[s][kk], b[n], acc[s][n]);
    }
  }
}

// Chunks begin .. begin + n - 1 through the ring into acc (zeroed here):
// load(chunk, As, Bs) issues one chunk's cp.async copies into a stage;
// after(t) runs once chunk begin + t is in acc (t = 0 .. n - 1). Every
// thread of the block calls this.
template <class T, class Load, class After>
__device__ __forceinline__ void run_chunks(float* smem, int begin, int n, int ty, int tx,
                                           float (&acc)[T::TM][T::TN], Load&& load,
                                           After&& after) {
#pragma unroll
  for (int s = 0; s < T::TM; ++s)
#pragma unroll
    for (int c = 0; c < T::TN; ++c) acc[s][c] = 0.0f;
#pragma unroll
  for (int s = 0; s < T::kStages - 1; ++s) {
    if (s < n) load(begin + s, smem + s * T::kStage, smem + s * T::kStage + T::BM * T::kAStride);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_async_wait<T::kStages - 2>();  // chunk t has landed (this thread's copies)
    __syncthreads();                  // ... and every thread's; chunk t - 1 is consumed
    const int next = t + T::kStages - 1;
    if (next < n) {
      float* st = smem + (next % T::kStages) * T::kStage;
      load(begin + next, st, st + T::BM * T::kAStride);
    }
    cp_async_commit();
    const float* st = smem + (t % T::kStages) * T::kStage;
    fma_chunk<T>(st, st + T::BM * T::kAStride, ty, tx, acc);
    after(t);
  }
  cp_async_wait<0>();
}

}  // namespace simt
