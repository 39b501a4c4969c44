// The tensor-core core shared by the bf16 GEMM (gfid_matmul_bf16.cu) and the
// bf16 implicit-GEMM conv (gfid_conv_bf16.cu): a block tile of BM rows x
// BN columns, walked over K in chunks of kBK = 32 with a ring of kStages
// shared-memory stages, each product a bf16 `mma.sync.m16n8k16` with fp32
// accumulators in registers, and the epilogue of epilogue.cuh.
//
// The pieces, in the order a block runs them:
//   * a loader (one per kernel) fills a stage: the A tile (BM x kBK, row
//     major, rows padded to kAStride) and the B tile (kBK x BN, row major,
//     rows padded to kBStride). Its 16-byte pieces go by `cp.async` with
//     src-size 0 for a masked piece (16 zero bytes, nothing read); ragged
//     shapes store element by element. The padding puts the 8 rows that one
//     `ldmatrix` phase reads in 8 different 16-byte bank groups;
//   * `mainloop` keeps kStages - 1 chunks in flight (`commit_group` per
//     chunk, `wait_group kStages - 2` before a chunk is read), one
//     __syncthreads a chunk;
//   * `mma_chunk`: each warp loads its A fragments with `ldmatrix.x4` and
//     its B fragments with `ldmatrix.x4.trans` (B is K x N row major in
//     shared memory; the mma wants it column major) and issues two k16
//     steps of MT x NT `mma.sync`s;
//   * `store_tile`: bias, act and the fp32 or bf16 store straight from the
//     accumulator fragments, or, under a split of K, the fp32 partial into
//     a workspace that `split_reduce_kernel` sums in split order (both of
//     split_k.cuh, which the fp32 conv shares); a conv block that runs
//     every split folds them in the same order first (`fold_split`).
//
// The sum order of an output element: chunk by chunk in K order, inside a
// chunk the two k16 steps in order, inside a step the tensor core's own
// fixed reduction over 16 products of that row and that column alone. None
// of it depends on BM, on the rows beside it or on the block that owns it:
// only the split of K does, and its partials are added in split order,
// whether by the reduction or by a fold.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "smem.cuh"
#include "split_k.cuh"

namespace mma {

using splitk::Epilogue;
using splitk::launch;

constexpr int kBK = 32;      // K chunk: two k16 mma steps
constexpr int kStages = 4;   // shared-memory ring: 3 chunks in flight
constexpr int kPieces = 8;   // bf16 values in one 16-byte copy
constexpr int kAStride = kBK + 8;  // 80 bytes an A row: conflict-free ldmatrix

// A block tile of BM rows x BN columns on WM x WN warps, each warp MT x NT
// mma tiles of 16 x 8. B rows are padded to BN + 8 values (144 or 272
// bytes: conflict-free ldmatrix.trans).
template <int BM_, int BN_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static constexpr int kBStride = BN + 8;
  static constexpr int kStage = BM * kAStride + kBK * kBStride;  // bf16 values
  static constexpr size_t kSmem = sizeof(uint16_t) * kStages * kStage;
  static_assert(MT >= 1 && NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(kThreads % kBK == 0, "a thread's K column of the A tile is fixed");
};

using smem::cp_async16;
using smem::cp_async_commit;
using smem::cp_async_wait;
using smem::ldmatrix_x4;
using smem::ldmatrix_x4_trans;

// d += a (16 x 16, row major) * b (16 x 8, column major), bf16 in, fp32 sums.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K chunk of the block tile from stage (As, Bs) into this warp's
// accumulators.
template <class T>
__device__ __forceinline__ void mma_chunk(const uint16_t* As, const uint16_t* Bs,
                                          float (&acc)[T::MT][T::NT][4]) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = (warp % T::WM) * (T::BM / T::WM);
  const int col0 = (warp / T::WM) * (T::BN / T::WN);
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)  // lanes 0-15: rows at k, 16-31: rows at k + 8
      ldmatrix_x4(a[mt], As + (row0 + mt * 16 + lane % 16) * kAStride + kk + (lane / 16) * 8);
    uint32_t b[T::NT][2];
#pragma unroll
    for (int nt = 0; nt < T::NT; nt += 2) {  // matrices (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
      uint32_t r[4];
      ldmatrix_x4_trans(r, Bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * T::kBStride +
                               col0 + nt * 8 + (lane / 16) * 8);
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Chunks [begin, end) of K through the ring. load(chunk, As, Bs) fills one
// stage; it may issue cp.async copies or store directly. after(t) runs once
// chunk begin + t is in acc (a fold's hook, split_k.cuh's fold_split).
template <class T, class Load, class After>
__device__ __forceinline__ void mainloop(Load&& load, int begin, int end, uint16_t* smem,
                                         float (&acc)[T::MT][T::NT][4], After&& after) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
  const int n = end - begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(begin + s, smem + s * T::kStage, smem + s * T::kStage + T::BM * kAStride);
    cp_async_commit();
  }
  for (int t = 0; t < n; ++t) {
    cp_async_wait<kStages - 2>();  // chunk t has landed (this thread's copies)
    __syncthreads();               // ... and every thread's; chunk t - 1 is consumed
    const int next = t + kStages - 1;
    if (next < n) {
      uint16_t* st = smem + (next % kStages) * T::kStage;
      load(begin + next, st, st + T::BM * kAStride);
    }
    cp_async_commit();
    const uint16_t* st = smem + (t % kStages) * T::kStage;
    mma_chunk<T>(st, st + T::BM * kAStride, acc);
    after(t);
  }
  cp_async_wait<0>();
}

template <class T, class Load>
__device__ __forceinline__ void mainloop(Load&& load, int begin, int end, uint16_t* smem,
                                         float (&acc)[T::MT][T::NT][4]) {
  mainloop<T>(load, begin, end, smem, acc, [](int) {});
}

// The block tile's accumulators to rows [m0, m0 + BM) of `rows` and columns
// n0 + [0, BN) of a segment of `seg` columns that starts at column col_off
// of an output with ldc columns (the conv's group; 0 and ldc for the GEMM).
// `ws` is this split's slab of the workspace, or null.
template <class T>
__device__ __forceinline__ void store_tile(const float (&acc)[T::MT][T::NT][4],
                                           const Epilogue& e, float* ws, int m0, int rows,
                                           int n0, int seg, int col_off, int ldc) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = m0 + (warp % T::WM) * (T::BM / T::WM) + lane / 4;
  const int col0 = n0 + (warp / T::WM) * (T::BN / T::WN) + 2 * (lane % 4);
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // c0, c1: row g; c2, c3: row g + 8
        const int r = row0 + mt * 16 + (q / 2) * 8;
        const int n = col0 + nt * 8 + q % 2;
        if (r >= rows || n >= seg) continue;
        const int col = col_off + n;
        const size_t idx = (size_t)r * ldc + col;
        if (ws != nullptr)
          ws[idx] = acc[mt][nt][q];
        else
          splitk::finish(e, idx, col, acc[mt][nt][q]);
      }
}

// Run f(Tile<...>{}) for the tile of (bm, bn), one of the block tiles both
// kernels are built for; cudaErrorInvalidValue for any other. 16-64 rows x
// 64 columns on 4 warps (warp tiles of 16 x 16, 16 x 32 and 32 x 32);
// 128 x 128 on 8 warps (64 x 32 each).
template <class F>
int with_tile(int bm, int bn, F&& f) {
  if (bn == 64 && bm == 16) return f(Tile<16, 64, 1, 4>{});
  if (bn == 64 && bm == 32) return f(Tile<32, 64, 2, 2>{});
  if (bn == 64 && bm == 64) return f(Tile<64, 64, 2, 2>{});
  if (bn == 128 && bm == 128) return f(Tile<128, 128, 2, 4>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma
