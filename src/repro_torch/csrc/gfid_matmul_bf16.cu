// GFID FC mode on bf16 operands: (M, K) bf16 @ (K, N) bf16 with fp32 sums and
// a fused bias + activation epilogue -> (M, N) fp32, or rounded once to bf16,
// for Hopper (sm_90a), on the tensor cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul (_kernel, _kernel_epilogue) on bf16 operands
//   (`preferred_element_type=jnp.float32`; the bf16 result is the fp32 one
//   cast by src/repro/kernels/ops.py::gfid_matmul).
//
// What bounds it on an H100: at small M (AlexNet's FC layers at batch 1 and
//   32, smollm-135m's decode GEMMs at M = 8) device memory: each bf16 weight
//   takes part in 2M operations, far below the ~295 operations a byte where
//   the 989 TFLOP/s bf16 tensor cores overtake the 3.35 TB/s memory; the floor
//   is the weight bytes over the memory rate. At large M (smollm's prefill,
//   M = 8 x prompt) the tensor cores' rate; there, on the H100, this kernel
//   is held back by its tile loads from L2 (each A row is read once for
//   every 64 columns), not by the mma rate.
//
// What the design does about it (csrc/mma_bf16.cuh): a block owns BM rows x
//   64 columns, BM = 16, 32 or 64 chosen by the wrapper from M, so that up
//   to M = 64 every weight is read from device memory once. The weights
//   stream through a 4-stage ring of 16-byte `cp.async` copies (3 chunks of
//   32 K rows in flight a block) into bf16 `mma.sync.m16n8k16` with fp32
//   accumulators. Where the column blocks alone do not fill the card (fc6:
//   64 of them), K is split across blocks (grid z): the split count comes
//   from (K, N) alone, never from M, and split_reduce_kernel adds the
//   partials in split order (no atomics). K % 8 != 0, N % 8 != 0 or an
//   unaligned base pointer selects element-by-element loads of that operand
//   (vec_x, vec_w = 0); edges are zero-filled, never padded in memory.
//
// Row invariance: a row's sums run in one order whatever M is and wherever
//   the row lands in a tile (mma_bf16.cuh): the serving scheduler's tokens
//   are bitwise across batchings on it. A grouped launch (the stacked
//   experts of an MoE layer: x (G, M, K) @ w (G, K, N), one launch, the
//   group on grid y) runs each group with that split, so a group's bits are
//   its own launch's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_bf16.cuh"

namespace {

using mma::kBK;
using mma::kPieces;

template <class T>
__global__ void __launch_bounds__(T::kThreads)
gfid_matmul_bf16_kernel(mma::Epilogue e, const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ w, int M, int K, int N,
                        int chunks_per_split, int vec_x, int vec_w, long long stride_x,
                        long long stride_w) {
  extern __shared__ __align__(16) uint16_t smem[];
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * T::BN;
  // grid y is group x row blocks + row block: group g reads x + g * stride_x
  // and w + g * stride_w and writes rows g * M + [0, M) of the output
  const int row_blocks = (M + T::BM - 1) / T::BM;
  const int g = blockIdx.y / row_blocks;
  const int m0 = (blockIdx.y - g * row_blocks) * T::BM;
  x += g * stride_x;
  w += g * stride_w;
  const int n_chunks = (K + kBK - 1) / kBK;
  const int begin = blockIdx.z * chunks_per_split;
  const int end = min(n_chunks, begin + chunks_per_split);

  auto load = [&](int chunk, uint16_t* As, uint16_t* Bs) {
    const int k0 = chunk * kBK;
    if (vec_x) {  // BM rows x 4 pieces; K % 8 == 0, so a piece is all in or all out
      for (int idx = tid; idx < T::BM * (kBK / kPieces); idx += T::kThreads) {
        const int r = idx / (kBK / kPieces);
        const int k = k0 + (idx % (kBK / kPieces)) * kPieces;
        const bool ok = m0 + r < M && k < K;
        mma::cp_async16(As + r * mma::kAStride + k - k0,
                        ok ? x + (size_t)(m0 + r) * K + k : x, ok);
      }
    } else {
      for (int idx = tid; idx < T::BM * kBK; idx += T::kThreads) {
        const int r = idx / kBK;
        const int k = k0 + idx % kBK;
        As[r * mma::kAStride + k - k0] =
            (m0 + r < M && k < K) ? __ldg(x + (size_t)(m0 + r) * K + k) : (uint16_t)0;
      }
    }
    if (vec_w) {  // 32 rows x 8 pieces
      for (int idx = tid; idx < kBK * (T::BN / kPieces); idx += T::kThreads) {
        const int r = idx / (T::BN / kPieces);
        const int n = n0 + (idx % (T::BN / kPieces)) * kPieces;
        const bool ok = k0 + r < K && n < N;
        mma::cp_async16(Bs + r * T::kBStride + n - n0,
                        ok ? w + (size_t)(k0 + r) * N + n : w, ok);
      }
    } else {
      for (int idx = tid; idx < kBK * T::BN; idx += T::kThreads) {
        const int r = idx / T::BN;
        const int n = n0 + idx % T::BN;
        Bs[r * T::kBStride + n - n0] =
            (k0 + r < K && n < N) ? __ldg(w + (size_t)(k0 + r) * N + n) : (uint16_t)0;
      }
    }
  };

  float acc[T::MT][T::NT][4];
  mma::mainloop<T>(load, begin, end, smem, acc);
  // the workspace is (splits, groups, M, N), the output (groups, M, N)
  const size_t group_out = (size_t)M * N;
  float* ws = e.ws == nullptr ? nullptr
                              : e.ws + ((size_t)blockIdx.z * (gridDim.y / row_blocks) + g) * group_out;
  mma::Epilogue eg = e;
  eg.out = static_cast<char*>(e.out) + g * group_out * (e.out_bf16 ? 2 : 4);
  mma::store_tile<T>(acc, eg, ws, m0, M, n0, N, 0, N);
}

}  // namespace

// x (groups, M, K) bf16 with groups stride_x elements apart, w (groups, K,
// N) bf16 with groups stride_w apart; bias (N,) fp32 (bias_bf16 = 0), bf16
// (1) or null, shared by the groups; out (groups, M, N) contiguous, fp32
// (out_bf16 = 0) or bf16 (1). Each group is the 2-D product of its x and w
// with the split of a launch of that group alone: its bits are that
// launch's. Group g's blocks are y = g x row blocks + row block of the grid.
// (bm, bn) is a block tile of mma::with_tile. With splits > 1, ws is an fp32
// workspace of splits x groups x M x N (not zeroed: every element is
// written); with splits == 1 it may be null. vec_x (vec_w): 16-byte copies
// of x (w), for K (N) and stride_x (stride_w) multiples of 8 on a 16-byte
// aligned pointer. act: 0 none, 1 relu, 2 gelu. Launches on `stream` and returns
// cudaGetLastError() (0 when accepted; cudaErrorInvalidValue for another
// tile).
extern "C" int gfid_matmul_bf16(const void* x, const void* w, const void* bias, void* out,
                                float* ws, int bias_bf16, int out_bf16, int M, int K, int N,
                                int bm, int bn, int splits, int chunks_per_split, int act,
                                int vec_x, int vec_w, int groups, long long stride_x,
                                long long stride_w, void* stream) {
  if (groups < 1) return (int)cudaErrorInvalidValue;
  const mma::Epilogue e{bias, bias_bf16, out, out_bf16, ws, act};
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  const uint16_t* wb = static_cast<const uint16_t*>(w);
  return mma::with_tile(bm, bn, [&](auto tile) {
    using T = decltype(tile);
    const dim3 grid((N + T::BN - 1) / T::BN, groups * ((M + T::BM - 1) / T::BM), splits);
    return mma::launch<T>(gfid_matmul_bf16_kernel<T>, grid, (cudaStream_t)stream, e, splits,
                          (long long)groups * M * N, N, xb, wb, M, K, N, chunks_per_split,
                          vec_x, vec_w, stride_x, stride_w);
  });
}
