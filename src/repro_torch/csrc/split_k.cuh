// The end of a block-tiled kernel, shared by the bf16 tensor-core GEMM and
// conv (through mma_bf16.cuh) and the fp32 implicit-GEMM conv and GEMM
// (gfid_conv.cu, gfid_matmul.cu): where a block's results go (`Epilogue`:
// bias, act and the fp32 or bf16 store, or the fp32 partial sums of one
// split of K), the split reduction that adds those partials in split order
// (no atomics, so a result does not change from run to run), the fold that
// adds them in the same order inside one block, and the launch of a tile
// kernel with its dynamic shared memory followed, under a split, by that
// reduction.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "epilogue.cuh"

namespace splitk {

// Where a block's results go. ws null: bias, act and the store to out
// (fp32, or bf16 when out_bf16). ws set: the fp32 partial sums of this
// block's split, for split_reduce_kernel.
struct Epilogue {
  const void* bias;
  int bias_bf16;
  void* out;
  int out_bf16;
  float* ws;
  int act;
};

__device__ __forceinline__ void finish(const Epilogue& e, size_t idx, int col, float v) {
  if (e.bias != nullptr) v += bias_at(e.bias, e.bias_bf16, col);
  v = apply_act(v, e.act);
  if (e.out_bf16)
    store_as(static_cast<__nv_bfloat16*>(e.out) + idx, v);
  else
    store_as(static_cast<float*>(e.out) + idx, v);
}

// Split K: out[i] = epilogue(ws[0][i] + ws[1][i] + ... + ws[splits - 1][i]),
// added in that order, for the n_out elements of an output with ldc columns.
__global__ void __launch_bounds__(256)
split_reduce_kernel(const float* __restrict__ ws, int splits, long long n_out, int ldc,
                    Epilogue e) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * 256) {
    float v = ws[i];
    for (int s = 1; s < splits; ++s) v += ws[(size_t)s * n_out + i];
    finish(e, (size_t)i, (int)(i % ldc), v);
  }
}

// A fold: a block that runs every split of K itself adds the finished
// splits in split order, exactly as split_reduce_kernel does. The first
// split's sums start a running sum that each thread keeps in shared memory
// (sum[i][thread], conflict-free; kThreads x N floats after the ring), each
// later split but the last is added to it, and fold_finish adds the last as
// the block stores. acc is a thread's N accumulators, viewed flat.
//
// After `done` of a block's n chunks: at the end of each split but the
// last, add acc to the running sum and restart acc from zero. split_end is
// the chunk count at which the current split ends (chunks_per_split at
// first; moved on here), so a chunk costs one comparison.
template <int kThreads, int N>
__device__ __forceinline__ void fold_split(float* sum, float (&acc)[N], int done, int n,
                                           int chunks_per_split, int& split_end) {
  if (done != split_end || done == n) return;  // inside a split, or the last
  split_end += chunks_per_split;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float* p = sum + i * kThreads + threadIdx.x;
    *p = done == chunks_per_split ? acc[i] : *p + acc[i];
    acc[i] = 0.0f;
  }
}

// The folded sums: the running sum plus the last split's, into acc.
template <int kThreads, int N>
__device__ __forceinline__ void fold_finish(const float* sum, float (&acc)[N], int n,
                                            int chunks_per_split) {
  if (n <= chunks_per_split) return;  // one split: nothing was folded
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = sum[i * kThreads + threadIdx.x] + acc[i];
}

// The launch shape of a tile kernel T (its threads and dynamic shared
// memory) with kExtra bytes more after T's ring (a fold's running sums).
template <class T, size_t kExtra>
struct WithSmem {
  static constexpr int kThreads = T::kThreads;
  static constexpr size_t kSmem = T::kSmem + kExtra;
};

// Launch a tile kernel (T names its kThreads and kSmem) with its dynamic shared memory, then, under a split of
// K, the reduction. Returns cudaGetLastError(). Without the opt-in a block
// gets 48 KB of shared memory, static and dynamic together; a kernel's static
// arrays (the conv's row table, 2 KB at most) stay under kStaticSmemRoom.
constexpr size_t kStaticSmemRoom = 16 * 1024;

template <class T, class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, const Epilogue& e, int splits,
           long long n_out, int ldc, Args... args) {
  if (T::kSmem + kStaticSmemRoom > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  Epilogue tile_e = e;
  if (splits <= 1) tile_e.ws = nullptr;
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(tile_e, args...);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const long long blocks = (n_out + 255) / 256;
  split_reduce_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      e.ws, splits, n_out, ldc, e);
  return (int)cudaGetLastError();
}

}  // namespace splitk
