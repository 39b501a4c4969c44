// The end of a block-tiled kernel, shared by the bf16 tensor-core GEMM and
// conv (through mma_bf16.cuh) and the fp32 implicit-GEMM conv (gfid_conv.cu):
// where a block's results go (`Epilogue`: bias, act and the fp32 or bf16
// store, or the fp32 partial sums of one split of K), the split reduction
// that adds those partials in split order (no atomics, so a result does not
// change from run to run), and the launch of a tile kernel with its dynamic
// shared memory followed, under a split, by that reduction.
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
