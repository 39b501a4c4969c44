// GFID FC mode: (M, K) @ (K, N) -> (M, N) with a fused bias + activation
// epilogue, for Hopper (sm_90a). Two entries share one kernel template:
// `gfid_matmul_f32` (fp32 x and w, fp32 out) and `gfid_matmul_bf16` (bf16 x
// and w, each value widened with __bfloat162float; an fp32 or bf16 bias; the
// result stored in fp32 or rounded once to bf16 with __float2bfloat16_rn).
// Both accumulate in fp32 in the same fixed K order: a product of two bf16
// values is exact in fp32, so the bf16 entry computes the fp32 entry's
// function on the widened operands.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul (_kernel, _kernel_epilogue), for fp32 and bf16 operands
//   (`preferred_element_type=jnp.float32`; the bf16 result is the fp32 one
//   cast by src/repro/kernels/ops.py::gfid_matmul).
//
// What bounds it on an H100: device memory. At AlexNet batch 1 the three FC
//   layers are matrix-vector products over 151 MB (fc6), 67 MB (fc7) and
//   16 MB (fc8) of fp32 weights: one multiply-add per 4-byte weight, far
//   below the ~20 flops per byte where the 3.35 TB/s memory stops being the
//   limit. The time floor is the weight bytes over the memory rate. In
//   bf16 the weights are half the bytes and the floor halves; smollm-135m's
//   decode GEMMs (M = 8) are bound the same way.
//
// What the design does about it: every weight is read from device memory
//   once per 8-row block of x, coalesced along N, and enough loads are in
//   flight to cover the memory latency. A block owns 32 output columns (one
//   per lane) and up to 8 rows; its 8 warps split K between them (each warp
//   takes a 32-row slice of every 256-row chunk), so N = 4096 gives 128
//   blocks of 256 threads for the 132 SMs. The TPU's sequential K grid axis
//   (accumulator kept in the output block) becomes the chunk loop; the x
//   chunk is staged in shared memory and read as a broadcast. The 8 warps'
//   partial sums are added in a fixed order in shared memory, then the
//   epilogue adds the bias, applies the activation and stores once. Edges
//   are masked; there is no padding to tile multiples. Accumulation is
//   plain fp32 FMA: no TF32, no tensor cores. Nothing depends on M but the
//   count of row blocks (no split-K), so a row's sums run in one order
//   whatever rows share the launch: the serving scheduler's tokens are
//   bitwise across batchings on that.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // K is split across the warps
constexpr int kBN = 32;                // output columns per block, one per lane
constexpr int kBM = 8;                 // rows of x per block
constexpr int kKT = 256;               // K chunk staged per step
constexpr int kSlice = kKT / kWarps;   // K rows of a chunk per warp

// T: the operands' type (float or __nv_bfloat16); O: the output's.
template <typename T, typename O>
__global__ void __launch_bounds__(kThreads)
gfid_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const void* __restrict__ bias, int bias_bf16,
                   O* __restrict__ out, int M, int K, int N, int act) {
  __shared__ float xs[kBM][kKT];
  __shared__ float red[kWarps][kBM][kBN];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n = blockIdx.x * kBN + lane;
  const int m0 = blockIdx.y * kBM;
  const bool col_ok = n < N;

  float acc[kBM];
#pragma unroll
  for (int m = 0; m < kBM; ++m) acc[m] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kKT) {
    for (int idx = threadIdx.x; idx < kBM * kKT; idx += kThreads) {
      const int m = idx / kKT;
      const int kk = idx % kKT;
      xs[m][kk] = (m0 + m < M && k0 + kk < K)
                      ? load_f32(x + (size_t)(m0 + m) * K + k0 + kk) : 0.0f;
    }
    __syncthreads();
    const int kbeg = k0 + warp * kSlice;
    const T* wp = w + (size_t)kbeg * N + n;
    if (col_ok && kbeg + kSlice <= K) {
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float wv = load_f32(wp + (size_t)kk * N);
#pragma unroll
        for (int m = 0; m < kBM; ++m) acc[m] = fmaf(xs[m][warp * kSlice + kk], wv, acc[m]);
      }
    } else if (col_ok) {
      for (int kk = 0; kk < kSlice && kbeg + kk < K; ++kk) {
        const float wv = load_f32(wp + (size_t)kk * N);
#pragma unroll
        for (int m = 0; m < kBM; ++m) acc[m] = fmaf(xs[m][warp * kSlice + kk], wv, acc[m]);
      }
    }
    __syncthreads();  // xs is rewritten by the next chunk
  }

#pragma unroll
  for (int m = 0; m < kBM; ++m) red[warp][m][lane] = acc[m];
  __syncthreads();
  for (int idx = threadIdx.x; idx < kBM * kBN; idx += kThreads) {
    const int m = idx / kBN;
    const int c = idx % kBN;
    const int nn = blockIdx.x * kBN + c;
    if (m0 + m < M && nn < N) {
      float v = 0.0f;
#pragma unroll
      for (int s = 0; s < kWarps; ++s) v += red[s][m][c];
      if (bias != nullptr) v += bias_at(bias, bias_bf16, nn);
      store_as(out + (size_t)(m0 + m) * N + nn, apply_act(v, act));
    }
  }
}

template <typename T, typename O>
int launch(const T* x, const T* w, const void* bias, int bias_bf16, O* out, int M, int K,
           int N, int act, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gfid_matmul_kernel<T, O><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, w, bias, bias_bf16, out, M, K, N, act);
  return (int)cudaGetLastError();
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh). bias may be null. Each launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int gfid_matmul_f32(const float* x, const float* w, const float* bias,
                               float* out, int M, int K, int N, int act, void* stream) {
  return launch<float, float>(x, w, bias, 0, out, M, K, N, act, stream);
}

// bf16 x and w; bias fp32 (bias_bf16 = 0) or bf16 (1); out fp32 (out_bf16 = 0)
// or bf16 (1).
extern "C" int gfid_matmul_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                const void* bias, int bias_bf16, void* out, int out_bf16,
                                int M, int K, int N, int act, void* stream) {
  if (out_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, bias_bf16,
                                                (__nv_bfloat16*)out, M, K, N, act, stream);
  return launch<__nv_bfloat16, float>(x, w, bias, bias_bf16, (float*)out, M, K, N, act,
                                      stream);
}
