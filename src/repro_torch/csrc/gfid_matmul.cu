// GFID FC mode: (M, K) fp32 @ (K, N) fp32 -> (M, N) fp32 with a fused bias +
// activation epilogue, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul (_kernel, _kernel_epilogue).
//
// What bounds it on an H100: device memory. At AlexNet batch 1 the three FC
//   layers are matrix-vector products over 151 MB (fc6), 67 MB (fc7) and
//   16 MB (fc8) of fp32 weights: one multiply-add per 4-byte weight, far
//   below the ~20 flops per byte where the 3.35 TB/s memory stops being the
//   limit. The time floor is the weight bytes over the memory rate.
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
//   plain fp32 FMA: no TF32, no tensor cores.
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

__global__ void __launch_bounds__(kThreads)
gfid_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int M,
                   int K, int N, int act) {
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
      xs[m][kk] = (m0 + m < M && k0 + kk < K) ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.0f;
    }
    __syncthreads();
    const int kbeg = k0 + warp * kSlice;
    const float* wp = w + (size_t)kbeg * N + n;
    if (col_ok && kbeg + kSlice <= K) {
#pragma unroll
      for (int kk = 0; kk < kSlice; ++kk) {
        const float wv = __ldg(wp + (size_t)kk * N);
#pragma unroll
        for (int m = 0; m < kBM; ++m) acc[m] = fmaf(xs[m][warp * kSlice + kk], wv, acc[m]);
      }
    } else if (col_ok) {
      for (int kk = 0; kk < kSlice && kbeg + kk < K; ++kk) {
        const float wv = __ldg(wp + (size_t)kk * N);
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
      if (bias != nullptr) v += bias[nn];
      out[(size_t)(m0 + m) * N + nn] = apply_act(v, act);
    }
  }
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh). bias may be null. Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int gfid_matmul_f32(const float* x, const float* w, const float* bias,
                               float* out, int M, int K, int N, int act, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gfid_matmul_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(x, w, bias, out, M, K,
                                                                   N, act);
  return (int)cudaGetLastError();
}
