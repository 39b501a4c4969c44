// Depthwise 1-D convolution, the GFID 1-D mode (the SSM short convs and the
// positional conv), for Hopper (sm_90a):
//   out[b, l, d] = sum_{i < W_f} x[b, l + i - lpad, d] * w[i, d]
// with zeros outside [0, L): lpad = W_f - 1 (causal) or (W_f - 1) / 2
// (centred). x and w are fp32 or bf16; out is fp32.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/conv1d.py
//   gfid_conv1d_depthwise (_kernel), which pads the sequence in device
//   memory, holds one (L + W_f - 1, 512-channel) block in VMEM and sums the
//   W_f shifted products with the VPU.
//
// What bounds it on an H100: device memory. Each output is W_f
//   multiply-adds, so at W_f = 4 the work is 8 flops for 4 + 4 bytes of fp32
//   input and output: far below the card's balance of flops to bytes. At
//   xlstm-125m's prefill (1, L, 1536) fp32 the floor is x read once, w read
//   once and out written once over the memory rate, about 0.9 us at L = 243.
//
// What the design does about it: one thread per output (b, l, d), d fastest,
//   so each warp reads 32 neighbouring channels of one row of x and of w
//   and writes 32 neighbouring outputs: every access coalesces, and the
//   W_f - 1 re-reads of a row of x by the outputs below it hit L1/L2, not
//   device memory. The pad is a bounds check on the load (the value is
//   0.0f), not a padded copy. Any D and any W_f are taken (no channel-block
//   divisibility), with 64-bit offsets and a grid-stride loop.
//
// Arithmetic order: the taps are summed in ascending order from 0.0f, each
//   product and each sum rounded on its own (__fmul_rn / __fadd_rn, which
//   nvcc never contracts into an FMA), so the result is bitwise that of the
//   plain version, `acc = acc + x_shifted * w[i]` over i in torch ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
conv1d_depthwise_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                        float* __restrict__ out, long long b, long long l,
                        long long d, int w_f, int lpad) {
  const long long total = b * l * d;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
       idx < total; idx += stride) {
    const long long c = idx % d;
    const long long row = idx / d;  // b * L + t
    const long long t = row % l;
    const long long base = row - t;  // b * L
    float acc = 0.0f;
    for (int i = 0; i < w_f; ++i) {
      const long long src = t + i - lpad;
      const float xv =
          (src >= 0 && src < l) ? load_f32(x, (base + src) * d + c) : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(xv, load_f32(w, (long long)i * d + c)));
    }
    out[idx] = acc;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, float* out, long long b, long long l,
           long long d, int w_f, int lpad, cudaStream_t stream) {
  const long long total = b * l * d;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 1048576) blocks = 1048576;  // the grid-stride loop does the rest
  conv1d_depthwise_kernel<TX, TW><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), out, b, l, d, w_f,
      lpad);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, l, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (w_f, d) likewise
// (w_bf16); out: (b, l, d) fp32; all contiguous; b * l * d > 0. lpad is the
// number of zero rows before the sequence. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int conv1d_depthwise(const void* x, const void* w, float* out,
                                long long b, long long l, long long d, int w_f,
                                int lpad, int x_bf16, int w_bf16,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, b, l, d, w_f, lpad, s);
  if (x_bf16) return launch<__nv_bfloat16, float>(x, w, out, b, l, d, w_f, lpad, s);
  if (w_bf16) return launch<float, __nv_bfloat16>(x, w, out, b, l, d, w_f, lpad, s);
  return launch<float, float>(x, w, out, b, l, d, w_f, lpad, s);
}
