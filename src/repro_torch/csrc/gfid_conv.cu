// GFID convolution (NHWC x HWIO -> NHWC, fp32) with a fused bias + activation
// epilogue, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_conv.py
//   gfid_conv2d_nhwc (_accumulate, _kernel, _kernel_epilogue), together with
//   the padding and group glue of src/repro/kernels/ops.py::gfid_conv2d.
//
// What bounds it on an H100: fp32 arithmetic. At AlexNet batch 1 the five
//   convs do 665.8 M multiply-adds on 13.8 MB of fp32 traffic, about 96
//   flops per byte, well above the ~20 flops per byte where the card's
//   67 TFLOP/s fp32 (non-tensor-core) peak overtakes its 3.35 TB/s.
//
// What the design does about it: it keeps operands on chip and the FMA
//   units fed from registers. A block owns one output row (b, h_out) of one
//   group by a 64-channel C_out tile: the GFID one-row sweep of the TPU
//   grid (B, H_out, n_cout, H_f, n_cin). The TPU's sequential (H_f, C_in)
//   grid axes become a loop inside the block: for each filter row j and
//   each 8-channel C_in chunk, the input row segment and the W_f x 8 x 64
//   weight taps are staged in shared memory, and each thread accumulates a
//   4-pixel x 4-channel register tile over the W_f taps (the W_f shifted
//   GEMMs of the TPU kernel). After the last (j, chunk) step the epilogue
//   adds the bias, applies the activation and stores once. Zero padding is
//   a bounds mask on the loads (no padded copy of x), and the group index
//   is part of the launch grid, so a grouped conv is one launch.
//   Accumulation is plain fp32 FMA: no TF32, no tensor cores (a later
//   change may move the inner product onto wgmma).
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCoutTile = 64;  // output channels per block
constexpr int kCinTile = 8;    // input channels staged per step
constexpr int kPixTile = 64;   // output pixels of the row per pass
constexpr int kChanLanes = 16;  // threads across channels, 4 channels each
constexpr int kPixLanes = kThreads / kChanLanes;           // 16
constexpr int kPixPerThread = kPixTile / kPixLanes;         // 4
constexpr int kChanPerThread = kCoutTile / kChanLanes;      // 4
constexpr int kXsStride = kCinTile + 1;  // odd row stride: fewer bank conflicts

static_assert(kChanPerThread == 4, "weights are read from shared memory as float4");

__global__ void __launch_bounds__(kThreads)
gfid_conv2d_nhwc_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int H_in, int W_in, int C_in, int H_f, int W_f, int C_out,
                        int H_out, int W_out, int stride, int pad, int groups,
                        int act) {
  extern __shared__ __align__(16) float smem[];
  const int cg = C_in / groups;
  const int og = C_out / groups;
  const int n_cot = (og + kCoutTile - 1) / kCoutTile;
  const int g = blockIdx.x / n_cot;
  const int co0 = (blockIdx.x % n_cot) * kCoutTile;  // within the group
  const int zo = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tc = tid % kChanLanes;
  const int tp = tid / kChanLanes;
  const int x_pix = (kPixTile - 1) * stride + W_f;  // input pixels per pass

  float* ws = smem;                                  // [W_f][kCinTile][kCoutTile]
  float* xs = smem + W_f * kCinTile * kCoutTile;     // [x_pix][kXsStride]
  const float* xb = x + (size_t)b * H_in * W_in * C_in + (size_t)g * cg;
  const int cbase = g * og + co0;  // first output channel of this block

  for (int w0 = 0; w0 < W_out; w0 += kPixTile) {
    float acc[kPixPerThread][kChanPerThread];
#pragma unroll
    for (int p = 0; p < kPixPerThread; ++p)
#pragma unroll
      for (int q = 0; q < kChanPerThread; ++q) acc[p][q] = 0.0f;

    for (int j = 0; j < H_f; ++j) {
      const int h_in = zo * stride + j - pad;
      if (h_in < 0 || h_in >= H_in) continue;  // a padding row; same for the whole block
      const float* xrow = xb + (size_t)h_in * W_in * C_in;
      for (int c0 = 0; c0 < cg; c0 += kCinTile) {
        __syncthreads();  // the previous step's tiles are consumed
        for (int idx = tid; idx < x_pix * kCinTile; idx += kThreads) {
          const int px = idx / kCinTile;
          const int c = idx % kCinTile;
          const int wi = w0 * stride + px - pad;
          float v = 0.0f;
          if (wi >= 0 && wi < W_in && c0 + c < cg) v = xrow[(size_t)wi * C_in + c0 + c];
          xs[px * kXsStride + c] = v;
        }
        for (int idx = tid; idx < W_f * kCinTile * kCoutTile; idx += kThreads) {
          const int co = idx % kCoutTile;
          const int c = (idx / kCoutTile) % kCinTile;
          const int i = idx / (kCoutTile * kCinTile);
          float v = 0.0f;
          if (c0 + c < cg && co0 + co < og)
            v = w[(((size_t)j * W_f + i) * cg + c0 + c) * C_out + cbase + co];
          ws[idx] = v;
        }
        __syncthreads();
        for (int i = 0; i < W_f; ++i) {
#pragma unroll
          for (int c = 0; c < kCinTile; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(
                &ws[(i * kCinTile + c) * kCoutTile + tc * kChanPerThread]);
#pragma unroll
            for (int p = 0; p < kPixPerThread; ++p) {
              const float xv = xs[((tp + p * kPixLanes) * stride + i) * kXsStride + c];
              acc[p][0] = fmaf(xv, wv.x, acc[p][0]);
              acc[p][1] = fmaf(xv, wv.y, acc[p][1]);
              acc[p][2] = fmaf(xv, wv.z, acc[p][2]);
              acc[p][3] = fmaf(xv, wv.w, acc[p][3]);
            }
          }
        }
      }
    }

#pragma unroll
    for (int p = 0; p < kPixPerThread; ++p) {
      const int pix = w0 + tp + p * kPixLanes;
      if (pix >= W_out) continue;
      float* orow = out + (((size_t)b * H_out + zo) * W_out + pix) * C_out + cbase;
#pragma unroll
      for (int q = 0; q < kChanPerThread; ++q) {
        const int co = tc * kChanPerThread + q;
        if (co0 + co < og) {
          float v = acc[p][q];
          if (bias != nullptr) v += bias[cbase + co];
          orow[co] = apply_act(v, act);
        }
      }
    }
  }
}

}  // namespace

// act: 0 none, 1 relu, 2 gelu (tanh). bias may be null. Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int gfid_conv2d_nhwc_f32(const float* x, const float* w, const float* bias,
                                    float* out, int B, int H_in, int W_in, int C_in,
                                    int H_f, int W_f, int C_out, int H_out, int W_out,
                                    int stride, int pad, int groups, int act,
                                    void* stream) {
  const int og = C_out / groups;
  const int n_cot = (og + kCoutTile - 1) / kCoutTile;
  const size_t smem =
      sizeof(float) * ((size_t)W_f * kCinTile * kCoutTile +
                       (size_t)((kPixTile - 1) * stride + W_f) * kXsStride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gfid_conv2d_nhwc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(groups * n_cot, H_out, B);
  gfid_conv2d_nhwc_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      x, w, bias, out, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad,
      groups, act);
  return (int)cudaGetLastError();
}
