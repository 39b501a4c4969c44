// GFID convolution on int8 operands (NHWC x HWIO -> NHWC) with an exact int32
// accumulator and a fused dequant + bias + activation epilogue, fp32 out, for
// Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_conv.py
//   gfid_conv2d_nhwc_int8 (_accumulate_int8, _kernel_int8), together with the
//   quantize-then-pad and group glue of src/repro/kernels/ops.py::
//   _gfid_conv2d_int8 (the operands arrive quantized; padding and groups are
//   handled here).
//
// What bounds it on an H100: at AlexNet batch 1 the five convs do 666 M
//   multiply-adds on about 5 MB of traffic (int8 inputs and weights, fp32
//   outputs): under the card's int8 tensor-core rate the bytes are the floor.
//   This kernel multiplies on the CUDA cores (__dp4a, 4 multiply-adds an
//   instruction), so its own issue rate, and at batch 1 the few output
//   pixels of conv3-5 (169 per image), bound it in practice.
//
// What the design does about it: it is an implicit GEMM per (image, group):
//   rows are the output pixels of the image flattened over H_out x W_out (so
//   13-wide rows waste no threads, unlike a one-row tile), columns the output
//   channels of the group, and K = H_f x W_f x C_in/groups in HWIO order,
//   which is also the row order of the flattened weights. A block owns 64
//   pixels by 64 channels; each thread a 4 x 4 register tile of int32 sums.
//   For each 32-deep K chunk the block gathers the x tile (64 pixels x 32
//   taps) and the weight tile (32 taps x 64 channels, stored channel-major)
//   into shared memory as 4-byte words, then runs __dp4a over them. The
//   gather masks the border: a tap outside the input reads the int8 value 0,
//   which is exact, as the reference pads after quantizing. Where C_in/groups
//   is a multiple of 4 the four taps of a word are four adjacent channels and
//   one aligned 32-bit load; otherwise (conv1, C_in = 3) the word is packed
//   from byte loads, zero-filled past the end of K. The group index is part of
//   the launch grid, so a padded, grouped conv is one launch.
//   Where the pixel and channel tiles give too few blocks for the 132 SMs
//   (conv3-5 at batch 1 give 12-18), the wrapper splits K across blocks: the
//   partial sums are added into an int32 workspace with atomics (integer
//   addition in any order gives the same sum) and the block that arrives
//   last for a tile, by a ticket counter, runs the epilogue.
//   The epilogue is `dequant_epilogue` of epilogue.cuh with scale =
//   sx[b] * sw[c_out], one fp32 multiply: bitwise the plain version's for act
//   none and relu.
//
// int32 range: |acc| <= K * 127^2; AlexNet's largest K is conv3's 3 x 3 x 256
//   = 2304, at most 3.7e7, far below 2^31. The wrapper refuses K above
//   133,144.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPixTile = 64;   // output pixels (of one image) per block
constexpr int kCoutTile = 64;  // output channels (of one group) per block
constexpr int kKc = 32;        // K chunk staged per step
constexpr int kKw = kKc / 4;   // words of one staged row
constexpr int kWStride = kKw + 1;  // odd word stride of the weight tile: no bank conflicts
constexpr int kChanLanes = 16;
constexpr int kPixLanes = kThreads / kChanLanes;  // 16
constexpr int kPixPerThread = kPixTile / kPixLanes;       // 4
constexpr int kChanPerThread = kCoutTile / kChanLanes;    // 4

// x[b, h, w, c] of the tap kk (in HWIO order: j, i, c within the group) for
// output pixel (zo, to), or 0 outside the input.
__device__ __forceinline__ uint32_t load_tap(const uint8_t* __restrict__ xb, int kk, int cg,
                                             int W_f, int zo, int to, int stride, int pad,
                                             int H_in, int W_in, int C_in) {
  const int c = kk % cg;
  const int t = kk / cg;
  const int h = zo * stride + t / W_f - pad;
  const int wi = to * stride + t % W_f - pad;
  if (h < 0 || h >= H_in || wi < 0 || wi >= W_in) return 0u;
  return xb[((size_t)h * W_in + wi) * C_in + c];
}

__global__ void __launch_bounds__(kThreads)
gfid_conv2d_nhwc_int8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                             const float* __restrict__ sx, const float* __restrict__ sw,
                             const float* __restrict__ bias, float* __restrict__ out,
                             int* __restrict__ ws, unsigned int* __restrict__ tickets,
                             int H_in, int W_in, int C_in, int H_f, int W_f, int C_out,
                             int H_out, int W_out, int stride, int pad, int groups,
                             int splits, int chunks_per_split, int act, int vec_x) {
  __shared__ int xs[kPixTile][kKw];
  __shared__ int wsm[kCoutTile][kWStride];
  __shared__ unsigned int is_last;
  const int cg = C_in / groups;
  const int og = C_out / groups;
  const int n_cot = (og + kCoutTile - 1) / kCoutTile;
  const int g = blockIdx.x / n_cot;
  const int co0 = (blockIdx.x % n_cot) * kCoutTile;  // within the group
  const int p0 = blockIdx.y * kPixTile;
  const int b = blockIdx.z / splits;
  const int part = blockIdx.z % splits;
  const int P = H_out * W_out;
  const int Kg = H_f * W_f * cg;
  const int n_chunks = (Kg + kKc - 1) / kKc;
  const int ch_begin = part * chunks_per_split;
  const int ch_end = min(n_chunks, ch_begin + chunks_per_split);
  const int tid = threadIdx.x;
  const int tc = tid % kChanLanes;
  const int tp = tid / kChanLanes;
  const int cbase = g * og + co0;  // first output channel of this block
  const uint8_t* xb = x + (size_t)b * H_in * W_in * C_in + (size_t)g * cg;

  int acc[kPixPerThread][kChanPerThread];
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p)
#pragma unroll
    for (int q = 0; q < kChanPerThread; ++q) acc[p][q] = 0;

  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int k0 = ch * kKc;
    for (int idx = tid; idx < kPixTile * kKw; idx += kThreads) {
      const int p = idx / kKw;
      const int kk = k0 + 4 * (idx % kKw);
      const int pix = p0 + p;
      uint32_t v = 0u;
      if (pix < P && kk < Kg) {
        const int zo = pix / W_out;
        const int to = pix % W_out;
        if (vec_x) {  // four adjacent channels of one tap: one aligned word
          const int c = kk % cg;
          const int t = kk / cg;
          const int h = zo * stride + t / W_f - pad;
          const int wi = to * stride + t % W_f - pad;
          if (h >= 0 && h < H_in && wi >= 0 && wi < W_in)
            v = *reinterpret_cast<const unsigned int*>(xb + ((size_t)h * W_in + wi) * C_in + c);
        } else {
          for (int r = 0; r < 4 && kk + r < Kg; ++r)
            v |= load_tap(xb, kk + r, cg, W_f, zo, to, stride, pad, H_in, W_in, C_in)
                 << (8 * r);
        }
      }
      xs[p][idx % kKw] = (int)v;
    }
    for (int idx = tid; idx < kCoutTile * kKw; idx += kThreads) {
      const int co = idx % kCoutTile;  // fastest: neighbouring threads, neighbouring bytes
      const int q = idx / kCoutTile;
      uint32_t v = 0u;
      if (co0 + co < og) {
        for (int r = 0; r < 4; ++r) {
          const int kk = k0 + 4 * q + r;
          if (kk < Kg) v |= (uint32_t)__ldg(w + (size_t)kk * C_out + cbase + co) << (8 * r);
        }
      }
      wsm[co][q] = (int)v;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kKw; ++q) {
      int xv[kPixPerThread], wv[kChanPerThread];
#pragma unroll
      for (int p = 0; p < kPixPerThread; ++p) xv[p] = xs[tp + p * kPixLanes][q];
#pragma unroll
      for (int c = 0; c < kChanPerThread; ++c) wv[c] = wsm[tc + c * kChanLanes][q];
#pragma unroll
      for (int p = 0; p < kPixPerThread; ++p)
#pragma unroll
        for (int c = 0; c < kChanPerThread; ++c) acc[p][c] = __dp4a(xv[p], wv[c], acc[p][c]);
    }
    __syncthreads();  // the tiles are rewritten by the next chunk
  }

  // out and ws are (B, P, C_out): NHWC with the pixels flattened.
  const size_t out_b = (size_t)b * P * C_out;
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p) {
    const int pix = p0 + tp + p * kPixLanes;
    if (pix >= P) continue;
#pragma unroll
    for (int c = 0; c < kChanPerThread; ++c) {
      const int co = tc + c * kChanLanes;
      if (co0 + co >= og) continue;
      const size_t o = out_b + (size_t)pix * C_out + cbase + co;
      if (splits > 1) {
        atomicAdd(&ws[o], acc[p][c]);
      } else {
        out[o] = dequant_epilogue(acc[p][c], __fmul_rn(sx[b], sw[cbase + co]), bias,
                                  cbase + co, act);
      }
    }
  }
  if (splits == 1) return;

  // Split K: the last block to finish this tile dequantizes the full sums.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int tile = (b * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    is_last = atomicAdd(&tickets[tile], 1u) == (unsigned int)(splits - 1);
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int p = 0; p < kPixPerThread; ++p) {
    const int pix = p0 + tp + p * kPixLanes;
    if (pix >= P) continue;
#pragma unroll
    for (int c = 0; c < kChanPerThread; ++c) {
      const int co = tc + c * kChanLanes;
      if (co0 + co >= og) continue;
      const size_t o = out_b + (size_t)pix * C_out + cbase + co;
      out[o] = dequant_epilogue(__ldcg(&ws[o]), __fmul_rn(sx[b], sw[cbase + co]), bias,
                                cbase + co, act);
    }
  }
}

}  // namespace

// xq (B, H_in, W_in, C_in) and wq (H_f, W_f, C_in/groups, C_out) int8; sx (B,)
// and sw (C_out,) fp32; bias (C_out,) fp32 or null; out (B, H_out, W_out,
// C_out) fp32. With splits > 1, ws is a zeroed int32 workspace of out's shape
// and tickets a zeroed array of one counter per (image, pixel tile, channel
// tile) block; with splits == 1 both may be null. act: 0 none, 1 relu, 2 gelu.
// Launches on `stream` and returns cudaGetLastError() (0 when accepted).
extern "C" int gfid_conv2d_nhwc_int8(const void* xq, const void* wq, const float* sx,
                                     const float* sw, const float* bias, float* out, int* ws,
                                     unsigned int* tickets, int B, int H_in, int W_in,
                                     int C_in, int H_f, int W_f, int C_out, int H_out,
                                     int W_out, int stride, int pad, int groups, int splits,
                                     int chunks_per_split, int act, int vec_x, void* stream) {
  const int og = C_out / groups;
  const int n_cot = (og + kCoutTile - 1) / kCoutTile;
  const int n_pt = (H_out * W_out + kPixTile - 1) / kPixTile;
  const dim3 grid(groups * n_cot, n_pt, B * splits);
  gfid_conv2d_nhwc_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(wq), sx, sw, bias, out,
      ws, tickets, H_in, W_in, C_in, H_f, W_f, C_out, H_out, W_out, stride, pad, groups,
      splits, chunks_per_split, act, vec_x);
  return (int)cudaGetLastError();
}
