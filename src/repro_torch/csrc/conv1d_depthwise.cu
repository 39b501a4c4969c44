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
//   xlstm-125m's prefill (1, 384, 1536) fp32 the floor is x read once, w read
//   once and out written once over the memory rate, about 1.4 us; a launch
//   of that size is short enough that the latency of its loads counts too.
//
// What the design does about it: a block owns a tile of kT = 8 consecutive
//   positions x kC = 128 channels of one sequence, one warp, each thread 4
//   consecutive channels; the grid is (tiles of L x B, tiles of D), so
//   (1, 384, 768) and (1, 384, 1536) give 288 and 576 blocks, and a block
//   finds its sequence and tile with one division, a thread never divides
//   in its loop (on an H100, tiles of 4 and 8 positions ran level, 16 and 32
//   slower: more, shorter chains of loads win). A thread loads its W_f x 4 taps once and the tile's
//   kT + W_f - 1 rows of its channels into registers, every load issued
//   before the first sum (a launch this short is bound by the latency of
//   its loads, so all of them are in flight at once), then walks its kT
//   positions with a window of the last W_f rows sliding down those
//   registers: each x element comes from device memory once, plus a halo of
//   W_f - 1 rows a tile. Where D % 4 == 0 and x is 16-byte aligned,
//   a thread's 4 channels are one float4 (fp32) or 8-byte (bf16) load and
//   one float4 store, a warp 512 contiguous bytes a row; else 4 scalar
//   accesses with bounds checks (any D). Offsets are 32-bit where
//   B * L * D < 2^31, else 64-bit. Above kRegTaps taps (hubert's centred
//   128-tap positional conv) the window no longer fits in registers: the
//   block stages its (kT + W_f - 1) x kC tile of x in shared memory instead,
//   kTapChunk taps at a time ((kT + kTapChunk - 1) rows a piece), and each
//   thread keeps its kT x 4 sums in registers across the pieces. The pad is a
//   bounds check on the load (0.0f), not a padded copy.
//
// Arithmetic order: the taps are summed in ascending order from 0.0f, each
//   product and each sum rounded on its own (__fmul_rn / __fadd_rn, which
//   nvcc never contracts into an FMA), padded rows as products of 0.0f, so
//   every path is bitwise that of the plain version, `acc = acc + x_shifted
//   * w[i]` over i in torch ops.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kT = 8;              // positions of a block's tile, walked by each thread
constexpr int kC = 128;            // channels of a block's tile, 4 a thread
constexpr int kThreads = kC / 4;   // one warp
constexpr int kRegTaps = 8;        // W_f up to this: the register window
constexpr int kTapChunk = 32;      // taps a staged piece of the shared-memory path

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The 4 channels c .. c + 3 at element offset `off` (that of channel c) as
// floats: one aligned load (kVec), or scalars with zeros past d.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, long long off, int c, int d) {
  if constexpr (kVec) return *reinterpret_cast<const float4*>(p + off);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < d ? p[off + e] : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
template <bool kVec>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long off, int c, int d) {
  if constexpr (kVec) {
    const uint2 u = *reinterpret_cast<const uint2*>(p + off);
    return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c + e < d ? to_f32(p[off + e]) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// Tap i of channels c .. c + 3 (scalar loads: once a thread, or once a tap
// on the shared-memory path), zeros past d.
__device__ __forceinline__ float4 load_taps(const void* w, int w_bf16, int i, int c, int d) {
  const long long off = (long long)i * d + c;
  return w_bf16 ? load4<false>(static_cast<const __nv_bfloat16*>(w), off, c, d)
                : load4<false>(static_cast<const float*>(w), off, c, d);
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, long long off, int c, int d, float4 v) {
  if constexpr (kVec) {
    *reinterpret_cast<float4*>(p + off) = v;
  } else {
    const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < d) p[off + e] = a[e];
  }
}

// acc += x * w, each product and sum rounded on its own.
__device__ __forceinline__ void madd(float4& acc, float4 x, float4 w) {
  acc.x = __fadd_rn(acc.x, __fmul_rn(x.x, w.x));
  acc.y = __fadd_rn(acc.y, __fmul_rn(x.y, w.y));
  acc.z = __fadd_rn(acc.z, __fmul_rn(x.z, w.z));
  acc.w = __fadd_rn(acc.w, __fmul_rn(x.w, w.w));
}

// Row `row` of sequence `seq` (its first row's index, b * L), channels c ..
// c + 3; zeros outside [0, l).
template <class TX, bool kVec, class Idx>
__device__ __forceinline__ float4 load_row(const TX* x, Idx seq, int row, int l, int c, int d) {
  if ((unsigned)row >= (unsigned)l) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  return load4<kVec>(x, (long long)((seq + (Idx)row) * (Idx)d + (Idx)c), c, d);
}

// W_f <= kRegTaps. rows[u] holds x row t0 - lpad - (kRegTaps - W_f) + u, so
// output t0 + j's window is rows[j + s] for s from kRegTaps - W_f (its tap
// s - (kRegTaps - W_f)); the rows below kRegTaps - W_f are never read
// (their taps are zero) and never loaded. Every row is loaded before the
// first sum, so all the tile's loads are in flight at once.
template <class TX, bool kVec, class Idx>
__global__ void __launch_bounds__(kThreads)
conv1d_window_kernel(const TX* __restrict__ x, const void* __restrict__ w, int w_bf16,
                     float* __restrict__ out, int l, int d, int w_f, int lpad) {
  constexpr int kRows = kT + kRegTaps - 1;
  const int tiles = (l + kT - 1) / kT;
  const int bi = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - bi * tiles) * kT;
  const int c = blockIdx.y * kC + 4 * threadIdx.x;
  if (c >= d) return;
  const Idx seq = (Idx)bi * (Idx)l;
  const int skip = kRegTaps - w_f;  // slots before the first tap
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 taps[kRegTaps], rows[kRows];
#pragma unroll
  for (int s = 0; s < kRegTaps; ++s)
    taps[s] = s >= skip ? load_taps(w, w_bf16, s - skip, c, d) : zero;
  const int row0 = t0 - lpad - skip;
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    rows[u] = u >= skip ? load_row<TX, kVec, Idx>(x, seq, row0 + u, l, c, d) : zero;
#pragma unroll
  for (int j = 0; j < kT; ++j) {
    float4 acc = zero;
#pragma unroll
    for (int s = 0; s < kRegTaps; ++s)
      if (s >= skip) madd(acc, rows[j + s], taps[s]);
    const int t = t0 + j;
    if (t < l) store4<kVec>(out, (long long)((seq + (Idx)t) * (Idx)d + (Idx)c), c, d, acc);
  }
}

// W_f > kRegTaps: the tile's rows staged in shared memory, kTapChunk taps
// at a time. Each thread stages and reads only its own 4 channels of a row,
// so no barrier is needed between the two.
template <class TX, bool kVec, class Idx>
__global__ void __launch_bounds__(kThreads)
conv1d_staged_kernel(const TX* __restrict__ x, const void* __restrict__ w, int w_bf16,
                     float* __restrict__ out, int l, int d, int w_f, int lpad) {
  __shared__ float4 tile[kT + kTapChunk - 1][kThreads];
  const int tiles = (l + kT - 1) / kT;
  const int bi = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - bi * tiles) * kT;
  const int c = blockIdx.y * kC + 4 * threadIdx.x;
  if (c >= d) return;
  const Idx seq = (Idx)bi * (Idx)l;
  float4 acc[kT];
#pragma unroll
  for (int j = 0; j < kT; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i0 = 0; i0 < w_f; i0 += kTapChunk) {
    const int taps = min(kTapChunk, w_f - i0);
    for (int r = 0; r < kT + taps - 1; ++r)  // rows t0 - lpad + i0 + r
      tile[r][threadIdx.x] = load_row<TX, kVec, Idx>(x, seq, t0 - lpad + i0 + r, l, c, d);
    for (int i = 0; i < taps; ++i) {
      const float4 wv = load_taps(w, w_bf16, i0 + i, c, d);
#pragma unroll
      for (int j = 0; j < kT; ++j) madd(acc[j], tile[j + i][threadIdx.x], wv);
    }
  }
#pragma unroll
  for (int j = 0; j < kT; ++j)
    if (t0 + j < l)
      store4<kVec>(out, (long long)((seq + (Idx)(t0 + j)) * (Idx)d + (Idx)c), c, d, acc[j]);
}

template <class TX, bool kVec, class Idx>
int launch(const void* x, const void* w, int w_bf16, float* out, int b, int l, int d, int w_f,
           int lpad, cudaStream_t stream) {
  const dim3 grid((l + kT - 1) / kT * b, (d + kC - 1) / kC);
  const TX* xt = static_cast<const TX*>(x);
  if (w_f <= kRegTaps)
    conv1d_window_kernel<TX, kVec, Idx><<<grid, kThreads, 0, stream>>>(xt, w, w_bf16, out, l, d,
                                                                       w_f, lpad);
  else
    conv1d_staged_kernel<TX, kVec, Idx><<<grid, kThreads, 0, stream>>>(xt, w, w_bf16, out, l, d,
                                                                       w_f, lpad);
  return (int)cudaGetLastError();
}

template <class TX>
int launch_x(const void* x, const void* w, int w_bf16, float* out, int b, int l, int d,
             int w_f, int lpad, int vec, cudaStream_t s) {
  const bool narrow = (long long)b * l * d < (1LL << 31);
  if (vec)
    return narrow ? launch<TX, true, int>(x, w, w_bf16, out, b, l, d, w_f, lpad, s)
                  : launch<TX, true, long long>(x, w, w_bf16, out, b, l, d, w_f, lpad, s);
  return narrow ? launch<TX, false, int>(x, w, w_bf16, out, b, l, d, w_f, lpad, s)
                : launch<TX, false, long long>(x, w, w_bf16, out, b, l, d, w_f, lpad, s);
}

}  // namespace

// x: (b, l, d) fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (w_f, d) likewise
// (w_bf16); out: (b, l, d) fp32; all contiguous; b * l * d > 0. lpad is the
// number of zero rows before the sequence. vec: float4 (fp32) or 8-byte
// (bf16) loads of x and float4 stores, for d % 4 == 0 on a 16-byte aligned
// x and out. Launches on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted).
extern "C" int conv1d_depthwise(const void* x, const void* w, float* out, int b, int l, int d,
                                int w_f, int lpad, int x_bf16, int w_bf16, int vec,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) return launch_x<__nv_bfloat16>(x, w, w_bf16, out, b, l, d, w_f, lpad, vec, s);
  return launch_x<float>(x, w, w_bf16, out, b, l, d, w_f, lpad, vec, s);
}
