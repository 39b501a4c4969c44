// Online-softmax attention forward, causal or not, for Hopper (sm_90a):
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  * v[b, j, h / G]
// over the keys j that row i may see (j <= i when causal, positions from 0
// for both q and k), with G = H / KV query heads per kv head (GQA as an
// index: no repeated copy of k and v). q is (B, Sq, H, D), k and v are
// (B, Skv, KV, D), out is (B, Sq, H, D); fp32 or bf16, widened on load, fp32
// inside, written in q's dtype.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention (_kernel), whose grid (B, H, n_q, n_kv) walks the kv
//   blocks of one q block in order and carries the running max, sum and
//   accumulator in VMEM scratch between grid steps; its caller broadcasts
//   the kv heads with jnp.repeat first.
//
// What bounds it on an H100: operations. A causal (1, S, 9 / 3, 64) prefill
//   does about 2 * 2 * 9 * 64 * S^2 / 2 flops (4.83 GFLOP at S = 2048) on
//   12.6 MB of input and output, far above the card's balance of flops to
//   bytes. On fp32 operands with TF32 off the tensor cores do not apply, so
//   the floor is the flops over the CUDA cores' fp32 rate.
//
// What the design does about it: one block per (q tile of 64 rows, head,
//   batch), 256 threads, four to a row; each of the four owns every fourth
//   of the D columns of its row's q and fp32 accumulator in registers, and
//   the row's running max m and sum l (the four hold the same values).
//   The block walks the kv tiles of 32 keys in order: the tile's k and v
//   rows go through shared memory (bounds-masked, zeros past Skv or D),
//   each thread takes partial dot products over its columns and two xor
//   shuffles complete every score in all four threads, the tile's max
//   rescales the row once, and p * v is accumulated. The four threads of a
//   row read four neighbouring words of a shared row, the same for every
//   row of a warp, so shared loads are conflict-free broadcasts. Any Sq and
//   Skv are taken: tails are bounds masks (no gcd block rule). q tiles are
//   started longest first, which evens the causal blocks' run times.
//
// Masking: a masked score is NEG_INF (-1e30), as in the Pallas kernel, and
//   the running max starts there. Every row sees key 0 (causal or not), and
//   key 0 lies in the first tile, so after it m is a real score and a
//   masked key adds exp(-1e30 - m) = 0. Hence l >= 1 at the end, and
//   neither this mask value, the 1e-30 clamp on l, nor the -2e38 and 1e-37
//   of models/flash.py reaches the result: one kernel serves both contracts.
//   Under causal masking a kv tile whose first key lies past the block's
//   last row is not visited. That is bitwise neutral: for every row of the
//   block such a tile gives a tile max of -1e30 < m, so m stays, alpha =
//   exp(0) = 1, and l * 1 + 0 and acc * 1 + 0 are exactly l and acc.
//
// Arithmetic: expf (not __expf) and IEEE division; built without
//   --use_fast_math. No tensor cores. Sums run in another order than the
//   plain version's, so the two agree within a tolerance, not bitwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kLanes = 4;                  // threads per q row
constexpr int kBQ = 64;                    // q rows per block
constexpr int kBK = 32;                    // keys per kv tile
constexpr int kThreads = kBQ * kLanes;     // 256
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// DMAX: the head dim rounded up to 32, 64 or 128; columns past d are zeros.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int skv, int h, int n_kv, int d, float scale,
                       int causal) {
  constexpr int kCols = DMAX / kLanes;     // columns a thread owns
  __shared__ float ks[kBK][DMAX];
  __shared__ float vs[kBK][DMAX];

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = head / (h / n_kv);
  const int row = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const int qi = qt * kBQ + row;
  const bool live = qi < sq;

  float qr[kCols], acc[kCols];
  const size_t q_off = (((size_t)b * sq + qi) * h + head) * (size_t)d;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c * kLanes + lane;
    qr[c] = (live && col < d) ? widen(q[q_off + col]) : 0.0f;
    acc[c] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;

  const int q_last = min(sq, (qt + 1) * kBQ) - 1;   // the block's last row
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();                       // the previous tile is consumed
    for (int e = threadIdx.x; e < kBK * DMAX; e += kThreads) {
      const int r = e / DMAX, col = e % DMAX, key = k0 + r;
      float kx = 0.0f, vx = 0.0f;
      if (key < skv && col < d) {
        const size_t off = (((size_t)b * skv + key) * n_kv + kvh) * (size_t)d + col;
        kx = widen(k[off]);
        vx = widen(v[off]);
      }
      ks[r][col] = kx;
      vs[r][col] = vx;
    }
    __syncthreads();

    float s[kBK];
    float tile_max = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        part = fmaf(qr[c], ks[j][c * kLanes + lane], part);
      // (a0 + a1) + (a2 + a3) in every lane: fp addition commutes, so the
      // four threads of a row hold the same bits
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int key = k0 + j;
      const bool valid = key < skv && (!causal || key <= qi);
      s[j] = valid ? part * scale : kNegInf;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      s[j] = expf(s[j] - m_new);
      p_sum += s[j];
    }
    l = l * alpha + p_sum;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int j = 0; j < kBK; ++j) a = fmaf(s[j], vs[j][c * kLanes + lane], a);
      acc[c] = a;
    }
    m = m_new;
  }

  if (!live) return;
  const float denom = fmaxf(l, 1.0e-30f);
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c * kLanes + lane;
    if (col < d) store(out + q_off + col, acc[c] / denom);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int h, int n_kv, int d, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
  if (d <= 32)
    flash_attention_kernel<T, 32><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, sq, skv, h, n_kv, d, scale, causal);
  else if (d <= 64)
    flash_attention_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, sq, skv, h, n_kv, d, scale, causal);
  else
    flash_attention_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qp, kp, vp, op, sq, skv, h, n_kv, d, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, sq, h, d); k, v: (b, skv, n_kv, d); out: (b, sq, h, d); all
// contiguous and of one type, fp32 (bf16 = 0) or bf16 (bf16 = 1). The caller
// guarantees b, sq, skv >= 1, 1 <= d <= 128 and h a multiple of n_kv.
// Launches on `stream` and returns cudaGetLastError() (0 when the launch was
// accepted); arguments out of those ranges return cudaErrorInvalidValue
// without launching.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int b, int sq, int skv, int h,
                               int n_kv, int d, float scale, int causal,
                               int bf16, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || d < 1 || d > 128 || n_kv < 1 ||
      h % n_kv != 0 || h > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, out, b, sq, skv, h, n_kv, d, scale,
                                 causal, s);
  return launch<float>(q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, s);
}
