// Online-softmax attention forward on bf16 q, k, v, causal or not, global or
// sliding-window, for Hopper (sm_90a), on the tensor cores:
//   out[b, i, h] = sum_j softmax_j(cap(scale * q[b, i, h] . k[b, j, h / G]))
//                  * v[b, j, h / G]
// over the keys j that row i may see, with G = H / KV query heads per kv
// head (GQA as an index). Row i sits at position p = i + q_offset, key j at
// j; j is visible when j < Skv, j <= p if causal and p - j < window if
// window > 0. cap(x) = softcap * tanhf(x / softcap) with a softcap, else x
// (the scores are capped, then masked). q is (B, Sq, H, D), k and v are (B,
// Skv, KV, D), out is (B, Sq, H, D), all bf16; the scores, the softmax and
// the sums are fp32, and out is rounded once to bf16. (fp32 q, k, v go to
// flash_attention.cu.)
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention (_kernel) on bf16 operands: s = (q . k^T in fp32) *
//   scale, masked to NEG_INF, an online softmax, p . v with fp32 sums, then
//   acc / max(l, 1e-30), cast to q's dtype; the window, the softcap and the
//   q offset of src/repro/models/flash.py flash_attention_jnp, which the
//   reference computes in plain JAX.
//
// What bounds it on an H100: operations. A causal (1, 1984, 9 / 3, 64)
//   prefill does 4.5 GFLOP on 6.1 MB of bf16 input and output, far above
//   the ~295 operations a byte where the 989 TFLOP/s bf16 tensor cores
//   overtake 3.35 TB/s.
//
// What the design does about it (FlashAttention-2's shape on mma.sync, with
//   the pieces of mma_bf16.cuh): a block of 4 warps owns 64 q rows of one q
//   head of one batch, 16 rows a warp; the grid starts the longest causal
//   q tiles of every head first, so that the short ones fill in behind
//   them. The block's q tile is copied once (cp.async) and held by each
//   warp as bf16 A fragments (`ldmatrix.x4`). The block walks tiles of 128
//   keys of kv head h / G through a 2-stage cp.async ring (the next tile
//   lands while this one is used); tiles wholly visible to a warp's rows
//   skip the mask. Rows are padded by 16 bytes so that the
//   eight rows of an `ldmatrix` phase fall in eight bank groups. Copies are
//   16 bytes where D % 8 == 0 on 16-byte aligned pointers (vec), else
//   element by element; rows past Skv and columns past D are zeros, and D is
//   padded with zeros to DP, a multiple of 16 (16, 32, 64 or 128).
//   S = Q K^T is bf16 `mma.sync.m16n8k16` with fp32 accumulators, K the B
//   operand through non-transposed `ldmatrix` (K rows are the mma's
//   columns). The row max and the row sum come from the four lanes that
//   share a row in the accumulator layout: two xor shuffles, the same order
//   in every lane. The fp32 score fragments of two n8 key tiles are the A
//   fragment of one k16 step of P V in the registers, with no trip through
//   shared memory; V is the B operand through `ldmatrix.trans`.
//
// p carried to about fp32 accuracy: the Pallas kernel multiplies an fp32 p
//   by v. Rounding p to bf16 would add a relative error of up to 2^-9 a
//   weight. So p = p_hi + p_lo, both bf16 (p_lo = bf16(p - p_hi), where p -
//   p_hi is exact in fp32), and two `mma`s go into the same accumulator:
//   p is then carried to about 2^-17. That doubles only the P V products.
//
// Masking and the band are those of flash_attention.cu: a masked score is
//   NEG_INF (-1e30); a block visits the kv tiles from the one holding its
//   first row's first visible key to, when causal, the one holding its last
//   row's last (the tiles outside are bitwise neutral or hold no visible
//   key). A later row of the block that sees no key in the band's first
//   tile adds exp(0) = 1 a key to l and that key's v to acc there; its first
//   tile with a visible key rescales both by alpha = expf(-1e30 - m) = 0,
//   which wipes them exactly. The wrapper refuses a shape where some row
//   sees no key at all. A warp masks only a tile that reaches past Skv, past
//   its first row's position when causal, or below its last row's band when
//   windowed. One block computes every output row from start to end (no
//   split of the kv axis, no atomics), so the result does not change from
//   run to run and does not depend on the other rows or on B.
//
// Arithmetic: expf (not __expf) and IEEE division; `scale` multiplies the
//   fp32 scores (q is not rescaled in bf16); built without --use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;   // q rows a block, 16 a warp
constexpr int kBK = 128;           // keys a kv tile
constexpr float kNegInf = -1.0e30f;

// Shared memory for a head dim padded to DP: the q tile and two stages of
// (K, V) tiles, rows of DP + 8 bf16 values.
template <int DP>
struct Layout {
  static constexpr int kStride = DP + 8;
  static constexpr int kQ = kBQ * kStride;
  static constexpr int kKV = kBK * kStride;   // one K or V tile
  static constexpr size_t kSmem = sizeof(uint16_t) * (kQ + 4 * kKV);
};

// Rows [row0, row0 + n_rows) of one head of a (B, S, heads, d) array into
// dst (n_rows x DP, rows padded to DP + 8); zeros past S and d. `head` points
// at row 0 of that head and batch, rows `stride` = heads x d values apart.
template <int DP>
__device__ __forceinline__ void load_tile(uint16_t* dst, const uint16_t* head, int row0,
                                          int n_rows, int S, int stride, int d, int vec) {
  constexpr int kPer = DP / mma::kPieces;   // 16-byte pieces a row
  for (int idx = threadIdx.x; idx < n_rows * kPer; idx += kThreads) {
    const int r = idx / kPer;
    const int c = (idx % kPer) * mma::kPieces;
    const int row = row0 + r;
    uint16_t* to = dst + r * Layout<DP>::kStride + c;
    const uint16_t* from = head + (size_t)row * stride + c;
    if (vec) {  // d % 8 == 0: a piece is all in or all out
      const bool ok = row < S && c < d;
      mma::cp_async16(to, ok ? from : head, ok);
    } else {
#pragma unroll
      for (int e = 0; e < mma::kPieces; ++e)
        to[e] = (row < S && c + e < d) ? __ldg(from + e) : (uint16_t)0;
    }
  }
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two bf16 pairs, hi = bf16(x) and lo = bf16(x - hi); x0 in the
// low half (the lower k index of an mma A register).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                            const uint16_t* __restrict__ v, __nv_bfloat16* __restrict__ out,
                            int sq, int skv, int h, int n_kv, int d, float scale, int causal,
                            int window, float softcap, int q_offset, int vec) {
  using L = Layout<DP>;
  constexpr int kD16 = DP / 16;       // k16 steps of Q K^T
  constexpr int kDT = DP / 8;         // n8 tiles of the output
  constexpr int kKT = kBK / 8;        // n8 key tiles of S
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* kv = smem + L::kQ;        // stage s: K at kv + 2 s kKV, V after it

  // the q tiles of every head, longest causal tiles first (a head's tiles
  // side by side), one batch a grid row
  const int qt = (sq + kBQ - 1) / kBQ - 1 - (int)(blockIdx.x / h);
  const int head = blockIdx.x % h;
  const int b = blockIdx.y;
  const uint16_t* kh = k + ((size_t)b * skv * n_kv + head / (h / n_kv)) * d;
  const uint16_t* vh = v + ((size_t)b * skv * n_kv + head / (h / n_kv)) * d;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int q0 = qt * kBQ;
  const int row_g = q0 + warp * 16 + lane / 4;  // this thread's rows: row_g, row_g + 8
  const int q_last = min(sq, q0 + kBQ) - 1;     // the block's last row
  // the band: from its first row's first visible key to its last row's last
  const int kv_begin = window > 0 ? max(0, q0 + q_offset - window + 1) : 0;
  const int kv_end = causal ? min(skv, q_last + q_offset + 1) : skv;
  const int t_first = kv_begin / kBK;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  auto load_kv = [&](int t) {
    uint16_t* st = kv + (t % 2) * 2 * L::kKV;
    load_tile<DP>(st, kh, t * kBK, kBK, skv, n_kv * d, d, vec);
    load_tile<DP>(st + L::kKV, vh, t * kBK, kBK, skv, n_kv * d, d, vec);
  };

  load_tile<DP>(qs, q + ((size_t)b * sq * h + head) * d, q0, kBQ, sq, h * d, d, vec);
  load_kv(t_first);
  mma::cp_async_commit();

  uint32_t qf[kD16][4];
  float o[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int t = t_first; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);
    mma::cp_async_commit();
    mma::cp_async_wait<1>();   // all but the newest group: q and tile t
    __syncthreads();
    if (t == t_first) {
#pragma unroll
      for (int kk = 0; kk < kD16; ++kk)
        mma::ldmatrix_x4(qf[kk], qs + (warp * 16 + lane % 16) * L::kStride + kk * 16 +
                                     (lane / 16) * 8);
    }
    const uint16_t* ks = kv + (t % 2) * 2 * L::kKV;
    const uint16_t* vs = ks + L::kKV;
    const int k0 = t * kBK;

    // S = Q K^T: c0, c1 of s[nt] are row row_g, keys k0 + 8 nt + 2 (lane % 4)
    // + {0, 1}; c2, c3 the same keys of row row_g + 8
    float s[kKT][4];
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kD16; ++kk)
#pragma unroll
      for (int nt = 0; nt < kKT; nt += 2) {  // matrices (n, k), (n, k + 8), (n + 8, k), (n + 8, k + 8)
        uint32_t r[4];
        mma::ldmatrix_x4(r, ks + (nt * 8 + (lane / 16) * 8 + lane % 8) * L::kStride + kk * 16 +
                                ((lane / 8) % 2) * 8);
        mma::mma_bf16_16816(s[nt], qf[kk], r[0], r[1]);
        mma::mma_bf16_16816(s[nt + 1], qf[kk], r[2], r[3]);
      }

    // Only a tile with keys past Skv, (causal) past the warp's first row's
    // position or (windowed) below its last row's band masks; elsewhere
    // every key is visible to every row of the warp.
    const int w0 = q0 + warp * 16 + q_offset;   // the warp's first row's position
    const bool masked = k0 + kBK > skv || (causal && k0 + kBK - 1 > w0) ||
                        (window > 0 && k0 < w0 + 16 - window);
    float mx[2] = {kNegInf, kNegInf};
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * (lane % 4) + e % 2;
          const int pos = row_g + (e / 2) * 8 + q_offset;
          const bool valid = key < skv && (!causal || key <= pos) &&
                             (window <= 0 || pos - key < window);
          float x = s[nt][e] * scale;
          if (softcap != 0.0f) x = softcap * tanhf(x / softcap);
          s[nt][e] = valid ? x : kNegInf;
          mx[e / 2] = fmaxf(mx[e / 2], s[nt][e]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[nt][e] * scale;
          if (softcap != 0.0f) x = softcap * tanhf(x / softcap);
          s[nt][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the four lanes of a row: the same max, and below the same sum, in all
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < kKT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = expf(s[nt][e] - m[e / 2]);
        sum[e / 2] += s[nt][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

    // O += P V, a k16 step per 16 keys: the C fragments of key tiles 2j and
    // 2j + 1 are the A fragment (rows g, g + 8; keys 0-7, 8-15) of step j
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * j][0], s[2 * j][1], ph[0], pl[0]);
      split_pair(s[2 * j][2], s[2 * j][3], ph[1], pl[1]);
      split_pair(s[2 * j + 1][0], s[2 * j + 1][1], ph[2], pl[2]);
      split_pair(s[2 * j + 1][2], s[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dt = 0; dt < kDT; dt += 2) {  // matrices (k, n), (k + 8, n), (k, n + 8), (k + 8, n + 8)
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, vs + (j * 16 + lane % 8 + ((lane / 8) % 2) * 8) * L::kStride +
                                      dt * 8 + (lane / 16) * 8);
        mma::mma_bf16_16816(o[dt], ph, r[0], r[1]);
        mma::mma_bf16_16816(o[dt], pl, r[0], r[1]);
        mma::mma_bf16_16816(o[dt + 1], ph, r[2], r[3]);
        mma::mma_bf16_16816(o[dt + 1], pl, r[2], r[3]);
      }
    }
    __syncthreads();   // this stage is consumed before tile t + 2 lands in it
  }
  mma::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_g + r * 8;
    if (qi >= sq) continue;
    const float denom = fmaxf(l[r], 1.0e-30f);
    __nv_bfloat16* orow = out + (((size_t)b * sq + qi) * h + head) * (size_t)d;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = dt * 8 + 2 * (lane % 4) + e;
        if (col < d) store_as(orow + col, o[dt][2 * r + e] / denom);
      }
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* out, int b, int sq, int skv,
           int h, int n_kv, int d, float scale, int causal, int window, float softcap,
           int q_offset, int vec, cudaStream_t stream) {
  using L = Layout<DP>;
  if (L::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(((sq + kBQ - 1) / kBQ) * h), b);
  flash_attention_bf16_kernel<DP><<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<__nv_bfloat16*>(out), sq, skv, h, n_kv, d,
      scale, causal, window, softcap, q_offset, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, sq, h, d); k, v: (b, skv, n_kv, d); out: (b, sq, h, d); all
// contiguous bf16. window: 0 for none; softcap: 0 for none; q_offset: the
// position of q row 0. vec: 16-byte copies, for d % 8 == 0 on 16-byte
// aligned q, k and v. The caller guarantees b, sq, skv >= 1, 1 <= d <= 128,
// h a multiple of n_kv, a grid within CUDA's limits (q tiles x h blocks in
// x, b in y), window >= 0, and that every row sees a key (q_offset >= 0
// when causal; the last row's band starting below skv). Launches on
// `stream` and returns cudaGetLastError() (0 when the launch was accepted);
// arguments out of those ranges return cudaErrorInvalidValue without
// launching.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int b, int sq, int skv, int h, int n_kv, int d,
                                    float scale, int causal, int window, float softcap,
                                    int q_offset, int vec, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || d < 1 || d > 128 || n_kv < 1 || h % n_kv != 0 ||
      (long long)((sq + kBQ - 1) / kBQ) * h > 0x7fffffffLL || b > 65535 ||
      (vec && d % 8 != 0) || window < 0 || (causal && q_offset < 0) ||
      (window > 0 && (long long)sq + q_offset - window >= skv))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 16)
    return launch<16>(q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, window, softcap,
                      q_offset, vec, s);
  if (d <= 32)
    return launch<32>(q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, window, softcap,
                      q_offset, vec, s);
  if (d <= 64)
    return launch<64>(q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, window, softcap,
                      q_offset, vec, s);
  return launch<128>(q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, window, softcap,
                     q_offset, vec, s);
}
