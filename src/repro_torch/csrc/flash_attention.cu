// Online-softmax attention forward, causal or not, for Hopper (sm_90a):
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h / G])
//                  * v[b, j, h / G]
// over the keys j that row i may see (j <= i when causal, positions from 0
// for both q and k), with G = H / KV query heads per kv head (GQA as an
// index: no repeated copy of k and v). q is (B, Sq, H, D), k and v are
// (B, Skv, KV, D), out is (B, Sq, H, D); all fp32. (bf16 q, k, v go to
// flash_attention_bf16.cu, on the tensor cores.)
//
// Replaces: the Pallas TPU kernel src/repro/kernels/flash_attention.py
//   flash_attention (_kernel), whose grid (B, H, n_q, n_kv) walks the kv
//   blocks of one q block in order and carries the running max, sum and
//   accumulator in VMEM scratch between grid steps; its caller broadcasts
//   the kv heads with jnp.repeat first.
//
// What bounds it on an H100: operations. A causal (1, S, 9 / 3, 64) prefill
//   does about 2 * 2 * 9 * 64 * S^2 / 2 flops (4.54 GFLOP at S = 1984) on
//   12 MB of input and output, far above the card's balance of flops to
//   bytes. On fp32 operands with TF32 off the tensor cores do not apply, so
//   the floor is the flops over the CUDA cores' fp32 rate (67 TFLOP/s).
//
// What the design does about it: two register-tiled SIMT products around an
//   online softmax. A block owns kBQ = 32 q rows of one head and walks the
//   kv tiles of kBK = 64 keys in order. Its 8 x 16 threads each own 4
//   rows (ty * 4 + i) x 4 keys (tx + 16 j) of the tile's scores and the same
//   4 rows x D / 16 columns of the output, so a row's m, l and rescale stay
//   in the thread, and the 16 threads that share a row are the lanes of one
//   half warp (xor shuffles 1, 2, 4, 8).
//   * S = Q K^T: the block's q rows (staged once) and each k tile lie in
//     shared memory row-major, rows padded to DMAX + 4 floats. Each 4 d
//     steps a thread reads 4 float4 of q (its rows) and 4 float4 of k (its
//     keys) for 64 FMAs: two 16-byte loads for 16 FMAs. (A k tile stored d
//     outermost would give the same ratio, but cp.async cannot transpose;
//     with the key a thread owns at tx + 16 j, the padded rows put the 8
//     lanes of a load phase on 8 different bank groups.)
//   * softmax: each score's expf is computed once, by the thread that owns
//     it; the tile's row max is reduced over the half warp; each thread
//     keeps a partial row sum of its own keys (rescaled by the same alpha
//     in every lane, as the max is exact) and the 16 partials are added
//     once at the end.
//   * O += P V: P goes to shared memory with the key outermost (key rows
//     padded to kBQ + 4); each key step a thread reads one float4 of P (its
//     4 rows) and D / 16 columns of v for 4 x D / 16 FMAs.
//   * loads: q, k and v arrive by cp.async, 16 bytes at a time where
//     D % 4 == 0 on 16-byte-aligned pointers (else 4), zero-filled past Skv,
//     Sq or D, through two stages: tile t + 1 is copied while tile t is
//     multiplied.
//   * scheduling: the grid is one axis, longest causal q tiles first across
//     heads and batch, so the hardware's in-order dispatch balances the
//     SMs. 32 rows a block because the path's prefills are one prompt at a
//     time: a prompt-1984 prefill makes 558 blocks of 32 rows; 64-row
//     blocks would make 279 for the 264 block slots of 132 SMs x 2, and one
//     SM would run two long causal tiles one after the other.
//
// Masking: a masked score is NEG_INF (-1e30), as in the Pallas kernel, and
//   the running max starts there. Every row sees key 0 (causal or not), and
//   the first tile visited is the one that holds key 0, so after it m is a
//   real score and a masked key adds exp(-1e30 - m) = 0. Hence l >= 1 at the
//   end, and neither this mask value, the 1e-30 clamp on l, nor the -2e38
//   and 1e-37 of models/flash.py reaches the result: one kernel serves both
//   contracts. Under causal masking a kv tile whose first key lies past the
//   block's last row is not visited. That is bitwise neutral: for every row
//   of the block such a tile gives a tile max of -1e30 < m, so m stays,
//   alpha = exp(0) = 1, and l * 1 + 0 and acc * 1 + 0 are exactly l and acc.
//   The mask is applied only on a tile that reaches past Skv or, when
//   causal, past the block's first row (the diagonal tile).
//
// Arithmetic: expf (not __expf) and IEEE division; built without
//   --use_fast_math. fp32 fmaf only: no tensor cores, no TF32. Sums run in
//   another order than the plain version's, so the two agree within a
//   tolerance, not bitwise.
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "smem.cuh"

namespace {

constexpr int kBQ = 32;            // q rows a block (kernels/flash_attention.py Q_ROWS)
constexpr int kBK = 64;            // keys per kv tile (kernels/flash_attention.py KV_TILE)
constexpr int kColThreads = 16;    // threads that share a q row: a half warp
constexpr int kTM = 4;             // q rows a thread
constexpr int kTN = kBK / kColThreads;  // keys a thread (tx + 16 j)
constexpr float kNegInf = -1.0e30f;

// The head dim padded to DMAX (32, 64 or 128).
template <int DMAX>
struct Shape {
  static constexpr int kThreads = kBQ / kTM * kColThreads;  // 128
  static constexpr int kStride = DMAX + 4;   // floats a q, k or v row in shared memory
  static constexpr int kPStride = kBQ + 4;   // floats a key row of P
  static constexpr int kTile = kBK * kStride;
  static constexpr int kOCols = DMAX / kColThreads;  // output columns a thread
  static constexpr size_t kSmem =
      sizeof(float) * (kBQ * kStride + 4 * kTile + kBK * kPStride);
  // two blocks an SM where their shared memory fits
  static constexpr int kMinBlocks = 2 * kSmem <= 227 * 1024 ? 2 : 1;
};

// Output column c (0 <= c < kOCols) of the thread in column lane tx: pairs
// at D = 32, runs of 4 strided by 64 otherwise, so v is read as float2 or
// float4.
template <int kOCols>
__device__ __forceinline__ int out_col(int tx, int c) {
  return kOCols == 2 ? tx * 2 + c : (c / 4) * 64 + tx * 4 + c % 4;
}

using smem::cp_async16;
using smem::cp_async4;
using smem::cp_async_commit;
using smem::cp_async_wait;

template <int DMAX>
__global__ void __launch_bounds__(Shape<DMAX>::kThreads, Shape<DMAX>::kMinBlocks)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int batch,
                       int sq, int skv, int h, int n_kv, int d, float scale, int causal,
                       int vec) {
  using S = Shape<DMAX>;
  constexpr int kThreads = S::kThreads, kStride = S::kStride, kOCols = S::kOCols;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                    // kBQ x kStride
  float* kvs = qs + kBQ * kStride;     // two stages of (k tile, v tile)
  float* ps = kvs + 4 * S::kTile;      // kBK x kPStride: P, key outermost

  // longest causal q tiles first, across heads and batch
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int per_tile = h * batch;
  const int qt = n_qt - 1 - blockIdx.x / per_tile;
  const int head = blockIdx.x % h;
  const int b = (blockIdx.x % per_tile) / h;
  const int kvh = head / (h / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid / kColThreads;
  const int tx = tid % kColThreads;
  const int q0 = qt * kBQ;
  const int q_last = min(sq, q0 + kBQ) - 1;   // the block's last row
  const int kv_end = causal ? min(skv, q_last + 1) : skv;
  const int n_tiles = (kv_end + kBK - 1) / kBK;

  const size_t ldq = (size_t)h * d, ldk = (size_t)n_kv * d;
  const float* qb = q + ((size_t)b * sq * h + head) * d;
  const float* kb = k + ((size_t)b * skv * n_kv + kvh) * d;
  const float* vb = v + ((size_t)b * skv * n_kv + kvh) * d;

  // rows [row0, row0 + n) of a (., ld) tensor at base into dst, zeros past
  // `limit` rows or d columns
  auto load_rows = [&](float* dst, const float* base, size_t ld, int row0, int n, int limit) {
    if (vec) {  // d % 4 == 0: a piece is 4 columns, all in or all out
      constexpr int kPer = DMAX / 4;
      for (int idx = tid; idx < n * kPer; idx += kThreads) {
        const int r = idx / kPer, c = (idx % kPer) * 4;
        const bool ok = row0 + r < limit && c < d;
        cp_async16(dst + r * kStride + c, ok ? base + (row0 + r) * ld + c : base, ok);
      }
    } else {
      for (int idx = tid; idx < n * DMAX; idx += kThreads) {
        const int r = idx / DMAX, c = idx % DMAX;
        const bool ok = row0 + r < limit && c < d;
        cp_async4(dst + r * kStride + c, ok ? base + (row0 + r) * ld + c : base, ok);
      }
    }
  };

  load_rows(qs, qb, ldq, q0, kBQ, sq);
  load_rows(kvs, kb, ldk, 0, kBK, skv);
  load_rows(kvs + S::kTile, vb, ldk, 0, kBK, skv);
  cp_async_commit();

  float acc[kTM][kOCols], m[kTM], l[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();    // tile t (and q) landed: this thread's copies
    __syncthreads();       // ... and every thread's; tile t - 1 and P consumed
    if (t + 1 < n_tiles) {
      float* st = kvs + ((t + 1) & 1) * 2 * S::kTile;
      load_rows(st, kb, ldk, (t + 1) * kBK, kBK, skv);
      load_rows(st + S::kTile, vb, ldk, (t + 1) * kBK, kBK, skv);
      cp_async_commit();
    }
    const float* ks = kvs + (t & 1) * 2 * S::kTile;
    const float* vs = ks + S::kTile;
    const int k0 = t * kBK;

    // S = Q K^T for rows ty * 4 + i, keys tx + 16 j
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < DMAX; c += 4) {
      float4 qf[kTM], kf[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        qf[i] = *reinterpret_cast<const float4*>(qs + (ty * kTM + i) * kStride + c);
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(ks + (tx + j * kColThreads) * kStride + c);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          float a = fmaf(qf[i].x, kf[j].x, s[i][j]);
          a = fmaf(qf[i].y, kf[j].y, a);
          a = fmaf(qf[i].z, kf[j].z, a);
          s[i][j] = fmaf(qf[i].w, kf[j].w, a);
        }
    }

    // online softmax: one expf a score, in the thread that owns it
    const bool edge = k0 + kBK > skv || (causal && k0 + kBK - 1 > q0);
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = q0 + ty * kTM + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        float x = s[i][j] * scale;
        if (edge) {
          const int key = k0 + tx + j * kColThreads;
          if (key >= skv || (causal && key > row)) x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 1; o < kColThreads; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + sum;   // this thread's keys; the lanes are added at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      *reinterpret_cast<float4*>(ps + (tx + j * kColThreads) * S::kPStride + ty * kTM) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();       // P complete

    // O += P V: each key a float4 of P (this thread's rows) and its columns of v
#pragma unroll 8
    for (int key = 0; key < kBK; ++key) {
      const float4 pf = *reinterpret_cast<const float4*>(ps + key * S::kPStride + ty * kTM);
      const float p[kTM] = {pf.x, pf.y, pf.z, pf.w};
      float vf[kOCols];
      const float* vr = vs + key * kStride;
      if constexpr (kOCols == 2) {
        const float2 v2 = *reinterpret_cast<const float2*>(vr + tx * 2);
        vf[0] = v2.x;
        vf[1] = v2.y;
      } else {
#pragma unroll
        for (int c = 0; c < kOCols; c += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vr + out_col<kOCols>(tx, c));
          vf[c] = v4.x;
          vf[c + 1] = v4.y;
          vf[c + 2] = v4.z;
          vf[c + 3] = v4.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int c = 0; c < kOCols; ++c) acc[i][c] = fmaf(p[i], vf[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int o = 1; o < kColThreads; o <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, o);
    const int row = q0 + ty * kTM + i;
    if (row >= sq) continue;
    const float denom = fmaxf(lt, 1.0e-30f);
    float* orow = out + ((size_t)b * sq + row) * ldq + (size_t)head * d;
#pragma unroll
    for (int c = 0; c < kOCols; ++c) {
      const int col = out_col<kOCols>(tx, c);
      if (col < d) orow[col] = acc[i][c] / denom;
    }
  }
}

template <int DMAX>
int launch(dim3 grid, cudaStream_t stream, const float* q, const float* k, const float* v,
           float* out, int b, int sq, int skv, int h, int n_kv, int d, float scale, int causal,
           int vec) {
  using S = Shape<DMAX>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_attention_kernel<DMAX><<<grid, S::kThreads, S::kSmem, stream>>>(
      q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (b, sq, h, d); k, v: (b, skv, n_kv, d); out: (b, sq, h, d); all
// contiguous fp32. vec: 16-byte copies, for d % 4 == 0 on 16-byte-aligned
// q, k and v. The caller guarantees b, sq, skv >= 1, 1 <= d <= 128 and h a
// multiple of n_kv. Launches on `stream` and returns cudaGetLastError() (0
// when the launch was accepted); arguments out of those ranges return
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention(const float* q, const float* k, const float* v,
                               float* out, int b, int sq, int skv, int h,
                               int n_kv, int d, float scale, int causal,
                               int vec, void* stream) {
  if (b < 1 || sq < 1 || skv < 1 || d < 1 || d > 128 || n_kv < 1 ||
      h % n_kv != 0 || (vec && d % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)((sq + kBQ - 1) / kBQ) * h * b;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch<32>(grid, s, q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, vec);
  if (d <= 64)
    return launch<64>(grid, s, q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, vec);
  return launch<128>(grid, s, q, k, v, out, b, sq, skv, h, n_kv, d, scale, causal, vec);
}
