// GFID FC mode on int8 operands: (M, K) int8 @ (K, N) int8 with an exact int32
// accumulator and a fused dequant + bias + activation epilogue -> (M, N) fp32,
// for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul_int8 (_kernel_int8, _chunked_i32_dot). The TPU kernel sums
//   K-chunked fp32 dots, each exact below 2^24 (a device for speed under CPU
//   XLA); this kernel multiplies and adds integers, with no fp32 chunking.
//
// What bounds it on an H100: device memory. At AlexNet batch 1 the three FC
//   layers are matrix-vector products over 37.7 MB (fc6), 16.8 MB (fc7) and
//   4.1 MB (fc8) of int8 weights, 2 operations per weight byte: the time floor
//   is the weight bytes over 3.35 TB/s, 17.5 us for the three. At batch 32 the
//   floor is still the bytes under the card's int8 tensor-core rate, but this
//   kernel multiplies on the CUDA cores (__dp4a, 4 multiply-adds an
//   instruction), and that rate, not the bytes, limits it there.
//
// What the design does about it:
//   * every weight byte is read from device memory once per 8-row block of x,
//     as 32-bit words (4 columns) along N, 16 threads of a warp on one 64-byte
//     row segment;
//   * a 4 x 4 byte block (4 K rows x 4 columns) is transposed in registers with
//     __byte_perm, so that each column's 4 K values form one word for __dp4a
//     against 4 K values of x, staged in shared memory as words;
//   * a block owns 64 columns and 8 rows, and its 16 K slices (16 threads
//     each) split every 256-row K chunk; the slices are reduced in shared
//     memory. To fill the 132 SMs where the columns alone give too few blocks
//     (fc8's N = 1000 gives 16, fc6's N = 4096 gives 64 at batch 1), the
//     wrapper splits K across blocks (grid z). The partial sums are added
//     into an int32 workspace with atomics (integer addition in any order
//     gives the same sum, so the result stays exact and deterministic), and
//     the block that arrives last for a tile, by a ticket counter, runs the
//     epilogue;
//   * the epilogue is `dequant_epilogue` of epilogue.cuh with scale =
//     sx[row] * sw[col], one fp32 multiply, so the output is bitwise that of
//     the plain version for act none and relu.
//   Ragged shapes: K not a multiple of 4 or of the chunk, N not a multiple of
//   4 and unaligned operands go through byte loads that pack the same words,
//   zero-filled past the edge (an int8 zero adds nothing); the flags vec_x /
//   vec_w say when the word loads are aligned.
//
// int32 range: |acc| <= K * 127^2; fc6 (K = 9216) gives at most 1.49e8, far
//   below 2^31. The wrapper refuses K above 2^31 / 127^2 = 133,144.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 8;                         // rows of x per block
constexpr int kColLanes = 16;                  // threads across columns, 4 columns each
constexpr int kBN = 64;                        // output columns per block, 4 a thread
constexpr int kSlices = kThreads / kColLanes;  // 16 K slices per block
constexpr int kKT = 256;                       // K chunk staged per step
constexpr int kSliceK = kKT / kSlices;         // 16 K rows of a chunk per slice
constexpr int kWords = kKT / 4;                // words of one staged x row
constexpr int kWarps = kThreads / 32;

static_assert(kBN == 4 * kColLanes, "each column lane owns 4 columns");
static_assert(kSliceK % 4 == 0, "a slice covers whole 4-row groups");
static_assert(kColLanes == 16, "slices 2w and 2w+1 share warp w");

// Four consecutive int8 weights w[k][c0 .. c0+3] as one little-endian word,
// zero past the edge.
__device__ __forceinline__ uint32_t load_w4(const uint8_t* __restrict__ w, int k, int c0,
                                            int K, int N, bool vec) {
  if (k >= K || c0 >= N) return 0u;
  const uint8_t* p = w + (size_t)k * N + c0;
  if (vec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t v = 0u;
  for (int j = 0; j < 4 && c0 + j < N; ++j) v |= (uint32_t)__ldg(p + j) << (8 * j);
  return v;
}

__global__ void __launch_bounds__(kThreads)
gfid_matmul_int8_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                        const float* __restrict__ sx, const float* __restrict__ sw,
                        const float* __restrict__ bias, float* __restrict__ out,
                        int* __restrict__ ws, unsigned int* __restrict__ tickets, int M,
                        int K, int N, int chunks_per_split, int act, int vec_x,
                        int vec_w) {
  __shared__ int xs[kBM][kWords];
  __shared__ __align__(16) int red[kWarps][kBM][kBN];
  __shared__ unsigned int is_last;
  const int tid = threadIdx.x;
  const int lane_c = tid % kColLanes;
  const int slice = tid / kColLanes;
  const int c0 = blockIdx.x * kBN + lane_c * 4;
  const int m0 = blockIdx.y * kBM;
  const int m_valid = min(kBM, M - m0);  // uniform over the block: no divergence
  const int n_chunks = (K + kKT - 1) / kKT;
  const int ch_begin = blockIdx.z * chunks_per_split;
  const int ch_end = min(n_chunks, ch_begin + chunks_per_split);

  int acc[kBM][4];
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0;

  for (int ch = ch_begin; ch < ch_end; ++ch) {
    const int k0 = ch * kKT;
    for (int idx = tid; idx < kBM * kWords; idx += kThreads) {
      const int m = idx / kWords;
      const int k = k0 + 4 * (idx % kWords);
      uint32_t v = 0u;
      if (m0 + m < M && k < K) {
        const uint8_t* p = x + (size_t)(m0 + m) * K + k;
        if (vec_x) {
          v = *reinterpret_cast<const unsigned int*>(p);  // K % 4 == 0: k + 3 < K
        } else {
          for (int j = 0; j < 4 && k + j < K; ++j) v |= (uint32_t)p[j] << (8 * j);
        }
      }
      xs[m][idx % kWords] = (int)v;
    }
    __syncthreads();
    const int kbeg = k0 + slice * kSliceK;
#pragma unroll
    for (int g = 0; g < kSliceK / 4; ++g) {
      const int k = kbeg + 4 * g;
      const uint32_t r0 = load_w4(w, k, c0, K, N, vec_w);
      const uint32_t r1 = load_w4(w, k + 1, c0, K, N, vec_w);
      const uint32_t r2 = load_w4(w, k + 2, c0, K, N, vec_w);
      const uint32_t r3 = load_w4(w, k + 3, c0, K, N, vec_w);
      // rows r0..r3 hold columns in their bytes; col j = (r0.j, r1.j, r2.j, r3.j)
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
      const uint32_t t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362);
      const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
      const int col[4] = {(int)__byte_perm(t0, t1, 0x5410), (int)__byte_perm(t0, t1, 0x7632),
                          (int)__byte_perm(t2, t3, 0x5410), (int)__byte_perm(t2, t3, 0x7632)};
      const int q = slice * (kSliceK / 4) + g;
#pragma unroll
      for (int m = 0; m < kBM; ++m) {
        if (m >= m_valid) break;
        const int xv = xs[m][q];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] = __dp4a(col[j], xv, acc[m][j]);
      }
    }
    __syncthreads();  // xs is rewritten by the next chunk
  }

  // Lanes l and l + 16 of a warp hold the same columns for two slices.
#pragma unroll
  for (int m = 0; m < kBM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] += __shfl_down_sync(0xffffffffu, acc[m][j], 16);
  const int warp = tid / 32;
  if (tid % 32 < 16) {
#pragma unroll
    for (int m = 0; m < kBM; ++m)
      *reinterpret_cast<int4*>(&red[warp][m][lane_c * 4]) =
          make_int4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  }
  __syncthreads();

  const bool split = gridDim.z > 1;
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int m = idx / kBN;
    const int c = idx % kBN;
    const int row = m0 + m;
    const int col = blockIdx.x * kBN + c;
    if (row >= M || col >= N) continue;
    int v = 0;
#pragma unroll
    for (int s = 0; s < kWarps; ++s) v += red[s][m][c];
    if (split) {
      atomicAdd(&ws[(size_t)row * N + col], v);
    } else {
      out[(size_t)row * N + col] =
          dequant_epilogue(v, __fmul_rn(sx[row], sw[col]), bias, col, act);
    }
  }
  if (!split) return;

  // Split K: the last block to finish this tile dequantizes the full sums.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int tile = blockIdx.y * gridDim.x + blockIdx.x;
    is_last = atomicAdd(&tickets[tile], 1u) == gridDim.z - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int idx = tid; idx < kBM * kBN; idx += kThreads) {
    const int row = m0 + idx / kBN;
    const int col = blockIdx.x * kBN + idx % kBN;
    if (row >= M || col >= N) continue;
    const int v = __ldcg(&ws[(size_t)row * N + col]);
    out[(size_t)row * N + col] =
        dequant_epilogue(v, __fmul_rn(sx[row], sw[col]), bias, col, act);
  }
}

}  // namespace

// xq (M, K) and wq (K, N) int8; sx (M,) and sw (N,) fp32; bias (N,) fp32 or
// null; out (M, N) fp32. With splits > 1, ws is a zeroed int32 (M, N)
// workspace and tickets a zeroed array of one counter per (row block, column
// block) tile; with splits == 1 both may be null. act: 0 none, 1 relu, 2 gelu.
// Launches on `stream` and returns cudaGetLastError() (0 when accepted).
extern "C" int gfid_matmul_int8(const void* xq, const void* wq, const float* sx,
                                const float* sw, const float* bias, float* out, int* ws,
                                unsigned int* tickets, int M, int K, int N, int splits,
                                int chunks_per_split, int act, int vec_x, int vec_w,
                                void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gfid_matmul_int8_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(xq), static_cast<const uint8_t*>(wq), sx, sw, bias, out,
      ws, tickets, M, K, N, chunks_per_split, act, vec_x, vec_w);
  return (int)cudaGetLastError();
}
