// GFID FC mode: (M, K) fp32 @ (K, N) fp32 -> (M, N) fp32 with a fused bias +
// activation epilogue, for Hopper (sm_90a), as a register-tiled SIMT GEMM on
// the CUDA cores.
//
// Replaces: the Pallas TPU kernel src/repro/kernels/gfid_matmul.py
//   gfid_matmul (_kernel, _kernel_epilogue) on fp32 operands.
//
// What bounds it on an H100: device memory at few rows, fp32 arithmetic at
//   many. At AlexNet batch 1 the three FC layers are matrix-vector products
//   over 151 MB (fc6), 67 MB (fc7) and 16 MB (fc8) of fp32 weights: one
//   multiply-add per 4-byte weight, far below the ~20 flops per byte where
//   the 3.35 TB/s memory stops being the limit. A prompt-1984 prefill of
//   smollm-135m runs its GEMMs at M = 15,872, some 2,000 flops per byte,
//   against the card's 67 TFLOP/s fp32 (non-tensor-core) peak.
//
// What the design does about it: the block tile, chunk ring and FMA loop of
//   simt_f32.cuh, which the fp32 conv shares (a GEMM is that conv's 1 x 1
//   case), with the block tile and the split of K chosen per launch by the
//   wrapper's plan (kernels/gfid_matmul.py::f32_plan):
//   * few rows (M <= 64): a tile of 8, 32 or 64 rows x 64 columns, or, where
//     w is large enough that streaming it sets the time (AlexNet's fc6 and
//     fc7, the unembeddings), 8 x 512 or 32 x 256, so that a block reads
//     long runs of each row of w and the memory's pages stay open (a
//     64-column tile, however deep its ring, streams such a w well below
//     the memory's rate); K split across blocks so that the column
//     blocks times the splits put about 512 threads on each SM. Each block
//     streams its slab of w through a cp.async ring (16-byte copies of 4
//     columns where N % 4 == 0 on a 16-byte aligned w, else 4 bytes). On a
//     64-column tile with up to kMaxCluster splits (a decode step's GEMMs),
//     the blocks of one output tile form a thread block cluster: each
//     leaves its partial sums in its shared memory and the first block adds
//     the others' in split order through distributed shared memory, then
//     runs the epilogue (one launch and no workspace, so the call costs the
//     host one launch). Otherwise each split writes its fp32 partial sums
//     to a workspace and split_k.cuh adds them in split order;
//   * many rows: the 128 x 128 tile (8 x 8 outputs a thread) or, where its
//     blocks would not fill the card twice, the 64 x 64 tile. Where the
//     plan splits K and the blocks fill the card twice without the split,
//     each block runs every split itself ("fold"): it keeps each split's
//     chain apart and adds the finished split to a running sum in shared
//     memory, in split order; otherwise the splits go through the
//     workspace as for few rows.
//
// Sum order (the serving scheduler's bitwise tokens rest on it): an output
//   element is one fmaf chain over K in order within each split, starting
//   from zero, and the splits are added in split order, by the reduction
//   kernel, the cluster's first block or the fold, which add alike. The
//   split comes from (K, N)
//   alone, so a row's result does not depend on M, on the tile M selects or
//   on the rows beside it. A grouped launch (the stacked experts of an MoE
//   layer: x (G, M, K) @ w (G, K, N), one launch, the group on grid y) runs
//   each group with that split, so a group's bits are its own launch's. The epilogue adds the bias, applies the
//   activation and stores once. Plain fp32 FMA: no TF32, no tensor cores.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <type_traits>

#include "epilogue.cuh"
#include "simt_f32.cuh"
#include "split_k.cuh"

namespace {

constexpr int kKT = 8;  // K rows of a chunk (kernels/gfid_matmul.py F32_BK)
// The widest block tile, rows x columns (kernels/gfid_matmul.py TILE, the
// engine plan's tiling).
constexpr int kBM = 128;
constexpr int kBN = 128;

template <int BM, int BN, int TM, int TN, int STAGES>
using Tile = simt::Tile<BM, BN, TM, TN, kKT, STAGES>;

// How a launch runs K (the `mode` argument; kernels/gfid_matmul.py
// F32_MODES): split z of K on grid z, the partial sums through the
// workspace when there are several; every split in each block; or the
// splits of an output tile as one cluster of at most kMaxCluster blocks.
enum Mode { kSplit = 0, kFold = 1, kCluster = 2 };
constexpr int kMaxCluster = 8;  // the portable cluster size

// What splitk::launch reads of a kernel: its threads and dynamic shared
// memory (the ring; under a fold each thread's running sums after it; a
// cluster leaves its partial sums where the ring was).
template <class T, int kMode>
struct Launch {
  static constexpr int kThreads = T::kThreads;
  static constexpr size_t kSums = sizeof(float) * T::TM * T::TN * T::kThreads;
  static constexpr size_t kSmem = kMode == kFold ? T::kSmem + kSums
                                  : kMode == kCluster && kSums > T::kSmem ? kSums
                                                                          : T::kSmem;
};

using simt::cp_async16;
using simt::cp_async4;

template <class T, int kMode>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
gfid_matmul_kernel(splitk::Epilogue e, const float* __restrict__ x,
                   const float* __restrict__ w, int M, int K, int N, int chunks_per_split,
                   int vec_x, int vec_w, long long stride_x, long long stride_w) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid / T::kColThreads;
  const int tx = tid % T::kColThreads;
  const int n0 = blockIdx.x * T::BN;
  // grid y is group x row blocks + row block: group g reads x + g * stride_x
  // and w + g * stride_w and writes rows g * M + [0, M) of the output
  const int row_blocks = (M + T::BM - 1) / T::BM;
  const int g = blockIdx.y / row_blocks;
  const int m0 = (blockIdx.y - g * row_blocks) * T::BM;
  x += g * stride_x;
  w += g * stride_w;
  const int n_chunks = (K + kKT - 1) / kKT;
  // a fold runs every split; otherwise the block runs split blockIdx.z
  const int begin = kMode == kFold ? 0 : blockIdx.z * chunks_per_split;
  const int end = kMode == kFold ? n_chunks : min(n_chunks, begin + chunks_per_split);
  const int n = end - begin;

  auto load = [&](int chunk, float* As, float* Bs) {
    const int k0 = chunk * kKT;
    if (vec_x) {  // K % 4 == 0: a piece is 4 K values of a row, all in or all out
      for (int idx = tid; idx < T::BM * (kKT / 4); idx += T::kThreads) {
        const int r = idx / (kKT / 4);
        const int k = k0 + (idx % (kKT / 4)) * 4;
        const bool ok = m0 + r < M && k < K;
        cp_async16(As + r * T::kAStride + k - k0, ok ? x + (size_t)(m0 + r) * K + k : x, ok);
      }
    } else {
      for (int idx = tid; idx < T::BM * kKT; idx += T::kThreads) {
        const int r = idx / kKT;
        const int k = k0 + idx % kKT;
        const bool ok = m0 + r < M && k < K;
        cp_async4(As + r * T::kAStride + k - k0, ok ? x + (size_t)(m0 + r) * K + k : x, ok);
      }
    }
    if (vec_w) {  // N % 4 == 0: a piece is 4 columns, all in or all out
      for (int idx = tid; idx < kKT * (T::BN / 4); idx += T::kThreads) {
        const int r = idx / (T::BN / 4);
        const int c = (idx % (T::BN / 4)) * 4;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async16(Bs + r * T::BN + c, ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok);
      }
    } else {
      for (int idx = tid; idx < kKT * T::BN; idx += T::kThreads) {
        const int r = idx / T::BN;
        const int c = idx % T::BN;
        const bool ok = k0 + r < K && n0 + c < N;
        cp_async4(Bs + r * T::BN + c, ok ? w + (size_t)(k0 + r) * N + n0 + c : w, ok);
      }
    }
  };

  // Under a fold: this thread's running sum of the finished splits after
  // the ring (split_k.cuh's fold_split).
  float* sum = smem + T::kStages * T::kStage;
  float acc[T::TM][T::TN];
  auto& flat = reinterpret_cast<float(&)[T::TM * T::TN]>(acc);
  int split_end = chunks_per_split;
  simt::run_chunks<T>(smem, begin, n, ty, tx, acc, load, [&](int t) {
    if constexpr (kMode == kFold)
      splitk::fold_split<T::kThreads>(sum, flat, t + 1, n, chunks_per_split, split_end);
  });

  if constexpr (kMode == kCluster) {
    // The cluster is this tile's splits, rank = split. Each block leaves
    // its partial sums where the ring was, sums[i][tid]; the first adds the
    // others' in split order and runs the epilogue.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int s = 0; s < T::TM; ++s)
#pragma unroll
      for (int c = 0; c < T::TN; ++c) smem[(s * T::TN + c) * T::kThreads + tid] = acc[s][c];
    cluster.sync();
    const unsigned splits = cluster.num_blocks();
    if (cluster.block_rank() == 0) {
#pragma unroll
      for (int s = 0; s < T::TM; ++s)
#pragma unroll
        for (int c = 0; c < T::TN; ++c) {
          float* mine = smem + (s * T::TN + c) * T::kThreads + tid;
          for (unsigned r = 1; r < splits; ++r) acc[s][c] += *cluster.map_shared_rank(mine, r);
        }
    }
    cluster.sync();  // the partial sums stay until the first block has read them
    if (cluster.block_rank() != 0) return;
  }

  if constexpr (kMode == kFold) splitk::fold_finish<T::kThreads>(sum, flat, n, chunks_per_split);
  // the workspace is (splits, groups, M, N), the output (groups, M, N)
  const size_t group_out = (size_t)M * N;
  float* ws = e.ws == nullptr ? nullptr
                              : e.ws + ((size_t)blockIdx.z * (gridDim.y / row_blocks) + g) * group_out;
#pragma unroll
  for (int s = 0; s < T::TM; ++s) {
    const int r = m0 + ty + s * T::kRowThreads;
    if (r >= M) continue;
#pragma unroll
    for (int c = 0; c < T::TN; ++c) {
      const int col = n0 + (c / 4) * 4 * T::kColThreads + tx * 4 + c % 4;
      if (col >= N) continue;
      const size_t idx = (size_t)r * N + col;
      if (ws != nullptr)
        ws[idx] = acc[s][c];
      else
        splitk::finish(e, g * group_out + idx, col, acc[s][c]);
    }
  }
}

// Run f(Tile<...>{}, mode) for the block tile (bm, bn), one of the six the
// wrapper's plan picks from (F32_TILES), with mode a std::integral_constant;
// cudaErrorInvalidValue for another tile, or a mode the tile does not run.
template <class F>
int with_tile(int bm, int bn, int mode, F&& f) {
  using Split = std::integral_constant<int, kSplit>;
  using Fold = std::integral_constant<int, kFold>;
  using Cluster = std::integral_constant<int, kCluster>;
  // the modes a tile runs in besides kSplit: the many-row tiles fold, the
  // 64-column ones take a cluster
  auto run = [&](auto tile, auto can_fold, auto can_cluster) -> int {
    if (mode == kSplit) return f(tile, Split{});
    if constexpr (decltype(can_fold)::value)
      if (mode == kFold) return f(tile, Fold{});
    if constexpr (decltype(can_cluster)::value)
      if (mode == kCluster) return f(tile, Cluster{});
    return (int)cudaErrorInvalidValue;
  };
  using Yes = std::true_type;
  using No = std::false_type;
  if (bm == kBM && bn == kBN) return run(Tile<kBM, kBN, 8, 8, 3>{}, Yes{}, No{});
  if (bm == 64 && bn == 64) return run(Tile<64, 64, 8, 4, 4>{}, Yes{}, Yes{});
  if (bm == 32 && bn == 256) return run(Tile<32, 256, 4, 8, 4>{}, No{}, No{});
  if (bm == 32 && bn == 64) return run(Tile<32, 64, 4, 4, 4>{}, No{}, Yes{});
  if (bm == 8 && bn == 512) return run(Tile<8, 512, 1, 16, 3>{}, No{}, No{});
  if (bm == 8 && bn == 64) return run(Tile<8, 64, 1, 4, 3>{}, No{}, Yes{});
  return (int)cudaErrorInvalidValue;
}

// A cluster launch: the splits of each output tile (grid z) as one cluster.
template <class L, class Kernel, class... Args>
int launch_cluster(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  if (L::kSmem + splitk::kStaticSmemRoom > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(L::kThreads);
  config.dynamicSmemBytes = L::kSmem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // namespace

// x (groups, M, K) with groups stride_x elements apart, w (groups, K, N) with
// groups stride_w apart, bias (N,) or null, shared by the groups, out
// (groups, M, N) contiguous; all fp32. Each group is the 2-D product of its
// x and w with the split of K of a launch of that group alone, added in the
// same order whatever the mode: its bits are that launch's. Group g's blocks
// are y = g x row blocks + row block of the grid. (bm, bn) is a block tile
// of with_tile; K is cut into splits runs of chunks_per_split chunks of kKT.
// mode 0: split z of K on grid z, then, with splits > 1, the partial sums in
// ws (fp32, splits x groups x M x N, not zeroed: every element is written)
// added in split order by split_k.cuh; mode 1 (fold): each block runs every
// split and adds them itself; mode 2 (cluster, 2 to kMaxCluster splits): the
// splits of a tile as one cluster, added in split order by its first block.
// ws may be null but in mode 0 with splits > 1. vec_x (vec_w): 16-byte
// copies of x (w), for K (N) and stride_x (stride_w) multiples of 4 on a
// 16-byte aligned pointer. act: 0 none, 1 relu, 2 gelu (tanh). Launches on `stream`
// and returns cudaGetLastError() (0 when the launch was accepted;
// cudaErrorInvalidValue for another tile or mode).
extern "C" int gfid_matmul_f32(const float* x, const float* w, const float* bias,
                               float* out, float* ws, int M, int K, int N, int bm, int bn,
                               int splits, int chunks_per_split, int mode, int act,
                               int vec_x, int vec_w, int groups, long long stride_x,
                               long long stride_w, void* stream) {
  if ((mode == kCluster && (splits < 2 || splits > kMaxCluster)) || groups < 1)
    return (int)cudaErrorInvalidValue;
  const splitk::Epilogue e{bias, 0, out, 0, mode == kSplit ? ws : nullptr, act};
  return with_tile(bm, bn, mode, [&](auto tile, auto mode_c) {
    using T = decltype(tile);
    constexpr int kMode = decltype(mode_c)::value;
    using L = Launch<T, kMode>;
    const int grid_splits = kMode == kFold ? 1 : splits;
    const dim3 grid((N + T::BN - 1) / T::BN, groups * ((M + T::BM - 1) / T::BM),
                    grid_splits);
    if constexpr (kMode == kCluster)
      return launch_cluster<L>(gfid_matmul_kernel<T, kMode>, grid, (cudaStream_t)stream,
                               e, x, w, M, K, N, chunks_per_split, vec_x, vec_w, stride_x,
                               stride_w);
    else
      return splitk::launch<L>(gfid_matmul_kernel<T, kMode>, grid, (cudaStream_t)stream,
                               e, grid_splits, (long long)groups * M * N, N, x, w, M, K, N,
                               chunks_per_split, vec_x, vec_w, stride_x, stride_w);
  });
}
