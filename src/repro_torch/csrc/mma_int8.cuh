// The int8 tensor-core core of the int8 implicit-GEMM conv
// (gfid_conv_int8.cu) and the int8 GEMM (gfid_matmul_int8.cu): a block tile
// of BM rows x BN columns, walked over K in chunks of kKc = 64 bytes, each
// product an s8 x s8 -> s32 `mma.sync.m16n8k32` with int32 accumulators in
// registers. Only the loader is the kernel's own.
//
// The pieces, in the order a block runs them:
//   * a loader (the kernel's) fills one stage of a kStages-deep ring with a
//     chunk of A (BM x kKc, row major, rows padded to kAStride = 80 bytes so
//     that the 8 rows an `ldmatrix` phase reads fall in 8 different 16-byte
//     bank groups) and of B as it lies in device memory (kKc K rows x BN
//     columns, channels contiguous, rows padded to BN + 16 bytes), by
//     16-byte `cp.async` where it can, else by words it gathers itself.
//     kStages - 2 chunks are in flight while one is multiplied;
//   * the mma wants each column's K bytes contiguous, and sm_90 has no
//     8-bit `ldmatrix.trans`, so B is transposed from its stage into one of
//     two channel-major buffers one chunk ahead of its use (`transpose_b`):
//     each thread reads blocks of 4 K rows x 4 columns as four 32-bit words,
//     transposes each with four `__byte_perm`s into four column words and
//     stores them 64 bytes a column, the 16-byte pieces of column n permuted
//     by ((n >> 1) ^ (n >> 3)) & 3 (`b_offset`): an `ldmatrix` of 8 columns
//     then reads 8 bank groups. One __syncthreads a chunk orders it all;
//   * `mma_chunk`: each warp takes its A fragments by `ldmatrix.x4`, which
//     for 8-bit data delivers the m16n8k32 A layout exactly (4 consecutive
//     K bytes of one row a register), and its B fragments by `ldmatrix.x4`
//     of the channel-major B (4 consecutive K bytes of one column a
//     register), then issues two k32 steps of MT x NT `mma.sync`s;
//   * under a split of K, the splits of an output tile run as one thread
//     block cluster (grid z = the split, at most kMaxCluster) and
//     `cluster_sum` adds them through distributed shared memory, each block
//     a share of the tile's accumulator slots (all of a slot's loads from
//     the cluster issued together), so that every block then stores its
//     share: no workspace, no memset, one launch, and no block reading the
//     whole tile alone. Integer addition is exact in any order, so every
//     split and tile gives the same bits.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "smem.cuh"

namespace mma8 {

constexpr int kKc = 64;              // K bytes a chunk: two k32 mma steps
constexpr int kStages = 4;           // ring: one chunk multiplied, the next transposed, two in flight
constexpr int kAStride = kKc + 16;   // bytes an A row: conflict-free ldmatrix
constexpr int kMaxCluster = 8;       // the portable cluster size

// A block tile of BM rows x BN columns on WM x WN warps, each warp MT x NT
// mma tiles of 16 x 8; kMinBlocks of it an SM (the kernels' launch bounds),
// by default 128 registers a thread: two 8-warp or four 4-warp blocks.
template <int BM_, int BN_, int WM_, int WN_, int MinBlocks_ = 512 / (32 * WM_ * WN_)>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int MT = BM / WM / 16;
  static constexpr int NT = BN / WN / 8;
  static constexpr int kAStage = BM * kAStride;         // bytes
  static constexpr int kBStride = BN + 16;               // bytes a staged B row
  static constexpr int kStage = kAStage + kKc * kBStride;  // bytes: A, then B as loaded
  static constexpr int kBBuf = BN * kKc;                 // bytes: B channel major
  static constexpr int kBBlocks = (kKc / 4) * (BN / 4);  // 4 x 4 byte blocks of a B chunk
  static constexpr int kBPer = kBBlocks / kThreads;      // blocks a thread
  static constexpr size_t kRing = (size_t)kStages * kStage + 2 * kBBuf;
  static constexpr size_t kSums = sizeof(int) * MT * NT * 4 * kThreads;
  static constexpr int kMinBlocks = MinBlocks_;
  static_assert(MT >= 1 && NT % 2 == 0, "B fragments load two n8 tiles at a time");
  static_assert(kBBlocks % kThreads == 0, "every thread stages the same number of B blocks");
  static_assert(kThreads % 16 == 0, "a thread's A word (or piece) of a chunk is fixed");

  // The B block a thread's idx-th slot transposes: K rows 4 kq .. 4 kq + 3
  // of the chunk, columns 4 cq .. 4 cq + 3. Four neighbouring lanes take
  // four K blocks of one column group, eight lanes eight column groups: the
  // reads and the stores of a warp each spread over 16 banks.
  static __device__ __forceinline__ void b_block(int idx, int& kq, int& cq) {
    kq = (idx / BN) * 4 + idx % 4;
    cq = (idx / 4) % (BN / 4);
  }
};

// Byte offset of (column n, K byte kb) in a B buffer.
__device__ __forceinline__ int b_offset(int n, int kb) {
  return n * kKc + ((((kb >> 4) ^ (n >> 1) ^ (n >> 3)) & 3) << 4) + (kb & 15);
}

using smem::cp_async16;
using smem::cp_async_commit;
using smem::cp_async_wait;
using smem::ldmatrix_x4;

// d += a (16 x 32, row major) * b (32 x 8, column major), s8 in, s32 sums.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows r0..r3 of a 4 x 4 byte block (each word: 4 columns of one K row) ->
// columns c0..c3 (each word: 4 K rows of one column, lowest K first).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The B chunk of a stage (Bn: K rows of BN bytes, kBStride apart) into a
// channel-major buffer, transposed.
template <class T>
__device__ __forceinline__ void transpose_b(const uint8_t* Bn, uint8_t* Bt) {
#pragma unroll
  for (int p = 0; p < T::kBPer; ++p) {
    int kq, cq;
    T::b_block(threadIdx.x + p * T::kThreads, kq, cq);
    uint32_t r[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(Bn + (4 * kq + i) * T::kBStride + 4 * cq);
    transpose4(r, c);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(Bt + b_offset(4 * cq + i, 4 * kq)) = c[i];
  }
}

// One K chunk of the block tile from (As, Bs) into this warp's accumulators.
template <class T>
__device__ __forceinline__ void mma_chunk(const uint8_t* As, const uint8_t* Bs,
                                          int (&acc)[T::MT][T::NT][4]) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int row0 = (warp % T::WM) * (T::BM / T::WM);
  const int col0 = (warp / T::WM) * (T::BN / T::WN);
#pragma unroll
  for (int kk = 0; kk < kKc; kk += 32) {
    uint32_t a[T::MT][4];
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)  // lanes 0-15: rows at kk, 16-31: rows at kk + 16
      ldmatrix_x4(a[mt], As + (row0 + mt * 16 + lane % 16) * kAStride + kk + (lane / 16) * 16);
    uint32_t b[T::NT][2];
#pragma unroll
    for (int nt = 0; nt < T::NT; nt += 2) {  // (n, k), (n, k + 16), (n + 8, k), (n + 8, k + 16)
      uint32_t r[4];
      ldmatrix_x4(r, Bs + b_offset(col0 + nt * 8 + (lane / 16) * 8 + lane % 8,
                                   kk + ((lane / 8) % 2) * 16));
      b[nt][0] = r[0];
      b[nt][1] = r[1];
      b[nt + 1][0] = r[2];
      b[nt + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < T::NT; ++nt) mma_s8_16832(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
  }
}

// Chunks [begin, end) of K through the ring. load(chunk, As, Bn) fills one
// stage: A at As, B as it lies in memory at Bn; it may issue cp.async copies
// or store directly.
template <class T, class Load>
__device__ __forceinline__ void mainloop(Load&& load, int begin, int end, uint8_t* smem,
                                         int (&acc)[T::MT][T::NT][4]) {
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0;
  uint8_t* bt = smem + kStages * T::kStage;  // the two channel-major B buffers
  const int n = end - begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n) load(begin + s, smem + s * T::kStage, smem + s * T::kStage + T::kAStage);
    cp_async_commit();
  }
  if (n > 0) {
    cp_async_wait<kStages - 2>();  // chunk 0 has landed
    __syncthreads();
    transpose_b<T>(smem + T::kAStage, bt);
  }
  for (int t = 0; t < n; ++t) {
    cp_async_wait<kStages - 3>();  // chunk t + 1 has landed (this thread's copies)
    __syncthreads();  // ... and every thread's; B of chunk t transposed; chunk t - 1 consumed
    const int next = t + kStages - 1;
    if (next < n) {
      uint8_t* st = smem + (next % kStages) * T::kStage;
      load(begin + next, st, st + T::kAStage);
    }
    cp_async_commit();
    if (t + 1 < n)  // one chunk ahead, into the other buffer
      transpose_b<T>(smem + ((t + 1) % kStages) * T::kStage + T::kAStage,
                     bt + ((t + 1) & 1) * T::kBBuf);
    mma_chunk<T>(smem + (t % kStages) * T::kStage, bt + (t & 1) * T::kBBuf, acc);
  }
  cp_async_wait<0>();
}

// The accumulator slots a block stores after `cluster_sum`: slot
// (mt * NT + nt) * 4 + q where slot % parts == rank; every slot without a
// split (rank 0 of 1).
struct Share {
  unsigned rank, parts;
  __device__ __forceinline__ bool mine(int slot) const { return (unsigned)slot % parts == rank; }
};

// Under a split of K (this block one of a cluster along grid z): every
// block leaves its sums in its shared memory, `sums` (where the ring was),
// then adds, for its share of the slots, the sums of every block of the
// cluster, its own included, into acc. Returns the share: the block stores
// those slots, and the cluster stores the whole tile.
template <class T>
__device__ __forceinline__ Share cluster_sum(int (&acc)[T::MT][T::NT][4], int* sums) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // every warp is done with the ring
  const int tid = threadIdx.x;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) sums[((mt * T::NT + nt) * 4 + q) * T::kThreads + tid] = acc[mt][nt][q];
  cluster.sync();
  const Share share{cluster.block_rank(), cluster.num_blocks()};
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < T::NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int slot = (mt * T::NT + nt) * 4 + q;
        if (!share.mine(slot)) continue;
        int* at = sums + slot * T::kThreads + tid;
        int part[kMaxCluster];
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)  // every load in flight at once
          part[r] = r < (int)share.parts ? *cluster.map_shared_rank(at, r) : 0;
        int v = 0;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) v += part[r];
        acc[mt][nt][q] = v;
      }
  cluster.sync();  // the sums stay until every block has read them
  return share;
}

// Launch a tile kernel with its dynamic shared memory (the ring, or the
// sums where they are larger), as one cluster of the grid's z blocks when
// kCluster. Returns the launch's error.
template <class T, bool kCluster, class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
  constexpr size_t smem = kCluster && T::kSums > T::kRing ? T::kSums : T::kRing;
  const cudaError_t set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (set != cudaSuccess) return (int)set;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(T::kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = cluster;
  config.numAttrs = kCluster ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// Run f(Tile<...>{}) for the tile of (bm, bn), one of the three the conv's
// plan picks from (kernels/gfid_conv.py INT8_TILES); cudaErrorInvalidValue
// for any other. 32 x 64 and 64 x 64 on 4 warps (warp tiles of 16 x 32 and
// 32 x 32); 128 x 128 on 8 warps (64 x 32 each).
template <class F>
int with_tile(int bm, int bn, F&& f) {
  if (bn == 64 && bm == 32) return f(Tile<32, 64, 2, 2>{});
  if (bn == 64 && bm == 64) return f(Tile<64, 64, 2, 2>{});
  if (bn == 128 && bm == 128) return f(Tile<128, 128, 2, 4>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma8
