// Paged-KV block gather: out[b, j*bs:(j+1)*bs, ...] = pool[table[b, j]], a
// bitwise copy of any element type, for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel src/repro/kernels/paged.py paged_gather
//   (_gather_kernel), whose scalar-prefetched block table steers the
//   BlockSpec index maps so that the body is a pure block copy.
//
// What bounds it on an H100: device memory. A gather does no arithmetic: it
//   reads B x blocks_per_req pool blocks and writes them once. At
//   smollm-135m's full width one pool block holds 16 slots x 30 layers x 3
//   kv heads x 64 bf16 values = 184,320 bytes, and a decode step at batch 8
//   with 32 blocks a request moves 47.2 MB in and 47.2 MB out per leaf. The
//   time floor is those bytes over the memory rate.
//
// What the design does about it: one thread block copies one (b, j) block.
//   It reads its block id from the table in device memory (the counterpart
//   of the TPU's scalar prefetch), then streams the block with the widest
//   unit that the two base pointers and the block's byte length all allow:
//   16-byte vector loads and stores when they are 16-byte aligned, else 8,
//   4, 2 or 1 bytes (the wrapper picks the unit per call), so a copy needs
//   no tail. Each thread keeps four loads in flight before it stores.
//   Consecutive threads touch consecutive units, so loads and stores
//   coalesce. Nothing is read or written outside the pool and the output:
//   an id outside [0, num_blocks) is a caller error, and the block stops
//   with __trap() before it reads anything, which ends the launch with an
//   error that the next synchronisation reports.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads in flight per thread before the stores

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const T* __restrict__ pool, const int* __restrict__ table,
                    T* __restrict__ out, long long units, int num_blocks,
                    int blocks_per_req) {
  const int j = blockIdx.x;
  const int b = blockIdx.y;
  const int id = table[(size_t)b * blocks_per_req + j];
  if (id < 0 || id >= num_blocks) __trap();  // uniform across the block
  const T* src = pool + (size_t)id * units;
  T* dst = out + ((size_t)b * blocks_per_req + j) * units;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < units; i += kUnroll * kThreads) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * kThreads] = v[u];
  }
  for (; i < units; i += kThreads) dst[i] = src[i];
}

template <typename T>
int launch(const void* pool, const int* table, void* out, long long block_bytes,
           int num_blocks, int batch, int blocks_per_req, cudaStream_t stream) {
  const dim3 grid(blocks_per_req, batch);
  paged_gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(pool), table, static_cast<T*>(out),
      block_bytes / (long long)sizeof(T), num_blocks, blocks_per_req);
  return (int)cudaGetLastError();
}

}  // namespace

// pool: (num_blocks, block_bytes) bytes; table: (batch, blocks_per_req) int32;
// out: (batch, blocks_per_req, block_bytes) bytes. `unit` (16, 8, 4, 2 or 1)
// must divide block_bytes and both pointers. Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted); an unknown
// unit returns cudaErrorInvalidValue without launching.
extern "C" int paged_gather(const void* pool, const int* table, void* out,
                            long long block_bytes, int num_blocks, int batch,
                            int blocks_per_req, int unit, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (unit) {
    case 16: return launch<int4>(pool, table, out, block_bytes, num_blocks, batch, blocks_per_req, s);
    case 8: return launch<int2>(pool, table, out, block_bytes, num_blocks, batch, blocks_per_req, s);
    case 4: return launch<int>(pool, table, out, block_bytes, num_blocks, batch, blocks_per_req, s);
    case 2: return launch<unsigned short>(pool, table, out, block_bytes, num_blocks, batch, blocks_per_req, s);
    case 1: return launch<unsigned char>(pool, table, out, block_bytes, num_blocks, batch, blocks_per_req, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
