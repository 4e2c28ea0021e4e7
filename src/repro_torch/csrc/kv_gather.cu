// K5a: whole-block KV gather for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kv_gather/kv_gather.py
// (kv_gather, pallas_call at :42). out[i] = pool[ids[i]] for whole blocks:
// pool (nb, L, 2, payload) and out (n, L, 2, payload), each block one
// contiguous run of block_bytes = L * 2 * payload * itemsize bytes in both.
// It is a byte copy; duplicate ids are fine (each out block is written once).
//
// Bound: bytes. Each block is read once and written once, so the least time
// is 2 * n * block_bytes / HBM bandwidth (a 33-block qwen3-1.7b bf16 prefix,
// 3.5 MiB a block, moves 242 MB: 72 us at 3.35 TB/s).
//
// Design: no page table. The grid is (chunks per block, n); each thread
// block reads its block id itself and copies one contiguous chunk of
// kThreads * kUnroll words, every thread with kUnroll loads in flight
// before its stores (16-byte words: 16 KiB a chunk, so a 3.5 MiB block
// spreads over 224 thread blocks and every SM shares the copy). When the
// block size or a base pointer is not 16-byte aligned the same kernel runs
// on 4-, 2- or 1-byte words, so any block width takes one launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename W>
__global__ void __launch_bounds__(kThreads)
kv_gather_blocks_kernel(const char* __restrict__ pool, char* __restrict__ out,
                        const int32_t* __restrict__ ids, long long block_bytes) {
  const long long words = block_bytes / (long long)sizeof(W);
  const W* s = reinterpret_cast<const W*>(pool + (long long)ids[blockIdx.y] * block_bytes);
  W* d = reinterpret_cast<W*>(out + (long long)blockIdx.y * block_bytes);
  const long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  W w[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = base + (long long)u * kThreads;
    if (j < words) w[u] = s[j];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long j = base + (long long)u * kThreads;
    if (j < words) d[j] = w[u];
  }
}

template <typename W>
void launch(const void* pool, void* out, const int32_t* ids, long long n,
            long long block_bytes, cudaStream_t stream) {
  const long long words = block_bytes / (long long)sizeof(W);
  const long long per = (long long)kThreads * kUnroll;
  const dim3 grid((unsigned)((words + per - 1) / per), (unsigned)n);
  kv_gather_blocks_kernel<W><<<grid, kThreads, 0, stream>>>(
      static_cast<const char*>(pool), static_cast<char*>(out), ids, block_bytes);
}

}  // namespace

extern "C" int kv_gather_blocks_launch(const void* pool, void* out, const int32_t* ids,
                                       long long n, long long block_bytes, void* stream) {
  if (n <= 0 || block_bytes <= 0) return 0;
  if (n > 65535) return (int)cudaErrorInvalidValue;          // gridDim.y
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(pool) | reinterpret_cast<uintptr_t>(out) |
                          (uintptr_t)block_bytes;
  if ((align & 15) == 0) {
    launch<uint4>(pool, out, ids, n, block_bytes, st);
  } else if ((align & 3) == 0) {
    launch<uint32_t>(pool, out, ids, n, block_bytes, st);
  } else if ((align & 1) == 0) {
    launch<uint16_t>(pool, out, ids, n, block_bytes, st);
  } else {
    launch<uint8_t>(pool, out, ids, n, block_bytes, st);
  }
  return (int)cudaGetLastError();
}
