// K1: fused descriptor-table KV transfer (gather-scatter) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/kv_gather/kv_transfer.py
// (kv_transfer, pallas_call at :57). Both pools are viewed as flat page
// tables (num_pages, row_bytes); descriptor i copies the bytes of
// src[src_pages[i]] to dst[dst_pages[i]]. The copy is in place on dst, so
// pages the table does not name keep their bytes. It is a byte copy: the
// Python wrapper refuses a dtype mismatch and src/dst sharing storage.
// Duplicate dst rows are allowed as long as they carry identical bytes (the
// decode append's power-of-two pad lanes replicate lane 0).
//
// Bound: bytes. Each descriptor reads row_bytes and writes row_bytes, so the
// least time is 2 * n * row_bytes / HBM bandwidth (a 1000-token qwen3-1.7b
// bf16 transfer moves 1792 pages of 64 KiB: ~117 MB each way).
//
// Design: one thread block per descriptor, 256 threads striding over the
// row. When the row size and both base pointers are 16-byte aligned every
// thread moves 16-byte vectors, four loads in flight before the four
// stores, which keeps enough bytes outstanding per SM to approach the HBM
// rate; otherwise the same kernel falls back to 4-, 2- or 1-byte words, so
// any row width (64 KiB pages, 2 KiB append rows, 16-element fine rows)
// takes one launch. Simple and correct first: no TMA, no persistent grid.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename W>
__global__ void kv_transfer_kernel(const char* __restrict__ src,
                                   char* __restrict__ dst,
                                   const int32_t* __restrict__ src_pages,
                                   const int32_t* __restrict__ dst_pages,
                                   long long row_bytes) {
  const long long i = blockIdx.x;
  const W* s = reinterpret_cast<const W*>(src + (long long)src_pages[i] * row_bytes);
  W* d = reinterpret_cast<W*>(dst + (long long)dst_pages[i] * row_bytes);
  const long long n = row_bytes / (long long)sizeof(W);
  const long long step = (long long)kThreads * kUnroll;
  long long base = threadIdx.x;
  for (; base + (kUnroll - 1) * kThreads < n; base += step) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = s[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) d[base + u * kThreads] = v[u];
  }
  for (long long j = base; j < n; j += kThreads) d[j] = s[j];
}

template <typename W>
void launch(const void* src, void* dst, const int32_t* sp, const int32_t* dp,
            long long n, long long row_bytes, cudaStream_t stream) {
  kv_transfer_kernel<W><<<(unsigned)n, kThreads, 0, stream>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), sp, dp, row_bytes);
}

}  // namespace

extern "C" int kv_transfer_launch(const void* src, void* dst,
                                  const int32_t* src_pages,
                                  const int32_t* dst_pages, long long n,
                                  long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t bases = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  const uintptr_t align = bases | (uintptr_t)row_bytes;
  if ((align & 15) == 0) {
    launch<uint4>(src, dst, src_pages, dst_pages, n, row_bytes, st);
  } else if ((align & 3) == 0) {
    launch<uint32_t>(src, dst, src_pages, dst_pages, n, row_bytes, st);
  } else if ((align & 1) == 0) {
    launch<uint16_t>(src, dst, src_pages, dst_pages, n, row_bytes, st);
  } else {
    launch<uint8_t>(src, dst, src_pages, dst_pages, n, row_bytes, st);
  }
  return (int)cudaGetLastError();
}
