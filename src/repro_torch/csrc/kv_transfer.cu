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
// Two designs, one launch per descriptor table each. The design and its
// launch geometry are chosen in Python (kernels/kv_gather/ops.py::k1_design)
// from the row width, the table's length, the alignment and which pool lies
// in pinned host memory, and passed to kv_transfer_launch; nothing here
// tries one design and falls back to another.
//
// pages (rows of at least ops.ROWS_BELOW bytes, short tables, and every
// launch with a pool in pinned host memory). Bound: HBM bytes, 2 * n *
// row_bytes over 3.35 TB/s (a 1000-token qwen3-1.7b bf16 transfer moves
// 1792 pages of 64 KiB: ~117 MB each way). One 256-thread block per row
// (grid = n), 16-byte words with four loads in flight before the four
// stores where the row and both bases are 16-byte aligned, else 4-, 2- or
// 1-byte words. A 64 KiB page keeps every thread busy for 16 words: ~81% of
// the HBM bound, faster than index_copy_.
//
// rows (rows narrower than ops.ROWS_BELOW = 2 KiB in a table of at least
// ops.rows_from(row_bytes) rows: a sharded plan's fine (-1, head_dim)
// rows). Bound: HBM
// bytes again, plus the row indices. One block a row leaves most of its 256
// threads idle (8 busy on a 128 B row), and the rate of block issue then
// sets the time: 577,536 fine rows of a TP 2 -> 4 plan ran at 7% of the
// bound. Here a group of `lanes` threads (the row's words rounded up to a
// power of two, at most a warp) copies one row, a block holds 256 / lanes
// groups, each group keeps up to kRowsInFlight rows in flight (fewer where
// the table is too short to give every SM a block), and the row indices of
// a pass are read coalesced across the groups. The grid (at most
// ops.ROWS_BLOCKS_PER_SM blocks an SM) strides over the table. The
// thresholds were measured with tools/k1_host_ablate.py on an H100 (one
// block a row vs this kernel). At ~19 MB of random rows, ms: 16 B 1.312 vs
// 0.139, 128 B 0.172 vs 0.024, 512 B 0.052 vs 0.023, 1 KiB 0.033 vs 0.025,
// 2 KiB 0.025 vs 0.030, 4 KiB 0.022 vs 0.035, 64 KiB 0.021 vs 0.104; at the
// decode append's 448 rows of 2 KiB 0.0070 vs 0.0098: so ROWS_BELOW = 2 KiB.
// Over short tables (the decode appends of a sharded MoE model are 48-192
// rows of 256 B-1 KiB), device us: a table shorter than one wave of page
// blocks (132 SMs x 8) runs all its rows at once in the page kernel, which
// then wins, 2.0-2.5 vs 2.8-3.1 at 128-512 B x 48-768 rows and 2.0-3.0 vs
// 3.6-4.2 at 1 KiB. The small-row kernel wins from 1056 rows at 128-256 B
// (3.15 vs 2.98 at 128 B), from 3072 at 512 B (6.04 vs 5.08; 3.70 vs 4.07
// at 1536) and is level at 6144 rows of 1 KiB (11.16 vs 11.21): so
// ops.rows_from asks 1056 rows for each 256 B of row width.
//
// The host route (the host tier's demote and promote) runs the page kernel
// on the pinned side's mapped device pointer (cudaHostGetDevicePointer).
// Bound: the host link, 63 GB/s a direction on PCIe gen 5 x16, not HBM. The
// demote (SM stores over PCIe) runs at ~83% of the link, level with copy_.
// The promote (SM loads over PCIe) ran at 43-48% of it on some hosts while
// the copy engine's copy_ reached ~78%. Finding: an earlier version of this
// file and of tools/k1_host_ablate.py tried, within one process on each of
// several H100 machines, one block a page, 16-264 persistent blocks, and a
// persistent kernel in which one thread a CTA issued TMA bulk copies
// (cp.async.bulk ... mbarrier::complete_tx) from the mapped host row into a
// 2-4 stage shared-memory ring of 16-64 KiB chunks and bulk-stored each
// stage to the pool, at 4-132 CTAs. The bulk-copy unit does take a mapped
// host address (bit-exact on every machine; the toolkit's headers do not
// say), but every design that has the GPU issue the reads ran at one rate,
// set by the host behind the card: 51 GB/s on one machine (4.72-4.78 ms for
// 242 MB; copy_ + index_copy_ 4.58-4.59 ms), 23-34 GB/s on the others
// (7.1-11 ms; the copy engine 4.6-5.7 ms), with as few as 4 CTAs and 192 KB
// in flight. So the cap is the host's, on reads the GPU initiates, not the
// number of reads in flight; the bulk kernel was no faster than one block a
// page and is not kept.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kRowsInFlight = 8;

enum Design { kPages = 0, kRows = 1 };

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

// A pass of a block covers groups * in_flight consecutive rows: group q
// takes rows base + q + k * groups (k < in_flight <= kRowsInFlight), so for
// each k the groups of a warp read consecutive entries of the tables.
template <typename W>
__global__ void __launch_bounds__(kThreads)
kv_transfer_rows_kernel(const char* __restrict__ src, char* __restrict__ dst,
                        const int32_t* __restrict__ src_pages,
                        const int32_t* __restrict__ dst_pages, long long n,
                        long long row_bytes, int lanes_log2, int in_flight) {
  const int lanes = 1 << lanes_log2;
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x >> lanes_log2;
  const int groups = kThreads >> lanes_log2;
  const long long tile = (long long)groups * in_flight;
  const long long words = row_bytes / (long long)sizeof(W);
  const W* s = reinterpret_cast<const W*>(src);
  W* d = reinterpret_cast<W*>(dst);
  for (long long base = (long long)blockIdx.x * tile; base < n;
       base += (long long)gridDim.x * tile) {
    long long so[kRowsInFlight], dof[kRowsInFlight];
#pragma unroll
    for (int k = 0; k < kRowsInFlight; ++k) {
      const long long r = base + group + (long long)k * groups;
      const bool on = k < in_flight && r < n;
      so[k] = on ? (long long)src_pages[r] * words : -1;
      dof[k] = on ? (long long)dst_pages[r] * words : -1;
    }
    for (long long j = lane; j < words; j += lanes) {
      W v[kRowsInFlight] = {};
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (so[k] >= 0) v[k] = s[so[k] + j];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k)
        if (so[k] >= 0) d[dof[k] + j] = v[k];
    }
  }
}

template <typename W>
void launch_word(int design, const char* src, char* dst, const int32_t* sp,
                 const int32_t* dp, long long n, long long row_bytes, int lanes_log2,
                 int in_flight, int grid, cudaStream_t stream) {
  if (design == kRows)
    kv_transfer_rows_kernel<W><<<grid, kThreads, 0, stream>>>(src, dst, sp, dp, n, row_bytes,
                                                              lanes_log2, in_flight);
  else
    kv_transfer_kernel<W><<<grid, kThreads, 0, stream>>>(src, dst, sp, dp, row_bytes);
}

// The mapped device pointer of pinned host memory, in place; on failure
// the error is cleared from the runtime's state (or the next launch check
// would report it) and returned.
cudaError_t to_device_pointer(void** ptr) {
  void* p = nullptr;
  const cudaError_t err = cudaHostGetDevicePointer(&p, *ptr, 0);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  *ptr = p;
  return cudaSuccess;
}

}  // namespace

// One K1 launch's design and geometry (ops.K1Design) and its host sides.
struct K1Launch {
  int design;       // 0 pages, 1 rows
  int word;         // bytes a thread access: 16, 4, 2 or 1
  int lanes;        // threads a row: a power of two up to 32 (rows)
  int in_flight;    // rows a group keeps in flight: 1 to kRowsInFlight (rows)
  int grid;         // blocks: n (pages), any count (rows: a grid-stride loop)
  int src_on_host;  // a side in pinned host memory: its mapped device
  int dst_on_host;  // pointer is resolved first
};

// One K1 launch as `g` says. Returns a cudaError_t: a geometry the kernels
// do not take is refused with cudaErrorInvalidValue before anything runs.
extern "C" int kv_transfer_launch(const void* src, void* dst, const int32_t* src_pages,
                                  const int32_t* dst_pages, long long n, long long row_bytes,
                                  const K1Launch* g, void* stream) {
  if (n <= 0) return 0;
  const int design = g->design, word = g->word, lanes = g->lanes, in_flight = g->in_flight;
  const int grid = g->grid;
  if (n > 0x7fffffffLL || row_bytes <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  if ((design != kPages && design != kRows) || (design == kPages && grid != n))
    return (int)cudaErrorInvalidValue;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  if (design == kRows && (lanes < 1 || lanes > 32 || (1 << lanes_log2) != lanes ||
                          in_flight < 1 || in_flight > kRowsInFlight))
    return (int)cudaErrorInvalidValue;
  void* s = const_cast<void*>(src);
  void* d = dst;
  cudaError_t err = cudaSuccess;
  if (g->src_on_host && (err = to_device_pointer(&s)) != cudaSuccess) return (int)err;
  if (g->dst_on_host && (err = to_device_pointer(&d)) != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const char* cs = static_cast<const char*>(s);
  char* cd = static_cast<char*>(d);
  const uintptr_t align = reinterpret_cast<uintptr_t>(cs) | reinterpret_cast<uintptr_t>(cd) |
                          static_cast<uintptr_t>(row_bytes);
  if ((word != 16 && word != 4 && word != 2 && word != 1) || (align & (word - 1)))
    return (int)cudaErrorInvalidValue;
  if (word == 16)
    launch_word<uint4>(design, cs, cd, src_pages, dst_pages, n, row_bytes, lanes_log2, in_flight,
                       grid, st);
  else if (word == 4)
    launch_word<uint32_t>(design, cs, cd, src_pages, dst_pages, n, row_bytes, lanes_log2, in_flight,
                          grid, st);
  else if (word == 2)
    launch_word<uint16_t>(design, cs, cd, src_pages, dst_pages, n, row_bytes, lanes_log2, in_flight,
                          grid, st);
  else
    launch_word<uint8_t>(design, cs, cd, src_pages, dst_pages, n, row_bytes, lanes_log2, in_flight,
                         grid, st);
  return (int)cudaGetLastError();
}
