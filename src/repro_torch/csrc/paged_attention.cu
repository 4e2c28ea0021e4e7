// K3: one-token GQA decode attention over the FlowKV block-major pool, for
// Hopper (sm_90a): a split-KV ("flash-decoding") kernel.
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention/paged_attention.py (paged_decode_attention,
// pallas_call at :145). For each request b it reads the pages named by
// block_tables[b] for ONE layer of the pool (nb, L, 2, payload) and keeps an
// fp32 online softmax (m, l, acc): scores are q.k / sqrt(hd) with an fp32
// sqrt and a true division, positions >= lengths[b] are masked, and it
// writes m and l per (b, kv-head, group) exactly as the reference's
// _stats_ref defines them -- a length-0 row gives out = 0,
// m = finfo(float32).min and l = 0.
//
// The kernel takes the whole pool plus a layer index and computes each
// page's address from (block, layer, k/v) in 64-bit arithmetic: pool[:, layer]
// is a strided view in torch, and making it contiguous would copy
// 2 * nb * payload elements per layer per step.
//
// Bound: bytes. The work reads each valid token's K and V row once per
// (request, kv-head), plus q and the tables, so the least time is those
// bytes / HBM bandwidth; the flops (4 * H * hd per token) are far below the
// ridge point, so there is nothing for wgmma to do, and TMA would only
// replace 16-byte register loads that already keep the bytes in flight.
//
// Design.
// - Grid (splits, KV, B). A split is a fixed run of pages_per_split pages
//   counted from page 0; the number of splits comes from the table width W
//   (a host shape), never from the lengths on the device, so the launch needs
//   no host sync. A split at or past the row's pages returns at once (its
//   partial would be empty: m = -FLT_MAX, l = 0, acc = 0, which the combine
//   skips, so it neither reads a page nor writes one). Table entries past the
//   row's pages are never read.
// - Inside a block (8 warps) each token is taken by a group of lpt lanes;
//   lane j of the group holds 16-byte vectors j, j + lpt, ... of the K and V
//   rows (vectors past the row, as at hd 160, are masked). One K load serves
//   all G query heads of the kv-head: each lane dots its slice with q (fp32,
//   in shared memory) and the group sums by xor shuffles. Each lane group
//   keeps its own online softmax state over the tokens it takes, with acc
//   over its slice of hd; warp w takes chunks w, w + 8, ... of 32 / lpt
//   tokens and issues the loads of its next chunk before computing the
//   current one; the split's block ids are read once, into shared memory,
//   so no load waits on a table read. No __syncthreads per page.
// - The split's state is merged across the lane groups of a warp (xor
//   butterfly) and then across the warps (shared memory, warp order), and
//   written unnormalised to a workspace. Each block then takes a ticket on a
//   per-(b, kv-head) counter; the last of the row's splits combines the
//   partials in split order s = 0, 1, ...:
//     M = max_s m_s, l = sum_s exp(m_s - M) l_s,
//     out = sum_s exp(m_s - M) acc_s / max(l, 1e-30),
//   rounds out to T once, and resets the counter to zero for the next call.
// - Every token's place in that arithmetic (split, warp, lane group, order)
//   follows from its position alone, so a row's out, m and l are bit-identical
//   whatever the batch, the other rows and the table width.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxG = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// 16 bytes of T -> kN floats
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x); o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z); o[3] = __uint_as_float(u.w);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float* o) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// Partial of one split in the workspace: acc (G, hd), then m (G), then l (G).
__host__ __device__ __forceinline__ long long partial_floats(int G, int hd) {
  return (long long)G * (hd + 2);
}

// T: element type; NV: 16-byte vectors a lane holds per row; GC: capacity
// for the G query heads of a kv-head (G <= GC).
template <typename T, int NV, int GC>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const T* __restrict__ q,                 // (B, H, hd)
                          const T* __restrict__ pool,              // (nb, L, 2, payload)
                          const int32_t* __restrict__ block_tables,  // (B, W)
                          const int32_t* __restrict__ lengths,       // (B,)
                          T* __restrict__ out,                     // (B, H, hd)
                          float* __restrict__ m_out,               // (B, KV, G) or null
                          float* __restrict__ l_out,               // (B, KV, G) or null
                          float* __restrict__ part,                // (B, KV, S) partials
                          int* __restrict__ counters,              // (B, KV), zero between calls
                          int H, int KV, int hd, int bs, int L, int layer, int W,
                          int pages_per_split, int lpt) {
  constexpr int VN = Vec<T>::kN;
  constexpr int NE = NV * VN;              // acc elements a lane holds per head
  extern __shared__ float smem[];
  __shared__ int last_block;
  const int G = H / KV;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float neg_max = -FLT_MAX;
  const long long bk = (long long)b * KV + kvh;
  T* ob = out + bk * G * hd;               // heads kvh*G .. kvh*G + G - 1 of row b

  int length = lengths[b];
  if (length < 0) length = 0;
  int n_pages = (length + bs - 1) / bs;
  if (n_pages > W) n_pages = W;
  if (length > n_pages * bs) length = n_pages * bs;
  const int n_splits = (n_pages + pages_per_split - 1) / pages_per_split;
  if (split >= n_splits) {
    if (split == 0) {                      // length 0: out = 0, m = finfo.min, l = 0
      for (int i = tid; i < G * hd; i += kThreads) from_f32(0.f, ob + i);
      if (m_out != nullptr)
        for (int g = tid; g < G; g += kThreads) {
          m_out[bk * G + g] = neg_max;
          l_out[bk * G + g] = 0.f;
        }
    }
    return;
  }

  const long long pf = partial_floats(G, hd);
  float* q_s = smem;                       // G * hd
  float* w_s = q_s + G * hd;               // kWarps partials of pf floats
  int* blk_s = reinterpret_cast<int*>(w_s + kWarps * pf);   // the split's block ids
  const T* qb = q + bk * G * hd;
  const int32_t* table = block_tables + (long long)b * W + split * pages_per_split;
  const int split_pages = min(pages_per_split, n_pages - split * pages_per_split);
  for (int i = tid; i < split_pages; i += kThreads) blk_s[i] = table[i];
  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_f32(qb[i]);
  __syncthreads();

  const float sqrt_hd = sqrtf((float)hd);
  const int tpw = 32 / lpt;                // tokens a warp takes per chunk
  const int grp = lane / lpt, j = lane % lpt;
  const int nvec = hd / VN;
  const int split_tokens = pages_per_split * bs;
  const int tok0 = split * split_tokens;
  const int n_tok = min(length - tok0, split_tokens);
  const int n_chunks = (n_tok + tpw - 1) / tpw;
  const long long payload = (long long)bs * KV * hd;
  const long long row_stride = (long long)KV * hd;   // token stride inside a page

  float m[GC], l[GC], acc[GC][NE];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = neg_max;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[g][e] = 0.f;
  }

  // the K and V vectors of this lane's token in chunk c (zero where masked)
  auto load = [&](int c, uint4 (&kr)[NV], uint4 (&vr)[NV]) {
    const int u = c * tpw + grp;
#pragma unroll
    for (int i = 0; i < NV; ++i) kr[i] = vr[i] = make_uint4(0u, 0u, 0u, 0u);
    if (c < n_chunks && u < n_tok) {
      const long long blk = blk_s[u / bs];
      const T* k_row = pool + ((blk * L + layer) * 2) * payload +
                       (long long)(u % bs) * row_stride + (long long)kvh * hd;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int v = j + lpt * i;
        if (v < nvec) {
          kr[i] = __ldg(reinterpret_cast<const uint4*>(k_row) + v);
          vr[i] = __ldg(reinterpret_cast<const uint4*>(k_row + payload) + v);
        }
      }
    }
  };

  uint4 kn[NV], vn[NV];
  load(warp, kn, vn);
  for (int c = warp; c < n_chunks; c += kWarps) {
    uint4 kc[NV], vc[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) { kc[i] = kn[i]; vc[i] = vn[i]; }
    load(c + kWarps, kn, vn);              // the next chunk's loads go out first
    const bool valid = c * tpw + grp < n_tok;
    float kf[NE], vf[NE];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      Vec<T>::unpack(kc[i], kf + i * VN);
      Vec<T>::unpack(vc[i], vf + i * VN);
    }
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < G) {
        const float* qg = q_s + g * hd;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = j + lpt * i;
          if (v < nvec) {
#pragma unroll
            for (int e4 = 0; e4 < VN; e4 += 4) {
              const float4 qv = *reinterpret_cast<const float4*>(qg + v * VN + e4);
              dot = fmaf(qv.x, kf[i * VN + e4], dot);
              dot = fmaf(qv.y, kf[i * VN + e4 + 1], dot);
              dot = fmaf(qv.z, kf[i * VN + e4 + 2], dot);
              dot = fmaf(qv.w, kf[i * VN + e4 + 3], dot);
            }
          }
        }
        for (int o = lpt >> 1; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (valid) {
          const float s = dot / sqrt_hd;
          const float m_new = fmaxf(m[g], s);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = fmaf(l[g], alpha, p);
          m[g] = m_new;
#pragma unroll
          for (int e = 0; e < NE; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e] * alpha);
        }
      }
    }
  }

  // merge the lane groups of the warp: an xor butterfly, a tree fixed by the
  // lane positions alone; group 0's result is the one written
  for (int o = lpt; o < 32; o <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < G) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m[g], o);
        const float l2 = __shfl_xor_sync(0xffffffffu, l[g], o);
        const float mx = fmaxf(m[g], m2);
        const float a1 = expf(m[g] - mx), a2 = expf(m2 - mx);
        l[g] = l[g] * a1 + l2 * a2;
        m[g] = mx;
#pragma unroll
        for (int e = 0; e < NE; ++e) {
          const float x2 = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
          acc[g][e] = acc[g][e] * a1 + x2 * a2;
        }
      }
    }
  }
  float* ws = w_s + warp * pf;
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      if (g < G) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int v = j + lpt * i;
          if (v < nvec) {
#pragma unroll
            for (int e = 0; e < VN; ++e) ws[g * hd + v * VN + e] = acc[g][i * VN + e];
          }
        }
        if (j == 0) {
          ws[G * hd + g] = m[g];
          ws[G * hd + G + g] = l[g];
        }
      }
    }
  }
  __syncthreads();

  // merge the warps in order 0..kWarps-1 and write the split's partial
  float* pb = part + bk * S * pf;
  float* pw = pb + split * pf;
  for (int i = tid; i < G * hd + G; i += kThreads) {
    const int g = i < G * hd ? i / hd : i - G * hd;
    float mx = neg_max;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, w_s[w * pf + G * hd + g]);
    const int src = i < G * hd ? i : G * hd + G + g;    // acc element, or l
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      sum += expf(w_s[w * pf + G * hd + g] - mx) * w_s[w * pf + src];
    if (i < G * hd) {
      pw[i] = sum;
    } else {
      pw[G * hd + g] = mx;
      pw[G * hd + G + g] = sum;
    }
  }

  // the last of the row's splits to finish combines them
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(counters + bk, 1) == n_splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  // stage every split's m and l (independent loads) in shared memory, which
  // the block no longer needs; then the weights exp(m_s - M) per head
  float* c_m = smem;                       // n_splits * G
  float* c_w = c_m + n_splits * G;         // n_splits * G: l_s, then exp(m_s - M)
  float* c_l = c_w + n_splits * G;         // G
  for (int k = tid; k < n_splits * G; k += kThreads) {
    const int s = k / G, g = k % G;
    c_m[k] = __ldcg(pb + s * pf + G * hd + g);
    c_w[k] = __ldcg(pb + s * pf + G * hd + G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float mx = neg_max;
    for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, c_m[s * G + g]);
    float lsum = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const float e = expf(c_m[s * G + g] - mx);
      lsum += e * c_w[s * G + g];
      c_w[s * G + g] = e;
    }
    c_l[g] = lsum;
    if (m_out != nullptr) {
      m_out[bk * G + g] = mx;
      l_out[bk * G + g] = lsum;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd;
    float a = 0.f;
#pragma unroll 4
    for (int s = 0; s < n_splits; ++s) a += c_w[s * G + g] * __ldcg(pb + s * pf + i);
    from_f32(a / fmaxf(c_l[g], 1e-30f), ob + i);
  }
  if (tid == 0) counters[bk] = 0;
}

// the larger of the split's needs (q, the warps' states, the block ids) and
// the combine's (m_s, l_s per split and head), in 4-byte words
long long smem_bytes(int G, int hd, int S, int pages_per_split) {
  const long long split = G * hd + kWarps * partial_floats(G, hd) + pages_per_split;
  const long long combine = 2LL * S * G + G;
  return (split > combine ? split : combine) * (long long)sizeof(float);
}

int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

template <typename T, int NV, int GC>
int launch(const void* q, const void* pool, const int32_t* block_tables,
           const int32_t* lengths, void* out, float* m_out, float* l_out, float* part,
           int* counters, int B, int H, int KV, int hd, int bs, int L, int layer, int W,
           int pages_per_split, int lpt, cudaStream_t st) {
  const int S = W > 0 ? (W + pages_per_split - 1) / pages_per_split : 1;
  const long long smem = smem_bytes(H / KV, hd, S, pages_per_split);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kernel = paged_decode_split_kernel<T, NV, GC>;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((unsigned)S, (unsigned)KV, (unsigned)B);
  kernel<<<grid, kThreads, (size_t)smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool), block_tables, lengths,
      static_cast<T*>(out), m_out, l_out, part, counters, H, KV, hd, bs, L, layer, W,
      pages_per_split, lpt);
  return (int)cudaGetLastError();
}

// NV and the lanes per token: two vectors a lane where the accumulators of
// the G heads stay within 64 registers, else one; lpt is the power of two
// that covers the row's vectors.
template <typename T, int GC>
int dispatch_nv(const void* q, const void* pool, const int32_t* block_tables,
                const int32_t* lengths, void* out, float* m_out, float* l_out, float* part,
                int* counters, int B, int H, int KV, int hd, int bs, int L, int layer, int W,
                int pages_per_split, cudaStream_t st) {
  constexpr int VN = Vec<T>::kN;
  const int nvec = hd / VN;
  const bool one = nvec <= 32 && GC * 2 * VN > 64;
  const int nv = one ? 1 : 2;
  const int lpt = pow2_at_least((nvec + nv - 1) / nv);
  if (lpt > 32) return (int)cudaErrorInvalidValue;
  if (one)
    return launch<T, 1, GC>(q, pool, block_tables, lengths, out, m_out, l_out, part, counters,
                            B, H, KV, hd, bs, L, layer, W, pages_per_split, lpt, st);
  return launch<T, 2, GC>(q, pool, block_tables, lengths, out, m_out, l_out, part, counters,
                          B, H, KV, hd, bs, L, layer, W, pages_per_split, lpt, st);
}

template <typename T>
int dispatch_g(const void* q, const void* pool, const int32_t* block_tables,
               const int32_t* lengths, void* out, float* m_out, float* l_out, float* part,
               int* counters, int B, int H, int KV, int hd, int bs, int L, int layer, int W,
               int pages_per_split, cudaStream_t st) {
  const int G = H / KV;
#define K3_DISPATCH(GC)                                                                   \
  return dispatch_nv<T, GC>(q, pool, block_tables, lengths, out, m_out, l_out, part,      \
                            counters, B, H, KV, hd, bs, L, layer, W, pages_per_split, st)
  if (G <= 2) K3_DISPATCH(2);
  if (G <= 4) K3_DISPATCH(4);
  if (G <= 8) K3_DISPATCH(8);
  K3_DISPATCH(16);
#undef K3_DISPATCH
}

}  // namespace

// Floats of the workspace one call needs: a partial per (b, kv-head, split).
extern "C" long long paged_decode_attention_workspace_floats(int B, int H, int KV, int hd,
                                                             int W, int pages_per_split) {
  const int S = W > 0 ? (W + pages_per_split - 1) / pages_per_split : 1;
  return (long long)B * KV * S * partial_floats(H / KV, hd);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pool and out share it). part holds
// paged_decode_attention_workspace_floats(...) floats; counters holds B * KV
// ints that are zero before the call and are zero again after it (calls that
// share counters must be ordered on one stream).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pool, const int32_t* block_tables,
    const int32_t* lengths, void* out, float* m_out, float* l_out, float* part,
    int* counters, int B, int H, int KV, int hd, int bs, int L, int layer, int W,
    int pages_per_split, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 || hd > 256 || hd % 8 != 0 ||
      bs <= 0 || W < 0 || pages_per_split <= 0 || KV > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_g<float>(q, pool, block_tables, lengths, out, m_out, l_out, part, counters,
                             B, H, KV, hd, bs, L, layer, W, pages_per_split, st);
  if (dtype == 1)
    return dispatch_g<__nv_bfloat16>(q, pool, block_tables, lengths, out, m_out, l_out, part,
                                     counters, B, H, KV, hd, bs, L, layer, W, pages_per_split,
                                     st);
  return (int)cudaErrorInvalidValue;
}
