// K3: one-token GQA decode attention over the FlowKV block-major pool, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// repro/kernels/paged_attention/paged_attention.py (paged_decode_attention,
// pallas_call at :145). For each request b it reads the pages named by
// block_tables[b] for ONE layer of the pool (nb, L, 2, payload) and keeps an
// fp32 online softmax (m, l, acc) across pages: scores are q.k / sqrt(hd)
// with an fp32 sqrt, positions >= lengths[b] are masked, and with stats it
// writes m and l per (b, kv-head, group) exactly as the reference's
// _stats_ref defines them -- a length-0 row gives out = 0,
// m = finfo(float32).min and l = 0.
//
// The kernel takes the whole pool plus a layer index and computes each
// page's address from (block, layer, k/v): pool[:, layer] is a strided view
// in torch, and making it contiguous would copy 2 * nb * payload elements
// per layer per step.
//
// Bound: bytes. The work reads each valid token's K and V row once per
// (request, kv-head), plus q and the tables, so the least time is those
// bytes / HBM bandwidth; the flops (4 * H * hd per token) are far below the
// ridge point.
//
// Design: one thread block (256 threads) per (request, kv-head). The block
// walks the request's block table itself, loading the ids. Per page, all
// threads first stage the head's K and V rows into shared memory as fp32
// with 16-byte loads, several in flight per thread (the page reads are the
// bound, and a sequence of dependent loads left the first version latency
// bound); K rows are padded by one float so that the per-token dot products
// are free of bank conflicts. Then one thread per (token, group) scores its
// token (the G = H/KV query heads that share the kv-head share each K/V row
// load), one warp per group turns the page's scores into the online softmax
// update, and every thread accumulates p.V for its own head dims. Tokens at
// or past the length are never read. Not yet done: splitting a long
// sequence's pages over several blocks (small batches fill B * KV SMs),
// prefetching the next page during compute, TMA and wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 16;
constexpr int kLoadBatch = 4;      // 16-byte loads in flight per thread, per K and V

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// 16 bytes of T -> VEC floats
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void paged_decode_kernel(const T* __restrict__ q,       // (B, H, hd)
                                    const T* __restrict__ pool,    // (nb, L, 2, payload)
                                    const int32_t* __restrict__ block_tables,  // (B, W)
                                    const int32_t* __restrict__ lengths,       // (B,)
                                    T* __restrict__ out,           // (B, H, hd)
                                    float* __restrict__ m_out,     // (B, KV, G)
                                    float* __restrict__ l_out,     // (B, KV, G)
                                    int H, int KV, int hd, int bs, int L,
                                    int layer, int W) {
  extern __shared__ float smem[];
  const int G = H / KV;
  const int kstride = hd + 1;        // padded K row (bank-conflict-free dots)
  float* q_s = smem;                 // G * hd
  float* acc_s = q_s + G * hd;       // G * hd
  float* p_s = acc_s + G * hd;       // G * bs  (scores, then probabilities)
  float* m_s = p_s + G * bs;         // G
  float* l_s = m_s + G;              // G
  float* sc_s = l_s + G;             // G  (rescale of the previous state)
  float* k_s = sc_s + G;             // bs * (hd + 1)
  float* v_s = k_s + bs * kstride;   // bs * hd

  const int b = blockIdx.x / KV;
  const int h = blockIdx.x % KV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float neg_inf = -FLT_MAX;
  const float sqrt_hd = sqrtf((float)hd);
  constexpr int VN = Vec<T>::kN;
  const int vec_per_row = hd / VN;

  const long long payload = (long long)bs * KV * hd;
  const long long row_stride = (long long)KV * hd;   // token stride inside a page
  const T* qb = q + ((long long)b * H + (long long)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = to_f32(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = neg_inf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int length = lengths[b];
  int n_pages = (length + bs - 1) / bs;
  if (n_pages > W) n_pages = W;
  const int32_t* table = block_tables + (long long)b * W;

  for (int pi = 0; pi < n_pages; ++pi) {
    const long long blk = table[pi];
    const T* k_page = pool + ((blk * L + layer) * 2 + 0) * payload + (long long)h * hd;
    const T* v_page = pool + ((blk * L + layer) * 2 + 1) * payload + (long long)h * hd;
    const int start = pi * bs;
    int n_valid = length - start;
    if (n_valid > bs) n_valid = bs;

    // -- stage the valid rows of K and V in shared memory (fp32)
    const int n_vec = n_valid * vec_per_row;
    for (int base = tid; base < n_vec; base += kThreads * kLoadBatch) {
      uint4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < n_vec) {
          const long long off = (long long)(idx / vec_per_row) * row_stride +
                                (long long)(idx % vec_per_row) * VN;
          kr[u] = *reinterpret_cast<const uint4*>(k_page + off);
          vr[u] = *reinterpret_cast<const uint4*>(v_page + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int idx = base + u * kThreads;
        if (idx < n_vec) {
          const int t = idx / vec_per_row;
          const int d0 = (idx % vec_per_row) * VN;
          float kf[VN], vf[VN];
          Vec<T>::unpack(kr[u], kf);
          Vec<T>::unpack(vr[u], vf);
#pragma unroll
          for (int j = 0; j < VN; ++j) {
            k_s[t * kstride + d0 + j] = kf[j];
            v_s[t * hd + d0 + j] = vf[j];
          }
        }
      }
    }
    __syncthreads();

    // -- scores: one thread per (group, token)
    for (int pair = tid; pair < G * bs; pair += kThreads) {
      const int g = pair / bs;
      const int t = pair % bs;
      float s = neg_inf;
      if (t < n_valid) {
        const float* qg = q_s + g * hd;
        const float* kt = k_s + t * kstride;
        float dot = 0.f;
        for (int d = 0; d < hd; ++d) dot += qg[d] * kt[d];
        s = dot / sqrt_hd;
      }
      p_s[pair] = s;
    }
    __syncthreads();

    // -- online softmax update: one warp per group
    for (int g = warp; g < G; g += kWarps) {
      float mx = neg_inf;
      for (int t = lane; t < bs; t += 32) mx = fmaxf(mx, p_s[g * bs + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < bs; t += 32) {
        const float p = (t < n_valid) ? expf(p_s[g * bs + t] - m_new) : 0.f;
        p_s[g * bs + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float scale = expf(m_prev - m_new);
        sc_s[g] = scale;
        l_s[g] = l_s[g] * scale + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // -- acc = acc * scale + p . V: each thread owns head dims d
    for (int d = tid; d < hd; d += kThreads) {
      float a[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) a[g] = (g < G) ? acc_s[g * hd + d] * sc_s[g] : 0.f;
      for (int t = 0; t < n_valid; ++t) {
        const float vv = v_s[t * hd + d];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) a[g] += p_s[g * bs + t] * vv;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) acc_s[g * hd + d] = a[g];
    }
    __syncthreads();
  }

  T* ob = out + ((long long)b * H + (long long)h * G) * hd;
  for (int i = tid; i < G * hd; i += kThreads) {
    const float denom = fmaxf(l_s[i / hd], 1e-30f);
    from_f32(acc_s[i] / denom, ob + i);
  }
  if (m_out != nullptr) {
    for (int g = tid; g < G; g += kThreads) {
      m_out[((long long)b * KV + h) * G + g] = m_s[g];
      l_out[((long long)b * KV + h) * G + g] = l_s[g];
    }
  }
}

}  // namespace

extern "C" int paged_decode_attention_smem_bytes(int H, int KV, int hd, int bs) {
  const int G = H / KV;
  return (2 * G * hd + G * bs + 3 * G + bs * (2 * hd + 1)) * (int)sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (q, pool and out share it).
extern "C" int paged_decode_attention_launch(
    const void* q, const void* pool, const int32_t* block_tables,
    const int32_t* lengths, void* out, float* m_out, float* l_out, int B, int H,
    int KV, int hd, int bs, int L, int layer, int W, int dtype, void* stream) {
  if (B <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kMaxG || hd <= 0 || hd > 256 || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = paged_decode_attention_smem_bytes(H, KV, hd, bs);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((unsigned)(B * KV));
  if (dtype == 0) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(paged_decode_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    paged_decode_kernel<float><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(pool), block_tables,
        lengths, static_cast<float*>(out), m_out, l_out, H, KV, hd, bs, L, layer, W);
  } else if (dtype == 1) {
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(paged_decode_kernel<__nv_bfloat16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(pool),
        block_tables, lengths, static_cast<__nv_bfloat16*>(out), m_out, l_out, H, KV,
        hd, bs, L, layer, W);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
