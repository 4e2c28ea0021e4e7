// K4: causal GQA flash attention for prefill, cold and suffix mode, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_prefill/flash_prefill.py
// (flash_prefill, pallas_call at :113). q (B, S, H, hd), k/v (B, T, KV, hd)
// with T = S + q_offset; query row i sits at global position q_offset + i and
// sees key j iff j <= q_offset + i (causal) -- q_offset > 0 is the suffix
// prefill of a prefix-cache hit or of a later chunk. Scores are q.k in fp32
// divided by an fp32 sqrt(hd); masked scores are finfo(float32).min; the
// online softmax keeps (m, l, acc) in fp32 with the Pallas body's guards and
// writes acc / max(l, 1e-30) in q's dtype. p stays fp32 for p.V (the Pallas
// body upcasts v as well). Non-causal only with q_offset = 0.
//
// Bound: operations. 4 * hd * H FLOPs per (query, visible key) pair against
// one read of q, k, v and one write of out: at qwen3-1.7b's cold S = T = 1500
// (H 16, KV 8, hd 128) one layer is 9.2 GFLOP over 18.4 MB in bf16, so the
// least time is 9.3 us at the tensor cores' 989 TFLOP/s (bytes: 5.5 us at
// 3.35 TB/s). This first version uses plain fp32 FMA (67 TFLOP/s peak on
// the card), so it cannot come near that bound; mma.sync / wgmma tiles are
// the redesign's work.
//
// Design: one thread block (256 threads) per (batch, kv-head, query tile).
// A query tile is kPairs = 64 (row, head) pairs: 64 / G rows times the G =
// H / KV query heads that share the kv-head, so each K/V tile staged in
// shared memory (16-byte loads, converted to fp32) serves all G heads. Key
// tiles are BK keys wide and start at key 0: their width depends on hd only,
// never on q_offset or S. Each thread computes an SP x KPT block of scores
// (sequential fp32 FMA over hd), 8 neighbouring lanes reduce a row's max and
// sum with a fixed butterfly, and each thread keeps an AP x DPT block of the
// fp32 accumulator in registers for the whole key sweep. Key tiles wholly
// above the diagonal of the query tile's last row are skipped.
//
// Row independence: every (row, head) pair goes through the same arithmetic
// whatever its place in its block -- the dot products run over hd in order,
// the row reductions follow key positions inside the tile, and p.V runs over
// the tile's keys in order. A tile that is wholly masked for a row leaves
// its m unchanged (max with finfo.min), gives scale = exp(0) = 1 and p = 0,
// so it adds exactly 0. Row q_offset + i of a suffix call is therefore
// bit-identical to the same row of the cold call over the whole sequence,
// which keeps chunked and prefix-reuse prefill equal to monolithic prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPairs = 64;                  // (row, head) pairs per block

template <int HD>
struct Tile {
  static constexpr int BK = 32;                         // keys per tile
  static constexpr int KPT = BK / 8;                    // keys per thread (scores)
  static constexpr int SP = kPairs * 8 / kThreads;      // pairs per thread (scores)
  static constexpr int QS = HD + 4;                     // padded q / k row stride
  static constexpr int ACC = kPairs * HD / kThreads;    // accumulators per thread
  static constexpr int DPT = ACC < 8 ? ACC : 8;         // head dims per thread (p.V)
  static constexpr int NDG = HD / DPT;                  // dim groups
  static constexpr int AP = ACC / DPT;                  // pairs per thread (p.V)
  static constexpr int SMEM_FLOATS =
      kPairs * QS + BK * QS + BK * HD + BK * kPairs + 3 * kPairs;
  static_assert(SP * (kThreads / 8) == kPairs, "score tiling covers the pairs");
  static_assert(NDG * (kPairs / AP) == kThreads, "p.V tiling covers the threads");
};

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

__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* o) { *o = __float2bfloat16(x); }

// Stage `rows` rows of hd elements (row r at src + r * row_stride) into
// dst[r * dst_stride + d] as fp32; rows at or past `valid` become zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, long long row_stride,
                                           int rows, int valid, float* dst, int dst_stride) {
  constexpr int VN = Vec<T>::kN;
  constexpr int VPR = HD / VN;
  for (int idx = threadIdx.x; idx < rows * VPR; idx += kThreads) {
    const int r = idx / VPR;
    const int d0 = (idx % VPR) * VN;
    float f[VN];
    if (r < valid) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + r * row_stride + d0);
      Vec<T>::unpack(u, f);
    } else {
#pragma unroll
      for (int c = 0; c < VN; ++c) f[c] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < VN; c += 4)
      *reinterpret_cast<float4*>(dst + r * dst_stride + d0 + c) =
          make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q,     // (B, S, H, HD)
                     const T* __restrict__ k,     // (B, T, KV, HD)
                     const T* __restrict__ v,     // (B, T, KV, HD)
                     T* __restrict__ out,         // (B, S, H, HD)
                     int S, int Tk, int H, int KV, int q_offset, int causal) {
  using C = Tile<HD>;
  constexpr int BK = C::BK, KPT = C::KPT, SP = C::SP, QS = C::QS;
  constexpr int DPT = C::DPT, NDG = C::NDG, AP = C::AP;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* q_s = smem;                     // kPairs x QS
  float* k_s = q_s + kPairs * QS;        // BK x QS
  float* v_s = k_s + BK * QS;            // BK x HD
  float* p_t = v_s + BK * HD;            // BK x kPairs (probabilities, key-major)
  float* m_s = p_t + BK * kPairs;        // kPairs
  float* l_s = m_s + kPairs;             // kPairs
  float* sc_s = l_s + kPairs;            // kPairs (rescale of the previous state)

  const int G = H / KV;
  const int BQ = kPairs / G;             // query rows per block
  const int P = BQ * G;                  // live pairs (< kPairs when G does not divide 64)
  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest (last) tiles start first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row0 = qt * BQ;
  const int rows = min(BQ, S - row0);
  const float neg_inf = -FLT_MAX;
  const float sqrt_hd = __fsqrt_rn((float)HD);

  // -- the query tile, pair p = r * G + g  ->  q[b, row0 + r, kh * G + g, :]
  {
    constexpr int VN = Vec<T>::kN;
    constexpr int VPR = HD / VN;
    for (int idx = tid; idx < kPairs * VPR; idx += kThreads) {
      const int p = idx / VPR, d0 = (idx % VPR) * VN;
      const int r = p / G, g = p % G;
      float f[VN];
      if (p < P && r < rows) {
        const T* src = q + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + d0;
        Vec<T>::unpack(*reinterpret_cast<const uint4*>(src), f);
      } else {
#pragma unroll
        for (int c = 0; c < VN; ++c) f[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < VN; c += 4)
        *reinterpret_cast<float4*>(q_s + p * QS + d0 + c) =
            make_float4(f[c], f[c + 1], f[c + 2], f[c + 3]);
    }
  }
  for (int p = tid; p < kPairs; p += kThreads) {
    m_s[p] = neg_inf;
    l_s[p] = 0.f;
  }

  // causal skip: tiles past the last real row's frontier are never loaded
  const int n_all = (Tk + BK - 1) / BK;
  int n_tiles = n_all;
  if (causal) {
    const int last_pos = q_offset + row0 + rows - 1;
    n_tiles = min(n_all, last_pos / BK + 1);
  }

  // score-stage coordinates: 8 neighbouring lanes share a pair block
  const int pg = tid >> 3, kg = tid & 7;
  int qpos[SP];
  bool row_ok[SP];
#pragma unroll
  for (int a = 0; a < SP; ++a) {
    const int p = pg * SP + a;
    const int r = p / G;
    row_ok[a] = p < P && r < rows;
    qpos[a] = q_offset + row0 + r;
  }
  // p.V coordinates
  const int dg = tid % NDG, apg = tid / NDG;
  float acc[AP][DPT];
#pragma unroll
  for (int a = 0; a < AP; ++a)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[a][c] = 0.f;

  const long long kv_row = (long long)KV * HD;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    const long long base = ((long long)b * Tk + k0) * kv_row + (long long)kh * HD;
    stage_rows<T, HD>(k + base, kv_row, BK, Tk - k0, k_s, QS);
    stage_rows<T, HD>(v + base, kv_row, BK, Tk - k0, v_s, HD);
    __syncthreads();

    // -- scores: thread (pg, kg) owns pairs pg*SP.. and keys kg + 8c
    float s[SP][KPT];
#pragma unroll
    for (int a = 0; a < SP; ++a)
#pragma unroll
      for (int c = 0; c < KPT; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[SP], kv[KPT];
#pragma unroll
      for (int a = 0; a < SP; ++a)
        qv[a] = *reinterpret_cast<const float4*>(q_s + (pg * SP + a) * QS + d);
#pragma unroll
      for (int c = 0; c < KPT; ++c)
        kv[c] = *reinterpret_cast<const float4*>(k_s + (kg + 8 * c) * QS + d);
#pragma unroll
      for (int a = 0; a < SP; ++a)
#pragma unroll
        for (int c = 0; c < KPT; ++c) {
          float x = s[a][c];
          x = fmaf(qv[a].x, kv[c].x, x);
          x = fmaf(qv[a].y, kv[c].y, x);
          x = fmaf(qv[a].z, kv[c].z, x);
          x = fmaf(qv[a].w, kv[c].w, x);
          s[a][c] = x;
        }
    }

    // -- online softmax update, per pair, across the 8 lanes of the pair block
#pragma unroll
    for (int a = 0; a < SP; ++a) {
      const int p = pg * SP + a;
      bool ok[KPT];
      float mx = neg_inf;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const int j = k0 + kg + 8 * c;
        ok[c] = row_ok[a] && j < Tk && (!causal || j <= qpos[a]);
        s[a][c] = ok[c] ? s[a][c] / sqrt_hd : neg_inf;
        mx = fmaxf(mx, s[a][c]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[p];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < KPT; ++c) {
        const float e = ok[c] ? expf(s[a][c] - m_safe) : 0.f;
        p_t[(kg + 8 * c) * kPairs + p] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float scale = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
      __syncwarp();
      if (kg == 0) {
        m_s[p] = m_new;
        l_s[p] = l_s[p] * scale + sum;
        sc_s[p] = scale;
      }
    }
    __syncthreads();

    // -- acc = acc * scale + p . V over the tile's keys in order
#pragma unroll
    for (int a = 0; a < AP; ++a) {
      const float sc = sc_s[apg * AP + a];
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[a][c] *= sc;
    }
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[AP], vv[DPT];
#pragma unroll
      for (int a = 0; a < AP; ++a) pv[a] = p_t[j * kPairs + apg * AP + a];
#pragma unroll
      for (int c = 0; c < DPT; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(v_s + j * HD + dg * DPT + c);
        vv[c] = x.x; vv[c + 1] = x.y; vv[c + 2] = x.z; vv[c + 3] = x.w;
      }
#pragma unroll
      for (int a = 0; a < AP; ++a)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
    __syncthreads();
  }

  // -- out = acc / max(l, 1e-30) in q's dtype
#pragma unroll
  for (int a = 0; a < AP; ++a) {
    const int p = apg * AP + a;
    const int r = p / G, g = p % G;
    if (p >= P || r >= rows) continue;
    const float denom = fmaxf(l_s[p], 1e-30f);
    T* o = out + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + dg * DPT;
#pragma unroll
    for (int c = 0; c < DPT; ++c) from_f32(acc[a][c] / denom, o + c);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
           int H, int KV, int q_offset, int causal, cudaStream_t st) {
  const int smem = Tile<HD>::SMEM_FLOATS * (int)sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_prefill_kernel<T, HD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int bq = kPairs / (H / KV);
  const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)KV, (unsigned)B);
  flash_prefill_kernel<T, HD><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, Tk, H, KV, q_offset, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
              int H, int KV, int hd, int q_offset, int causal, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 256: return launch<T, 256>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Tk = S + q_offset.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int Tk, int H, int KV, int hd,
                                    int q_offset, int causal, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > kPairs || q_offset < 0 || Tk != S + q_offset ||
      (!causal && q_offset != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, out, B, S, Tk, H, KV, hd, q_offset, causal, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, B, S, Tk, H, KV, hd, q_offset, causal, st);
  return (int)cudaErrorInvalidValue;
}
