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
// 3.35 TB/s).
//
// Two kernels, chosen by dtype (a design choice, not a fallback):
//
// float32 -- flash_prefill_kernel<float, HD>, plain fp32 FMA (67 TFLOP/s
// peak; TF32 would break the fp32 tolerance). One thread block (256
// threads) per (batch, kv-head, query tile). A query tile is kPairs = 64
// (row, head) pairs: 64 / G rows times the G = H / KV query heads that share
// the kv-head, so each K/V tile staged in shared memory (16-byte loads,
// converted to fp32) serves all G heads. Key tiles are BK keys wide and
// start at key 0: their width depends on hd only, never on q_offset or S.
// Each thread computes an SP x KPT block of scores (sequential fp32 FMA over
// hd), 8 neighbouring lanes reduce a row's max and sum with a fixed
// butterfly, and each thread keeps an AP x DPT block of the fp32 accumulator
// in registers for the whole key sweep. Key tiles wholly above the diagonal
// of the query tile's last row are skipped.
//
// bfloat16 -- flash_prefill_mma_kernel<HD, NG>, on the tensor cores with
// mma.sync.m16n8k16 (bf16 inputs, fp32 accumulators). A block holds NG
// groups of 16 (row, head) pairs of one kv-head (2 groups, or 4 when G > 32)
// and two warps per group. Key tiles of BK = 64 keys (32 at hd 256) from
// key 0 are double-buffered in shared memory by cp.async (rows padded by
// 16 bytes, so ldmatrix is free of bank conflicts); each tile is an even and
// an odd chunk of BK/2 keys, and a group's two warps take one chunk each,
// with their own (m, l, acc), merged once at the end -- twice the warps on
// the card for the same work, which the short suffix and hd-256 shapes
// need. Fragments come from ldmatrix (.trans for V), loaded a step ahead of
// their MMAs; q's fragments stay in registers at hd <= 128. S = Q.K^T lands
// in fp32 accumulator fragments and the online softmax runs on them in
// registers, each row's max and sum reduced over its quad of lanes by two
// fixed shuffles; a chunk that all 16 rows see whole skips the mask. The
// division by sqrt(hd) is a reciprocal and one FMA correction (div_sqrt_hd).
// p stays close to fp32 for p.V: it is split into P_hi = bf16(p) and
// P_lo = bf16(p - P_hi), and both go through the MMA into the same fp32
// accumulator (p to about 2^-17 relative, against 2^-9 for one bf16 P,
// which would miss the half-ulp gate against the upcast plain version).
// The longest query tiles start first.
//
// Row independence (both kernels): every (row, head) pair goes through the
// same arithmetic whatever its place in its block -- the dot products run
// over hd in order, the row reductions follow key positions inside the tile
// (chunk) in a fixed order, p.V runs over the keys in order, and (bf16) the
// even/odd chunk split and the final merge are fixed from key 0. A tile
// that is wholly masked for a row leaves its m unchanged (max with
// finfo.min), gives scale = exp(0) = 1 and p = 0, so it adds exactly 0.
// Row q_offset + i of a suffix call is therefore bit-identical to the same
// row of the cold call over the whole sequence, which keeps chunked and
// prefix-reuse prefill equal to monolithic prefill.
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

__device__ __forceinline__ void from_f32(float x, float* o) { *o = x; }

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

// ---------------------------------------------------------------------------
// bfloat16: tensor cores (mma.sync m16n8k16, fp32 accumulators)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

template <int HD>
struct MmaTile {
  static constexpr int CH = HD <= 128 ? 32 : 16;    // keys per chunk, from key 0
  static constexpr int BK = 2 * CH;                 // keys per tile: an even and an odd chunk
  static constexpr int LD = HD + 8;                 // smem row stride (bf16), 16 B of pad
  static constexpr int NT = CH / 8;                 // n8 score tiles per chunk
  static constexpr int KS = HD / 16;                // k16 steps of q.k
  static constexpr int DT = HD / 8;                 // n8 tiles of the output
  static constexpr int CPR = HD / 8;                // 16-byte chunks per row
  static constexpr bool QREG = HD <= 128;           // q fragments live in registers
  static constexpr int WARPS_PER_SM = HD <= 128 ? 12 : 8;   // register budget
  static_assert(NT % 2 == 0 && DT % 2 == 0, "ldmatrix.x4 loads two n8 tiles");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// x / d rounded to nearest, for d = sqrt(hd) and r = RN(1 / d): q0 = RN(x * r)
// lies within an ulp of x / d, the FMA gives the remainder x - q0 * d
// exactly, and one FMA correction rounds to the nearest quotient
// (Markstein). Three instructions where div.rn takes a range check and a
// branch. Equal to div.rn on every finite score of magnitude >= 2^-100
// (flash_prefill_scale_check lets a test hold it to that on the card);
// below that a last-bit difference cannot reach p, since exp of a
// difference that small rounds to 1.
__device__ __forceinline__ float div_sqrt_hd(float x, float d, float r) {
  const float q0 = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q0, d, x), r, q0);
}

__global__ void scale_check_kernel(const float* __restrict__ x, float* __restrict__ out,
                                   long long n, int hd) {
  const float d = __fsqrt_rn((float)hd);
  const float r = __frcp_rn(d);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = div_sqrt_hd(x[i], d, r);
}

// Stage BK rows of K and V (keys k0..k0+BK-1 of kv-head kh) into one stage;
// keys at or past Tk become zeros.
template <int HD, int NTH>
__device__ __forceinline__ void load_kv_tile(const bf16* __restrict__ k, const bf16* __restrict__ v,
                                             long long base, int k0, int Tk, int KV,
                                             bf16* k_s, bf16* v_s) {
  using C = MmaTile<HD>;
  for (int idx = threadIdx.x; idx < C::BK * C::CPR; idx += NTH) {
    const int r = idx / C::CPR, c = idx % C::CPR;
    const bool ok = k0 + r < Tk;
    const long long off = ok ? base + (long long)(k0 + r) * KV * HD + c * 8 : 0;
    cp_async16(k_s + r * C::LD + c * 8, k + off, ok);
    cp_async16(v_s + r * C::LD + c * 8, v + off, ok);
  }
}

// Online-softmax update of one key chunk on the score fragments of this
// thread's two rows (h = 0, 1: row g and g + 8 of the warp's 16; s[j][2h+c]
// is key k0 + 8j + 2*t4 + c). MASK = false for a chunk that every row of
// the warp sees whole -- the same arithmetic with every key valid. Leaves p
// in s and rescales o.
template <int NT, int DT, bool MASK>
__device__ __forceinline__ void softmax_chunk(float (&s)[NT][4], float (&o)[DT][4], float (&m)[2],
                                              float (&l)[2], const bool (&row_ok)[2],
                                              const int (&qpos)[2], int k0, int t4, int Tk,
                                              int causal, float d, float r) {
  const float neg_inf = -FLT_MAX;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = neg_inf;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t4 + c;
        const bool ok = !MASK || (row_ok[h] && key < Tk && (!causal || key <= qpos[h]));
        const float x = ok ? div_sqrt_hd(s[j][2 * h + c], d, r) : neg_inf;
        s[j][2 * h + c] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = k0 + 8 * j + 2 * t4 + c;
        const bool ok = !MASK || (row_ok[h] && key < Tk && (!causal || key <= qpos[h]));
        const float e = ok ? expf(__fsub_rn(s[j][2 * h + c], m_safe)) : 0.f;
        s[j][2 * h + c] = e;
        sum = __fadd_rn(sum, e);
      }
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    const float scale = isfinite(m[h]) ? expf(__fsub_rn(m[h], m_safe)) : 0.f;
    l[h] = __fadd_rn(__fmul_rn(l[h], scale), sum);
    m[h] = m_new;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][2 * h] = __fmul_rn(o[n][2 * h], scale);
      o[n][2 * h + 1] = __fmul_rn(o[n][2 * h + 1], scale);
    }
  }
}

// A block: NG groups of 16 (row, head) pairs, two warps per group. Tile t
// holds keys [t*BK, t*BK + BK): the group's even warp takes chunk 2t, its odd
// warp chunk 2t+1, each with its own (m, l, acc); the two states merge at
// the end.
template <int HD, int NG>
__global__ void __launch_bounds__(NG * 64, MmaTile<HD>::WARPS_PER_SM / (2 * NG))
flash_prefill_mma_kernel(const bf16* __restrict__ q,     // (B, S, H, HD)
                         const bf16* __restrict__ k,     // (B, T, KV, HD)
                         const bf16* __restrict__ v,     // (B, T, KV, HD)
                         bf16* __restrict__ out,         // (B, S, H, HD)
                         int B, int S, int Tk, int H, int KV, int q_offset, int causal) {
  using C = MmaTile<HD>;
  constexpr int CH = C::CH, BK = C::BK, LD = C::LD, NT = C::NT, KS = C::KS, DT = C::DT;
  constexpr int CPR = C::CPR;
  constexpr int MP = 16 * NG;                     // (row, head) pairs per block
  constexpr int NTH = NG * 64;
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);     // 2 stages x BK x LD
  bf16* v_s = k_s + 2 * BK * LD;                  // 2 stages x BK x LD
  // q (MP x LD) waits in stage 1 of K when its fragments move to registers
  bf16* q_s = C::QREG ? k_s + BK * LD : v_s + 2 * BK * LD;
  static_assert(!C::QREG || MP <= BK, "q fits in one K stage");

  const int G = H / KV;
  const int BQ = MP / G;                          // query rows per block
  const int P = BQ * G;                           // live pairs
  const int nq = (S + BQ - 1) / BQ;
  // a 1-D grid, query tile slowest: the longest (last) tiles of every
  // (batch, kv-head) start first
  const int qt = nq - 1 - (int)(blockIdx.x / (KV * B));
  const int kh = (int)(blockIdx.x % KV);
  const int b = (int)(blockIdx.x / KV) % B;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp % NG, par = warp / NG;     // pair group, key chunk parity
  const int row0 = qt * BQ;
  const int rows = min(BQ, S - row0);
  const float d = __fsqrt_rn((float)HD);
  const float rd = __frcp_rn(d);

  // -- the query tile, pair p = r * G + g  ->  q[b, row0 + r, kh * G + g, :]
  for (int idx = threadIdx.x; idx < MP * CPR; idx += NTH) {
    const int p = idx / CPR, c = idx % CPR;
    const int r = p / G, g = p % G;
    const bool ok = p < P && r < rows;
    const long long off = ok ? (((long long)b * S + row0 + r) * H + kh * G + g) * HD + c * 8 : 0;
    cp_async16(q_s + p * LD + c * 8, q + off, ok);
  }
  // causal skip: tiles past the last real row's frontier are never loaded
  const int n_all = (Tk + BK - 1) / BK;
  int n_tiles = n_all;
  if (causal) n_tiles = min(n_all, (q_offset + row0 + rows - 1) / BK + 1);
  const long long kv_base = (long long)b * Tk * KV * HD + (long long)kh * HD;
  load_kv_tile<HD, NTH>(k, v, kv_base, 0, Tk, KV, k_s, v_s);
  cp_async_commit();

  // this thread's two rows of the group's 16: pair grp*16 + (lane>>2) + 8h
  const int t4 = lane & 3;
  bool row_ok[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = grp * 16 + (lane >> 2) + 8 * h;
    row_ok[h] = p < P && p / G < rows;
    qpos[h] = q_offset + row0 + p / G;
  }
  // the group's rows: all 16 pairs live, and the first row's causal frontier
  const int wp = grp * 16 + 15;
  const bool warp_full = wp < P && wp / G < rows;
  const int warp_qpos0 = q_offset + row0 + (grp * 16) / G;
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};
  const bf16* q_w = q_s + (grp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  // ldmatrix lane offsets: K (non-trans, two n8 key tiles x k16) and V (trans)
  const int k_lane = ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
  const int v_lane = ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;

  uint32_t qf[C::QREG ? KS : 1][4];
  if (C::QREG) {
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[C::QREG ? kk : 0], q_w + kk * 16);
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();                  // tile t has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; the other stage is free
    if (t + 1 < n_tiles)
      load_kv_tile<HD, NTH>(k, v, kv_base, (t + 1) * BK, Tk, KV, k_s + ((t + 1) & 1) * BK * LD,
                            v_s + ((t + 1) & 1) * BK * LD);
    cp_async_commit();
    const bf16* ks = k_s + ((t & 1) * BK + par * CH) * LD + k_lane;
    const bf16* vs = v_s + ((t & 1) * BK + par * CH) * LD + v_lane;
    const int k0 = t * BK + par * CH;

    // -- s = q . k over hd in k16 steps; step kk+1's fragments load before
    //    step kk's MMAs issue
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    uint32_t kf[2][NT / 2][4];
    uint32_t qs[2][4];
#pragma unroll
    for (int nj = 0; nj < NT / 2; ++nj) ldmatrix_x4(kf[0][nj], ks + nj * 16 * LD);
    if (!C::QREG) ldmatrix_x4(qs[0], q_w);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      if (kk + 1 < KS) {
#pragma unroll
        for (int nj = 0; nj < NT / 2; ++nj)
          ldmatrix_x4(kf[(kk + 1) & 1][nj], ks + nj * 16 * LD + (kk + 1) * 16);
        if (!C::QREG) ldmatrix_x4(qs[(kk + 1) & 1], q_w + (kk + 1) * 16);
      }
      const uint32_t(&a)[4] = C::QREG ? qf[C::QREG ? kk : 0] : qs[kk & 1];
#pragma unroll
      for (int nj = 0; nj < NT / 2; ++nj) {
        mma_bf16(s[2 * nj], a, kf[kk & 1][nj][0], kf[kk & 1][nj][1]);
        mma_bf16(s[2 * nj + 1], a, kf[kk & 1][nj][2], kf[kk & 1][nj][3]);
      }
    }

    // -- online softmax; the mask-free path when the warp sees the whole chunk
    const bool whole = warp_full && k0 + CH <= Tk && (!causal || k0 + CH - 1 <= warp_qpos0);
    if (whole)
      softmax_chunk<NT, DT, false>(s, o, m, l, row_ok, qpos, k0, t4, Tk, causal, d, rd);
    else
      softmax_chunk<NT, DT, true>(s, o, m, l, row_ok, qpos, k0, t4, Tk, causal, d, rd);

    // -- p = P_hi + P_lo in the A-fragment layout of the p.V MMA (k16 step
    //    kk covers n8 tiles 2kk and 2kk+1: a[0..3] = (row, tile) (g,2kk)
    //    (g+8,2kk) (g,2kk+1) (g+8,2kk+1))
    uint32_t ph[NT / 2][4], pl[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float e0 = s[j][2 * h], e1 = s[j][2 * h + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(e0, e1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(__fsub_rn(e0, __low2float(hi)),
                                                        __fsub_rn(e1, __high2float(hi)));
        ph[j / 2][(j & 1) * 2 + h] = bits(hi);
        pl[j / 2][(j & 1) * 2 + h] = bits(lo);
      }

    // -- acc += P_hi . V + P_lo . V over the chunk's keys in k16 steps, in
    //    order; each V fragment loads two steps before its MMAs
    constexpr int NV = (NT / 2) * (DT / 2);
    uint32_t vf[3][4];
    ldmatrix_x4_trans(vf[0], vs);
    ldmatrix_x4_trans(vf[1], vs + (1 / (DT / 2)) * 16 * LD + (1 % (DT / 2)) * 16);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (i + 2 < NV)
        ldmatrix_x4_trans(vf[(i + 2) % 3],
                          vs + ((i + 2) / (DT / 2)) * 16 * LD + ((i + 2) % (DT / 2)) * 16);
      const int kk = i / (DT / 2), dn = i % (DT / 2);
      const uint32_t(&bv)[4] = vf[i % 3];
      mma_bf16(o[2 * dn], ph[kk], bv[0], bv[1]);
      mma_bf16(o[2 * dn], pl[kk], bv[0], bv[1]);
      mma_bf16(o[2 * dn + 1], ph[kk], bv[2], bv[3]);
      mma_bf16(o[2 * dn + 1], pl[kk], bv[2], bv[3]);
    }
  }
  cp_async_wait_all();
  __syncthreads();                        // K/V stages are free: merge through them

  // -- the odd warp hands its (m, l, acc) to the even warp of its group, which
  //    merges the two states and writes out = acc / max(l, 1e-30) in bf16
  constexpr int NX = DT * 4 + 4;          // floats per lane
  float* x_s = reinterpret_cast<float*>(smem4) + grp * NX * 32 + lane;
  if (par == 1) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) x_s[(n * 4 + c) * 32] = o[n][c];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x_s[(DT * 4 + h) * 32] = m[h];
      x_s[(DT * 4 + 2 + h) * 32] = l[h];
    }
  }
  __syncthreads();
  if (par == 1) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mb = x_s[(DT * 4 + h) * 32], lb = x_s[(DT * 4 + 2 + h) * 32];
    const float mm = fmaxf(m[h], mb);
    const float ms = isfinite(mm) ? mm : 0.f;
    const float sa = isfinite(m[h]) ? expf(__fsub_rn(m[h], ms)) : 0.f;
    const float sb = isfinite(mb) ? expf(__fsub_rn(mb, ms)) : 0.f;
    const float denom = fmaxf(__fadd_rn(__fmul_rn(l[h], sa), __fmul_rn(lb, sb)), 1e-30f);
    if (!row_ok[h]) continue;
    const int p = grp * 16 + (lane >> 2) + 8 * h;
    const int r = p / G, g = p % G;
    bf16* o_row = out + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const float o0 = __fadd_rn(__fmul_rn(o[n][2 * h], sa),
                                 __fmul_rn(x_s[(n * 4 + 2 * h) * 32], sb));
      const float o1 = __fadd_rn(__fmul_rn(o[n][2 * h + 1], sa),
                                 __fmul_rn(x_s[(n * 4 + 2 * h + 1) * 32], sb));
      *reinterpret_cast<__nv_bfloat162*>(o_row + 8 * n) =
          __floats2bfloat162_rn(__fdiv_rn(o0, denom), __fdiv_rn(o1, denom));
    }
  }
}

template <int HD, int NG>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
               int H, int KV, int q_offset, int causal, cudaStream_t st) {
  using C = MmaTile<HD>;
  const int smem = (4 * C::BK + (C::QREG ? 0 : 16 * NG)) * C::LD * (int)sizeof(bf16);
  static_assert((MmaTile<HD>::DT * 4 + 4) * 32 * NG * 4 <=
                    (4 * MmaTile<HD>::BK) * MmaTile<HD>::LD * 2,
                "the merge fits in the K/V stages");
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(flash_prefill_mma_kernel<HD, NG>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int bq = 16 * NG / (H / KV);
  const long long blocks = (long long)((S + bq - 1) / bq) * KV * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_mma_kernel<HD, NG><<<(unsigned)blocks, NG * 64, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), B, S, Tk, H, KV, q_offset, causal);
  return (int)cudaGetLastError();
}

// Two pair groups (4 warps) a block; four when a kv-head has more than 32
// query heads, so a block holds at least one whole row.
template <int HD>
int launch_mma_ng(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                  int H, int KV, int q_offset, int causal, cudaStream_t st) {
  if (H / KV > 32) return launch_mma<HD, 4>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
  return launch_mma<HD, 2>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
}

int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int S, int Tk,
                int H, int KV, int hd, int q_offset, int causal, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_mma_ng<16>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 32: return launch_mma_ng<32>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 64: return launch_mma_ng<64>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 128: return launch_mma_ng<128>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    case 256: return launch_mma_ng<256>(q, k, v, out, B, S, Tk, H, KV, q_offset, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The score scaling of the bf16 kernel on n fp32 values (x / sqrt(hd)), so a
// test can hold it to a division on the card.
extern "C" int flash_prefill_scale_check(const float* x, float* out, long long n, int hd,
                                         void* stream) {
  if (n <= 0) return 0;
  scale_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, hd);
  return (int)cudaGetLastError();
}

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
    return launch_bf16(q, k, v, out, B, S, Tk, H, KV, hd, q_offset, causal, st);
  return (int)cudaErrorInvalidValue;
}
