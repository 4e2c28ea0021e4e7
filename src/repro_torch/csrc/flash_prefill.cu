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
// 3.35 TB/s); in fp32 it is 138 us at the 67 TFLOP/s of plain FMA.
//
// Two kernels, chosen by dtype (a design choice, not a fallback):
//
// float32 -- flash_prefill_fp32_kernel<HD, NW>, plain fp32 FMA (TF32 would
// break the fp32 tolerance), NW warps a block. Each warp owns WP (row, head)
// pairs of one kv-head (16, or 8 at hd 256) for the whole key sweep, so
// every reduction of a row stays inside its warp: lane (pg, kg) = (lane / 8,
// lane % 8) holds pairs pg + 4a (a < TM = WP / 4) and, in the softmax, keys
// kg + 8c of each key tile. What bounds an FMA kernel on Hopper is shared
// memory: it delivers one 4-byte value a lane per cycle to the SM's 128 FMA
// lanes, whatever the broadcast, so a lane must do 4 FMAs per value it loads.
// So q lives in registers: lane (pg, kg) holds its TM pairs' q at the hd/8
// dims kg*DV + 8*DV*cv + e, loads only those dims of each key (TM FMAs per
// value), and a reduce-scatter over the 8 dim lanes (three fixed xor
// shuffles) leaves it with whole dot products for its keys, eight keys at a
// time (one chunk's partial sums in registers; the scores wait in a
// warp-private shared-memory buffer). p.V runs on the same lane for the same
// pairs over the same hd/8 dims (TM p values and hd/8 v values a key; p goes
// through the same buffer, __syncwarp only), so the rescale by each pair's m
// stays in registers. Row
// max and sum reduce over the 8 key lanes by three fixed xor shuffles. K/V
// tiles of BK keys (64 at hd <= 64, 32 at 128, 16 at 256) are
// double-buffered in shared memory by cp.async 16-byte copies: tile t+1 is
// in flight while tile t computes, one __syncthreads a tile. The division
// by sqrt(hd) is div_sqrt_hd (equal to div.rn).
//
// Keys are split into runs of kKeysPerSplit = 512 counted from key 0, one
// block per (query tile, split, kv-head, batch), so the short suffix and the
// hd-256 shapes fill the card and no block runs the whole causal triangle.
// A tile whose rows need one split writes out directly; otherwise each
// split writes its unnormalised (acc, m, l) to a workspace, takes a ticket,
// and the last block of the tile combines each row's splits in split order
// (M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s l_s,
// 1e-30); with one split that is acc_0 / max(l_0, 1e-30) bit for bit) and
// resets the ticket for the next call on the stream. The query tile (NW,
// so the pairs a block holds) is the caller's launch plan (ops.py).
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
// same arithmetic whatever its place in its block or the block's size --
// the dot products run over hd in order (fp32: over each dim lane's dims in
// order, then a fixed tree over the 8 dim lanes), the row reductions follow key
// positions inside the tile (chunk) in a fixed order, p.V runs over the keys
// in order, and the key tiles, the fp32 splits with their combine and the
// bf16 even/odd chunks with their merge are fixed from key 0. A tile that
// is wholly masked for a row leaves its m unchanged (max with finfo.min),
// gives scale = exp(0) = 1 and p = 0, so it adds exactly 0 (acc is never
// -0). Row q_offset + i of a suffix call is therefore bit-identical to the
// same row of the cold call over the whole sequence, which keeps chunked and
// prefix-reuse prefill equal to monolithic prefill.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// Shared helpers
// ---------------------------------------------------------------------------
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

// ---------------------------------------------------------------------------
// float32: FMA micro-tiles, key splits
// ---------------------------------------------------------------------------
constexpr int kKeysPerSplit = 512;     // a constant: rows stay bit-identical

template <int HD>
struct Fp32Tile {
  static constexpr int WP = HD <= 128 ? 16 : 8;                    // pairs per warp
  static constexpr int TM = WP / 4;                                // pairs per lane
  static constexpr int BK = HD <= 64 ? 64 : (HD == 128 ? 32 : 16); // keys per tile
  static constexpr int TN = BK / 8;                                // keys per lane
  static constexpr int DV = HD >= 32 ? 4 : 2;   // vector width of a lane's dims
  static constexpr int NDV = HD / (8 * DV);     // vectors of a lane's hd/8 dims
  static constexpr int CPR = HD / 4;            // 16-byte chunks per row
  static constexpr int PF = HD + 4;             // workspace floats per pair: acc, m, l, pad
  static_assert(kKeysPerSplit % BK == 0 && NDV >= 1, "fp32 tiling");
  // K and V stages, and each warp's BK x WP buffer of scores and p
  static int smem_bytes(int nw) {
    return 4 * (2 * BK * 2 * HD + nw * BK * WP);
  }
};

template <int N> struct FVec;
template <> struct FVec<2> {
  __device__ static void load(const float* p, float* o) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
  __device__ static void store(float* p, const float* o) {
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  }
};
template <> struct FVec<4> {
  __device__ static void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  __device__ static void store(float* p, const float* o) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

// Stage BK rows of K and V (keys k0.. of kv-head kh) into one stage; keys at
// or past Tk become zeros.
template <int HD, int NTH>
__device__ __forceinline__ void load_kv_tile_f32(const float* __restrict__ k,
                                                 const float* __restrict__ v, long long base,
                                                 int k0, int Tk, int KV, float* k_s, float* v_s) {
  using C = Fp32Tile<HD>;
  for (int idx = threadIdx.x; idx < C::BK * C::CPR; idx += NTH) {
    const int r = idx / C::CPR, c = idx % C::CPR;
    const bool ok = k0 + r < Tk;
    const long long off = ok ? base + (long long)(k0 + r) * KV * HD + c * 4 : 0;
    cp_async16(k_s + r * HD + c * 4, k + off, ok);
    cp_async16(v_s + r * HD + c * 4, v + off, ok);
  }
}

// Eight partial sums on each of the 8 lanes kg of a lane group, slot j of
// lane kg holding key j ^ kg -> the sum over the group of key kg, on lane kg.
// Each step keeps the lower half of the slots (the keys that share the
// lane's bit) and adds the partner's upper half, which holds the same keys,
// to its own: a fixed tree per key, whatever the lane group, and no selects.
__device__ __forceinline__ float reduce_scatter8(const float (&x)[8]) {
  float h4[4], h2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) h4[i] = __fadd_rn(x[i], __shfl_xor_sync(0xffffffffu, x[4 + i], 4));
#pragma unroll
  for (int i = 0; i < 2; ++i) h2[i] = __fadd_rn(h4[i], __shfl_xor_sync(0xffffffffu, h4[2 + i], 2));
  return __fadd_rn(h2[0], __shfl_xor_sync(0xffffffffu, h2[1], 1));
}

// Online-softmax update of one key tile on a lane's TM x TN scores (pair
// pg + 4a, key k0 + kg + 8c). MASK = false for a tile that every pair of the
// warp sees whole -- the same arithmetic with every key valid. Leaves p in s
// and each pair's rescale of the previous state in sc.
template <int TM, int TN, bool MASK>
__device__ __forceinline__ void softmax_tile_f32(float (&s)[TM][TN], float (&m)[TM],
                                                 float (&l)[TM], float (&sc)[TM],
                                                 const bool (&pair_ok)[TM],
                                                 const int (&qpos)[TM], int k0, int kg, int Tk,
                                                 int causal, float d, float r) {
  const float neg_inf = -FLT_MAX;
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    float mx = neg_inf;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int key = k0 + kg + 8 * c;
      const bool ok = !MASK || (pair_ok[a] && key < Tk && (!causal || key <= qpos[a]));
      const float x = ok ? div_sqrt_hd(s[a][c], d, r) : neg_inf;
      s[a][c] = x;
      mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_new = fmaxf(m[a], mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int key = k0 + kg + 8 * c;
      const bool ok = !MASK || (pair_ok[a] && key < Tk && (!causal || key <= qpos[a]));
      const float e = ok ? expf(__fsub_rn(s[a][c], m_safe)) : 0.f;
      s[a][c] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 4));
    const float scale = isfinite(m[a]) ? expf(__fsub_rn(m[a], m_safe)) : 0.f;
    l[a] = __fadd_rn(__fmul_rn(l[a], scale), sum);
    m[a] = m_new;
    sc[a] = scale;
  }
}

// One block: NW warps of WP pairs each (pair p = r * G + g is q row row0 + r,
// head kh * G + g), one run of keys [sp * kKeysPerSplit, ...) of one
// kv-head. The 1-D grid is (query tile, split, kv-head, batch), query tile
// slowest, the longest tiles first.
// (NW * 32, 1): without the minimum of one block ptxas holds the hd-16
// instantiation to 128 registers and spills.
template <int HD, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
flash_prefill_fp32_kernel(const float* __restrict__ q,     // (B, S, H, HD)
                          const float* __restrict__ k,     // (B, T, KV, HD)
                          const float* __restrict__ v,     // (B, T, KV, HD)
                          float* __restrict__ out,         // (B, S, H, HD)
                          float* __restrict__ part,        // (tiles, ns_max, MP, PF)
                          int* __restrict__ tickets,       // (tiles), zero between calls
                          int B, int S, int Tk, int H, int KV, int q_offset, int causal,
                          int nq, int ns_max) {
  using C = Fp32Tile<HD>;
  constexpr int WP = C::WP, TM = C::TM, BK = C::BK, TN = C::TN;
  constexpr int DV = C::DV, NDV = C::NDV, CPR = C::CPR, PF = C::PF;
  constexpr int MP = NW * WP, NTH = NW * 32;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);     // 2 stages x BK x HD
  float* v_s = k_s + 2 * BK * HD;                   // 2 stages x BK x HD
  float* p_s = v_s + 2 * BK * HD;                   // NW x BK x WP
  __shared__ int last_block;

  const int G = H / KV;
  const int BQ = MP / G;                            // query rows per block
  const int P = BQ * G;                             // live pairs
  const int per_tile = ns_max * KV * B;
  const int qt = nq - 1 - (int)(blockIdx.x / per_tile);
  const int rem = (int)(blockIdx.x % per_tile);
  const int sp = rem / (KV * B);
  const int kh = rem % KV;
  const int b = (rem / KV) % B;
  const int row0 = qt * BQ;
  const int rows = min(BQ, S - row0);
  const int last_pos = q_offset + row0 + rows - 1;
  const int ns_tile = causal ? min(ns_max, last_pos / kKeysPerSplit + 1) : ns_max;
  if (sp >= ns_tile) return;                        // no row of the tile reaches this split
  const int k_begin = sp * kKeysPerSplit;
  int k_end = min(Tk, k_begin + kKeysPerSplit);
  if (causal) k_end = min(k_end, last_pos + 1);     // causal skip
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // -- the first K/V tile
  const long long kv_base = (long long)b * Tk * KV * HD + (long long)kh * HD;
  load_kv_tile_f32<HD, NTH>(k, v, kv_base, k_begin, Tk, KV, k_s, v_s);
  cp_async_commit();

  // this lane's pairs (pg + 4a of the warp's WP) and key / dim lanes
  const int pg = lane >> 3, kg = lane & 7;
  const int wp0 = warp * WP;
  bool pair_ok[TM];
  int qpos[TM];
  // q of this lane's pairs at its hd/8 dims kg*DV + 8*DV*cv + e, in registers
  float qr[TM][NDV * DV];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int p = wp0 + pg + 4 * a, r = p / G, g = p % G;
    pair_ok[a] = p < P && r < rows;
    qpos[a] = q_offset + row0 + r;
    const float* qp = q + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + kg * DV;
#pragma unroll
    for (int cv = 0; cv < NDV; ++cv) {
      float x[DV] = {};
      if (pair_ok[a]) FVec<DV>::load(qp + 8 * DV * cv, x);
#pragma unroll
      for (int e = 0; e < DV; ++e) qr[a][cv * DV + e] = x[e];
    }
  }
  const int w_end = min(min(wp0 + WP, P), rows * G);    // one past the warp's last live pair
  const bool warp_live = w_end > wp0;
  const bool warp_full = w_end == wp0 + WP;
  const int w_first_pos = q_offset + row0 + wp0 / G;
  const int w_last_pos = q_offset + row0 + (w_end - 1) / G;
  float m[TM], l[TM], acc[TM][NDV * DV];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    m[a] = -FLT_MAX;
    l[a] = 0.f;
#pragma unroll
    for (int e = 0; e < NDV * DV; ++e) acc[a][e] = 0.f;
  }
  const float d = __fsqrt_rn((float)HD);
  const float rd = __frcp_rn(d);
  // the warp's scores, then p, key-major: key j of pair pg + 4a at
  // p_w[j * WP + pg * TM + a]
  float* p_w = p_s + warp * BK * WP;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait_all();                  // tile t has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; the other stage is free
    if (t + 1 < n_tiles)
      load_kv_tile_f32<HD, NTH>(k, v, kv_base, k_begin + (t + 1) * BK, Tk, KV,
                                k_s + ((t + 1) & 1) * BK * HD, v_s + ((t + 1) & 1) * BK * HD);
    cp_async_commit();
    const int k0 = k_begin + t * BK;
    if (!warp_live || (causal && k0 > w_last_pos)) continue;   // adds exactly 0
    const float* ks = k_s + (t & 1) * BK * HD;
    const float* vs = v_s + (t & 1) * BK * HD;

    // -- scores, 8 keys at a time: each lane sums q.k over its hd/8 dims in
    //    order (one chain per (pair, key); slot j holds key 8c + (j ^ kg)),
    //    then a reduce-scatter over the 8 dim lanes (xor 4, 2, 1) leaves lane
    //    kg with the whole dot products of key 8c + kg, which it parks in p_w
    //    (one chunk in registers at a time)
#pragma unroll 1
    for (int c = 0; c < TN; ++c) {
      float x[TM][8];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int j = 0; j < 8; ++j) x[a][j] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* kr = ks + (8 * c + (j ^ kg)) * HD + kg * DV;
#pragma unroll
        for (int cv = 0; cv < NDV; ++cv) {
          float kv[DV];
          FVec<DV>::load(kr + 8 * DV * cv, kv);
#pragma unroll
          for (int a = 0; a < TM; ++a)
#pragma unroll
            for (int e = 0; e < DV; ++e) x[a][j] = fmaf(qr[a][cv * DV + e], kv[e], x[a][j]);
        }
      }
      float sx[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) sx[a] = reduce_scatter8(x[a]);
      FVec<TM>::store(p_w + (8 * c + kg) * WP + pg * TM, sx);
    }
    float s[TM][TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      float sx[TM];
      FVec<TM>::load(p_w + (8 * c + kg) * WP + pg * TM, sx);
#pragma unroll
      for (int a = 0; a < TM; ++a) s[a][c] = sx[a];
    }

    // -- online softmax in registers; the mask-free path for a whole tile
    float sc[TM];
    const bool whole = warp_full && k0 + BK <= Tk && (!causal || k0 + BK - 1 <= w_first_pos);
    if (whole)
      softmax_tile_f32<TM, TN, false>(s, m, l, sc, pair_ok, qpos, k0, kg, Tk, causal, d, rd);
    else
      softmax_tile_f32<TM, TN, true>(s, m, l, sc, pair_ok, qpos, k0, kg, Tk, causal, d, rd);
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int e = 0; e < NDV * DV; ++e) acc[a][e] = __fmul_rn(acc[a][e], sc[a]);

    // -- acc += p . V over the tile's keys in order, p through the warp's
    //    buffer (the lane's own slots, then every lane's)
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      float pv[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) pv[a] = s[a][c];
      FVec<TM>::store(p_w + (8 * c + kg) * WP + pg * TM, pv);
    }
    __syncwarp();
    const float* vk = vs + kg * DV;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[TM];
      FVec<TM>::load(p_w + j * WP + pg * TM, pv);
#pragma unroll
      for (int cv = 0; cv < NDV; ++cv) {
        float vv[DV];
        FVec<DV>::load(vk + j * HD + 8 * DV * cv, vv);
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int e = 0; e < DV; ++e)
            acc[a][cv * DV + e] = fmaf(pv[a], vv[e], acc[a][cv * DV + e]);
      }
    }
    __syncwarp();
  }

  // -- one split: out = acc / max(l, 1e-30) in place
  if (ns_tile == 1) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      if (!pair_ok[a]) continue;
      const int p = wp0 + pg + 4 * a, r = p / G, g = p % G;
      const float denom = fmaxf(l[a], 1e-30f);
      float* o = out + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + kg * DV;
#pragma unroll
      for (int cv = 0; cv < NDV; ++cv) {
        float x[DV];
#pragma unroll
        for (int e = 0; e < DV; ++e) x[e] = __fdiv_rn(acc[a][cv * DV + e], denom);
        FVec<DV>::store(o + 8 * DV * cv, x);
      }
    }
    return;
  }

  // -- several splits: this split's partial, then a ticket; the last block
  //    of the tile combines every row's splits in split order
  const int tile = (b * KV + kh) * nq + qt;
  float* pt = part + (long long)tile * ns_max * MP * PF;
  const long long ss = (long long)MP * PF;            // split stride
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    if (!pair_ok[a]) continue;
    float* pp = pt + sp * ss + (wp0 + pg + 4 * a) * PF;
#pragma unroll
    for (int cv = 0; cv < NDV; ++cv) {
      float x[DV];
#pragma unroll
      for (int e = 0; e < DV; ++e) x[e] = acc[a][cv * DV + e];
      FVec<DV>::store(pp + kg * DV + 8 * DV * cv, x);
    }
    if (kg == 0) {
      pp[HD] = m[a];
      pp[HD + 1] = l[a];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + tile, 1) == ns_tile - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int idx = tid; idx < MP * CPR; idx += NTH) {
    const int p = idx / CPR, c4 = (idx % CPR) * 4;
    const int r = p / G, g = p % G;
    if (p >= P || r >= rows) continue;
    const int pos = q_offset + row0 + r;
    const int nr = causal ? min(ns_max, pos / kKeysPerSplit + 1) : ns_max;
    const float* pp = pt + p * PF;
    // four splits' loads at a time, summed in split order
    float mx = -FLT_MAX;
    for (int s0 = 0; s0 < nr; s0 += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < nr) mx = fmaxf(mx, __ldcg(pp + (s0 + u) * ss + HD));
    }
    const float ms = isfinite(mx) ? mx : 0.f;
    float lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < nr; s0 += 4) {
      float m_s[4], l_s[4];
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u >= nr) continue;
        const float* ps = pp + (s0 + u) * ss;
        m_s[u] = __ldcg(ps + HD);
        l_s[u] = __ldcg(ps + HD + 1);
        x[u] = __ldcg(reinterpret_cast<const float4*>(ps + c4));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (s0 + u >= nr) continue;
        const float w = isfinite(m_s[u]) ? expf(__fsub_rn(m_s[u], ms)) : 0.f;
        const float xs[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
        if (s0 + u == 0) {
          lsum = __fmul_rn(l_s[u], w);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = __fmul_rn(xs[e], w);
        } else {
          lsum = __fadd_rn(lsum, __fmul_rn(l_s[u], w));
#pragma unroll
          for (int e = 0; e < 4; ++e) o[e] = __fadd_rn(o[e], __fmul_rn(xs[e], w));
        }
      }
    }
    const float denom = fmaxf(lsum, 1e-30f);
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) y[e] = __fdiv_rn(o[e], denom);
    FVec<4>::store(out + (((long long)b * S + row0 + r) * H + kh * G + g) * HD + c4, y);
  }
  if (tid == 0) tickets[tile] = 0;
}

template <int HD, int NW>
int launch_fp32(const void* q, const void* k, const void* v, void* out, float* part,
                int* tickets, int B, int S, int Tk, int H, int KV, int q_offset, int causal,
                int nq, int ns_max, cudaStream_t st) {
  const int smem = Fp32Tile<HD>::smem_bytes(NW);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  // the kernel's own 16 bytes of static shared memory count against the
  // default 48 KiB too, so the limit is always raised to what it needs
  cudaFuncSetAttribute(flash_prefill_fp32_kernel<HD, NW>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const long long blocks = (long long)nq * ns_max * KV * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_fp32_kernel<HD, NW><<<(unsigned)blocks, NW * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), part, tickets, B, S, Tk, H, KV, q_offset, causal, nq, ns_max);
  return (int)cudaGetLastError();
}

// nw warps a block, from the caller's launch plan; the block must hold a
// whole row (nw * WP >= G), and nq / ns_max must be this tiling's.
template <int HD>
int launch_fp32_nw(const void* q, const void* k, const void* v, void* out, float* part,
                   int* tickets, int B, int S, int Tk, int H, int KV, int q_offset, int causal,
                   int nw, int nq, int ns_max, cudaStream_t st) {
  const int mp = nw * Fp32Tile<HD>::WP, G = H / KV;
  if (mp < G) return (int)cudaErrorInvalidValue;
  const int bq = mp / G;
  if (nq != (S + bq - 1) / bq || ns_max != (Tk + kKeysPerSplit - 1) / kKeysPerSplit)
    return (int)cudaErrorInvalidValue;
  if (ns_max > 1 && (part == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
#define K4_FP32(NW_)                                                                        \
  return launch_fp32<HD, NW_>(q, k, v, out, part, tickets, B, S, Tk, H, KV, q_offset, causal, \
                              nq, ns_max, st)
  switch (nw) {
    case 1: K4_FP32(1);
    case 2: K4_FP32(2);
    case 4: K4_FP32(4);
    case 8:
      if constexpr (HD == 256) { K4_FP32(8); }
      return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_FP32
}

int launch_f32(const void* q, const void* k, const void* v, void* out, float* part,
               int* tickets, int B, int S, int Tk, int H, int KV, int hd, int q_offset,
               int causal, int nw, int nq, int ns_max, cudaStream_t st) {
#define K4_HD(HD_)                                                                           \
  return launch_fp32_nw<HD_>(q, k, v, out, part, tickets, B, S, Tk, H, KV, q_offset, causal, \
                             nw, nq, ns_max, st)
  switch (hd) {
    case 16: K4_HD(16);
    case 32: K4_HD(32);
    case 64: K4_HD(64);
    case 128: K4_HD(128);
    case 256: K4_HD(256);
    default: return (int)cudaErrorInvalidValue;
  }
#undef K4_HD
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

// The score scaling of both kernels on n fp32 values (x / sqrt(hd)), so a
// test can hold it to a division on the card.
extern "C" int flash_prefill_scale_check(const float* x, float* out, long long n, int hd,
                                         void* stream) {
  if (n <= 0) return 0;
  scale_check_kernel<<<1024, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out, n, hd);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it). Tk = S + q_offset.
// float32 only: nw warps a block, nq query tiles and ns_max key splits (the
// caller's launch plan, checked here), part the splits' workspace (nq * KV *
// B * ns_max * nw * WP * (hd + 4) floats, unused when ns_max == 1) and
// tickets nq * KV * B int32 counters, zero before the call and left zero
// after it (calls that share them must be ordered on one stream).
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                    int B, int S, int Tk, int H, int KV, int hd,
                                    int q_offset, int causal, int dtype, int nw, int nq,
                                    int ns_max, float* part, int* tickets, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > 64 || q_offset < 0 || Tk != S + q_offset ||
      (!causal && q_offset != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_f32(q, k, v, out, part, tickets, B, S, Tk, H, KV, hd, q_offset, causal, nw, nq,
                      ns_max, st);
  if (dtype == 1)
    return launch_bf16(q, k, v, out, B, S, Tk, H, KV, hd, q_offset, causal, st);
  return (int)cudaErrorInvalidValue;
}
