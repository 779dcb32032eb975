// C-query chunk attention over the budgeted KV ring buffer, with the
// per-slot eviction statistics.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/chunk_attention.py
// `fused_chunk_attend`: its 1-pass `_onepass_kernel` (whole logits block in
// VMEM) and its 2-pass `_flash_kernel` + `_score_kernel` compute one
// function, and this file computes it once, for a float or an int8 cache
// (per-slot dequant scales folded into the logits and into p.V, never a
// dequantized copy), with or without the statistics, with an optional
// sliding window.
//
// For each (batch, kv-head) and each query row r = (rep head i, chunk query
// c), with pos the slot's token position and qp = q_pos[c] (-1: padding):
//   logit[r][s] = (q_r . k_s) * D^-1/2 (* k_scale[s]), masked unless
//                 0 <= pos[s] <= qp (and pos[s] > qp - window);
//   p[r][s]     = masked ? 0 : exp(logit - m_r) / max(l_r, 1e-30);
//   out[r]      = sum_s p[r][s] (* v_scale[s]) v_s;
//   with scores: p_kv[c][s] = mean_i p[(i, c)][s]; ssum[s] = sum_c p_kv,
//   ssq[s] = sum_c p_kv^2, last[s] = p_kv[C-1][s].
// A padding row sees no slot: m stays -1e30, l and the accumulator 0, and
// its out is 0 / 1e-30 = exactly 0 (e is zeroed explicitly, never left to
// exp underflow).
//
// What bounds it on an H100: at the main path's shapes (int8 cache, C=128,
// LLaMa-2-7B MHA, 512 of 768 slots visible in the last prompt chunk) the
// launch reads 4.2 MB of int8 K/V rows and does 1.07 GFLOP: 1.3 us of bytes
// at 3.35 TB/s against 1.1 us of bf16 tensor-core work; at the strided
// encode's (C=96, 2176 of 2304 slots) 18 MB and 3.4 GFLOP. Both products
// run on the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate):
//   * QK^T: q and the K rows are bf16 in shared memory (an int8 row's
//     values are exact in bf16), so every product is exact and the logits
//     differ from the plain version's only in the order of their f32 sums;
//   * PV: p (times v_scale) enters as a bf16 pair, hi + lo, about 16 bits;
//   * an f32 q or cache is split in the kernel into three bf16 limbs whose
//     sum is the value exactly; the products of limbs i, j with i + j <= 2
//     are kept (the others lie below an f32 ulp), and p is split into three;
//     each k-step's limb products are summed apart and added to the f32
//     accumulator with round-to-nearest (mma_limbs), since the tensor
//     cores' own accumulation truncates.
// The attention launch: one block (4 warps, 16 query rows a warp) per
// (batch, kv-head, 64 consecutive rows of the head's rep * C rows, run of
// slot tiles). A block walks its run of 64-slot tiles with an online
// softmax, skipping every tile that no row of it can see; while a tile's
// products run, cp.async brings the next tile's K and V rows (raw: int8,
// bf16 or f32) into shared memory, and the block turns them into the bf16
// planes when it gets there. The runs split S so that about two blocks per
// SM are in flight (the wrapper's plan). An f32 q takes one run and walks it
// three times, rounding each entry as the plain version does: each row's
// max, then l = sum of exp(logit - max), then p = exp(logit - max) / l and
// (p * v_scale) . v; its errors then follow the plain version's, which an
// int8 cache's requantization of the next layer would otherwise amplify
// into other victims. With one run a block writes out
// (and each row's final m and l for the statistics); with several, each
// writes its partial (acc, m, l) and a combine launch adds them in run
// order: the result is the same in every run. The statistics launch: one
// block (8 warps) per (batch, kv-head, run of 64-slot tiles); per tile it
// loads the K rows once and takes the chunk's query tiles in turn, 128 rows
// each (every rep head of its queries, so the GQA mean stays in the block;
// one tile for an MHA chunk of up to 128 queries, loaded once for the whole
// run): the logits again on the tensor cores, exact p from the row's final
// m and l, the GQA mean, and the tile's sums, a quarter of the queries per
// thread and the quarters added in order. Each block owns its slots:
// deterministic, no atomics.
//
// K6, the strided encode's chunk write + attend: `chunk_write_attend`
// replaces the TPU kernel `fused_chunk_write_attend` (its 1-pass
// `_wa_kernel`, its S-tiled `_wa_flash_kernel` and the `_score_kernel`
// second pass): it writes the chunk's C rows per kv-head into caller-given
// slots, then computes K5's function over the UPDATED cache. On the TPU the
// fusion saves a whole-block HBM round trip (a Pallas block is copied in and
// out whole); here the cache is updated in place and the write touches only
// C rows per head, so one C call launches a row-write kernel and then K5's
// launches on the same stream, which are the code K5 already holds to its
// plain version. The row write is one warp per (batch, kv-head, chunk row,
// K or V): an int8 cache gets the row quantized in the kernel, bit-exact with
// quantize_kv (scale = fmaxf(amax, 1e-8) * f32(1/127), values divided by it
// with IEEE division, rounded half to even, clipped to +-127), and its
// scale; a float cache gets the row as it is. The K warp also writes the
// slot's sidecars: pos = q_pos, counter = counter_init exactly (negative
// initial counters too: the TPU kernel's max-based pick clamps them to 0,
// the XLA path and this kernel do not), score = score_sq = 0. Its bytes (C
// rows per head) are ~1/20 of the attention's at the encode shapes; the
// attention half bounds the call.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kAT = 128;        // threads of an attention block: 4 warps
constexpr int kQT = 64;         // query rows of an attention block, 16 a warp
constexpr int kSTh = 256;       // threads of a statistics block: 8 warps
constexpr int kSQ = 128;        // query rows of a statistics tile, 16 a warp
constexpr int kTS = 64;         // slots of a tile
constexpr int kPP = kTS + 1;    // f32 between rows of the statistics' p tile
constexpr int kCombineRows = 4; // rows of a combine block, one a warp
constexpr int kStatsBlocks = 2 * 132;   // statistics blocks to aim at: two an SM of an H100
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ bool sees(int p, int qp, int window) {
  return p >= 0 && p <= qp && (window <= 0 || p > qp - window);
}
// whether some query with a position in [qmin, qmax] may see a slot at p
__device__ __forceinline__ bool seen(int p, int qmax, int qmin, int window) {
  return p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
}

// the four lanes of a quad hold one row's values
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename QT, typename KT, int D>
struct Cfg {
  static constexpr int kQL = std::is_same<QT, float>::value ? 3 : 1;   // bf16 limbs of q
  static constexpr int kKL = std::is_same<KT, float>::value ? 3 : 1;   // of K and V
  static constexpr int kPL = std::is_same<QT, float>::value ? 3 : 2;   // of p
  static constexpr bool kExact = std::is_same<QT, float>::value;        // f32 out: mma_limbs
  static constexpr int RS = D + 8;     // bf16 between rows: ldmatrix rows on distinct banks
  static constexpr size_t kQPlane = (size_t)kQT * RS * 2;
  static constexpr size_t kSPlane = (size_t)kSQ * RS * 2;
  static constexpr size_t kKPlane = (size_t)kTS * RS * 2;
  static constexpr size_t kRaw = (size_t)kTS * D * sizeof(KT);   // a tile's K (or V) rows
  // attention: q, K and V planes; the next tile's raw K and V rows; pos,
  // k_scale, v_scale of two tiles; qp of the rows
  static constexpr size_t attend_bytes() {
    return kQL * kQPlane + 2 * kKL * kKPlane + 2 * kRaw + (6 * kTS + kQT) * 4;
  }
  // statistics: q and K planes, the p tile; pos, k_scale; qp, m, l of the rows
  static constexpr size_t stats_bytes() {
    return kQL * kSPlane + kKL * kKPlane + (size_t)kSQ * kPP * 4 + (2 * kTS + 3 * kSQ) * 4;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// 16 bytes from global to shared, the first `bytes` of them read, the rest 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += the products A_i B_j of the limb pairs i + j <= 2 (B_j's fragment at
// b[j] + boff). In f32 (kExact: an f32 q, or an f32 cache) they go, the
// smallest first, into a zeroed tile that is then added to d with
// round-to-nearest: the tensor cores truncate each MMA's sum to d's
// precision, so small limbs added straight into a large d would lose their
// bits, an ulp or so every MMA. A bf16 result takes them straight into d.
template <bool kExact, int NA, int NB>
__device__ __forceinline__ void mma_limbs(float (&d)[4], const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][4], int boff) {
  if constexpr (!kExact) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        if (i + j <= 2) mma(d, a[i], &b[j][boff]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sum = 2; sum >= 0; --sum)
#pragma unroll
      for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          if (i + j == sum) mma(t, a[i], &b[j][boff]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 as L bf16x2 limbs (limb k of both in w[k]); with L = 3 their sum
// is the pair exactly.
template <int L>
__device__ __forceinline__ void split(float a, float b, uint32_t* w) {
#pragma unroll
  for (int k = 0; k < L; ++k) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    w[k] = pack_bf16(ha, hb);
    a -= __bfloat162float(ha);
    b -= __bfloat162float(hb);
  }
}

// 16 bytes of a row at src (16-byte aligned) as bf16 limb planes: element e
// of the segment to planes[k][e] (planes `stride` bf16 apart), or zeros.
__device__ __forceinline__ void put16(const __nv_bfloat16* src, __nv_bfloat16* dst, size_t,
                                      bool ld) {
  *reinterpret_cast<uint4*>(dst) = ld ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
}
__device__ __forceinline__ void put16(const float* src, __nv_bfloat16* dst, size_t stride,
                                      bool ld) {
  const float4 v = ld ? *reinterpret_cast<const float4*>(src) : make_float4(0.f, 0.f, 0.f, 0.f);
  uint32_t a[3], b[3];
  split<3>(v.x, v.y, a);
  split<3>(v.z, v.w, b);
#pragma unroll
  for (int k = 0; k < 3; ++k) *reinterpret_cast<uint2*>(dst + k * stride) = make_uint2(a[k], b[k]);
}
// an int8 byte (sign bit flipped in x) as f32: 2^23 + (v + 128) - (2^23 + 128)
__device__ __forceinline__ float byte_value(uint32_t x, int j) {
  return __int_as_float((int)__byte_perm(x, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}
// two integer-valued f32 (|v| <= 128) as bf16x2: their top halves, exact
__device__ __forceinline__ uint32_t pack_top(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ void put16(const int8_t* src, __nv_bfloat16* dst, size_t, bool ld) {
  const uint4 v = ld ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_top(byte_value(w[i], 0), byte_value(w[i], 1));
    o[2 * i + 1] = pack_top(byte_value(w[i], 2), byte_value(w[i], 3));
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(o[0], o[1], o[2], o[3]);
  d[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

template <typename QT, typename KT>
struct Args {
  const QT* q;
  const KT* k;
  const KT* v;
  const int* pos;
  const int* q_pos;
  const float* k_scale;
  const float* v_scale;
  QT* out;
  float* ssum;
  float* ssq;
  float* last;
  float* ml;      // (B, Hq, C, 2) each row's final m and l, or null
  float* part;    // (nsplit, B Hq C, D + 2) the runs' partials, or null
  int Hkv, rep, C, S, nsplit;
  float scale;
  int window;
  int spb;        // slot tiles a statistics block walks
};

// The logits of the warp's 16 rows against the tile's 64 slots (q and K
// from their planes), scaled and masked: row g of the warp in s[j][0..1],
// row g + 8 in s[j][2..3], slots 8 j + 2q, 8 j + 2q + 1; a masked entry is
// -inf.
template <typename QT, typename KT, int D, int QROWS>
__device__ __forceinline__ void tile_logits(const Args<QT, KT>& a, const __nv_bfloat16* qpl,
                                            const __nv_bfloat16* kpl, const int* pos,
                                            const float* ksc, int s0, int qp_a, int qp_b,
                                            float (&s)[8][4]) {
  using C = Cfg<QT, KT, D>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[C::kQL][4];
#pragma unroll
    for (int l = 0; l < C::kQL; ++l)
      ldsm_x4(af[l], qpl + l * (QROWS * C::RS) + (warp * 16 + (lane & 15)) * C::RS + kk * 16 +
                         (lane >> 4) * 8);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t bf[C::kKL][4];
#pragma unroll
      for (int l = 0; l < C::kKL; ++l)
        ldsm_x4(bf[l], kpl + l * (C::kKPlane / 2) +
                           (jj * 16 + (lane & 7) + (lane >> 4) * 8) * C::RS + kk * 16 +
                           ((lane >> 3) & 1) * 8);
      mma_limbs<C::kExact>(s[2 * jj], af, bf, 0);
      mma_limbs<C::kExact>(s[2 * jj + 1], af, bf, 2);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int sl = 8 * j + 2 * q + (e & 1);
      float x = s[j][e] * a.scale;
      if (std::is_same<KT, int8_t>::value) x *= ksc[sl];
      s[j][e] = (s0 + sl < a.S && sees(pos[sl], e < 2 ? qp_a : qp_b, a.window)) ? x : -INFINITY;
    }
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The positions (and scales; vsc may be null) of the tile at s0 into pos,
// ksc, vsc; true for a thread tid < kTS whose slot some row in [qmin, qmax]
// may see.
template <typename QT, typename KT>
__device__ __forceinline__ bool load_meta(const Args<QT, KT>& a, size_t kv0, int s0, int qmax,
                                          int qmin, int* pos, float* ksc, float* vsc) {
  const int tid = threadIdx.x;
  if (tid >= kTS) return false;
  const int s = s0 + tid;
  const int p = s < a.S ? a.pos[kv0 + s] : -1;
  pos[tid] = p;
  if (std::is_same<KT, int8_t>::value) {
    ksc[tid] = s < a.S ? a.k_scale[kv0 + s] : 0.f;
    if (vsc != nullptr) vsc[tid] = s < a.S ? a.v_scale[kv0 + s] : 0.f;
  }
  return seen(p, qmax, qmin, a.window);
}

// Starts the copies of the tile's K and V rows that some row in [qmin,
// qmax] may see into raw (K, then V), zeros for the others.
template <typename QT, typename KT, int D>
__device__ __forceinline__ void issue_rows(const Args<QT, KT>& a, size_t kv0, int s0, int qmax,
                                           int qmin, const int* pos, uint8_t* raw) {
  constexpr int CH = D * (int)sizeof(KT) / 16;   // 16-byte segments a row
  constexpr size_t kRaw = Cfg<QT, KT, D>::kRaw;
  for (int idx = threadIdx.x; idx < kTS * CH; idx += kAT) {
    const int sl = idx / CH, part = idx % CH;
    const int p = pos[sl];
    const bool ld = s0 + sl < a.S && seen(p, qmax, qmin, a.window);
    const size_t g = (kv0 + s0 + sl) * D * sizeof(KT) + part * 16;
    uint8_t* dst = raw + (size_t)sl * D * sizeof(KT) + part * 16;
    cp_async16(dst, ld ? reinterpret_cast<const uint8_t*>(a.k) + g : (const void*)a.k, ld ? 16 : 0);
    cp_async16(dst + kRaw, ld ? reinterpret_cast<const uint8_t*>(a.v) + g : (const void*)a.v,
               ld ? 16 : 0);
  }
}

// The raw K and V rows as bf16 planes.
template <typename QT, typename KT, int D>
__device__ __forceinline__ void raw_to_planes(const uint8_t* raw, __nv_bfloat16* kpl,
                                              __nv_bfloat16* vpl) {
  using C = Cfg<QT, KT, D>;
  constexpr int VK = 16 / sizeof(KT);
  for (int idx = threadIdx.x; idx < kTS * (D / VK); idx += kAT) {
    const int sl = idx / (D / VK), part = idx % (D / VK);
    const KT* src = reinterpret_cast<const KT*>(raw) + sl * D + part * VK;
    put16(src, kpl + sl * C::RS + part * VK, C::kKPlane / 2, true);
    put16(reinterpret_cast<const KT*>(raw + C::kRaw) + sl * D + part * VK,
          vpl + sl * C::RS + part * VK, C::kKPlane / 2, true);
  }
}

// The passes over a run's tiles: bf16 takes one, the online softmax; f32
// takes three and rounds each entry as the plain version does: each row's
// max, then l = sum of exp(logit - max), then p = exp(logit - max) / l and
// (p * v_scale) v.
enum { kPassMax = 0, kPassSum = 1, kPassNorm = 2, kPassOnline = 3 };

// One pass of one tile: the warp's 16 rows against the tile's 64 slots
// (planes ready); m, l and the accumulator o updated as `mode` says.
template <typename QT, typename KT, int D>
__device__ __forceinline__ void attend_tile(const Args<QT, KT>& a, const __nv_bfloat16* qpl,
                                            const __nv_bfloat16* kpl, const __nv_bfloat16* vpl,
                                            const int* pos, const float* ksc, const float* vsc,
                                            int s0, int qp_a, int qp_b, int mode,
                                            float& m_a, float& m_b, float& l_a, float& l_b,
                                            float (&o)[D / 8][4]) {
  using C = Cfg<QT, KT, D>;
  const int lane = threadIdx.x & 31, q = lane & 3;
  float s[8][4];
  tile_logits<QT, KT, D, kQT>(a, qpl, kpl, pos, ksc, s0, qp_a, qp_b, s);
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
  }
  const float mn_a = fmaxf(m_a, quad_max(mx_a)), mn_b = fmaxf(m_b, quad_max(mx_b));
  if (mode == kPassMax) {
    m_a = mn_a;
    m_b = mn_b;
    return;
  }
  // kPassSum and kPassNorm run with m the row's final max (mn == m)
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[j][e];
      float ev = x == -INFINITY ? 0.f : expf(x - (e < 2 ? mn_a : mn_b));
      if (e < 2) sum_a += ev; else sum_b += ev;
      if (mode == kPassNorm) ev = ev / (e < 2 ? d_a : d_b);   // p, as the plain version rounds it
      s[j][e] = std::is_same<KT, int8_t>::value ? ev * vsc[8 * j + 2 * q + (e & 1)] : ev;
    }
  if (mode == kPassSum) {
    l_a += quad_sum(sum_a);
    l_b += quad_sum(sum_b);
    return;
  }
  if (mode == kPassOnline) {
    const float c_a = expf(m_a - mn_a), c_b = expf(m_b - mn_b);
    l_a = l_a * c_a + quad_sum(sum_a);
    l_b = l_b * c_b + quad_sum(sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= c_a;
      o[n][1] *= c_a;
      o[n][2] *= c_b;
      o[n][3] *= c_b;
    }
  }
  // PV: p as C::kPL bf16 limbs, the A operand of four 16-slot steps
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t pa[C::kPL][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // a0a1: row g, slots 16 ks + 2q; a2a3: row g + 8; a4a5..
      uint32_t w[C::kPL];
      const float* sv = s[2 * ks + (i >> 1)] + 2 * (i & 1);
      split<C::kPL>(sv[0], sv[1], w);
#pragma unroll
      for (int l = 0; l < C::kPL; ++l) pa[l][i] = w[l];
    }
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[C::kKL][4];
#pragma unroll
      for (int l = 0; l < C::kKL; ++l)
        ldsm_x4_t(bf[l], vpl + l * (C::kKPlane / 2) +
                             (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * C::RS +
                             np * 16 + (lane >> 4) * 8);
      mma_limbs<C::kExact>(o[2 * np], pa, bf, 0);
      mma_limbs<C::kExact>(o[2 * np + 1], pa, bf, 2);
    }
  }
}

// The attention of one (batch, kv-head, 64 rows, run of slot tiles). The
// next tile's positions and K / V rows load (cp.async) while this one's
// products run.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kAT) attend_kernel(const Args<QT, KT> a) {
  using C = Cfg<QT, KT, D>;
  constexpr int VQ = 16 / sizeof(QT);
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kpl = qpl + C::kQL * (C::kQPlane / 2);
  __nv_bfloat16* vpl = kpl + C::kKL * (C::kKPlane / 2);
  uint8_t* raw = reinterpret_cast<uint8_t*>(vpl + C::kKL * (C::kKPlane / 2));
  int* posb = reinterpret_cast<int*>(raw + 2 * C::kRaw);   // two tiles' positions
  float* kscb = reinterpret_cast<float*>(posb + 2 * kTS);
  float* vscb = kscb + 2 * kTS;
  int* qps = reinterpret_cast<int*>(vscb + 2 * kTS);

  const int bh = blockIdx.x, b = bh / a.Hkv;
  const int rows = a.rep * a.C, R0 = blockIdx.y * kQT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const size_t kv0 = (size_t)bh * a.S, row0 = (size_t)bh * rows;   // the head's first row

  if (tid < kQT) qps[tid] = R0 + tid < rows ? a.q_pos[(size_t)b * a.C + (R0 + tid) % a.C] : -1;
  for (int idx = tid; idx < kQT * (D / VQ); idx += kAT) {
    const int r = idx / (D / VQ), part = idx % (D / VQ);
    put16(a.q + (row0 + R0 + r) * D + part * VQ, qpl + r * C::RS + part * VQ, C::kQPlane / 2,
          R0 + r < rows);
  }
  __syncthreads();
  int qmax = -1, qmin = 0x7fffffff;
  for (int r = 0; r < kQT; ++r) {
    const int p = qps[r];
    if (p >= 0) {
      qmax = max(qmax, p);
      qmin = min(qmin, p);
    }
  }
  const int ra = warp * 16 + g, rb = ra + 8;   // the lane's two rows
  const int qp_a = qps[ra], qp_b = qps[rb];

  const int n_st = (a.S + kTS - 1) / kTS, per = (n_st + a.nsplit - 1) / a.nsplit;
  const int t0 = blockIdx.z * per, t1 = min(n_st, t0 + per);
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // f32 (kExact) walks the run three times, bf16 once (kPassOnline)
  for (int pass = C::kExact ? kPassMax : kPassOnline; pass <= (C::kExact ? kPassNorm : kPassOnline);
       ++pass) {
    __syncthreads();   // the previous pass is done with the positions
    bool vis_next = load_meta(a, kv0, t0 * kTS, qmax, qmin, posb, kscb, vscb);
    __syncthreads();
    if (t0 < t1) issue_rows<QT, KT, D>(a, kv0, t0 * kTS, qmax, qmin, posb, raw);
    cp_commit();
    for (int t = t0; t < t1; ++t) {
      const int buf = (t - t0) & 1;
      cp_wait_all();
      const bool vis = __syncthreads_or(vis_next);   // tile t landed; every warp is done with t - 1
      if (vis) raw_to_planes<QT, KT, D>(raw, kpl, vpl);
      vis_next = t + 1 < t1 && load_meta(a, kv0, (t + 1) * kTS, qmax, qmin,
                                         posb + (buf ^ 1) * kTS, kscb + (buf ^ 1) * kTS,
                                         vscb + (buf ^ 1) * kTS);
      __syncthreads();
      if (t + 1 < t1)
        issue_rows<QT, KT, D>(a, kv0, (t + 1) * kTS, qmax, qmin, posb + (buf ^ 1) * kTS, raw);
      cp_commit();
      if (vis)
        attend_tile<QT, KT, D>(a, qpl, kpl, vpl, posb + buf * kTS, kscb + buf * kTS,
                               vscb + buf * kTS, t * kTS, qp_a, qp_b, pass, m_a, m_b, l_a, l_b,
                               o);
    }
  }
  // out (one run), or the run's partial
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = h == 0 ? ra : rb;
    if (R0 + r >= rows) continue;
    const size_t row = row0 + R0 + r;
    const float m = h == 0 ? m_a : m_b, l = h == 0 ? l_a : l_b;
    if (a.nsplit == 1) {
      const float denom = C::kExact ? 1.f : fmaxf(l, 1e-30f);   // f32: p came normalized
      QT* out = a.out + row * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        out[8 * n + 2 * q] = from_f<QT>(o[n][2 * h] / denom);
        out[8 * n + 2 * q + 1] = from_f<QT>(o[n][2 * h + 1] / denom);
      }
      if (a.ml != nullptr && q == 0) {
        a.ml[row * 2] = m;
        a.ml[row * 2 + 1] = l;
      }
    } else {
      const size_t n_rows = (size_t)gridDim.x * rows;
      float* pr = a.part + ((size_t)blockIdx.z * n_rows + row) * (D + 2);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(pr + 8 * n + 2 * q) = make_float2(o[n][2 * h], o[n][2 * h + 1]);
      if (q == 0) *reinterpret_cast<float2*>(pr + D) = make_float2(m, l);
    }
  }
}

// The runs' partials of one row per warp, added in run order: out, and the
// row's final m and l where ml is given.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(32 * kCombineRows) combine_kernel(const Args<QT, KT> a,
                                                                    int n_rows) {
  const int row = blockIdx.x * kCombineRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  constexpr int E = D / 32;
  float mx = kNegInf;
  for (int z = 0; z < a.nsplit; ++z) mx = fmaxf(mx, a.part[((size_t)z * n_rows + row) * (D + 2) + D]);
  float l = 0.f, o[E] = {};
  for (int z = 0; z < a.nsplit; ++z) {
    const float* pr = a.part + ((size_t)z * n_rows + row) * (D + 2);
    const float w = expf(pr[D] - mx);
    l += pr[D + 1] * w;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] += pr[lane * E + e] * w;
  }
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e) a.out[(size_t)row * D + lane * E + e] = from_f<QT>(o[e] / denom);
  if (a.ml != nullptr && lane == 0) {
    a.ml[(size_t)row * 2] = mx;
    a.ml[(size_t)row * 2 + 1] = l;
  }
}

// The statistics of one (batch, kv-head, run of a.spb 64-slot tiles): per
// tile its K rows are loaded once (every row some query of the chunk may
// see), then each query tile in turn (tc = 128 / rep queries x rep heads,
// row r = i tc + j; one tile, loaded once for the block, for an MHA chunk of
// up to 128 queries) gives exact p from its rows' final m and l, the GQA
// mean, and the tile's sums: four quarters of the tile's queries a slot,
// added in quarter order. A query tile that sees no slot of the tile is
// skipped, as is a slot tile no query sees.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kSTh) stats_kernel(const Args<QT, KT> a) {
  using C = Cfg<QT, KT, D>;
  constexpr int VQ = 16 / sizeof(QT), VK = 16 / sizeof(KT);
  constexpr int kQuarters = kSTh / kTS;
  extern __shared__ __align__(16) uint8_t smem[];
  __nv_bfloat16* qpl = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* kpl = qpl + C::kQL * (C::kSPlane / 2);
  float* pt = reinterpret_cast<float*>(kpl + C::kKL * (C::kKPlane / 2));
  int* pos = reinterpret_cast<int*>(pt + kSQ * kPP);
  float* ksc = reinterpret_cast<float*>(pos + kTS);
  int* qps = reinterpret_cast<int*>(ksc + kTS);
  float* ms = reinterpret_cast<float*>(qps + kSQ);
  float* ls = ms + kSQ;
  __shared__ int q_range[2];
  __shared__ float red[2 * kQuarters * kTS];   // each quarter's sums, then its sums of squares

  const int bh = blockIdx.x, b = bh / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int rep = a.rep, tc = kSQ / rep, n_ct = (a.C + tc - 1) / tc;
  const float inv_rep = 1.f / (float)rep;   // the GQA mean (a multiply: the sum's chain is serial)
  const size_t kv0 = (size_t)bh * a.S, row0 = (size_t)bh * rep * a.C;
  if (tid == 0) {
    q_range[0] = -1;
    q_range[1] = 0x7fffffff;
  }
  __syncthreads();
  for (int c = tid; c < a.C; c += kSTh) {
    const int p = a.q_pos[(size_t)b * a.C + c];
    if (p >= 0) {
      atomicMax(&q_range[0], p);
      atomicMin(&q_range[1], p);
    }
  }
  __syncthreads();
  const int sl = tid & (kTS - 1), h = tid / kTS;   // the thread's slot and query quarter
  const int ra = warp * 16 + g, rb = ra + 8;
  // query tile ct: rows, positions, final m and l, and (qmax, qmin)
  auto load_queries = [&](int ct) {
    const int c0 = ct * tc;
    if (tid < kSQ) {
      const int i = tid / tc, j = tid % tc;
      const bool real = tid < rep * tc && c0 + j < a.C;
      const size_t row = row0 + (size_t)i * a.C + c0 + j;
      qps[tid] = real ? a.q_pos[(size_t)b * a.C + c0 + j] : -1;
      ms[tid] = real ? a.ml[row * 2] : kNegInf;
      ls[tid] = real ? a.ml[row * 2 + 1] : 0.f;
    }
    for (int idx = tid; idx < kSQ * (D / VQ); idx += kSTh) {
      const int r = idx / (D / VQ), part = idx % (D / VQ);
      const int i = r / tc, j = r % tc;
      const bool real = r < rep * tc && c0 + j < a.C;
      put16(a.q + (row0 + (size_t)i * a.C + c0 + j) * D + part * VQ,
            qpl + r * C::RS + part * VQ, C::kSPlane / 2, real);
    }
    __syncthreads();
    int qmax = -1, qmin = 0x7fffffff;
#pragma unroll 8
    for (int r = 0; r < kSQ; ++r) {
      const int p = qps[r];
      if (p >= 0) {
        qmax = max(qmax, p);
        qmin = min(qmin, p);
      }
    }
    return make_int2(qmax, qmin);
  };
  int2 qr = n_ct == 1 ? load_queries(0) : make_int2(-1, 0);

  const int n_st = (a.S + kTS - 1) / kTS;
  for (int t = blockIdx.y * a.spb; t < min(n_st, (int)blockIdx.y * a.spb + a.spb); ++t) {
    const int s0 = t * kTS;
    if (!__syncthreads_or(load_meta(a, kv0, s0, q_range[0], q_range[1], pos, ksc, nullptr)))
      continue;
    for (int idx = tid; idx < kTS * (D / VK); idx += kSTh) {   // the K rows some query may see
      const int sl = idx / (D / VK), part = idx % (D / VK);
      put16(a.k + (kv0 + s0 + sl) * D + part * VK, kpl + sl * C::RS + part * VK, C::kKPlane / 2,
            s0 + sl < a.S && seen(pos[sl], q_range[0], q_range[1], a.window));
    }
    __syncthreads();
    const bool mine = tid < kTS && s0 + tid < a.S;
    float sum_acc = mine ? a.ssum[kv0 + s0 + tid] : 0.f;
    float sq_acc = mine ? a.ssq[kv0 + s0 + tid] : 0.f;
    float last_p = 0.f;
    bool has_last = false;
    for (int ct = 0; ct < n_ct; ++ct) {
      const int c0 = ct * tc;
      if (n_ct > 1) qr = load_queries(ct);
      if (!__syncthreads_or(tid < kTS && seen(pos[tid], qr.x, qr.y, a.window))) continue;
      float s[8][4];
      tile_logits<QT, KT, D, kSQ>(a, qpl, kpl, pos, ksc, s0, qps[ra], qps[rb], s);
      const float m_a = ms[ra], m_b = ms[rb];
      const float d_a = fmaxf(ls[ra], 1e-30f), d_b = fmaxf(ls[rb], 1e-30f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const bool top = e < 2;
          pt[(top ? ra : rb) * kPP + 8 * j + 2 * q + (e & 1)] =
              x == -INFINITY ? 0.f : expf(x - (top ? m_a : m_b)) / (top ? d_a : d_b);
        }
      __syncthreads();
      {
        const int jn = min(tc, a.C - c0);
        float sum = 0.f, sq = 0.f;
#pragma unroll 4
        for (int j = h; j < jn; j += kQuarters) {
          float pk = 0.f;
          for (int i = 0; i < rep; ++i) pk += pt[(i * tc + j) * kPP + sl];
          pk *= inv_rep;
          sum += pk;
          sq += pk * pk;
        }
        red[h * kTS + sl] = sum;
        red[(kQuarters + h) * kTS + sl] = sq;
        const int jl = a.C - 1 - c0;   // the chunk's last query, if in this tile
        if (jl < jn && jl % kQuarters == h) {
          float pk = 0.f;
          for (int i = 0; i < rep; ++i) pk += pt[(i * tc + jl) * kPP + sl];
          last_p = pk * inv_rep;
          has_last = true;
        }
      }
      __syncthreads();
      if (mine) {
        float sum = 0.f, sq = 0.f;
#pragma unroll
        for (int k = 0; k < kQuarters; ++k) {
          sum += red[k * kTS + tid];
          sq += red[(kQuarters + k) * kTS + tid];
        }
        sum_acc += sum;
        sq_acc += sq;
      }
    }
    if (mine) {
      a.ssum[kv0 + s0 + tid] = sum_acc;
      a.ssq[kv0 + s0 + tid] = sq_acc;
    }
    if (has_last && s0 + sl < a.S) a.last[kv0 + s0 + sl] = last_p;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename QT, typename KT, int D>
int launch(const Args<QT, KT>& a, int B, cudaStream_t stream) {
  using C = Cfg<QT, KT, D>;
  const int rows = a.rep * a.C;
  const int n_st = (a.S + kTS - 1) / kTS;
  if (a.rep < 1 || a.rep > kQT / 2 || a.C < 1 || a.S < 1 || a.nsplit < 1 || a.nsplit > n_st)
    return (int)cudaErrorInvalidValue;
  if (std::is_same<KT, int8_t>::value && (a.k_scale == nullptr || a.v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool scores = a.ssum != nullptr;
  if ((scores && (a.ssq == nullptr || a.last == nullptr || a.ml == nullptr)) ||
      (a.nsplit > 1 && a.part == nullptr))
    return (int)cudaErrorInvalidValue;
  auto attend = attend_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(attend, C::attend_bytes());
  if (err != cudaSuccess) return (int)err;
  attend<<<dim3(B * a.Hkv, (rows + kQT - 1) / kQT, a.nsplit), kAT, C::attend_bytes(), stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (a.nsplit > 1) {
    const int n_rows = B * a.Hkv * rows;
    combine_kernel<QT, KT, D><<<(n_rows + kCombineRows - 1) / kCombineRows, 32 * kCombineRows, 0,
                                stream>>>(a, n_rows);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (!scores) return 0;
  // slot tiles a statistics block walks: about two blocks an SM in all
  Args<QT, KT> sa = a;
  sa.spb = (n_st + max(1, kStatsBlocks / (B * a.Hkv)) - 1) / max(1, kStatsBlocks / (B * a.Hkv));
  auto stats = stats_kernel<QT, KT, D>;
  err = allow_smem(stats, C::stats_bytes());
  if (err != cudaSuccess) return (int)err;
  stats<<<dim3(B * a.Hkv, (n_st + sa.spb - 1) / sa.spb), kSTh, C::stats_bytes(), stream>>>(sa);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_d(int D, const void* q, const void* k, const void* v, const int* pos,
             const int* q_pos, const float* k_scale, const float* v_scale, void* out,
             float* ssum, float* ssq, float* last, float* ml, float* part, int B, int Hkv,
             int rep, int C, int S, int nsplit, float scale, int window, cudaStream_t st) {
  const Args<QT, KT> a{(const QT*)q, (const KT*)k, (const KT*)v, pos,   q_pos,  k_scale,
                       v_scale,      (QT*)out,     ssum,          ssq,   last,   ml,
                       part,         Hkv,          rep,           C,     S,      nsplit,
                       scale,        window,       1};
  if (D == 64) return launch<QT, KT, 64>(a, B, st);
  if (D == 128) return launch<QT, KT, 128>(a, B, st);
  return (int)cudaErrorInvalidValue;
}

template <typename QT, typename KT>
size_t smem_of(int D) {
  if (D == 64) {
    using C = Cfg<QT, KT, 64>;
    return C::attend_bytes() > C::stats_bytes() ? C::attend_bytes() : C::stats_bytes();
  }
  if (D == 128) {
    using C = Cfg<QT, KT, 128>;
    return C::attend_bytes() > C::stats_bytes() ? C::attend_bytes() : C::stats_bytes();
  }
  return 0;
}

constexpr float kInv127 = 1.0f / 127.0f;   // f32(1/127), as quantize_kv rounds it
constexpr int kWriteThreads = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// One warp writes chunk row r = (bh, c) (K, or V when is_v) into cache slot
// `at` = bh * S + slot; the K warp also writes the slot's sidecars. CT is IT
// (float cache) or int8_t (quantized).
template <typename IT, typename CT>
__device__ __forceinline__ void put_row(const IT* __restrict__ k_c, const IT* __restrict__ v_c,
                                        const int* __restrict__ q_pos,
                                        const float* __restrict__ cinit, CT* __restrict__ k,
                                        CT* __restrict__ v, int* __restrict__ pos,
                                        float* __restrict__ score,
                                        float* __restrict__ score_sq,
                                        float* __restrict__ counter,
                                        float* __restrict__ k_scale,
                                        float* __restrict__ v_scale, bool is_v, int r,
                                        size_t at, int b, int c, int C, int D, int lane) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  const IT* src = (is_v ? v_c : k_c) + (size_t)r * D;
  CT* dst = (is_v ? v : k) + at * D;
  if constexpr (kQuant) {
    float amax = 0.f;
    for (int d = lane; d < D; d += 32) amax = fmaxf(amax, fabsf(to_f(src[d])));
    amax = warp_max(amax);
    const float sc = fmaxf(amax, 1e-8f) * kInv127;
    for (int d = lane; d < D; d += 32) {
      const float qv = rintf(__fdiv_rn(to_f(src[d]), sc));
      dst[d] = (CT)(int)fminf(fmaxf(qv, -127.f), 127.f);
    }
    if (lane == 0) (is_v ? v_scale : k_scale)[at] = sc;
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = (CT)src[d];
  }
  if (lane == 0 && !is_v) {
    pos[at] = q_pos[(size_t)b * C + c];
    counter[at] = cinit[(size_t)b * C + c];
    score[at] = 0.f;
    score_sq[at] = 0.f;
  }
}

// One warp per (bh, c, K or V) row: warp w < rows writes K row w, w >= rows
// writes V row w - rows.
template <typename IT, typename CT>
__global__ void __launch_bounds__(kWriteThreads)
chunk_write_kernel(const IT* __restrict__ k_c, const IT* __restrict__ v_c,
                   const int* __restrict__ ids, const int* __restrict__ q_pos,
                   const float* __restrict__ cinit, CT* __restrict__ k, CT* __restrict__ v,
                   int* __restrict__ pos, float* __restrict__ score,
                   float* __restrict__ score_sq, float* __restrict__ counter,
                   float* __restrict__ k_scale, float* __restrict__ v_scale, int rows, int Hkv,
                   int C, int S, int D) {
  const int w = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  if (w >= 2 * rows) return;
  const bool is_v = w >= rows;
  const int r = is_v ? w - rows : w;   // (bh, c) row of the chunk
  const int bh = r / C, c = r % C;
  put_row<IT, CT>(k_c, v_c, q_pos, cinit, k, v, pos, score, score_sq, counter, k_scale,
                  v_scale, is_v, r, (size_t)bh * S + ids[r], bh / Hkv, c, C, D,
                  threadIdx.x & 31);
}

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kMaskRows = 32;       // chunk rows per mask-write block
constexpr int kStepThreads = 512;   // threads of a step block
constexpr float kStdForce = 1e9f;   // policies.STD_FORCE
constexpr float kStdExclude = 1e30f;  // policies.STD_EXCLUDE
constexpr int kStdGuard = 10;       // policies.ROCO_STD_GUARD

__device__ __forceinline__ int warp_sum_i(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Exclusive prefix sum of one int per thread over an NT-thread block, in
// thread order; *total gets the block's sum. buf holds NT / 32 + 1 ints.
// Starts and ends with the block in step (every thread passes two
// barriers), so buf is free again on return.
template <int NT>
__device__ int block_scan(int x, int* buf, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) buf[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < NT / 32 ? buf[lane] : 0;
    int winc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, winc, o);
      if (lane >= o) winc += y;
    }
    __syncwarp();
    if (lane < NT / 32) buf[lane] = winc - w;
    if (lane == NT / 32 - 1) buf[NT / 32] = winc;
  }
  __syncthreads();
  const int out = buf[warp] + inc - x;
  *total = buf[NT / 32];
  __syncthreads();
  return out;
}

// The mask-rank row write: block (bh, y) ranks the write mask of head bh
// (each thread counts a contiguous run of slots, a block scan gives the
// ranks) and writes chunk rows [32 y, 32 y + 32), K and V, row r into the
// slot of rank r; a row with no slot of its rank is dropped.
template <typename IT, typename CT>
__global__ void __launch_bounds__(kWriteThreads)
chunk_mask_write_kernel(const IT* __restrict__ k_c, const IT* __restrict__ v_c,
                        const int* __restrict__ wmask, const int* __restrict__ q_pos,
                        const float* __restrict__ cinit, CT* __restrict__ k,
                        CT* __restrict__ v, int* __restrict__ pos, float* __restrict__ score,
                        float* __restrict__ score_sq, float* __restrict__ counter,
                        float* __restrict__ k_scale, float* __restrict__ v_scale, int Hkv,
                        int C, int S, int D) {
  __shared__ int slot[kMaskRows];
  __shared__ int buf[kWriteThreads / 32 + 1];
  const int bh = blockIdx.x, r0 = blockIdx.y * kMaskRows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* wm = wmask + (size_t)bh * S;
  if (tid < kMaskRows) slot[tid] = -1;
  const int per = (S + kWriteThreads - 1) / kWriteThreads;
  const int lo = min(S, tid * per), hi = min(S, lo + per);
  int n = 0;
  for (int s = lo; s < hi; ++s) n += wm[s] != 0;
  int total;
  int rank = block_scan<kWriteThreads>(n, buf, &total);
  for (int s = lo; s < hi && rank < r0 + kMaskRows; ++s) {
    if (wm[s] == 0) continue;
    if (rank >= r0) slot[rank - r0] = s;
    ++rank;
  }
  __syncthreads();
  for (int j = warp; j < 2 * kMaskRows; j += kWriteThreads / 32) {
    const bool is_v = j >= kMaskRows;
    const int c = r0 + (is_v ? j - kMaskRows : j);
    const int s = slot[is_v ? j - kMaskRows : j];
    if (c >= C || s < 0) continue;
    put_row<IT, CT>(k_c, v_c, q_pos, cinit, k, v, pos, score, score_sq, counter, k_scale,
                    v_scale, is_v, bh * C + c, (size_t)bh * S + s, bh / Hkv, c, C, D, lane);
  }
}

// policies._kth_smallest's order: the f32 bit pattern with the sign bit
// flipped for positives and every bit for negatives (NaN by its bits)
__device__ __forceinline__ uint32_t order_key(float x) {
  const uint32_t b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}
// a stable ascending torch.sort's order: -0 == +0, every NaN above +inf
__device__ __forceinline__ uint32_t sort_key(float x) {
  if (x != x) return 0xffffffffu;
  return order_key(x == 0.f ? 0.f : x);
}

// The k-th smallest (1-indexed) of key[0, S) by a 32-step bisection, as
// policies._kth_smallest: each round counts the keys below the candidate
// prefix. red holds 2 x NT / 32 ints (rounds alternate halves, so one
// barrier a round suffices). Every thread returns the same key.
template <int NT>
__device__ uint32_t kth_key(const uint32_t* key, int S, int k, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t prefix = 0;
  for (int i = 0; i < 32; ++i) {
    const uint32_t cand = prefix | (1u << (31 - i));
    int n = 0;
    for (int s = threadIdx.x; s < S; s += NT) n += key[s] < cand;
    n = warp_sum_i(n);
    int* half = red + (i & 1) * (NT / 32);
    if (lane == 0) half[warp] = n;
    __syncthreads();
    int total = 0;
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) total += half[w];
    prefix = total >= k ? prefix : cand;
  }
  return prefix;
}

// The score update, the bump and the selection of one (batch, kv-head)
// row; shared memory: key[S] (u32), then val[S] (f32).
template <int NT>
__global__ void __launch_bounds__(NT)
chunk_step_kernel(const float* __restrict__ ssum, const float* __restrict__ ssq,
                  const uint8_t* __restrict__ ugate, const uint8_t* __restrict__ egate,
                  const int* __restrict__ next_pos, const int* __restrict__ next_start,
                  int* __restrict__ pos, float* __restrict__ score,
                  float* __restrict__ score_sq, float* __restrict__ counter,
                  int* __restrict__ wm_out, int Hkv, int C, int S, int roco, int feasible_k,
                  int sink, int recent_window) {
  extern __shared__ __align__(16) uint32_t key[];
  float* val = reinterpret_cast<float*>(key + S);
  __shared__ int red[2 * (NT / 32)];
  __shared__ int buf[NT / 32 + 1];
  const int bh = blockIdx.x, b = bh / Hkv;
  const size_t o = (size_t)bh * S;
  const float gu = ugate[b] ? 1.f : 0.f;
  const bool evict = egate[b] != 0;
  const int np = next_pos[b], ns = next_start[b];
  // update (policies.update_scores_reduced), bump under the gate, keys
  for (int s = threadIdx.x; s < S; s += NT) {
    const float sc = __fadd_rn(score[o + s], __fmul_rn(ssum[o + s], gu));
    score[o + s] = sc;
    float sq = 0.f;
    if (roco) {
      sq = __fadd_rn(score_sq[o + s], __fmul_rn(ssq[o + s], gu));
      score_sq[o + s] = sq;
    }
    if (!evict) {
      wm_out[o + s] = s >= ns && s < ns + C;
      continue;
    }
    const float cn = __fadd_rn(counter[o + s], (float)C);
    counter[o + s] = cn;
    const int p = pos[o + s];
    if (roco) {
      const float mean = __fdiv_rn(sc, cn);
      const float var = __fsub_rn(__fdiv_rn(sq, cn), __fmul_rn(mean, mean));
      float sd = __fsqrt_rn(var < 0.f ? 0.f : var);   // NaN stays NaN, as torch.clamp
      if (p >= np - kStdGuard || p < sink) sd = __fadd_rn(kStdForce, __fmul_rn((float)p, 1024.f));
      if (p < 0) sd = kStdExclude;
      key[s] = order_key(sd);
      val[s] = mean;
    } else {
      const bool cand = p >= 0 && p >= sink && p < np - recent_window;
      key[s] = sort_key(cand ? sc : INFINITY);
    }
  }
  if (!evict) return;
  __syncthreads();
  if (roco) {   // stage 1: feasible = std <= the feasible_k-th smallest std
    const float kth = key_value(kth_key<NT>(key, S, feasible_k, red));
    for (int s = threadIdx.x; s < S; s += NT)
      key[s] = sort_key(key_value(key[s]) <= kth ? val[s] : INFINITY);
    __syncthreads();
  }
  // the C smallest keys: those below the C-th, then its ties in slot order
  const uint32_t t = kth_key<NT>(key, S, C, red);
  const int per = (S + NT - 1) / NT;
  const int lo = min(S, (int)threadIdx.x * per), hi = min(S, lo + per);
  int below = 0, ties = 0;
  for (int s = lo; s < hi; ++s) {
    below += key[s] < t;
    ties += key[s] == t;
  }
  int n_below;
  block_scan<NT>(below, buf, &n_below);
  int n_ties;
  int tie_rank = block_scan<NT>(ties, buf, &n_ties);
  const int need = C - n_below;
  for (int s = lo; s < hi; ++s) {
    const bool victim = key[s] < t || (key[s] == t && tie_rank++ < need);
    if (victim) pos[o + s] = -1;
    wm_out[o + s] = victim;
  }
}

template <typename IT, typename CT>
int launch_write(const void* k_c, const void* v_c, const int* ids, const int* q_pos,
                 const float* cinit, void* k, void* v, int* pos, float* score, float* score_sq,
                 float* counter, float* k_scale, float* v_scale, int B, int Hkv, int C, int S,
                 int D, cudaStream_t stream) {
  if (std::is_same<CT, int8_t>::value && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int rows = B * Hkv * C;
  const int warps_per_block = kWriteThreads / 32;
  const int blocks = (2 * rows + warps_per_block - 1) / warps_per_block;
  chunk_write_kernel<IT, CT><<<blocks, kWriteThreads, 0, stream>>>(
      (const IT*)k_c, (const IT*)v_c, ids, q_pos, cinit, (CT*)k, (CT*)v, pos, score, score_sq,
      counter, k_scale, v_scale, rows, Hkv, C, S, D);
  return (int)cudaGetLastError();
}

template <typename IT, typename CT>
int launch_mask_write(const void* k_c, const void* v_c, const int* wmask, const int* q_pos,
                      const float* cinit, void* k, void* v, int* pos, float* score,
                      float* score_sq, float* counter, float* k_scale, float* v_scale, int B,
                      int Hkv, int C, int S, int D, cudaStream_t stream) {
  if (std::is_same<CT, int8_t>::value && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  chunk_mask_write_kernel<IT, CT>
      <<<dim3(B * Hkv, (C + kMaskRows - 1) / kMaskRows), kWriteThreads, 0, stream>>>(
          (const IT*)k_c, (const IT*)v_c, wmask, q_pos, cinit, (CT*)k, (CT*)v, pos, score,
          score_sq, counter, k_scale, v_scale, Hkv, C, S, D);
  return (int)cudaGetLastError();
}

size_t step_smem(int S) { return (size_t)S * (sizeof(uint32_t) + sizeof(float)); }

// Calls f(QT{}, KT{}) with the queries' (and chunk rows') type QT (q_dtype
// 0 = float32, 1 = bfloat16) and the cache's type KT (QT, or int8_t when
// kv_int8).
template <typename F>
int by_types(int q_dtype, int kv_int8, F f) {
  if (q_dtype == 0) return kv_int8 ? f(float{}, int8_t{}) : f(float{}, float{});
  if (q_dtype == 1)
    return kv_int8 ? f(__nv_bfloat16{}, int8_t{}) : f(__nv_bfloat16{}, __nv_bfloat16{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory of K7's step launch at S slots, bytes.
size_t chunk_step_smem(int S) { return step_smem(S); }

// Dynamic shared memory the attention or statistics launch needs at
// head_dim D (64 or 128) and these types, bytes (0: not taken).
size_t chunk_attend_smem(int D, int q_dtype, int kv_int8) {
  size_t bytes = 0;
  by_types(q_dtype, kv_int8, [&](auto qt, auto kt) {
    bytes = smem_of<decltype(qt), decltype(kt)>(D);
    return 0;
  });
  return bytes;
}

// q: (B, Hkv*rep, C, D), q_dtype 0 = float32, 1 = bfloat16; k, v: (B, Hkv,
// S, D) in q's type, or int8 (kv_int8 = 1) with k_scale, v_scale (B, Hkv, S)
// f32. ssum, ssq, last: (B, Hkv, S) f32 zero-filled, and ml: (B, Hkv*rep,
// C, 2) f32 scratch (each row's final softmax max and sum), or all null for
// no statistics. The slot tiles split into nsplit runs (1 <= nsplit <=
// ceil(S / 64)); with nsplit > 1, part: (nsplit, B*Hkv*rep*C, D + 2) f32
// scratch of the runs' partials. window <= 0: no sliding window. Every
// pointer of q, k, v is 16-byte aligned. Returns cudaGetLastError().
int chunk_attend(const void* q, const void* k, const void* v, const int* pos, const int* q_pos,
                 const float* k_scale, const float* v_scale, void* out, float* ssum, float* ssq,
                 float* last, float* ml, float* part, int B, int Hkv, int rep, int C, int S,
                 int D, int nsplit, float scale, int window, int q_dtype, int kv_int8,
                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return by_types(q_dtype, kv_int8, [&](auto qt, auto kt) {
    return launch_d<decltype(qt), decltype(kt)>(D, q, k, v, pos, q_pos, k_scale, v_scale, out,
                                                ssum, ssq, last, ml, part, B, Hkv, rep, C, S,
                                                nsplit, scale, window, st);
  });
}

// K6: write the chunk (k_c, v_c: (B, Hkv, C, D) in q's type) into slots
// ids (B, Hkv, C) int32, distinct per head, of the cache k, v (+ k_scale,
// v_scale for int8) and its sidecars pos, score, score_sq, counter (B, Hkv,
// S), with pos = q_pos (B, C) and counter = counter_init (B, C) f32, then
// attend as chunk_attend over the updated cache. A float cache is in q's
// type. Returns the first launch error, or cudaGetLastError().
int chunk_write_attend(const void* q, const void* k_c, const void* v_c, const int* ids,
                       const int* q_pos, const float* cinit, void* k, void* v, int* pos,
                       float* score, float* score_sq, float* counter, float* k_scale,
                       float* v_scale, void* out, float* ssum, float* ssq, float* last,
                       float* ml, float* part, int B, int Hkv, int rep, int C, int S, int D,
                       int nsplit, float scale, int window, int q_dtype, int kv_int8,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int err = by_types(q_dtype, kv_int8, [&](auto it, auto ct) {
    return launch_write<decltype(it), decltype(ct)>(k_c, v_c, ids, q_pos, cinit, k, v, pos,
                                                    score, score_sq, counter, k_scale, v_scale,
                                                    B, Hkv, C, S, D, st);
  });
  if (err != 0) return err;
  return chunk_attend(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last, ml, part, B,
                      Hkv, rep, C, S, D, nsplit, scale, window, q_dtype, kv_int8, stream);
}

// K7: one strided-encode chunk step. wmask (B, Hkv, S) int32, nonzero at
// this chunk's write slots (row r into the r-th set slot, ascending); then
// chunk_attend over the updated cache with the statistics into ssum, ssq,
// last (zero-filled), ml and part; then per (batch, kv-head) the score update
// under ugate (B,) and, under egate (B,), counter += C, the encode-phase
// selection (roco = 1: roco with feasible_k; 0: h2o_head with sink and
// recent_window; next_pos (B,) int32) and pos = -1 at the victims.
// wm_out (B, Hkv, S) int32 gets the next write mask: the victims, or
// [next_start, next_start + C) where egate is off. Gates are bytes (0/1).
// Returns the first launch error, or cudaGetLastError().
int chunk_step(const void* q, const void* k_c, const void* v_c, const int* wmask,
               const int* q_pos, const float* cinit, const uint8_t* ugate,
               const uint8_t* egate, const int* next_pos, const int* next_start, void* k,
               void* v, int* pos, float* score, float* score_sq, float* counter,
               float* k_scale, float* v_scale, void* out, float* ssum, float* ssq, float* last,
               float* ml, float* part, int* wm_out, int B, int Hkv, int rep, int C, int S,
               int D, int nsplit, float scale, int window, int q_dtype, int kv_int8, int roco,
               int feasible_k, int sink, int recent_window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || C > S || D < 1 || ssum == nullptr) return (int)cudaErrorInvalidValue;
  int err = by_types(q_dtype, kv_int8, [&](auto it, auto ct) {
    return launch_mask_write<decltype(it), decltype(ct)>(k_c, v_c, wmask, q_pos, cinit, k, v,
                                                         pos, score, score_sq, counter,
                                                         k_scale, v_scale, B, Hkv, C, S, D, st);
  });
  if (err != 0) return err;
  err = chunk_attend(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last, ml, part, B,
                     Hkv, rep, C, S, D, nsplit, scale, window, q_dtype, kv_int8, stream);
  if (err != 0) return err;
  const size_t smem = step_smem(S);
  auto step = chunk_step_kernel<kStepThreads>;
  cudaError_t e = allow_smem(step, smem);
  if (e != cudaSuccess) return (int)e;
  step<<<B * Hkv, kStepThreads, smem, st>>>(ssum, ssq, ugate, egate, next_pos, next_start, pos,
                                            score, score_sq, counter, wm_out, Hkv, C, S, roco,
                                            feasible_k, sink, recent_window);
  return (int)cudaGetLastError();
}

}  // extern "C"
