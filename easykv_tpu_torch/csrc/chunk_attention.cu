// C-query chunk attention over the budgeted KV ring buffer, with the
// per-slot eviction statistics reduced in the same launch.
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
// at 3.35 TB/s against 1.1 us of bf16 tensor-core work, so a fast kernel
// would sit near both limits at once. This first design is a plain fp32
// CUDA-core kernel, far from either limit:
//   * one block per (batch, kv-head, tile of 32 query rows); a tile holds
//     all rep heads of its queries, so the GQA mean of the statistics never
//     crosses blocks;
//   * the block walks S in tiles of 64 slots with an online softmax (the
//     whole 128 x 768 fp32 logits block would need 393 KB of shared memory),
//     reading each K/V row once per query tile with 16-byte loads and
//     skipping every tile that no row of the block can see (causal prefill:
//     a chunk sees only the slots written before it and itself);
//   * QK^T and PV are the block's own fp32 products in shared memory, 2 x 4
//     logits and 2 x D/16 outputs per thread; no library call;
//   * with scores, the attention launch also stores each row's final m and
//     l, and a second launch, one block per (batch, kv-head, tile of 64
//     slots), loads its K rows once and takes every query tile in turn:
//     exact p from the row's m and l, the GQA mean, and the tile's sums
//     added into ssum / ssq in query-tile order. Each block owns its slots,
//     so the statistics are deterministic without atomics, and the launch
//     spreads over B * Hkv * S / 64 blocks (1152 at the strided encode's
//     S = 2304 with 32 heads).
// Tensor-core products (wgmma) and a TMA ring are later work.
//
// K6, the strided encode's chunk write + attend: `chunk_write_attend`
// replaces the TPU kernel `fused_chunk_write_attend` (its 1-pass
// `_wa_kernel`, its S-tiled `_wa_flash_kernel` and the `_score_kernel`
// second pass): it writes the chunk's C rows per kv-head into caller-given
// slots, then computes K5's function over the UPDATED cache. On the TPU the
// fusion saves a whole-block HBM round trip (a Pallas block is copied in and
// out whole); here the cache is updated in place and the write touches only
// C rows per head, so one C call launches a row-write kernel and then K5's
// attention and statistics launches on the same stream (the statistics read
// the K rows a second time), which are the code K5 already holds to its plain
// version. The row write is one warp per (batch, kv-head, chunk row, K or
// V): an int8 cache gets the row quantized in the kernel, bit-exact with
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

constexpr int kThreads = 256;   // 16 x 16: ty picks rows, tx slots / columns
constexpr int kRows = 32;       // query rows per tile (rep heads x queries)
constexpr int kTS = 64;         // slots per S tile
constexpr int kPS = kTS + 1;    // row stride of the logits tile
constexpr float kNegInf = -1e30f;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }  // 16-byte rows, no conflicts

// 16 bytes at p (16-byte aligned) as floats
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)b[i];
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool sees(int p, int qp, int window) {
  return p >= 0 && p <= qp && (window <= 0 || p > qp - window);
}

template <int D>
struct Smem {
  float* q;      // kRows x RS
  float* k;      // kTS x RS
  float* v;      // kTS x RS
  float* lg;     // kRows x kPS: logits, then e (or p)
  float* m;      // kRows
  float* l;      // kRows
  float* corr;   // kRows
  int* qp;       // kRows
  int* pos;      // kTS
  float* ksc;    // kTS
  float* vsc;    // kTS
  __device__ explicit Smem(float* base) {
    constexpr int RS = row_stride<D>();
    q = base;
    k = q + kRows * RS;
    v = k + kTS * RS;
    lg = v + kTS * RS;
    m = lg + kRows * kPS;
    l = m + kRows;
    corr = l + kRows;
    qp = reinterpret_cast<int*>(corr + kRows);
    pos = qp + kRows;
    ksc = reinterpret_cast<float*>(pos + kTS);
    vsc = ksc + kTS;
  }
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)(kRows + 2 * kTS) * row_stride<D>() + kRows * kPS +
                            3 * kRows + 2 * kTS) +
           sizeof(int) * (kRows + kTS);
  }
};

// Loads one S tile's positions (and scales), then the K (and V) rows of the
// slots some row of the block may see; other rows are zero. Returns false,
// uniformly, when no slot of the tile is visible to any row.
template <typename KT, int D>
__device__ bool load_tile(const Smem<D>& sm, const KT* k, const KT* v, const int* pos,
                          const float* k_scale, const float* v_scale, size_t kv0, int s0,
                          int S, int qmax, int qmin, int window, bool with_v) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int VK = 16 / sizeof(KT);
  constexpr int RS = row_stride<D>();
  const int tid = threadIdx.x;
  int any = 0;
  if (tid < kTS) {
    const int s = s0 + tid;
    const int p = s < S ? pos[kv0 + s] : -1;
    sm.pos[tid] = p;
    any = p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
    if (kQuant) {
      sm.ksc[tid] = s < S ? k_scale[kv0 + s] : 0.f;
      if (with_v) sm.vsc[tid] = s < S ? v_scale[kv0 + s] : 0.f;
    }
  }
  if (!__syncthreads_or(any)) return false;
  for (int idx = tid; idx < kTS * (D / VK); idx += kThreads) {
    const int sl = idx / (D / VK), part = idx % (D / VK);
    const int p = sm.pos[sl];
    const bool ld = s0 + sl < S && p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
    float* kd = sm.k + sl * RS + part * VK;
    float* vd = sm.v + sl * RS + part * VK;
    const size_t g = (kv0 + s0 + sl) * D + part * VK;
    if (ld) {
      load16(k + g, kd);
      if (with_v) load16(v + g, vd);
    } else {
#pragma unroll
      for (int e = 0; e < VK; ++e) {
        kd[e] = 0.f;
        if (with_v) vd[e] = 0.f;
      }
    }
  }
  __syncthreads();
  return true;
}

// logits of rows (ty, ty + 16) x slots (tx + 16 j) into sm.lg; a masked
// entry is -inf (its e is then exactly 0).
template <bool kQuant, int D>
__device__ void tile_logits(const Smem<D>& sm, int s0, int S, float scale, int window) {
  constexpr int RS = row_stride<D>();
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[2][4] = {};
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(sm.q + ty * RS + d);
    const float4 a1 = *reinterpret_cast<const float4*>(sm.q + (ty + 16) * RS + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(sm.k + (tx + 16 * j) * RS + d);
      acc[0][j] += a0.x * b.x + a0.y * b.y + a0.z * b.z + a0.w * b.w;
      acc[1][j] += a1.x * b.x + a1.y * b.y + a1.z * b.z + a1.w * b.w;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int qp = sm.qp[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int sl = tx + 16 * j;
      float x = acc[i][j] * scale;
      if (kQuant) x *= sm.ksc[sl];
      sm.lg[r * kPS + sl] = (s0 + sl < S && sees(sm.pos[sl], qp, window)) ? x : -INFINITY;
    }
  }
}

// Query tile c0 of (batch b, kv-head bh): row r = i * tc + j (rep head i,
// query c0 + j) gets its q row, its position (-1: padding or past the
// chunk) and, from ml (null: the online softmax's start), its final m and l.
// Ends in a barrier; returns the tile's (qmax, qmin) over real rows.
template <typename QT, int D>
__device__ int2 load_queries(const Smem<D>& sm, const QT* q, const int* q_pos, const float* ml,
                             int bh, int b, int rep, int C, int c0, int tc) {
  constexpr int VQ = 16 / sizeof(QT);
  constexpr int RS = row_stride<D>();
  const int tid = threadIdx.x, rows = rep * tc;
  if (tid < kRows) {
    const int i = tid / tc, j = tid % tc;
    const bool real = tid < rows && c0 + j < C;
    const size_t at = (((size_t)bh * rep + i) * C + c0 + j) * 2;
    sm.qp[tid] = real ? q_pos[(size_t)b * C + c0 + j] : -1;
    sm.m[tid] = real && ml != nullptr ? ml[at] : kNegInf;
    sm.l[tid] = real && ml != nullptr ? ml[at + 1] : 0.f;
  }
  for (int idx = tid; idx < kRows * (D / VQ); idx += kThreads) {
    const int r = idx / (D / VQ), part = idx % (D / VQ);
    const int i = r / tc, j = r % tc;
    float* dst = sm.q + r * RS + part * VQ;
    if (r < rows && c0 + j < C) {
      load16(q + (((size_t)bh * rep + i) * C + c0 + j) * D + part * VQ, dst);
    } else {
#pragma unroll
      for (int e = 0; e < VQ; ++e) dst[e] = 0.f;
    }
  }
  __syncthreads();
  int qmax = -1, qmin = 0x7fffffff;
  for (int r = 0; r < kRows; ++r) {
    const int p = sm.qp[r];
    if (p >= 0) {
      qmax = max(qmax, p);
      qmin = min(qmin, p);
    }
  }
  return make_int2(qmax, qmin);
}

// One block per (batch, kv-head, query tile): the online softmax and out;
// with ml, each row's final m and l for the statistics launch.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
chunk_attend_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const int* __restrict__ pos,
                    const int* __restrict__ q_pos, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, QT* __restrict__ out,
                    float* __restrict__ ml, int Hkv, int rep, int C, int S, int tc,
                    float scale, int window) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  constexpr int RS = row_stride<D>();
  constexpr int DJ = D / 64;   // float4 column groups per thread, 64 apart
  extern __shared__ __align__(16) float smem_f[];
  const Smem<D> sm(smem_f);

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int rows = rep * tc;   // row r = i * tc + j: rep head i, query c0 + j
  const int c0 = blockIdx.y * tc;
  const size_t kv0 = (size_t)bh * S;
  const int2 qr = load_queries<QT, D>(sm, q, q_pos, nullptr, bh, b, rep, C, c0, tc);
  const int qmax = qr.x, qmin = qr.y;

  float acc[2][4 * DJ] = {};
  for (int s0 = 0; s0 < S; s0 += kTS) {
    if (!load_tile<KT, D>(sm, k, v, pos, k_scale, v_scale, kv0, s0, S, qmax, qmin, window,
                          true))
      continue;
    tile_logits<kQuant, D>(sm, s0, S, scale, window);
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* lr = sm.lg + r * kPS;
      const float x0 = lr[lane], x1 = lr[lane + 32];
      const float m_old = sm.m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      float e0 = x0 == -INFINITY ? 0.f : expf(x0 - m_new);
      float e1 = x1 == -INFINITY ? 0.f : expf(x1 - m_new);
      const float sum = warp_sum(e0 + e1);
      if (kQuant) {
        e0 *= sm.vsc[lane];
        e1 *= sm.vsc[lane + 32];
      }
      lr[lane] = e0;
      lr[lane + 32] = e1;
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        sm.l[r] = sm.l[r] * c + sum;
        sm.m[r] = m_new;
        sm.corr[r] = c;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float c = sm.corr[ty + 16 * i];
#pragma unroll
      for (int e = 0; e < 4 * DJ; ++e) acc[i][e] *= c;
    }
    for (int sl = 0; sl < kTS; ++sl) {
      const float p0 = sm.lg[ty * kPS + sl], p1 = sm.lg[(ty + 16) * kPS + sl];
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj) {
        const float4 w = *reinterpret_cast<const float4*>(sm.v + sl * RS + tx * 4 + 64 * jj);
        acc[0][4 * jj + 0] += p0 * w.x; acc[0][4 * jj + 1] += p0 * w.y;
        acc[0][4 * jj + 2] += p0 * w.z; acc[0][4 * jj + 3] += p0 * w.w;
        acc[1][4 * jj + 0] += p1 * w.x; acc[1][4 * jj + 1] += p1 * w.y;
        acc[1][4 * jj + 2] += p1 * w.z; acc[1][4 * jj + 3] += p1 * w.w;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ty + 16 * i;
    const int ri = r / tc, j = r % tc;
    if (r < rows && c0 + j < C) {
      const float denom = fmaxf(sm.l[r], 1e-30f);
      QT* o = out + (((size_t)bh * rep + ri) * C + c0 + j) * D;
#pragma unroll
      for (int jj = 0; jj < DJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[tx * 4 + 64 * jj + e] = from_f<QT>(acc[i][4 * jj + e] / denom);
    }
  }
  if (ml != nullptr && tid < rows && c0 + tid % tc < C) {
    const size_t at = (((size_t)bh * rep + tid / tc) * C + c0 + tid % tc) * 2;
    ml[at] = sm.m[tid];
    ml[at + 1] = sm.l[tid];
  }
}

// The statistics, one block per (batch, kv-head, tile of kTS slots): the
// tile's K rows are loaded once (every row some query of the chunk may see),
// then each query tile in turn gives exact p with its rows' final m and l,
// the GQA mean, and the tile's sums, added in query-tile order. A query tile
// that sees no slot of the tile is skipped, as is the block when no query
// does.
template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads)
chunk_stats_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                   const int* __restrict__ pos, const int* __restrict__ q_pos,
                   const float* __restrict__ k_scale, const float* __restrict__ ml,
                   float* __restrict__ ssum, float* __restrict__ ssq, float* __restrict__ last,
                   int Hkv, int rep, int C, int S, int tc, float scale, int window) {
  constexpr bool kQuant = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) float smem_f[];
  const Smem<D> sm(smem_f);
  __shared__ int q_range[2];

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int s0 = blockIdx.y * kTS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_ct = (C + tc - 1) / tc;
  const size_t kv0 = (size_t)bh * S;
  if (tid == 0) {
    q_range[0] = -1;
    q_range[1] = 0x7fffffff;
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const int p = q_pos[(size_t)b * C + c];
    if (p >= 0) {
      atomicMax(&q_range[0], p);
      atomicMin(&q_range[1], p);
    }
  }
  __syncthreads();
  if (!load_tile<KT, D>(sm, k, nullptr, pos, k_scale, nullptr, kv0, s0, S, q_range[0],
                        q_range[1], window, false))
    return;

  const bool mine = tid < kTS && s0 + tid < S;
  float sum_acc = mine ? ssum[kv0 + s0 + tid] : 0.f;
  float sq_acc = mine ? ssq[kv0 + s0 + tid] : 0.f;
  float last_p = 0.f;
  bool has_last = false;
  for (int ct = 0; ct < n_ct; ++ct) {
    const int c0 = ct * tc;
    const int2 qr = load_queries<QT, D>(sm, q, q_pos, ml, bh, b, rep, C, c0, tc);
    int any = 0;
    if (tid < kTS) {
      const int p = sm.pos[tid];
      any = p >= 0 && p <= qr.x && (window <= 0 || p > qr.y - window);
    }
    if (!__syncthreads_or(any)) continue;
    tile_logits<kQuant, D>(sm, s0, S, scale, window);
    __syncthreads();
    for (int r = warp; r < kRows; r += kThreads / 32) {
      float* lr = sm.lg + r * kPS;
      const float m = sm.m[r], denom = fmaxf(sm.l[r], 1e-30f);
      const float x0 = lr[lane], x1 = lr[lane + 32];
      lr[lane] = x0 == -INFINITY ? 0.f : expf(x0 - m) / denom;
      lr[lane + 32] = x1 == -INFINITY ? 0.f : expf(x1 - m) / denom;
    }
    __syncthreads();
    if (mine) {
      float sum = 0.f, sq = 0.f;
      for (int j = 0; j < tc && c0 + j < C; ++j) {
        float pk = 0.f;
        for (int i = 0; i < rep; ++i) pk += sm.lg[(i * tc + j) * kPS + tid];
        pk = pk / (float)rep;
        sum += pk;
        sq += pk * pk;
        if (c0 + j == C - 1) {
          last_p = pk;
          has_last = true;
        }
      }
      sum_acc += sum;
      sq_acc += sq;
    }
    __syncthreads();
  }
  if (mine) {
    ssum[kv0 + s0 + tid] = sum_acc;
    ssq[kv0 + s0 + tid] = sq_acc;
    if (has_last) last[kv0 + s0 + tid] = last_p;
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* k, const void* v, const int* pos, const int* q_pos,
           const float* k_scale, const float* v_scale, void* out, float* ssum, float* ssq,
           float* last, float* ml, int B, int Hkv, int rep, int C, int S, float scale,
           int window, cudaStream_t stream) {
  if (rep < 1 || rep > kRows || C < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (std::is_same<KT, int8_t>::value && (k_scale == nullptr || v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool scores = ssum != nullptr;
  if (scores && (ssq == nullptr || last == nullptr || ml == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tc = kRows / rep;
  const int n_ct = (C + tc - 1) / tc;
  const size_t smem = Smem<D>::bytes();
  auto attend = chunk_attend_kernel<QT, KT, D>;
  cudaError_t err = allow_smem(attend, smem);
  if (err != cudaSuccess) return (int)err;
  attend<<<dim3(B * Hkv, n_ct), kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)k, (const KT*)v, pos, q_pos, k_scale, v_scale, (QT*)out,
      scores ? ml : nullptr, Hkv, rep, C, S, tc, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || !scores) return (int)err;
  auto stats = chunk_stats_kernel<QT, KT, D>;
  err = allow_smem(stats, smem);
  if (err != cudaSuccess) return (int)err;
  stats<<<dim3(B * Hkv, (S + kTS - 1) / kTS), kThreads, smem, stream>>>(
      (const QT*)q, (const KT*)k, pos, q_pos, k_scale, ml, ssum, ssq, last, Hkv, rep, C, S, tc,
      scale, window);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_d(int D, const void* q, const void* k, const void* v, const int* pos,
             const int* q_pos, const float* k_scale, const float* v_scale, void* out,
             float* ssum, float* ssq, float* last, float* ml, int B, int Hkv, int rep, int C,
             int S, float scale, int window, cudaStream_t st) {
  if (D == 64)
    return launch<QT, KT, 64>(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last, ml,
                              B, Hkv, rep, C, S, scale, window, st);
  if (D == 128)
    return launch<QT, KT, 128>(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last,
                               ml, B, Hkv, rep, C, S, scale, window, st);
  return (int)cudaErrorInvalidValue;
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

// Dynamic shared memory one launch needs at head_dim D (64 or 128), bytes.
size_t chunk_attend_smem(int D) {
  if (D == 64) return Smem<64>::bytes();
  if (D == 128) return Smem<128>::bytes();
  return 0;
}

// q: (B, Hkv*rep, C, D), q_dtype 0 = float32, 1 = bfloat16; k, v: (B, Hkv,
// S, D) in q's type, or int8 (kv_int8 = 1) with k_scale, v_scale (B, Hkv, S)
// f32. ssum, ssq, last: (B, Hkv, S) f32 zero-filled, and ml: (B, Hkv*rep,
// C, 2) f32 scratch (each row's final softmax max and sum), or all null for
// no statistics. window <= 0: no sliding window. Every pointer of q, k, v is
// 16-byte aligned. Returns cudaGetLastError().
int chunk_attend(const void* q, const void* k, const void* v, const int* pos, const int* q_pos,
                 const float* k_scale, const float* v_scale, void* out, float* ssum, float* ssq,
                 float* last, float* ml, int B, int Hkv, int rep, int C, int S, int D,
                 float scale, int window, int q_dtype, int kv_int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  return by_types(q_dtype, kv_int8, [&](auto qt, auto kt) {
    return launch_d<decltype(qt), decltype(kt)>(D, q, k, v, pos, q_pos, k_scale, v_scale, out,
                                                ssum, ssq, last, ml, B, Hkv, rep, C, S, scale,
                                                window, st);
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
                       float* ml, int B, int Hkv, int rep, int C, int S, int D, float scale,
                       int window, int q_dtype, int kv_int8, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || S < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const int err = by_types(q_dtype, kv_int8, [&](auto it, auto ct) {
    return launch_write<decltype(it), decltype(ct)>(k_c, v_c, ids, q_pos, cinit, k, v, pos,
                                                    score, score_sq, counter, k_scale, v_scale,
                                                    B, Hkv, C, S, D, st);
  });
  if (err != 0) return err;
  return chunk_attend(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last, ml, B, Hkv,
                      rep, C, S, D, scale, window, q_dtype, kv_int8, stream);
}

// K7: one strided-encode chunk step. wmask (B, Hkv, S) int32, nonzero at
// this chunk's write slots (row r into the r-th set slot, ascending); then
// chunk_attend over the updated cache with the statistics into ssum, ssq,
// last (zero-filled) and ml; then per (batch, kv-head) the score update
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
               float* ml, int* wm_out, int B, int Hkv, int rep, int C, int S, int D,
               float scale, int window, int q_dtype, int kv_int8, int roco, int feasible_k,
               int sink, int recent_window, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (C < 1 || C > S || D < 1 || ssum == nullptr) return (int)cudaErrorInvalidValue;
  int err = by_types(q_dtype, kv_int8, [&](auto it, auto ct) {
    return launch_mask_write<decltype(it), decltype(ct)>(k_c, v_c, wmask, q_pos, cinit, k, v,
                                                         pos, score, score_sq, counter,
                                                         k_scale, v_scale, B, Hkv, C, S, D, st);
  });
  if (err != 0) return err;
  err = chunk_attend(q, k, v, pos, q_pos, k_scale, v_scale, out, ssum, ssq, last, ml, B, Hkv,
                     rep, C, S, D, scale, window, q_dtype, kv_int8, stream);
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
