// Device helpers of the one-kernel decode steps, K14 (fused_decode.cu, B = 1)
// and K15 (fused_decode_batch.cu, B rows): the layer table's products, the
// attention of one layer for every (row, KV head) pair, split into chunks of
// its slots and combined, the phase clock, and the cooperative launch of a
// step.
//
// Attention: each (row b, KV head) pair's slots split into C chunks, one
// block (or warp group) a chunk (the K1 design within a chunk,
// decode_common.cuh: rows of visible slots read once with 16-byte loads, f32
// logits in shared memory). Each chunk writes its max, its exp(logit - max)
// and their sum, and its unnormalised PV; after a grid-wide barrier the
// chunks combine (out = sum_c e^(m_c - M) PV_c / denom + p_new vn) and the
// probabilities rescale to the row's max: K15 in a phase of its own, K14 in
// its O product's input. The chunk's q, K and V come from the QKV product
// through a functor (element m of row b's QKV output), since the two
// kernels keep their product outputs in different layouts.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "decode_common.cuh"

// Phase clock (tools/torch_k14_phases.py builds a step's source with
// -DSTEP_STAMPS): block 0 reads the card's nanosecond clock once before the
// layers (after a barrier) and once after each phase's barrier (K15 9 a
// layer, K14 8), 1 + 9 L (1 + 8 L) reads in all; the source's `..._stamps`
// entry copies them out (copy_stamps). Without the flag STAMP_BEGIN, STAMP
// and STAMP_END compile to nothing.
#ifdef STEP_STAMPS
constexpr int kMaxStamps = 8192;
__device__ unsigned long long g_stamps[kMaxStamps];
__device__ int g_stamp_n;
__device__ __forceinline__ void stamp(int& n) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (n < kMaxStamps) g_stamps[n] = t;
  }
  ++n;
}
#define STAMP_BEGIN() \
  int stamp_n = 0;    \
  grid.sync();        \
  stamp(stamp_n)
#define STAMP() stamp(stamp_n)
#define STAMP_END() \
  if (blockIdx.x == 0 && threadIdx.x == 0) g_stamp_n = stamp_n

// The last launch's clock reads: copies min(n, kMaxStamps) of them to dst
// (host memory) and their count n to *n. Returns the copy's error.
inline int copy_stamps(unsigned long long* dst, int* n) {
  cudaError_t err = cudaMemcpyFromSymbol(n, g_stamp_n, sizeof(int));
  if (err != cudaSuccess) return (int)err;
  const int m = *n < kMaxStamps ? *n : kMaxStamps;
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(unsigned long long) * m);
}
#else
#define STAMP_BEGIN() ((void)0)
#define STAMP() ((void)0)
#define STAMP_END() ((void)0)
#endif

namespace fused_step {

using namespace decode_common;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;            // attention: K/V rows a lane loads at a time
constexpr int kMaxChunks = 8;         // attention chunks of one (row, KV head) pair
constexpr int kMaxBlocks = 1024;      // of the cooperative grid

constexpr int kPtrs = 10;             // per-layer pointers in the layer table

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  return decode_common::block_reduce<kMax, kWarps>(x, red);
}

// One quantized product of a layer: the fused arithmetic-int4 carrier and
// its scale pair.
struct Product {
  const int8_t* p;              // (kh, N) carrier
  const __nv_bfloat16* gs3;     // (2 gch, N) [gs_hi; gs_lo] / 16
  int kh, N, gch;
};

// Product i (0..3: wqkv, wo, wgu, wd) of a layer, from its row t of the
// layer table (kPtrs pointers: the four products as (q4a, gs3), then
// ln_attn, ln_mlp).
__device__ __forceinline__ Product layer_product(const long long* t, int i, int kh, int N,
                                                 int gch) {
  return Product{reinterpret_cast<const int8_t*>(t[2 * i]),
                 reinterpret_cast<const __nv_bfloat16*>(t[2 * i + 1]), kh, N, gch};
}

// One layer's attention inputs and outputs; B rows (K14: B = 1).
struct AttnArgs {
  const void* k;            // (L, B, Hkv, S, Dh) T or int8
  const void* v;
  const int* pos;           // (L, B, Hkv, S)
  const float* ksc;         // (L, B, Hkv, S) with an int8 cache, else null
  const float* vsc;
  const int* q_pos;         // (B,); -1: a dead row
  const int* rope_pos;      // (B,) or null: rotate at q_pos
  const float* inv_freq;    // (Dh/2,)
  void* kn;                 // (L, B, Hkv, Dh) T, rotated
  void* vn;
  float* probs;             // (L, B, Hkv, S)
  float* p_new;             // (L, B, Hkv)
  int B, Hq, Hkv, Dh, S, window;   // window <= 0: none
  float scale;
};

// The attention part of a step's workspace.
struct AttnWs {
  float* pe;      // (B, Hq, S): exp(logit - the chunk's max), 0 at masked slots
  float* stats;   // (B, Hkv, C, rep, 2): the chunk's max and sum of pe
  float* ov;      // (B, Hkv, C, rep, Dh): sum over the chunk of pe * v_scale * V
  float* lnew;    // (B, Hq): the in-flight logit (-1e30 for a dead row)
  float* vn;      // (B, Hkv, Dh): the in-flight V row, f32
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Floats of AttnWs for B rows; with base, carves it from there (each part
// 16-byte aligned).
__host__ __device__ inline size_t attn_ws_floats(int B, int Hq, int Hkv, int Dh, int S,
                                                 float* base, AttnWs* w) {
  const size_t o_pe = 0, o_st = o_pe + round4((size_t)B * Hq * S),
               o_ov = o_st + round4((size_t)B * Hq * kMaxChunks * 2),
               o_ln = o_ov + round4((size_t)B * Hq * kMaxChunks * Dh),
               o_vn = o_ln + round4((size_t)B * Hq), end = o_vn + round4((size_t)B * Hkv * Dh);
  if (w != nullptr) *w = AttnWs{base + o_pe, base + o_st, base + o_ov, base + o_ln, base + o_vn};
  return end;
}

// Chunks of each (row, KV head) pair: as many as the grid holds, 1..8.
__device__ __forceinline__ int chunks_of(int pairs) {
  const int c = (int)gridDim.x / pairs;
  return c < 1 ? 1 : (c > kMaxChunks ? kMaxChunks : c);
}

template <typename KV>
inline bool head_dim_ok(int Dh) {
  const int lpr = Dh / VecOf<KV>::n;
  return Dh % VecOf<KV>::n == 0 && Dh % 2 == 0 && lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
}

// A block's warps may split into groups of nt threads (K15 where the pairs
// outnumber the blocks); each group attends one chunk at a time, so a block
// keeps that many chunks' K / V loads in flight (a chunk's phases, each
// waiting on the one before, would otherwise leave the block waiting on one
// chunk's latency). Named barrier 1 + gid joins a group; the phases of a
// block with a producer warp beside its kThreads (K14) use these named
// barriers only.
__device__ __forceinline__ void group_sync(int gid, int nt) {
  asm volatile("bar.sync %0, %1;" ::"r"(gid + 1), "r"(nt) : "memory");
}

template <bool kMax>
__device__ __forceinline__ float group_reduce(float x, float* red, int gid, int nt) {
  const int lane = threadIdx.x & 31, warp = (int)(threadIdx.x % nt) >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  group_sync(gid, nt);
  x = lane < nt / 32 ? red[lane] : (kMax ? kNegInf : 0.f);
  x = kMax ? warp_max(x) : warp_sum(x);
  group_sync(gid, nt);
  return x;
}

// Floats of one group's chunk (nt threads; at most S slots).
template <typename KV>
__host__ __device__ inline size_t group_floats(int rep, int S, int Dh, int nt) {
  const int G = nt / (Dh / VecOf<KV>::n);
  return (size_t)rep * Dh + (size_t)rep * S + rep + nt / 32 + (size_t)G * Dh + 3 * Dh +
         (size_t)(rep + 2) * Dh;
}

// One chunk of one (row b, KV head) pair, by a group of nt threads (gid;
// K14 runs it with its 512 consumer threads as one group): q, K and V of
// the row's QKV output (qkv(m), m in [0, (Hq + 2 Hkv) Dh)), RoPE, the
// chunk's logits, its max, exp and sum, its unnormalised PV; chunk 0 also
// emits the rotated K row and the V row.
template <typename T, typename KV, class Q>
__device__ __noinline__ void attend_group(const AttnArgs& a, int l, int b, int head, int c, int C,
                                          Q qkv, const AttnWs& w, float* smem, int gid, int nt) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int V = VecOf<KV>::n;
  const int Dh = a.Dh, S = a.S, Hkv = a.Hkv, Hq = a.Hq, rep = Hq / Hkv, d2 = Dh / 2;
  const int LPR = Dh / V, G = nt / LPR, nw = nt / 32;
  const int tid = (int)(threadIdx.x % nt), lane = tid & 31, warp = tid >> 5;
  const int clen = (S + C - 1) / C, s0 = c * clen;
  const int n = S - s0 < clen ? (S - s0 > 0 ? S - s0 : 0) : clen;   // the chunk's slots
  float* qs = smem;               // rep * Dh, rotated
  float* lg = qs + rep * Dh;      // rep * clen: logits, then exp
  float* lnew = lg + rep * clen;  // rep
  float* red = lnew + rep;        // nw
  float* pv = red + nw;           // G * Dh: PV partial sums
  float* cs = pv + G * Dh;        // Dh / 2
  float* sn = cs + d2;            // Dh / 2
  float* knr = sn + d2;           // Dh: the new K row, rotated
  float* vnr = knr + Dh;          // Dh
  float* raw = vnr + Dh;          // (rep + 2) * Dh: the head's q rows, K, V before RoPE

  const int bh = b * Hkv + head;
  const size_t row0 = ((size_t)l * a.B * Hkv + bh) * S;
  const KV* kb = static_cast<const KV*>(a.k) + row0 * Dh;
  const KV* vb = static_cast<const KV*>(a.v) + row0 * Dh;
  const int* pb = a.pos + row0;
  const int qp = a.q_pos[b];
  const bool live = qp >= 0;
  const int rp = a.rope_pos != nullptr ? a.rope_pos[b] : qp;
  for (int i = tid; i < d2; i += nt) {
    const float ang = (float)max(rp, 0) * a.inv_freq[i];
    cs[i] = cosf(ang);
    sn[i] = sinf(ang);
  }
  const int nq = Hq * Dh;
  for (int i = tid; i < (rep + 2) * Dh; i += nt) {
    const int m = i < rep * Dh ? head * rep * Dh + i
                  : i < (rep + 1) * Dh ? nq + head * Dh + i - rep * Dh
                                       : nq + (Hkv + head) * Dh + i - (rep + 1) * Dh;
    raw[i] = qkv(m);
  }
  group_sync(gid, nt);
  for (int i = tid; i < (rep + 1) * Dh; i += nt) {   // q rows, then K
    const int r = i / Dh, d = i % Dh;
    const float x1 = raw[r * Dh + d % d2], x2 = raw[r * Dh + d2 + d % d2];
    const float y = d < d2 ? x1 * cs[d] - x2 * sn[d] : x2 * cs[d - d2] + x1 * sn[d - d2];
    if (r < rep) qs[i] = y; else knr[d] = y;
  }
  for (int d = tid; d < Dh; d += nt) vnr[d] = raw[(rep + 1) * Dh + d];
  group_sync(gid, nt);

  for (int r = warp; r < rep; r += nw) {
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32) acc += qs[r * Dh + d] * knr[d];
    acc = warp_sum(acc);
    if (lane == 0) lnew[r] = live ? acc * a.scale : kNegInf;
  }

  {
    const int rpw = 32 / LPR;
    const int sub = lane / LPR, li = lane % LPR;
    const int step = nw * rpw * kUnroll;
    for (int base = warp * rpw * kUnroll; base < n; base += step) {
      float kr[kUnroll][V];
      bool vis[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + base + u * rpw + sub;
        const int p = base + u * rpw + sub < n ? pb[s] : -1;
        vis[u] = p >= 0 && p <= qp && (a.window <= 0 || p > qp - a.window);
        if (vis[u]) {
          load16(kb + (size_t)s * Dh + li * V, kr[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) kr[u][j] = 0.f;
        }
      }
      for (int r = 0; r < rep; ++r) {
        const float* qr = qs + r * Dh + li * V;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) acc += qr[j] * kr[u][j];
          for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          const int i = base + u * rpw + sub;
          if (li == 0 && i < n) {
            float x = acc * a.scale;
            if (kQuant) x *= a.ksc[row0 + s0 + i];
            lg[r * clen + i] = vis[u] ? x : -INFINITY;
          }
        }
      }
    }
  }
  group_sync(gid, nt);

  // per query row: the chunk's max m, e = exp(logit - m) (0 where masked), sum e
  float* stats = w.stats + ((size_t)(bh * C + c) * rep) * 2;
  for (int r = 0; r < rep; ++r) {
    float* lr = lg + r * clen;
    float m = kNegInf;
    for (int i = tid; i < n; i += nt) m = fmaxf(m, lr[i]);
    m = group_reduce<true>(m, red, gid, nt);
    float sum = 0.f;
    float* pe = w.pe + ((size_t)b * Hq + head * rep + r) * S + s0;
    for (int i = tid; i < n; i += nt) {
      const float e = lr[i] == -INFINITY ? 0.f : expf(lr[i] - m);
      lr[i] = e;
      pe[i] = e;
      sum += e;
    }
    sum = group_reduce<false>(sum, red, gid, nt);
    if (tid == 0) {
      stats[2 * r] = m;
      stats[2 * r + 1] = sum;
    }
  }
  if (c == 0) {
    T* kn = static_cast<T*>(a.kn) + ((size_t)l * a.B * Hkv + bh) * Dh;
    T* vn = static_cast<T*>(a.vn) + ((size_t)l * a.B * Hkv + bh) * Dh;
    for (int d = tid; d < Dh; d += nt) {
      kn[d] = from_f<T>(knr[d]);
      vn[d] = from_f<T>(vnr[d]);
      w.vn[(size_t)bh * Dh + d] = vnr[d];
    }
    for (int r = tid; r < rep; r += nt) w.lnew[b * Hq + head * rep + r] = lnew[r];
  }
  group_sync(gid, nt);

  // ov[r] = sum over the chunk of (e * v_scale) V, f32
  const int li = tid % LPR, g = tid / LPR;
  for (int r = 0; r < rep; ++r) {
    const float* pr = lg + r * clen;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int base = g; base < n; base += G * kUnroll) {
      float vr[kUnroll][V];
      float wt[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * G;
        wt[u] = i < n ? pr[i] : 0.f;
        if (wt[u] != 0.f) {
          if (kQuant) wt[u] *= a.vsc[row0 + s0 + i];
          load16(vb + (size_t)(s0 + i) * Dh + li * V, vr[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) vr[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += wt[u] * vr[u][j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) pv[g * Dh + li * V + j] = acc[j];
    group_sync(gid, nt);
    float* ov = w.ov + ((size_t)(bh * C + c) * rep + r) * Dh;
    for (int d = tid; d < Dh; d += nt) {
      float o = 0.f;
      for (int j = 0; j < G; ++j) o += pv[j * Dh + d];
      ov[d] = o;
    }
    group_sync(gid, nt);
  }
}

// Query row hr (= head * rep + r) of row b over all chunks: the max M over
// the chunks and the in-flight logit, the softmax denominator, and the
// in-flight token's exp, from the chunk statistics (other blocks wrote
// them: read through L2).
__device__ __forceinline__ void row_stats(const AttnWs& w, int b, int hr, int Hq, int rep,
                                          int C, bool live, float* M, float* denom,
                                          float* e_new) {
  const int Hkv = Hq / rep, head = hr / rep, r = hr % rep;
  const float ln = __ldcg(w.lnew + (size_t)b * Hq + hr);
  const float* st0 = w.stats + ((size_t)((b * Hkv + head) * C) * rep + r) * 2;
  float m = ln;
  for (int c = 0; c < C; ++c) m = fmaxf(m, __ldcg(st0 + (size_t)c * rep * 2));
  float sum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* st = st0 + (size_t)c * rep * 2;
    sum += __ldcg(st + 1) * expf(__ldcg(st) - m);
  }
  const float en = live ? expf(ln - m) : 0.f;
  *M = m;
  *e_new = en;
  *denom = fmaxf(sum + en, 1e-30f);
}

// The chunks combined, one element a thread of the grid (grid-stride past
// its size): the attention output (B, Hq Dh) into out, out = (sum_c
// exp(m_c - M) ov_c) / denom + (e_new / denom) vn; then probs (L, B, Hkv, S)
// of layer l, each slot's e rescaled to its row's max and denominator and
// averaged over the rep query rows; then p_new (L, B, Hkv).
__device__ inline void combine_attention(const AttnArgs& a, const AttnWs& w, float* out, int l,
                                         int C) {
  const int B = a.B, Hq = a.Hq, Hkv = a.Hkv, Dh = a.Dh, S = a.S, rep = Hq / Hkv;
  const int clen = (S + C - 1) / C;
  const int n_out = Hq * Dh, n_probs = Hkv * S;
  const int per_row = n_out + n_probs + Hkv, n = B * per_row;
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gstride = gridDim.x * kThreads;
  for (int e = gtid; e < n; e += gstride) {
    const int b = e / per_row, i = e % per_row;
    const bool live = a.q_pos[b] >= 0;
    if (i < n_out) {
      const int hr = i / Dh, d = i % Dh, head = hr / rep, r = hr % rep;
      float M, denom, en;
      row_stats(w, b, hr, Hq, rep, C, live, &M, &denom, &en);
      float o = 0.f;
      for (int c = 0; c < C; ++c) {
        const size_t k = (size_t)((b * Hkv + head) * C + c) * rep + r;
        o += __ldcg(w.ov + k * Dh + d) * expf(__ldcg(w.stats + 2 * k) - M);
      }
      out[(size_t)b * n_out + i] =
          o / denom + (en / denom) * __ldcg(w.vn + ((size_t)b * Hkv + head) * Dh + d);
    } else if (i < n_out + n_probs) {
      const int j = i - n_out, head = j / S, s = j % S, c = s / clen;
      float acc = 0.f;
      for (int r = 0; r < rep; ++r) {
        float M, denom, en;
        row_stats(w, b, head * rep + r, Hq, rep, C, live, &M, &denom, &en);
        const float m_c = __ldcg(w.stats + ((size_t)((b * Hkv + head) * C + c) * rep + r) * 2);
        acc += __ldcg(w.pe + ((size_t)b * Hq + head * rep + r) * S + s) * expf(m_c - M) / denom;
      }
      a.probs[(((size_t)l * B + b) * Hkv + head) * S + s] = acc / (float)rep;
    } else {
      const int head = i - n_out - n_probs;
      float acc = 0.f;
      for (int r = 0; r < rep; ++r) {
        float M, denom, en;
        row_stats(w, b, head * rep + r, Hq, rep, C, live, &M, &denom, &en);
        acc += en / denom;
      }
      a.p_new[((size_t)l * B + b) * Hkv + head] = acc / (float)rep;
    }
  }
}

// Launches kernel(args) as one cooperative grid of kThreads-thread blocks
// with `smem` bytes of dynamic shared memory; grid <= 0: as many blocks as
// are co-resident (at most kMaxBlocks). A grid the card cannot hold at once
// is refused (cudaErrorCooperativeLaunchTooLarge). Returns the launch's
// error, or cudaGetLastError().
template <class A>
int cooperative_launch(void (*kernel)(A), A args, size_t smem, int grid, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the co-resident blocks per SM, kept per (kernel, device, shared
  // memory); the kernel's shared-memory attribute, raised to the most any
  // launch of it on the device has asked for
  struct Seen {
    const void* fn;
    int dev, per_sm, sms;
    size_t smem;
  };
  constexpr int kSeen = 64;
  static std::mutex mu;
  static Seen seen[kSeen];
  static int n_seen = 0;
  int per_sm = 0, sms = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    size_t attr = 0;
    int hit = -1;
    for (int i = 0; i < n_seen; ++i) {
      if (seen[i].fn != (const void*)kernel || seen[i].dev != dev) continue;
      attr = seen[i].smem > attr ? seen[i].smem : attr;
      if (seen[i].smem == smem) hit = i;
    }
    if (hit < 0) {
      if (n_seen == kSeen) return (int)cudaErrorInvalidValue;
      if (smem > attr && (err = cudaFuncSetAttribute(
                              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
                             cudaSuccess)
        return (int)err;
      if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                               smem)) != cudaSuccess)
        return (int)err;
      seen[n_seen++] = Seen{(const void*)kernel, dev, per_sm, sms, smem};
    } else {
      per_sm = seen[hit].per_sm;
      sms = seen[hit].sms;
    }
  }
  if (grid <= 0) {
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  }
  if (grid > kMaxBlocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* kargs[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), kargs, smem,
                                    stream);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch's error
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace fused_step
