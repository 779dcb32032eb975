// The one-kernel decode step (K14): all L layers of one B = 1 decode token
// over the fused arithmetic-int4 tree, in one cooperative launch.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/fused_decode.py
// `fused_decode_step` (one pallas_call over a (L, phases) grid). It computes
// that kernel's function, not the per-layer scan's:
//   * the residual h and every intermediate (qkv, attention out, gate|up,
//     SwiGLU) stay f32 across all layers; h is rounded to the compute dtype
//     once, at the end;
//   * each product's activation row is fed as two int8 planes per scale
//     group (the TPU kernel's default feed, `prep_lhs`): the carrier rows of
//     group j of the hi half (A = x_hi), of B = x_lo - x_hi / 16 and of
//     C = x_lo, each with its own sr = max(max|X_g|, 1e-30) * (1/127),
//     P1 = clip(rint(X / sr), +-127), P2 = clip(rint((X / sr - P1) * 127),
//     +-127);
//   * per group and column the six integer dots (A planes . p, B and C
//     planes . u, p the carrier byte 16 hi + lo, u = p << 4 = 16 lo) are
//     exact in int32; af = (ra + ra2 / 127) * sr_A (likewise bf, cf) and the
//     column adds (af + bf - cf) * gs3_hi + cf * gs3_lo over the groups;
//   * RMSNorm, RoPE at max(rope_pos or q_pos, 0), the in-flight attention
//     with GQA-mean probabilities, the O product with the residual, the
//     gate|up product, g * sigmoid(g) * up and the down product with the
//     residual, as the TPU kernel's phases do.
// Built with --fmad=false: the elementwise steps round like the plain
// PyTorch version (ops/cuda/fused_decode.py), op by op.
//
// What bounds it on an H100: bytes. A step reads every layer's carrier and
// scale pair once (3.34 GB at LLaMa-2-7B width) and each layer's visible
// K/V rows once, ~1 ms at 3.35 TB/s; the integer dots are ~3 operations a
// weight byte. The design:
//   * one persistent cooperative grid (as many blocks as are co-resident),
//     its phases separated by grid-wide barriers (cooperative_groups), 9 a
//     layer: QKV product | attention | the chunks combined | O product | h
//     += O | gate|up product | gate|up sums | down product | h += down; one
//     launch a step;
//   * a product's work item is one scale group of one 128-column tile, done
//     by one warp: a lane reads 4 columns of a row as one 4-byte load (a
//     warp reads a 128-byte row segment), 16 rows at a time, transposes
//     them in registers (byte_perm) and feeds
//     __dp4a; the group's scaled sum goes to a partial per (group, column).
//     Items go round the blocks first, so every SM streams even at N =
//     4096 (512 items). The next phase adds each column's partials (8
//     threads a column, in a fixed order): the result is the same in every
//     run, with no atomics;
//   * each block that holds an item rebuilds the product's input (RMSNorm
//     of h, the attention output, or SwiGLU of gate|up) and its int8 planes in shared
//     memory, so the prep costs no barrier;
//   * attention splits each KV head's slots into C chunks (C = blocks /
//     KV heads, at most 8: 4 at 7B on 132 SMs), one block a chunk, the K1
//     design within it (decode_common.cuh: rows of visible slots read once
//     with 16-byte loads, f32 logits in shared memory): each chunk writes
//     its max, its exp(logit - max) and their sum, and its unnormalised PV;
//     the next phase combines the chunks (out = sum_c e^(m_c - M) PV_c /
//     denom + p_new vn) and rescales the probabilities to the row's max. The
//     chunk's q, K and V are summed from the QKV partials. The chunk and
//     item functions are not inlined, so their registers do not crowd each
//     other;
//   * h, the attention output, gate|up, the attention chunks and the
//     partials live in a per-stream
//     f32 workspace, read through L2 (__ldcg) since other blocks write them
//     during the launch.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "decode_common.cuh"

namespace cg = cooperative_groups;

// Phase clock (tools/torch_k14_phases.py builds this file with
// -DK14_STAMPS): block 0 reads the card's nanosecond clock once before the
// layers (after a barrier) and once after each phase's barrier, 9 a layer,
// 1 + 9 L reads in all; fused_decode_stamps copies them out. Without the
// flag STAMP_BEGIN, STAMP and STAMP_END compile to nothing.
#ifdef K14_STAMPS
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
#else
#define STAMP_BEGIN() ((void)0)
#define STAMP() ((void)0)
#define STAMP_END() ((void)0)
#endif

namespace {

using namespace decode_common;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;              // columns of a lane in a product tile
constexpr int kTN = 32 * kCols;       // columns of a tile
constexpr int kQuads = 4;             // 4-row quads a lane loads before it multiplies
constexpr int kUnroll = 4;            // attention: K/V rows a lane loads at a time
constexpr int kPtrs = 10;             // per-layer pointers in the layer table
constexpr float kR127 = (float)(1.0 / 127.0);

struct Args {
  const long long* table;   // (L, kPtrs): wqkv, wo, wgu, wd as (q4a, gs3); ln_attn, ln_mlp
  const void* k;            // (L, Hkv, S, Dh) T or int8
  const void* v;
  const int* pos;           // (L, Hkv, S)
  const float* ksc;         // (L, Hkv, S) with an int8 cache, else null
  const float* vsc;
  const void* h0;           // (D,) T
  const int* q_pos;         // (1,)
  const int* rope_pos;      // (1,) or null: rotate at q_pos
  const float* inv_freq;    // (Dh/2,)
  void* h_out;              // (D,) T
  void* kn;                 // (L, Hkv, Dh) T, rotated
  void* vn;
  float* probs;             // (L, Hkv, S)
  float* p_new;             // (L, Hkv)
  float* ws;                // f32 workspace (struct Workspace)
  int L, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, window;
  float eps, scale;
};

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  return decode_common::block_reduce<kMax, kWarps>(x, red);
}

// ---------------------------------------------------------------------------
// products: input rows -> two int8 planes per group -> integer dots
// ---------------------------------------------------------------------------

struct Product {
  const int8_t* p;              // (kh, N) carrier
  const __nv_bfloat16* gs3;     // (2 gch, N) [gs_hi; gs_lo] / 16
  int kh, N, gch;
};

__host__ __device__ inline int group_pad(int G) { return (G + 4 * kQuads - 1) / (4 * kQuads) * (4 * kQuads); }
__host__ __device__ inline int tiles_of(int N) { return (N + kTN - 1) / kTN; }

__device__ __forceinline__ void two_planes(float x, float sr, int8_t& p1, int8_t& p2) {
  const float q = x / sr;
  const float r1 = fminf(fmaxf(rintf(q), -127.f), 127.f);
  const float r2 = fminf(fmaxf(rintf((q - r1) * 127.f), -127.f), 127.f);
  p1 = (int8_t)(int)r1;
  p2 = (int8_t)(int)r2;
}

// xs (2 kh) f32 in shared memory -> planes (6, gch * Gp) int8: A1, A2, B1,
// B2, C1, C2, group j at j * Gp, zeros past its G rows; sr (3, gch).
__device__ void build_planes(const float* xs, int kh, int gch, int8_t* planes, float* sr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = kh / gch, Gp = group_pad(G), khp = gch * Gp;
  for (int j = warp; j < gch; j += kWarps) {
    const float* xl = xs + j * G;
    const float* xh = xs + kh + j * G;
    float ma = 0.f, mb = 0.f, mc = 0.f;
    for (int i = lane; i < G; i += 32) {
      const float b = xl[i] - xh[i] * 0.0625f;
      ma = fmaxf(ma, fabsf(xh[i]));
      mb = fmaxf(mb, fabsf(b));
      mc = fmaxf(mc, fabsf(xl[i]));
    }
    const float sa = fmaxf(warp_max(ma), 1e-30f) * kR127;
    const float sb = fmaxf(warp_max(mb), 1e-30f) * kR127;
    const float sc = fmaxf(warp_max(mc), 1e-30f) * kR127;
    for (int i = lane; i < Gp; i += 32) {
      int8_t a1 = 0, a2 = 0, b1 = 0, b2 = 0, c1 = 0, c2 = 0;
      if (i < G) {
        two_planes(xh[i], sa, a1, a2);
        two_planes(xl[i] - xh[i] * 0.0625f, sb, b1, b2);
        two_planes(xl[i], sc, c1, c2);
      }
      const int o = j * Gp + i;
      planes[o] = a1;
      planes[khp + o] = a2;
      planes[2 * khp + o] = b1;
      planes[3 * khp + o] = b2;
      planes[4 * khp + o] = c1;
      planes[5 * khp + o] = c2;
    }
    if (lane == 0) {
      sr[j] = sa;
      sr[gch + j] = sb;
      sr[2 * gch + j] = sc;
    }
  }
  __syncthreads();
}

// Rows r .. r+3 of the lane's 4 columns -> 4 words, one per column, rows in
// byte order.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// One 4-byte row segment (the lane's columns), or byte loads at the ragged
// edge (zeros past `valid`).
__device__ __forceinline__ uint32_t load_seg(const int8_t* p, bool vec_ok, int valid) {
  if (vec_ok) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t word = 0;
  for (int b = 0; b < valid; ++b) word |= (uint32_t)(uint8_t)p[b] << (8 * b);
  return word;
}

// Rows r .. r + 4 kQuads of a group (zeros past its G rows).
__device__ __forceinline__ void load_rows(uint32_t (&w)[kQuads][4], const int8_t* pj, int r,
                                          int G, int N, bool vec_ok, int valid) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r + 4 * q + i;
      w[q][i] = row < G ? load_seg(pj + (size_t)row * N, vec_ok, valid) : 0u;
    }
}

// The six integer dots of rows r .. r + 4 kQuads with the planes at plr
// (plane i at plr + i * khp), for the lane's 4 columns.
__device__ __forceinline__ void dot_rows(int (&acc)[6][kCols], const uint32_t (&w)[kQuads][4],
                                         const int8_t* plr, int khp) {
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    int a[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) a[i] = *reinterpret_cast<const int*>(plr + i * khp + 4 * q);
    uint32_t col[4];
    transpose4(w[q], col);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int pc = (int)col[c];
      const int uc = (int)((col[c] << 4) & 0xF0F0F0F0u);   // 16 lo, bytewise
      acc[0][c] = __dp4a(pc, a[0], acc[0][c]);
      acc[1][c] = __dp4a(pc, a[1], acc[1][c]);
      acc[2][c] = __dp4a(uc, a[2], acc[2][c]);
      acc[3][c] = __dp4a(uc, a[3], acc[3][c]);
      acc[4][c] = __dp4a(uc, a[4], acc[4][c]);
      acc[5][c] = __dp4a(uc, a[5], acc[5][c]);
    }
  }
}

// One item of a product, by one warp: group j of the column tile, the
// lane's 4 columns, against the group's planes (plane i at pl + i * khp)
// and scales sa, sb, sc; the group's scaled sum goes to part[j][n]. Not
// inlined: the loop keeps its own registers.
__device__ __noinline__ void group_item(const Product& W, int j, int tile, const int8_t* pl,
                                        int khp, float sa, float sb, float sc, float* part) {
  const int lane = threadIdx.x & 31;
  const int G = W.kh / W.gch, Gp = group_pad(G);
  const int c0 = tile * kTN + lane * kCols;
  const int valid = min(kCols, W.N - c0);
  if (valid <= 0) return;
  const bool vec_ok = valid == kCols && (W.N % 4) == 0;
  int acc[6][kCols];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0;
  const int8_t* pj = W.p + (size_t)j * G * W.N + c0;
  for (int r = 0; r < Gp; r += 4 * kQuads) {
    uint32_t w[kQuads][4];
    if (vec_ok && r + 4 * kQuads <= G) {   // all loads issued before any is used
#pragma unroll
      for (int q = 0; q < kQuads; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[q][i] = __ldg(reinterpret_cast<const unsigned int*>(pj + (size_t)(r + 4 * q + i) * W.N));
    } else {
      load_rows(w, pj, r, G, W.N, vec_ok, valid);
    }
    dot_rows(acc, w, pl + r, khp);
  }
  float y[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    y[c] = 0.f;
    if (c >= valid) continue;
    const float af = ((float)acc[0][c] + (float)acc[1][c] * kR127) * sa;
    const float bf = ((float)acc[2][c] + (float)acc[3][c] * kR127) * sb;
    const float cf = ((float)acc[4][c] + (float)acc[5][c] * kR127) * sc;
    const float ghi = __bfloat162float(W.gs3[(size_t)j * W.N + c0 + c]);
    const float glo = __bfloat162float(W.gs3[(size_t)(W.gch + j) * W.N + c0 + c]);
    y[c] = (af + bf - cf) * ghi + cf * glo;
  }
  float* out = part + (size_t)j * W.N + c0;
  if (vec_ok) {
    *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    for (int c = 0; c < valid; ++c) out[c] = y[c];
  }
}

// A product phase: part[j][n] for every group j and column n. The blocks
// are dealt out over the groups (block b takes group b mod gch; the blocks
// of one group take its column tiles in turn, one tile a warp), so that a
// block needs one group's input: it fills xs = [x_lo | x_hi] of the group
// from src(e) (element e of the product's input row), builds the group's
// planes, then its warps take their tiles. With fewer blocks than groups a
// block takes groups b, b + blocks, ... one after the other.
template <class Src>
__device__ void product_phase(const Product& W, float* part, float* xs, int8_t* planes,
                              float* sr, Src src) {
  const int warp = threadIdx.x >> 5;
  const int G = W.kh / W.gch, Gp = group_pad(G), tiles = tiles_of(W.N);
  const bool spread = (int)gridDim.x >= W.gch;
  for (int j = spread ? (int)blockIdx.x % W.gch : (int)blockIdx.x; j < W.gch;
       j += spread ? W.gch : (int)gridDim.x) {
    const int rank = spread ? (int)blockIdx.x / W.gch : 0;
    const int nb = spread ? ((int)gridDim.x - j + W.gch - 1) / W.gch : 1;   // the group's blocks
    for (int i = threadIdx.x; i < 2 * G; i += kThreads)
      xs[i] = src(i < G ? j * G + i : W.kh + j * G + i - G);
    __syncthreads();
    build_planes(xs, G, 1, planes, sr);
    for (int t = rank + nb * warp; t < tiles; t += nb * kWarps)
      group_item(W, j, t, planes, Gp, sr[0], sr[1], sr[2], part);
    __syncthreads();
    if (spread) break;
  }
}

// y[n] of a product: its groups' partials added in group order.
__device__ __forceinline__ float group_sum(const float* part, int gch, int N, int n) {
  float s = 0.f;
#pragma unroll 16
  for (int j = 0; j < gch; ++j) s += __ldcg(part + (size_t)j * N + n);
  return s;
}

// The reduce phases. Element i (of n) of a product's output is column i of
// the partials (gch rows of N), and with pair > 0 column i + pair too; 8
// consecutive threads of the grid share it, thread k adding groups k, k +
// 8, ... in order, the 8 sums then added by a fixed shuffle pattern (the
// same in every run). fn(i, y, y2) runs on the first of the 8 and returns
// what it adds to its block's sum of squares, which every thread of the
// block gets back.
constexpr int kSplit = 8;

template <class Fn>
__device__ float reduce_columns(const float* part, int gch, int N, int n, int pair, float* red,
                                Fn fn) {
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gstride = gridDim.x * kThreads;
  const int k = gtid % kSplit, lane = gtid & 31;
  const int total = (n * kSplit + 31) & ~31;
  float ssq = 0.f;
  for (int wb = gtid - lane; wb < total; wb += gstride) {   // the whole warp loops alike
    const int i = (wb + lane) / kSplit;
    float s = 0.f, s2 = 0.f;
    if (i < n) {
      for (int j = k; j < gch; j += kSplit) {
        s += __ldcg(part + (size_t)j * N + i);
        if (pair > 0) s2 += __ldcg(part + (size_t)j * N + pair + i);
      }
    }
#pragma unroll
    for (int o = 1; o < kSplit; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (k == 0 && i < n) ssq += fn(i, s, s2);
  }
  return block_reduce<false>(ssq, red);
}

// RMSNorm's 1 / sqrt(mean(h^2) + eps), the same in every block: from the
// blocks' sums of squares (ssq, nb of them) added by warp 0 in a fixed
// order, or, with h0, from h0 itself.
template <typename T>
__device__ float rms_scale(const float* ssq, int nb, const T* h0, int D, float eps,
                           float* red) {
  float s = 0.f;
  if (h0 != nullptr) {
    for (int i = threadIdx.x; i < D; i += kThreads) s += to_f(h0[i]) * to_f(h0[i]);
    s = block_reduce<false>(s, red);
  } else {
    if (threadIdx.x < 32) {
      for (int b = threadIdx.x; b < nb; b += 32) s += __ldcg(ssq + b);
      s = warp_sum(s);
      if (threadIdx.x == 0) red[0] = s;
    }
    __syncthreads();
    s = red[0];
    __syncthreads();
  }
  return 1.f / sqrtf(s / (float)D + eps);
}

// ---------------------------------------------------------------------------
// attention: each KV head's slots split into C chunks, one block a chunk
// (the K1 design within a chunk), combined where the O product reads them
// ---------------------------------------------------------------------------

constexpr int kMaxChunks = 8;

// The attention part of the workspace.
struct AttnWs {
  float* pe;      // (Hq, S): exp(logit - the chunk's max), 0 at masked slots
  float* stats;   // (Hkv, C, rep, 2): the chunk's max and sum of pe
  float* ov;      // (Hkv, C, rep, Dh): sum over the chunk of pe * v_scale * V
  float* lnew;    // (Hq): the in-flight logit (-1e30 for a dead row)
  float* vn;      // (Hkv, Dh): the in-flight V row, f32
};

__device__ __forceinline__ int chunks_of(int Hkv) {
  const int c = (int)gridDim.x / Hkv;
  return c < 1 ? 1 : (c > kMaxChunks ? kMaxChunks : c);
}

// One chunk of one KV head: q, K and V summed from the QKV partials
// (qkv_part (gq, Nq)), RoPE, the chunk's logits, its max, exp and sum, and
// its unnormalised PV; chunk 0 also emits the rotated K row and the V row.
template <typename T, typename KV>
__device__ __noinline__ void attend_chunk(const Args& a, int l, int head, int c, int C,
                                          const float* qkv_part, const AttnWs& w, float* smem) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int V = VecOf<KV>::n;
  const int Dh = a.Dh, S = a.S, Hkv = a.Hkv, rep = a.Hq / a.Hkv, d2 = Dh / 2;
  const int LPR = Dh / V, G = kThreads / LPR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int clen = (S + C - 1) / C, s0 = c * clen;
  const int n = S - s0 < clen ? (S - s0 > 0 ? S - s0 : 0) : clen;   // the chunk's slots
  float* qs = smem;               // rep * Dh, rotated
  float* lg = qs + rep * Dh;      // rep * clen: logits, then exp
  float* lnew = lg + rep * clen;  // rep
  float* red = lnew + rep;        // kWarps
  float* pv = red + kWarps;       // G * Dh: PV partial sums
  float* cs = pv + G * Dh;        // Dh / 2
  float* sn = cs + d2;            // Dh / 2
  float* knr = sn + d2;           // Dh: the new K row, rotated
  float* vnr = knr + Dh;          // Dh
  float* raw = vnr + Dh;          // (rep + 2) * Dh: the head's q rows, K, V before RoPE

  const size_t row0 = ((size_t)l * Hkv + head) * S;
  const KV* kb = static_cast<const KV*>(a.k) + row0 * Dh;
  const KV* vb = static_cast<const KV*>(a.v) + row0 * Dh;
  const int* pb = a.pos + row0;
  const int qp = a.q_pos[0];
  const bool live = qp >= 0;
  const int rp = a.rope_pos != nullptr ? a.rope_pos[0] : qp;
  for (int i = tid; i < d2; i += kThreads) {
    const float ang = (float)max(rp, 0) * a.inv_freq[i];
    cs[i] = cosf(ang);
    sn[i] = sinf(ang);
  }
  const int nq = a.Hq * Dh, Nq = nq + 2 * Hkv * Dh;
  for (int i = tid; i < (rep + 2) * Dh; i += kThreads) {
    const int m = i < rep * Dh ? head * rep * Dh + i
                  : i < (rep + 1) * Dh ? nq + head * Dh + i - rep * Dh
                                       : nq + (Hkv + head) * Dh + i - (rep + 1) * Dh;
    raw[i] = group_sum(qkv_part, a.gq, Nq, m);
  }
  __syncthreads();
  for (int i = tid; i < (rep + 1) * Dh; i += kThreads) {   // q rows, then K
    const int r = i / Dh, d = i % Dh;
    const float x1 = raw[r * Dh + d % d2], x2 = raw[r * Dh + d2 + d % d2];
    const float y = d < d2 ? x1 * cs[d] - x2 * sn[d] : x2 * cs[d - d2] + x1 * sn[d - d2];
    if (r < rep) qs[i] = y; else knr[d] = y;
  }
  for (int d = tid; d < Dh; d += kThreads) vnr[d] = raw[(rep + 1) * Dh + d];
  __syncthreads();

  for (int r = warp; r < rep; r += kWarps) {
    float acc = 0.f;
    for (int d = lane; d < Dh; d += 32) acc += qs[r * Dh + d] * knr[d];
    acc = warp_sum(acc);
    if (lane == 0) lnew[r] = live ? acc * a.scale : kNegInf;
  }

  {
    const int rpw = 32 / LPR;
    const int sub = lane / LPR, li = lane % LPR;
    const int step = kWarps * rpw * kUnroll;
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
  __syncthreads();

  // per query row: the chunk's max m, e = exp(logit - m) (0 where masked), sum e
  float* stats = w.stats + ((size_t)(head * C + c) * rep) * 2;
  for (int r = 0; r < rep; ++r) {
    float* lr = lg + r * clen;
    float m = kNegInf;
    for (int i = tid; i < n; i += kThreads) m = fmaxf(m, lr[i]);
    m = block_reduce<true>(m, red);
    float sum = 0.f;
    float* pe = w.pe + (size_t)(head * rep + r) * S + s0;
    for (int i = tid; i < n; i += kThreads) {
      const float e = lr[i] == -INFINITY ? 0.f : expf(lr[i] - m);
      lr[i] = e;
      pe[i] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    if (tid == 0) {
      stats[2 * r] = m;
      stats[2 * r + 1] = sum;
    }
  }
  if (c == 0) {
    T* kn = static_cast<T*>(a.kn) + ((size_t)l * Hkv + head) * Dh;
    T* vn = static_cast<T*>(a.vn) + ((size_t)l * Hkv + head) * Dh;
    for (int d = tid; d < Dh; d += kThreads) {
      kn[d] = from_f<T>(knr[d]);
      vn[d] = from_f<T>(vnr[d]);
      w.vn[(size_t)head * Dh + d] = vnr[d];
    }
    for (int r = tid; r < rep; r += kThreads) w.lnew[head * rep + r] = lnew[r];
  }
  __syncthreads();

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
    __syncthreads();
    float* ov = w.ov + ((size_t)(head * C + c) * rep + r) * Dh;
    for (int d = tid; d < Dh; d += kThreads) {
      float o = 0.f;
      for (int j = 0; j < G; ++j) o += pv[j * Dh + d];
      ov[d] = o;
    }
    __syncthreads();
  }
}

// Query row hr (= head * rep + r) over all chunks: the max M over the
// chunks and the in-flight logit, the softmax denominator, and the
// in-flight token's exp, from the chunk statistics (other blocks wrote
// them: read through L2).
__device__ __forceinline__ void row_stats(const AttnWs& w, int hr, int rep, int C, bool live,
                                          float* M, float* denom, float* e_new) {
  const int head = hr / rep, r = hr % rep;
  const float ln = __ldcg(w.lnew + hr);
  float m = ln;
  for (int c = 0; c < C; ++c) m = fmaxf(m, __ldcg(w.stats + ((size_t)(head * C + c) * rep + r) * 2));
  float sum = 0.f;
  for (int c = 0; c < C; ++c) {
    const float* st = w.stats + ((size_t)(head * C + c) * rep + r) * 2;
    sum += __ldcg(st + 1) * expf(__ldcg(st) - m);
  }
  const float en = live ? expf(ln - m) : 0.f;
  *M = m;
  *e_new = en;
  *denom = fmaxf(sum + en, 1e-30f);
}

// The chunks combined, one element a thread of the grid (grid-stride past
// its size): the attention output (Hq Dh) into out, out = (sum_c
// exp(m_c - M) ov_c) / denom + (e_new / denom) vn; then probs (L, Hkv, S)
// of layer l, each slot's e rescaled to its row's max and denominator and
// averaged over the rep query rows; then p_new (L, Hkv).
__device__ void combine_attention(const Args& a, const AttnWs& w, float* out, int l, int C,
                                  bool live) {
  const int Hq = a.Hq, Hkv = a.Hkv, Dh = a.Dh, S = a.S, rep = Hq / Hkv;
  const int clen = (S + C - 1) / C;
  const int n_out = Hq * Dh, n_probs = Hkv * S, n = n_out + n_probs + Hkv;
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gstride = gridDim.x * kThreads;
  for (int i = gtid; i < n; i += gstride) {
    if (i < n_out) {
      const int hr = i / Dh, d = i % Dh, head = hr / rep, r = hr % rep;
      float M, denom, en;
      row_stats(w, hr, rep, C, live, &M, &denom, &en);
      float o = 0.f;
      for (int c = 0; c < C; ++c) {
        const size_t k = (size_t)(head * C + c) * rep + r;
        o += __ldcg(w.ov + k * Dh + d) * expf(__ldcg(w.stats + 2 * k) - M);
      }
      out[i] = o / denom + (en / denom) * __ldcg(w.vn + (size_t)head * Dh + d);
    } else if (i < n_out + n_probs) {
      const int j = i - n_out, head = j / S, s = j % S, c = s / clen;
      float acc = 0.f;
      for (int r = 0; r < rep; ++r) {
        float M, denom, en;
        row_stats(w, head * rep + r, rep, C, live, &M, &denom, &en);
        const float m_c = __ldcg(w.stats + ((size_t)(head * C + c) * rep + r) * 2);
        acc += __ldcg(w.pe + (size_t)(head * rep + r) * S + s) * expf(m_c - M) / denom;
      }
      a.probs[((size_t)l * Hkv + head) * S + s] = acc / (float)rep;
    } else {
      const int head = i - n_out - n_probs;
      float acc = 0.f;
      for (int r = 0; r < rep; ++r) {
        float M, denom, en;
        row_stats(w, head * rep + r, rep, C, live, &M, &denom, &en);
        acc += en / denom;
      }
      a.p_new[(size_t)l * Hkv + head] = acc / (float)rep;
    }
  }
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

template <typename KV>
__host__ __device__ inline size_t attn_floats(int rep, int S, int Dh) {
  const int G = kThreads / (Dh / VecOf<KV>::n);
  return (size_t)rep * Dh + (size_t)rep * S + rep + kWarps + (size_t)G * Dh + 3 * Dh +
         (size_t)(rep + 2) * Dh;
}

// Bytes of the product prep: xs (2 G f32), red (kWarps f32), sr (3 f32,
// padded to 4), planes (6 Gp int8), for the largest group of the four
// products.
__host__ __device__ inline int group_max(const Args& a) {
  const int g[4] = {a.D / 2 / a.gq, a.Hq * a.Dh / 2 / a.go, a.D / 2 / a.gg, a.F / 2 / a.gd};
  int m = g[0];
  for (int i = 1; i < 4; ++i) m = g[i] > m ? g[i] : m;
  return m;
}

__host__ __device__ inline size_t prep_bytes(const Args& a) {
  const int G = group_max(a);
  return sizeof(float) * (2 * (size_t)G + kWarps + 4) + 6 * (size_t)group_pad(G);
}

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

constexpr int kMaxBlocks = 1024;      // of the cooperative grid

// The f32 workspace: h (D), the blocks' sums of squares of h (kMaxBlocks),
// the attention output (Hq Dh), SwiGLU (F), the attention chunks (AttnWs, for
// up to kMaxChunks a head), then the group partials of the widest
// product; each part 16-byte aligned.
struct Workspace {
  float *h, *ssq, *attn, *sw, *part;
};

__host__ __device__ inline size_t workspace_floats(int D, int F, int Hq, int Hkv, int Dh, int S,
                                                   int gq, int go, int gg, int gd, Workspace* w,
                                                   AttnWs* aw, float* base) {
  const size_t Nq = (size_t)(Hq + 2 * Hkv) * Dh;
  size_t part = (size_t)gq * Nq;
  part = (size_t)go * D > part ? (size_t)go * D : part;
  part = (size_t)gg * 2 * F > part ? (size_t)gg * 2 * F : part;
  part = (size_t)gd * D > part ? (size_t)gd * D : part;
  const size_t o_h = 0, o_ss = o_h + round4(D), o_at = o_ss + kMaxBlocks,
               o_sw = o_at + round4((size_t)Hq * Dh), o_pe = o_sw + round4(F),
               o_st = o_pe + round4((size_t)Hq * S), o_ov = o_st + round4((size_t)Hq * kMaxChunks * 2),
               o_ln = o_ov + round4((size_t)Hq * kMaxChunks * Dh), o_vn = o_ln + round4(Hq),
               o_part = o_vn + round4((size_t)Hkv * Dh);
  if (w != nullptr) {
    *w = Workspace{base + o_h, base + o_ss, base + o_at, base + o_sw, base + o_part};
    *aw = AttnWs{base + o_pe, base + o_st, base + o_ov, base + o_ln, base + o_vn};
  }
  return o_part + part;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  float* xs = reinterpret_cast<float*>(smem_raw);
  float* red = xs + 2 * group_max(a);
  float* sr = red + kWarps;
  int8_t* planes = reinterpret_cast<int8_t*>(sr + 4);
  float* att_smem = reinterpret_cast<float*>(smem_raw);

  const int D = a.D, F = a.F, Dh = a.Dh, Hq = a.Hq, Hkv = a.Hkv, L = a.L;
  const int Nq = (Hq + 2 * Hkv) * Dh;
  Workspace ws;
  AttnWs aw;
  workspace_floats(D, F, Hq, Hkv, Dh, a.S, a.gq, a.go, a.gg, a.gd, &ws, &aw, a.ws);
  const int C = chunks_of(Hkv);
  const bool live = a.q_pos[0] >= 0;
  const T* h0 = static_cast<const T*>(a.h0);
  T* h_out = static_cast<T*>(a.h_out);

  STAMP_BEGIN();
  for (int l = 0; l < L; ++l) {
    const long long* t = a.table + (size_t)l * kPtrs;
    auto prod = [&](int i, int kh, int N, int gch) {
      return Product{reinterpret_cast<const int8_t*>(t[2 * i]),
                     reinterpret_cast<const __nv_bfloat16*>(t[2 * i + 1]), kh, N, gch};
    };
    const T* ln_attn = reinterpret_cast<const T*>(t[8]);
    const T* ln_mlp = reinterpret_cast<const T*>(t[9]);
    const bool first = l == 0, last = l == L - 1;

    // QKV product of RMSNorm(h)
    float r = rms_scale(ws.ssq, gridDim.x, first ? h0 : nullptr, D, a.eps, red);
    product_phase(prod(0, D / 2, Nq, a.gq), ws.part, xs, planes, sr, [&](int e) {
      return (first ? to_f(h0[e]) : __ldcg(ws.h + e)) * r * to_f(ln_attn[e]);
    });
    grid.sync();
    STAMP();

    // attention: C chunks of each KV head's slots, one block a chunk
    for (int it = blockIdx.x; it < Hkv * C; it += gridDim.x) {
      attend_chunk<T, KV>(a, l, it / C, it % C, C, ws.part, aw, att_smem);
      __syncthreads();
    }
    grid.sync();
    STAMP();

    // the chunks combined: the attention output, probs and p_new
    combine_attention(a, aw, ws.attn, l, C, live);
    grid.sync();
    STAMP();

    // O product of the attention output; then h += its sum
    product_phase(prod(1, Hq * Dh / 2, D, a.go), ws.part, xs, planes, sr,
                  [&](int e) { return __ldcg(ws.attn + e); });
    grid.sync();
    STAMP();
    float ss = reduce_columns(ws.part, a.go, D, D, 0, red, [&](int n, float y, float) {
      const float h = (first ? to_f(h0[n]) : __ldcg(ws.h + n)) + y;
      ws.h[n] = h;
      return h * h;
    });
    if (threadIdx.x == 0) ws.ssq[blockIdx.x] = ss;
    grid.sync();
    STAMP();

    // gate|up product of RMSNorm(h); then SwiGLU of its sums
    r = rms_scale(ws.ssq, gridDim.x, (const T*)nullptr, D, a.eps, red);
    product_phase(prod(2, D / 2, 2 * F, a.gg), ws.part, xs, planes, sr,
                  [&](int e) { return __ldcg(ws.h + e) * r * to_f(ln_mlp[e]); });
    grid.sync();
    STAMP();
    reduce_columns(ws.part, a.gg, 2 * F, F, F, red, [&](int i, float g, float up) {
      ws.sw[i] = g * (1.f / (1.f + expf(-g))) * up;
      return 0.f;
    });
    grid.sync();
    STAMP();

    // down product of SwiGLU; then h += its sum (and h out after the last
    // layer)
    product_phase(prod(3, F / 2, D, a.gd), ws.part, xs, planes, sr,
                  [&](int e) { return __ldcg(ws.sw + e); });
    grid.sync();
    STAMP();
    ss = reduce_columns(ws.part, a.gd, D, D, 0, red, [&](int n, float y, float) {
      const float h = __ldcg(ws.h + n) + y;
      ws.h[n] = h;
      if (last) h_out[n] = from_f<T>(h);
      return h * h;
    });
    if (threadIdx.x == 0) ws.ssq[blockIdx.x] = ss;
    if (!last) grid.sync();
    STAMP();
  }
  STAMP_END();
}

template <typename T, typename KV>
size_t smem_bytes(const Args& a) {
  const size_t prep = prep_bytes(a);
  const size_t att = sizeof(float) * attn_floats<KV>(a.Hq / a.Hkv, a.S, a.Dh);
  return prep > att ? prep : att;
}

template <typename KV>
bool head_dim_ok(int Dh) {
  const int lpr = Dh / VecOf<KV>::n;
  return Dh % VecOf<KV>::n == 0 && Dh % 2 == 0 && lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
}

// Launches the step; grid <= 0: as many blocks as are co-resident. A grid
// the card cannot hold at once is refused by the cooperative launch
// (cudaErrorCooperativeLaunchTooLarge).
template <typename T, typename KV>
int launch(Args a, int grid, cudaStream_t stream) {
  if (!head_dim_ok<KV>(a.Dh)) return (int)cudaErrorInvalidValue;
  auto kernel = fused_decode_kernel<T, KV>;
  const size_t smem = smem_bytes<T, KV>(a);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the shared-memory attribute and the co-resident blocks per SM, kept per
  // (device, shared memory) of this instantiation
  static std::mutex mu;
  static int c_dev = -1, c_per_sm = 0, c_sms = 0;
  static size_t c_smem = 0;
  int per_sm, sms;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (c_dev != dev || c_smem != smem) {
      if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      (int)smem)) != cudaSuccess ||
          (err = cudaDeviceGetAttribute(&c_sms, cudaDevAttrMultiProcessorCount, dev)) !=
              cudaSuccess ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c_per_sm, kernel, kThreads,
                                                               smem)) != cudaSuccess) {
        c_dev = -1;
        return (int)err;
      }
      c_dev = dev;
      c_smem = smem;
    }
    per_sm = c_per_sm;
    sms = c_sms;
  }
  if (grid <= 0) {
    if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid = per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
  }
  if (grid > kMaxBlocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args, smem,
                                    stream);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch's error
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" {

// Floats of the workspace one launch needs.
size_t fused_decode_step_ws(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go,
                            int gg, int gd) {
  return workspace_floats(D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, nullptr, nullptr, nullptr);
}

// Dynamic shared memory of one block, in bytes; 0 for a head dim the
// attention phase does not take (a row of 1..32 sixteen-byte loads, a power
// of two). dtype: 0 = float32, 1 = bfloat16; kv_int8: 1 for an int8 cache.
size_t fused_decode_step_smem(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go,
                              int gg, int gd, int dtype, int kv_int8) {
  Args a{};
  a.D = D; a.F = F; a.Hq = Hq; a.Hkv = Hkv; a.Dh = Dh; a.S = S;
  a.gq = gq; a.go = go; a.gg = gg; a.gd = gd;
  if (kv_int8) return head_dim_ok<int8_t>(Dh) ? smem_bytes<float, int8_t>(a) : 0;
  if (dtype == 0) return head_dim_ok<float>(Dh) ? smem_bytes<float, float>(a) : 0;
  return head_dim_ok<__nv_bfloat16>(Dh) ? smem_bytes<__nv_bfloat16, __nv_bfloat16>(a) : 0;
}

// One decode step of all L layers. table: (L, 10) device pointers per layer
// (wqkv, wo, wgu, wd as carrier and bf16 scale pair; ln_attn, ln_mlp in the
// compute dtype). k, v (L, Hkv, S, Dh) in the compute dtype, or int8 with
// k_scale, v_scale (L, Hkv, S) f32 (null otherwise); pos (L, Hkv, S); h0
// (D,); q_pos (1,); rope_pos (1,) or null; inv_freq (Dh/2,) f32; scale
// the logits' Dh^-0.5; window <= 0: no sliding window. Outputs:
// h_out (D,), kn, vn (L, Hkv, Dh) in the compute dtype, probs (L, Hkv, S)
// and p_new (L, Hkv) f32. ws: fused_decode_step_ws floats, 16-byte aligned.
// Every cache and weight pointer is 16-byte aligned. Returns the launch's
// error, or cudaGetLastError().
int fused_decode_step(const long long* table, const void* k, const void* v, const int* pos,
                      const float* k_scale, const float* v_scale, const void* h0,
                      const int* q_pos, const int* rope_pos, const float* inv_freq,
                      void* h_out, void* kn, void* vn, float* probs, float* p_new, float* ws,
                      int L, int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go,
                      int gg, int gd, int window, float eps, float scale, int dtype,
                      int kv_int8, int grid, void* stream) {
  if (L < 1 || Hkv < 1 || Hq % Hkv != 0 || D % 4 || F % 4 || (Hq * Dh) % 4 || gq < 1 ||
      go < 1 || gg < 1 || gd < 1 || (D / 2) % gq || (Hq * Dh / 2) % go || (D / 2) % gg ||
      (F / 2) % gd || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{reinterpret_cast<const long long*>(table), k, v, pos, k_scale, v_scale, h0, q_pos,
         rope_pos, inv_freq, h_out, kn, vn, probs, p_new, ws,
         L, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, window, eps, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && kv_int8) return launch<float, int8_t>(a, grid, st);
  if (dtype == 0) return launch<float, float>(a, grid, st);
  if (dtype == 1 && kv_int8) return launch<__nv_bfloat16, int8_t>(a, grid, st);
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, grid, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef K14_STAMPS
// The last launch's clock reads: copies min(n, kMaxStamps) of them to dst
// (host memory) and their count n to *n. Returns the copy's error.
int fused_decode_stamps(unsigned long long* dst, int* n) {
  cudaError_t err = cudaMemcpyFromSymbol(n, g_stamp_n, sizeof(int));
  if (err != cudaSuccess) return (int)err;
  const int m = *n < kMaxStamps ? *n : kMaxStamps;
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, sizeof(unsigned long long) * m);
}
#endif

}  // extern "C"
