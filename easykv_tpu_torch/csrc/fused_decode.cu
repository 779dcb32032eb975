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
//   * attention (fused_step.cuh, shared with K15) splits each KV head's
//     slots into C chunks (C = blocks / KV heads, at most 8: 4 at 7B on 132
//     SMs), one block a chunk, the K1 design within it (rows of visible
//     slots read once with 16-byte loads, f32 logits in shared memory): each chunk writes
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

#include "fused_step.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode_common;
using namespace fused_step;

constexpr int kCols = 4;              // columns of a lane in a product tile
constexpr int kTN = 32 * kCols;       // columns of a tile
constexpr int kQuads = 4;             // 4-row quads a lane loads before it multiplies
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

// ---------------------------------------------------------------------------
// products: input rows -> two int8 planes per group -> integer dots
// ---------------------------------------------------------------------------

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
// the step
// ---------------------------------------------------------------------------

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
               o_sw = o_at + round4((size_t)Hq * Dh), o_aw = o_sw + round4(F),
               o_part = o_aw + attn_ws_floats(1, Hq, Hkv, Dh, S, nullptr, nullptr);
  if (w != nullptr) {
    *w = Workspace{base + o_h, base + o_ss, base + o_at, base + o_sw, base + o_part};
    attn_ws_floats(1, Hq, Hkv, Dh, S, base + o_aw, aw);
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
  const AttnArgs at{a.k, a.v, a.pos, a.ksc, a.vsc, a.q_pos, a.rope_pos, a.inv_freq, a.kn,
                    a.vn, a.probs, a.p_new, 1, Hq, Hkv, Dh, a.S, a.window, a.scale};
  const int C = chunks_of(Hkv);
  const T* h0 = static_cast<const T*>(a.h0);
  T* h_out = static_cast<T*>(a.h_out);

  STAMP_BEGIN();
  for (int l = 0; l < L; ++l) {
    const long long* t = a.table + (size_t)l * kPtrs;
    const T* ln_attn = reinterpret_cast<const T*>(t[8]);
    const T* ln_mlp = reinterpret_cast<const T*>(t[9]);
    const bool first = l == 0, last = l == L - 1;

    // QKV product of RMSNorm(h)
    float r = rms_scale(ws.ssq, gridDim.x, first ? h0 : nullptr, D, a.eps, red);
    product_phase(layer_product(t, 0, D / 2, Nq, a.gq), ws.part, xs, planes, sr, [&](int e) {
      return (first ? to_f(h0[e]) : __ldcg(ws.h + e)) * r * to_f(ln_attn[e]);
    });
    grid.sync();
    STAMP();

    // attention: C chunks of each KV head's slots, one block a chunk
    const float* qkv_part = ws.part;
    const int gq = a.gq;
    for (int it = blockIdx.x; it < Hkv * C; it += gridDim.x) {
      attend_chunk<T, KV>(at, l, 0, it / C, it % C, C,
                          [=](int m) { return group_sum(qkv_part, gq, Nq, m); }, aw, att_smem);
      __syncthreads();
    }
    grid.sync();
    STAMP();

    // the chunks combined: the attention output, probs and p_new
    combine_attention(at, aw, ws.attn, l, C);
    grid.sync();
    STAMP();

    // O product of the attention output; then h += its sum
    product_phase(layer_product(t, 1, Hq * Dh / 2, D, a.go), ws.part, xs, planes, sr,
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
    product_phase(layer_product(t, 2, D / 2, 2 * F, a.gg), ws.part, xs, planes, sr,
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
    product_phase(layer_product(t, 3, F / 2, D, a.gd), ws.part, xs, planes, sr,
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

// Launches the step; grid <= 0: as many blocks as are co-resident.
template <typename T, typename KV>
int launch(Args a, int grid, cudaStream_t stream) {
  if (!head_dim_ok<KV>(a.Dh)) return (int)cudaErrorInvalidValue;
  return cooperative_launch(fused_decode_kernel<T, KV>, a, smem_bytes<T, KV>(a), grid, stream);
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

#ifdef STEP_STAMPS
// The last launch's clock reads (fused_step.cuh's phase clock).
int fused_decode_stamps(unsigned long long* dst, int* n) { return copy_stamps(dst, n); }
#endif

}  // extern "C"
