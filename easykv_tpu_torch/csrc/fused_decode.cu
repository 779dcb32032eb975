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
//   * one persistent cooperative grid (as many blocks as are co-resident:
//     one an SM), its phases separated by grid-wide barriers, 8 a layer:
//     QKV product | attention | O product | h += O | gate|up product |
//     gate|up sums | down product | h += down; one launch a step;
//   * a product's work item is one scale group (G carrier rows) of one
//     128-column tile, done by one warp. Block b takes group b mod gch (the
//     blocks of one group take its tiles in turn, one a warp), so a block
//     builds one group's input planes in shared memory (from RMSNorm of h,
//     the combined attention, or SwiGLU), and the items of a phase go out
//     at once;
//   * the carrier stream: each of the block's first 12 warps owns a slot of
//     shared memory (~17 KB) with an mbarrier, and its lane 0 brings an
//     item into it as one box of the carrier's tensor map (no swizzle: 128
//     contiguous bytes a row, no L2 promotion, which would fetch 256; its
//     L2 lines first to go, so that the stream does not push out the
//     partials and attention state read back) and two bulk copies of its
//     scale rows, counted in bytes on the barrier: the whole phase's
//     carrier bytes are in flight at once (~200 KB an SM), where one warp's
//     direct loads kept 2 KB. The weights do not depend on the activations,
//     so as a warp finishes the gate|up product it already asks for its
//     first item of the down product, and as it finishes the down product
//     its first of the next layer's QKV product, which arrive across the
//     barrier and the reduce phase between them. (Not across the
//     attention, whose chunk shares the slots' memory and whose K / V reads
//     items asked for ahead slowed more than they saved; not from the O
//     product, whose end they held back by more than gate|up gained.) The
//     tensor maps (one per carrier, 4 L) are made once per layer table and
//     read from global memory;
//   * the dots of an item: a lane reads 4 columns of a carrier row as one
//     4-byte load from the slot, 16 rows at a time, transposes them in
//     registers (byte_perm) and feeds __dp4a against the group's planes;
//     the group's scaled sum goes to a partial per (group, column). The
//     next phase adds each column's partials (8 threads a column, in a fixed
//     order): the same sums in every run, with no atomics;
//   * attention (fused_step.cuh's attend_group, the block as one group)
//     splits each KV head's slots into C chunks (C = blocks / KV heads, at
//     most 8: 4 at 7B on 132 SMs), one block a chunk, with q, K and V summed
//     from the QKV partials; the chunks combine in the O product's input:
//     each block rebuilds its group's input elements from the chunk
//     statistics (a row table of every query head's max, denominator and
//     chunk weights), and the blocks share out probs and p_new.
// Diagnostic builds: -DK14_NO_DOTS (the items streamed, no dots),
// -DK14_EMPTY_PHASES (nothing but the barriers and the phase clock).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fused_step.cuh"
#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace decode_common;
using namespace fused_step;
using namespace tma_ring;

constexpr int kCols = 4;                  // columns of a lane in an item
constexpr int kTN = 32 * kCols;           // columns of a tile: 128 carrier bytes a row
constexpr int kQuads = 4;                 // 4-row quads a lane loads before it multiplies
constexpr float kR127 = (float)(1.0 / 127.0);
constexpr int kProducts = 4;
constexpr int kScaleBytes = 2 * kTN * 2;  // an item's two bf16 scale rows
constexpr int kMaxSlots = 12;             // warps with a slot: the most whose slots fit
constexpr int kMaxBoxRows = 256;          // rows of a tensor-map box
constexpr int kSplit = 8;                 // threads a column in the reduce phases
constexpr size_t kSmemLimit = 232448;

struct Args {
  const long long* table;   // (L, kPtrs): wqkv, wo, wgu, wd as (q4a, gs3); ln_attn, ln_mlp
  const CUtensorMap* maps;  // (L, 4): each carrier's tensor map (where tma_mask has its bit)
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
  int L, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, window, tma_mask;
  float eps, scale;
};

// ---------------------------------------------------------------------------
// the products and their items
// ---------------------------------------------------------------------------

__host__ __device__ inline int group_pad(int G) { return (G + 4 * kQuads - 1) / (4 * kQuads) * (4 * kQuads); }
__host__ __device__ inline int tiles_of(int N) { return (N + kTN - 1) / kTN; }

// Product p (0..3: wqkv, wo, wgu, wd): its carrier (kh, N) in gch groups of
// G rows, its N columns in `tiles` tiles.
struct Prod {
  int kh, N, gch, G, Gp, tiles;
};

__host__ __device__ inline Prod prod_of(int p, int D, int F, int Hq, int Hkv, int Dh, int gq,
                                        int go, int gg, int gd) {
  Prod P;
  P.kh = p == 1 ? Hq * Dh / 2 : p == 3 ? F / 2 : D / 2;
  P.N = p == 0 ? (Hq + 2 * Hkv) * Dh : p == 2 ? 2 * F : D;
  P.gch = p == 0 ? gq : p == 1 ? go : p == 2 ? gg : gd;
  P.G = P.kh / P.gch;
  P.Gp = group_pad(P.G);
  P.tiles = tiles_of(P.N);
  return P;
}

__host__ __device__ inline Prod prod_of(const Args& a, int p) {
  return prod_of(p, a.D, a.F, a.Hq, a.Hkv, a.Dh, a.gq, a.go, a.gg, a.gd);
}

// Whether product p's items can come by the tensor map and bulk copies:
// carrier rows a multiple of 16 bytes apart, scale rows of whole 16-byte
// pieces, a group within one box.
__host__ __device__ inline bool tma_ok(const Prod& P) {
  return P.N % 16 == 0 && P.G <= kMaxBoxRows;
}

// The block's share of a product: its first group j (block b mod gch, or b
// where the groups outnumber the blocks), its rank among the blocks of the
// group and their count nb; warp w of the block takes tiles rank + nb w,
// rank + nb (w + slots), ...
struct Deal {
  int j, rank, nb, jstep;
  bool spread;
};

__device__ __forceinline__ Deal deal_of(const Prod& P) {
  Deal d;
  d.spread = (int)gridDim.x >= P.gch;
  d.j = d.spread ? (int)blockIdx.x % P.gch : (int)blockIdx.x;
  d.rank = d.spread ? (int)blockIdx.x / P.gch : 0;
  d.nb = d.spread ? ((int)gridDim.x - d.j + P.gch - 1) / P.gch : 1;
  d.jstep = d.spread ? P.gch : (int)gridDim.x;
  return d;
}

// ---------------------------------------------------------------------------
// shared memory and workspace
// ---------------------------------------------------------------------------

// From a 128-byte aligned base: `slots` slots of `slot` bytes (two scale
// rows, then Gp carrier rows of kTN bytes), which the attention's chunk
// shares; their mbarriers; then the prep: xs (2 G f32), red (kWarps f32),
// sr (4 f32), the row table (Hq x (3 + kMaxChunks) f32), the planes (6 Gp
// int8) of the largest group.
struct Layout {
  size_t slot, bars, xs, red, sr, rows, planes, total;
  int slots;
};

template <typename KV>
__host__ __device__ inline Layout layout_of(int D, int F, int Hq, int Hkv, int Dh, int S, int gq,
                                            int go, int gg, int gd) {
  int gp = 0, gmax = 0;
  for (int p = 0; p < kProducts; ++p) {
    const Prod P = prod_of(p, D, F, Hq, Hkv, Dh, gq, go, gg, gd);
    gp = P.Gp > gp ? P.Gp : gp;
    gmax = P.G > gmax ? P.G : gmax;
  }
  Layout y;
  y.slot = align_to((size_t)kScaleBytes + (size_t)gp * kTN, 128);
  const size_t prep = sizeof(float) * (2 * (size_t)gmax + kWarps + 4 + (size_t)Hq * (3 + kMaxChunks)) +
                      6 * (size_t)gp;
  const size_t att = sizeof(float) * group_floats<KV>(Hq / Hkv, S, Dh, kThreads);
  const size_t fixed = 128 + align_to(prep, 16) + sizeof(uint64_t) * kMaxSlots;
  const size_t fit = fixed < kSmemLimit ? (kSmemLimit - fixed) / y.slot : 0;
  y.slots = (int)(fit > kMaxSlots ? kMaxSlots : fit < 1 ? 1 : fit);
  const size_t region = align_to((size_t)y.slots * y.slot > att ? (size_t)y.slots * y.slot : att,
                                 128);
  y.bars = region;
  y.xs = align_to(y.bars + sizeof(uint64_t) * y.slots, 16);
  y.red = y.xs + sizeof(float) * 2 * (size_t)gmax;
  y.sr = y.red + sizeof(float) * kWarps;
  y.rows = y.sr + sizeof(float) * 4;
  y.planes = y.rows + sizeof(float) * (size_t)Hq * (3 + kMaxChunks);
  y.total = 128 + y.planes + 6 * (size_t)gp;
  return y;
}

// The f32 workspace: h (D), the blocks' sums of squares of h (kMaxBlocks),
// SwiGLU (F), the attention chunks (AttnWs, for up to kMaxChunks a head),
// then the group partials of the widest product; each part 16-byte aligned.
struct Workspace {
  float *h, *ssq, *sw, *part;
};

__host__ __device__ inline size_t workspace_floats(int D, int F, int Hq, int Hkv, int Dh, int S,
                                                   int gq, int go, int gg, int gd, Workspace* w,
                                                   AttnWs* aw, float* base) {
  size_t part = 0;
  for (int p = 0; p < kProducts; ++p) {
    const Prod P = prod_of(p, D, F, Hq, Hkv, Dh, gq, go, gg, gd);
    part = (size_t)P.gch * P.N > part ? (size_t)P.gch * P.N : part;
  }
  const size_t o_h = 0, o_ss = o_h + round4(D), o_sw = o_ss + kMaxBlocks,
               o_aw = o_sw + round4(F),
               o_part = o_aw + attn_ws_floats(1, Hq, Hkv, Dh, S, nullptr, nullptr);
  if (w != nullptr) {
    *w = Workspace{base + o_h, base + o_ss, base + o_sw, base + o_part};
    attn_ws_floats(1, Hq, Hkv, Dh, S, base + o_aw, aw);
  }
  return o_part + part;
}

// ---------------------------------------------------------------------------
// the carrier stream: a slot a warp
// ---------------------------------------------------------------------------

// A warp's slot: its bytes, its barrier, the parity of its next wait,
// whether an item was asked for ahead (the warp's first of the next
// product), and the last layer whose tensor maps its lane 0 acquired.
struct Slot {
  unsigned char* st;
  uint64_t* bar;
  uint32_t parity;
  bool ahead;
  int fenced;
};

// Item (group j, tile t) of product p of layer l into the warp's slot:
// lane 0 asks the copy engine for the carrier box and the two scale rows,
// or (where no tensor map takes the product) the warp copies them itself;
// the bytes arrive on the slot's barrier.
__device__ void issue_item(const Args& a, const Prod& P, int l, int p, int j, int t, Slot& sl) {
  const int lane = threadIdx.x & 31;
  const long long* tb = a.table + (size_t)l * kPtrs;
  const int8_t* w = reinterpret_cast<const int8_t*>(tb[2 * p]);
  const __nv_bfloat16* gs = reinterpret_cast<const __nv_bfloat16*>(tb[2 * p + 1]);
  const int col = t * kTN, valid = min(kTN, P.N - col);
  const __nv_bfloat16* hi = gs + (size_t)j * P.N + col;
  const __nv_bfloat16* lo = gs + (size_t)(P.gch + j) * P.N + col;
  if ((a.tma_mask >> p) & 1) {
    if (lane == 0) {
      const CUtensorMap* maps = a.maps + (size_t)l * kProducts;
      if (sl.fenced != l) {
        for (int q = 0; q < kProducts; ++q) map_acquire(maps + q);
        sl.fenced = l;
      }
      // the slot's earlier generic writes (the attention's chunk) ordered
      // before the copy engine's
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      bar_arrive_tx(sl.bar, (uint32_t)(P.G * kTN + 4 * valid));
      bulk_copy(sl.st, hi, (uint32_t)(2 * valid), sl.bar);
      bulk_copy(sl.st + 2 * kTN, lo, (uint32_t)(2 * valid), sl.bar);
      box_copy_once(sl.st + kScaleBytes, maps + p, col, j * P.G, sl.bar);
    }
    return;
  }
  // the warp's own loads: rows of the group, zeros past `valid`
  const int8_t* src = w + (size_t)j * P.G * P.N + col;
  for (int e = lane; e < P.G * (kTN / 4); e += 32) {
    const int r = e / (kTN / 4), cb = e % (kTN / 4) * 4;
    uint32_t word = 0;
    for (int b = 0; b < 4; ++b)
      if (cb + b < valid) word |= (uint32_t)(uint8_t)src[(size_t)r * P.N + cb + b] << (8 * b);
    *reinterpret_cast<uint32_t*>(sl.st + kScaleBytes + r * kTN + cb) = word;
  }
  __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(sl.st);
  for (int c2 = lane; c2 < valid; c2 += 32) {
    sc[c2] = hi[c2];
    sc[kTN + c2] = lo[c2];
  }
  __syncwarp();
  if (lane == 0) bar_arrive(sl.bar);
}

__device__ __forceinline__ void two_planes(float x, float sr, int8_t& p1, int8_t& p2) {
  const float q = x / sr;
  const float r1 = fminf(fmaxf(rintf(q), -127.f), 127.f);
  const float r2 = fminf(fmaxf(rintf((q - r1) * 127.f), -127.f), 127.f);
  p1 = (int8_t)(int)r1;
  p2 = (int8_t)(int)r2;
}

// Group j's planes by one warp, from xs = [x_lo (G) | x_hi (G)] f32: plane i
// (A1, A2, B1, B2, C1, C2) at planes + i gch Gp + j Gp, zeros past G; its
// sr at sr[j], sr[gch + j], sr[2 gch + j].
__device__ void build_group(const float* xs, int G, int Gp, int j, int gch, int8_t* planes,
                            float* sr) {
  const int lane = threadIdx.x & 31, khp = gch * Gp;
  const float* xl = xs;
  const float* xh = xs + G;
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

// Rows r .. r + 3 of the lane's 4 columns -> 4 words, one per column, rows in
// byte order.
__device__ __forceinline__ void transpose4(const uint32_t* w, uint32_t* col) {
  const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140), t1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362), t3 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
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

// One item by one warp, from its slot `st`: the group's scaled sums of the
// lane's 4 columns (the first `valid` of the tile) to out[c] (the partials'
// row of the group, at the tile's first column). Not inlined: the loop
// keeps its own registers.
__device__ __noinline__ void stage_item(const unsigned char* st, int Gp, int valid,
                                        const int8_t* pl, int khp, float sa, float sb, float sc,
                                        float* out) {
  const int lane = threadIdx.x & 31, c0 = lane * kCols;
  if (c0 >= valid) return;
  int acc[6][kCols];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0;
  const unsigned char* wp = st + kScaleBytes + c0;
  for (int r = 0; r < Gp; r += 4 * kQuads) {
    uint32_t w[kQuads][4];
#pragma unroll
    for (int q = 0; q < kQuads; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[q][i] = *reinterpret_cast<const uint32_t*>(wp + (size_t)(r + 4 * q + i) * kTN);
    dot_rows(acc, w, pl + r, khp);
  }
  const __nv_bfloat16* ghi = reinterpret_cast<const __nv_bfloat16*>(st) + c0;
  const __nv_bfloat16* glo = ghi + kTN;
  float y[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    y[c] = 0.f;
    if (c0 + c >= valid) continue;
    const float af = ((float)acc[0][c] + (float)acc[1][c] * kR127) * sa;
    const float bf = ((float)acc[2][c] + (float)acc[3][c] * kR127) * sb;
    const float cf = ((float)acc[4][c] + (float)acc[5][c] * kR127) * sc;
    y[c] = (af + bf - cf) * __bfloat162float(ghi[c]) + cf * __bfloat162float(glo[c]);
  }
  if (c0 + kCols <= valid) {
    *reinterpret_cast<float4*>(out + c0) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
    for (int c = 0; c < valid - c0; ++c) out[c0 + c] = y[c];
  }
}


// The warp's first item of product p of layer l into its slot, ahead of
// the product's phase (the phase then takes it without asking again).
__device__ void issue_first(const Args& a, const Prod* Ps, int l, int p, Slot& sl, int slots) {
  const int warp = threadIdx.x >> 5;
  const Deal d = deal_of(Ps[p]);
  const int t = d.rank + d.nb * warp;
  if (warp < slots && d.j < Ps[p].gch && t < Ps[p].tiles) {
    issue_item(a, Ps[p], l, p, d.j, t, sl);
    sl.ahead = true;
  }
}

// A product phase of layer l: part[j][n] for every group j and column n.
// The block builds its group's planes from src(e) (element e of the
// product's input row), then each slot warp takes its items: the item's
// bytes (asked for ahead, or now), its dots, its partials. With fewer
// blocks than groups a block takes groups b, b + blocks, ... one after the
// other. Then, where `next` >= 0, each slot warp asks for its first item of
// product `next` of layer nl.
template <class Src>
__device__ void product_phase(const Args& a, const Prod* Ps, int l, int p, int nl, int next,
                              float* part, float* xs, int8_t* planes, float* sr, Src src,
                              Slot& sl, int slots) {
  const Prod& P = Ps[p];
  const int warp = threadIdx.x >> 5, G = P.G;
  const Deal d = deal_of(P);
  for (int j = d.j; j < P.gch; j += d.jstep) {
    for (int i = threadIdx.x; i < 2 * G; i += kThreads)
      xs[i] = src(i < G ? j * G + i : P.kh + j * G + i - G);
    __syncthreads();
    if (warp == 0) build_group(xs, G, P.Gp, 0, 1, planes, sr);
    __syncthreads();
    if (warp < slots) {
      for (int t = d.rank + d.nb * warp; t < P.tiles; t += d.nb * slots) {
        if (!sl.ahead) issue_item(a, P, l, p, j, t, sl);
        sl.ahead = false;
        bar_wait(sl.bar, sl.parity);
        sl.parity ^= 1;
#ifndef K14_NO_DOTS
        const int col = t * kTN;
        stage_item(sl.st, P.Gp, min(kTN, P.N - col), planes, P.Gp, sr[0], sr[1], sr[2],
                   part + (size_t)j * P.N + col);
#endif
        __syncwarp();   // the slot read: free for the next item
      }
    }
    __syncthreads();
    if (d.spread) break;
  }
  if (next >= 0) issue_first(a, Ps, nl, next, sl, slots);
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

// The combined attention: each query row's max M over the chunks and the
// in-flight logit, its denominator, the in-flight token's exp, and each
// chunk's exp(m_c - M), (Hq, 3 + kMaxChunks) in `rows`.
__device__ void row_table(const AttnArgs& at, const AttnWs& aw, int C, float* rows) {
  const int Hq = at.Hq, rep = Hq / at.Hkv;
  const bool live = at.q_pos[0] >= 0;
  for (int hr = threadIdx.x; hr < Hq; hr += kThreads) {
    float M, denom, en;
    row_stats(aw, 0, hr, Hq, rep, C, live, &M, &denom, &en);
    float* r = rows + hr * (3 + kMaxChunks);
    r[0] = M;
    r[1] = denom;
    r[2] = en;
    const int head = hr / rep, rr = hr % rep;
    for (int c = 0; c < C; ++c)
      r[3 + c] = expf(__ldcg(aw.stats + 2 * ((size_t)(head * C + c) * rep + rr)) - M);
  }
}

// Element i of the attention output: sum_c exp(m_c - M) ov_c / denom +
// (e_new / denom) vn.
__device__ __forceinline__ float attn_out(const AttnArgs& at, const AttnWs& aw, const float* rows,
                                          int C, int i) {
  const int Dh = at.Dh, rep = at.Hq / at.Hkv, hr = i / Dh, d = i % Dh, head = hr / rep,
            r = hr % rep;
  const float* rs = rows + hr * (3 + kMaxChunks);
  float o = 0.f;
  for (int c = 0; c < C; ++c)
    o += __ldcg(aw.ov + ((size_t)(head * C + c) * rep + r) * Dh + d) * rs[3 + c];
  return o / rs[1] + (rs[2] / rs[1]) * __ldcg(aw.vn + (size_t)head * Dh + d);
}

// probs (L, Hkv, S) of layer l, each slot's exp rescaled to its row's max
// and denominator and averaged over the rep query rows, and p_new (L, Hkv):
// shared out over the grid.
__device__ void probs_out(const AttnArgs& a, const AttnWs& w, const float* rows, int l, int C) {
  const int S = a.S, Hkv = a.Hkv, rep = a.Hq / Hkv, clen = (S + C - 1) / C;
  const int n = Hkv * S + Hkv;
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < n; e += gridDim.x * kThreads) {
    float acc = 0.f;
    if (e < Hkv * S) {
      const int head = e / S, s = e % S, c = s / clen;
      for (int r = 0; r < rep; ++r) {
        const float* rs = rows + (head * rep + r) * (3 + kMaxChunks);
        acc += __ldcg(w.pe + (size_t)(head * rep + r) * S + s) * rs[3 + c] / rs[1];
      }
      a.probs[((size_t)l * Hkv + head) * S + s] = acc / (float)rep;
    } else {
      const int head = e - Hkv * S;
      for (int r = 0; r < rep; ++r) {
        const float* rs = rows + (head * rep + r) * (3 + kMaxChunks);
        acc += rs[2] / rs[1];
      }
      a.p_new[(size_t)l * Hkv + head] = acc / (float)rep;
    }
  }
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const Layout lay = layout_of<KV>(a.D, a.F, a.Hq, a.Hkv, a.Dh, a.S, a.gq, a.go, a.gg, a.gd);
  cg::grid_group grid = cg::this_grid();
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.bars);
  float* xs = reinterpret_cast<float*>(sm + lay.xs);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  float* sr = reinterpret_cast<float*>(sm + lay.sr);
  float* rows = reinterpret_cast<float*>(sm + lay.rows);
  int8_t* planes = reinterpret_cast<int8_t*>(sm + lay.planes);
  float* att_smem = reinterpret_cast<float*>(sm);   // the slots' memory, between products
  const int slots = lay.slots, warp = threadIdx.x >> 5;

  Prod P[kProducts];
#pragma unroll
  for (int p = 0; p < kProducts; ++p) P[p] = prod_of(a, p);
  const int D = a.D, F = a.F, Hq = a.Hq, Hkv = a.Hkv, L = a.L, Nq = P[0].N;
  Workspace ws;
  AttnWs aw;
  workspace_floats(D, F, Hq, Hkv, a.Dh, a.S, a.gq, a.go, a.gg, a.gd, &ws, &aw, a.ws);
  const AttnArgs at{a.k, a.v, a.pos, a.ksc, a.vsc, a.q_pos, a.rope_pos, a.inv_freq, a.kn,
                    a.vn, a.probs, a.p_new, 1, Hq, Hkv, a.Dh, a.S, a.window, a.scale};
  const int C = chunks_of(Hkv);
  const T* h0 = static_cast<const T*>(a.h0);
  T* h_out = static_cast<T*>(a.h_out);

  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) bar_init(bars + i, 1);   // one arrival, with the bytes
    bar_fence_init();
  }
  __syncthreads();
  Slot sl{sm + (size_t)(warp < slots ? warp : 0) * lay.slot, bars + (warp < slots ? warp : 0),
          0u, false, -1};

  STAMP_BEGIN();
  for (int l = 0; l < L; ++l) {
    const long long* t = a.table + (size_t)l * kPtrs;
    const T* ln_attn = reinterpret_cast<const T*>(t[8]);
    const T* ln_mlp = reinterpret_cast<const T*>(t[9]);
    const bool first = l == 0, last = l == L - 1;

#ifndef K14_EMPTY_PHASES
    // QKV product of RMSNorm(h) (nothing asked for ahead: the attention's
    // chunk takes the slots' memory next)
    float r = rms_scale(ws.ssq, gridDim.x, first ? h0 : nullptr, D, a.eps, red);
    product_phase(a, P, l, 0, l, -1, ws.part, xs, planes, sr, [&](int e) {
      return (first ? to_f(h0[e]) : __ldcg(ws.h + e)) * r * to_f(ln_attn[e]);
    }, sl, slots);
#endif
    grid.sync();
    STAMP();

#ifndef K14_EMPTY_PHASES
    // attention: C chunks of each KV head's slots, one block a chunk
    const float* qkv_part = ws.part;
    const int gq = a.gq;
    for (int it = blockIdx.x; it < Hkv * C; it += gridDim.x)
      attend_group<T, KV>(at, l, 0, it / C, it % C, C,
                          [=](int m) { return group_sum(qkv_part, gq, Nq, m); }, aw, att_smem, 0,
                          kThreads);
#endif
    grid.sync();
    STAMP();

#ifndef K14_EMPTY_PHASES
    // probs and p_new; the O product of the combined attention
    row_table(at, aw, C, rows);
    __syncthreads();
    probs_out(at, aw, rows, l, C);
    product_phase(a, P, l, 1, l, -1, ws.part, xs, planes, sr,
                  [&](int e) { return attn_out(at, aw, rows, C, e); }, sl, slots);
#endif
    grid.sync();
    STAMP();
#ifndef K14_EMPTY_PHASES
    // h += the O product's sums
    float ss = reduce_columns(ws.part, a.go, D, D, 0, red, [&](int n, float y, float) {
      const float h = (first ? to_f(h0[n]) : __ldcg(ws.h + n)) + y;
      ws.h[n] = h;
      return h * h;
    });
    if (threadIdx.x == 0) ws.ssq[blockIdx.x] = ss;
#endif
    grid.sync();
    STAMP();

#ifndef K14_EMPTY_PHASES
    // gate|up product of RMSNorm(h) (down's first items asked for ahead)
    r = rms_scale(ws.ssq, gridDim.x, (const T*)nullptr, D, a.eps, red);
    product_phase(a, P, l, 2, l, 3, ws.part, xs, planes, sr,
                  [&](int e) { return __ldcg(ws.h + e) * r * to_f(ln_mlp[e]); }, sl, slots);
#endif
    grid.sync();
    STAMP();
#ifndef K14_EMPTY_PHASES
    // SwiGLU of the gate|up sums
    reduce_columns(ws.part, a.gg, 2 * F, F, F, red, [&](int i, float g, float up) {
      ws.sw[i] = g * (1.f / (1.f + expf(-g))) * up;
      return 0.f;
    });
#endif
    grid.sync();
    STAMP();

#ifndef K14_EMPTY_PHASES
    // down product of SwiGLU (the next layer's QKV items asked for ahead)
    product_phase(a, P, l, 3, l + 1, last ? -1 : 0, ws.part, xs, planes, sr,
                  [&](int e) { return __ldcg(ws.sw + e); }, sl, slots);
#endif
    grid.sync();
    STAMP();
#ifndef K14_EMPTY_PHASES
    // h += the down product's sums (and h out after the last layer)
    ss = reduce_columns(ws.part, a.gd, D, D, 0, red, [&](int n, float y, float) {
      const float h = __ldcg(ws.h + n) + y;
      ws.h[n] = h;
      if (last) h_out[n] = from_f<T>(h);
      return h * h;
    });
    if (threadIdx.x == 0) ws.ssq[blockIdx.x] = ss;
#endif
    if (!last) grid.sync();
    STAMP();
  }
  STAMP_END();
}

template <typename KV>
Layout layout_for(const Args& a) {
  return layout_of<KV>(a.D, a.F, a.Hq, a.Hkv, a.Dh, a.S, a.gq, a.go, a.gg, a.gd);
}

template <typename T, typename KV>
int launch(const Args& a, int grid, cudaStream_t stream) {
  if (!head_dim_ok<KV>(a.Dh)) return (int)cudaErrorInvalidValue;
  const Layout lay = layout_for<KV>(a);
  if (lay.total > kSmemLimit) return (int)cudaErrorInvalidValue;
  return cooperative_launch(fused_decode_kernel<T, KV>, a, lay.total, grid, stream);
}

// Blocks of one SM times the SMs (at most kMaxBlocks), or a negative error.
template <typename T, typename KV>
int grid_of(const Args& a) {
  const size_t smem = layout_for<KV>(a).total;
  if (!head_dim_ok<KV>(a.Dh) || smem > kSmemLimit) return -(int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(fused_decode_kernel<T, KV>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
          cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decode_kernel<T, KV>,
                                                           kThreads, smem)) != cudaSuccess)
    return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  return per_sm * sms < kMaxBlocks ? per_sm * sms : kMaxBlocks;
}

Args dims(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go, int gg, int gd) {
  Args a{};
  a.D = D; a.F = F; a.Hq = Hq; a.Hkv = Hkv; a.Dh = Dh; a.S = S;
  a.gq = gq; a.go = go; a.gg = gg; a.gd = gd;
  return a;
}

bool dims_ok(int D, int F, int Hq, int Hkv, int Dh, int gq, int go, int gg, int gd) {
  return Hkv >= 1 && Hq % Hkv == 0 && D % 4 == 0 && F % 4 == 0 && (Hq * Dh) % 4 == 0 &&
         gq >= 1 && go >= 1 && gg >= 1 && gd >= 1 && (D / 2) % gq == 0 &&
         (Hq * Dh / 2) % go == 0 && (D / 2) % gg == 0 && (F / 2) % gd == 0;
}

}  // namespace

extern "C" {

// Floats of the workspace one launch needs.
size_t fused_decode_step_ws(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go,
                            int gg, int gd) {
  return workspace_floats(D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, nullptr, nullptr, nullptr);
}

// Dynamic shared memory of one block, in bytes; 0 for widths the step does
// not take or a head dim the attention phase does not take (a row of 1..32
// sixteen-byte loads, a power of two). dtype: 0 = float32, 1 = bfloat16;
// kv_int8: 1 for an int8 cache.
size_t fused_decode_step_smem(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go,
                              int gg, int gd, int dtype, int kv_int8) {
  if (!dims_ok(D, F, Hq, Hkv, Dh, gq, go, gg, gd)) return 0;
  const Args a = dims(D, F, Hq, Hkv, Dh, S, gq, go, gg, gd);
  if (kv_int8) return head_dim_ok<int8_t>(Dh) ? layout_for<int8_t>(a).total : 0;
  if (dtype == 0) return head_dim_ok<float>(Dh) ? layout_for<float>(a).total : 0;
  return head_dim_ok<__nv_bfloat16>(Dh) ? layout_for<__nv_bfloat16>(a).total : 0;
}

// The warps with a carrier slot at these widths (as fused_decode_step_smem).
int fused_decode_step_slots(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go, int gg,
                            int gd, int dtype, int kv_int8) {
  const Args a = dims(D, F, Hq, Hkv, Dh, S, gq, go, gg, gd);
  if (kv_int8) return layout_for<int8_t>(a).slots;
  return dtype == 0 ? layout_for<float>(a).slots : layout_for<__nv_bfloat16>(a).slots;
}

// The blocks the launch runs when the caller leaves the grid to it: as many
// as are co-resident; a negative CUDA error where none fits.
int fused_decode_step_grid(int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go, int gg,
                           int gd, int dtype, int kv_int8) {
  if (!dims_ok(D, F, Hq, Hkv, Dh, gq, go, gg, gd)) return -(int)cudaErrorInvalidValue;
  const Args a = dims(D, F, Hq, Hkv, Dh, S, gq, go, gg, gd);
  if (dtype == 0 && kv_int8) return grid_of<float, int8_t>(a);
  if (dtype == 0) return grid_of<float, float>(a);
  if (kv_int8) return grid_of<__nv_bfloat16, int8_t>(a);
  return grid_of<__nv_bfloat16, __nv_bfloat16>(a);
}

// The tensor maps of a layer table's carriers: table (L, 10) host copy of
// the device pointers (wqkv, wo, wgu, wd as carrier and scale pair, ...),
// out (L, 4) CUtensorMap in host memory (64-byte aligned; a product whose
// items cannot come by the copy engine keeps zeros). Returns the mask of
// the products whose maps were made (bit p: product p), or a negative
// CUDA error.
int fused_decode_maps(const long long* table, int L, int D, int F, int Hq, int Hkv, int Dh,
                      int gq, int go, int gg, int gd, void* out) {
  if (L < 1 || !dims_ok(D, F, Hq, Hkv, Dh, gq, go, gg, gd)) return -(int)cudaErrorInvalidValue;
  CUtensorMap* maps = static_cast<CUtensorMap*>(out);
  int mask = 0;
  for (int p = 0; p < kProducts; ++p) {
    const Prod P = prod_of(p, D, F, Hq, Hkv, Dh, gq, go, gg, gd);
    if (!tma_ok(P)) continue;
    for (int l = 0; l < L; ++l) {
      const void* w = reinterpret_cast<const void*>(table[(size_t)l * kPtrs + 2 * p]);
      const int err = byte_map(w, P.kh, P.N, P.G, kTN, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                               maps + (size_t)l * kProducts + p);
      if (err != 0) return -err;
    }
    mask |= 1 << p;
  }
  return mask;
}

// One decode step of all L layers. table: (L, 10) device pointers per layer
// (wqkv, wo, wgu, wd as carrier and bf16 scale pair; ln_attn, ln_mlp in the
// compute dtype); maps: (L, 4) tensor maps (fused_decode_maps; products
// outside tma_mask take the warps' own loads). k, v (L, Hkv, S, Dh) in the
// compute dtype, or int8 with k_scale, v_scale (L, Hkv, S) f32 (null
// otherwise); pos (L, Hkv, S); h0 (D,); q_pos (1,); rope_pos (1,) or null;
// inv_freq (Dh/2,) f32; scale the logits' Dh^-0.5; window <= 0: no sliding
// window. Outputs: h_out (D,), kn, vn (L, Hkv, Dh) in the compute dtype,
// probs (L, Hkv, S) and p_new (L, Hkv) f32. ws: fused_decode_step_ws
// floats, 16-byte aligned. Every cache and weight pointer is 16-byte
// aligned. grid: the blocks (fused_decode_step_grid, or the caller's).
// Returns the launch's error, or cudaGetLastError().
int fused_decode_step(const long long* table, const void* maps, const void* k, const void* v,
                      const int* pos, const float* k_scale, const float* v_scale, const void* h0,
                      const int* q_pos, const int* rope_pos, const float* inv_freq, void* h_out,
                      void* kn, void* vn, float* probs, float* p_new, float* ws, int L, int D,
                      int F, int Hq, int Hkv, int Dh, int S, int gq, int go, int gg, int gd,
                      int window, int tma_mask, float eps, float scale, int dtype, int kv_int8,
                      int grid, void* stream) {
  if (L < 1 || grid < 1 || !dims_ok(D, F, Hq, Hkv, Dh, gq, go, gg, gd) ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (grid > kMaxBlocks) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args a{reinterpret_cast<const long long*>(table), static_cast<const CUtensorMap*>(maps), k, v,
         pos, k_scale, v_scale, h0, q_pos, rope_pos, inv_freq, h_out, kn, vn, probs, p_new, ws,
         L, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, window, tma_mask, eps, scale};
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
