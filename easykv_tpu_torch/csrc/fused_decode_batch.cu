// The batched one-kernel decode step (K15): all L layers of one decode token
// at B rows (1 < B <= 16) over the fused arithmetic-int4 tree, in one
// cooperative launch.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/fused_decode_batch.py
// `fused_decode_step_batch` (one pallas_call over a (L, phases) grid). It
// computes that kernel's function, not the per-layer scan's:
//   * the residual h and every intermediate (qkv, attention out, gate|up,
//     SwiGLU) stay f32 across all layers; h is rounded to the compute dtype
//     once, at the end;
//   * each product's input row x (f32) is fed per scale group j as three
//     rows rounded to the compute dtype (the TPU kernel's `prep_lhs`):
//     A = x_hi, B = x_lo - x_hi / 16 (formed in f32, then rounded) and
//     C = x_lo; A is dotted with the carrier byte p (16 hi + lo), B and C
//     with u = (p << 4) as int8 = 16 lo, each dot summed in f32, and the
//     column adds hi_j (A.p + B.u - C.u) + lo_j C.u over the groups (the
//     scale pair gs3 = [hi; lo] / 16). With an f32 compute dtype nothing
//     rounds;
//   * RMSNorm, RoPE at max(rope_pos or q_pos, 0) per row, the in-flight
//     attention with GQA-mean probabilities (fused_step.cuh, shared with
//     K14), the O product with the residual, the gate|up product,
//     g * sigmoid(g) * up and the down product with the residual.
// Built with --fmad=false: the elementwise steps round like the plain
// PyTorch version (ops/cuda/fused_decode_batch.py), op by op.
//
// What bounds it on an H100: bytes. A step reads every layer's carrier,
// scale pair and norms once (3.340 GB at LLaMa-2-7B width) and each row's
// visible K/V rows once: at S = 768 with 712 visible slots, 4.83 GB at B = 4
// and 9.31 GB at B = 16 with a bf16 cache (1.44 / 2.78 ms at 3.35 TB/s),
// 4.11 / 6.42 GB with an int8 one. Each carrier byte feeds 3 B multiply-adds
// (1.6e11 a step at B = 16, >= 4.6 ms on the CUDA cores), so the products
// run on the tensor cores. The design:
//   * one persistent cooperative grid, 9 phases a layer separated by
//     grid-wide barriers, as K14: QKV product | attention chunks | the
//     chunks combined | O product | h += O | gate|up product | SwiGLU | down
//     product | h += down;
//   * products: mma.sync m16n8k16, bf16 in, f32 accumulate, with the weights
//     as the 16-row operand (16 columns of a tile) and the feed as the
//     8-column one (8 rows of the batch; B padded with zero rows to 8 or 16,
//     one or two MMAs). p and u are small integers, exact in bf16; an f32
//     feed is split into three bf16 limbs (x = l1 + l2 + l3 exactly), three
//     MMAs for one. A lane holds 4 columns of 4 carrier rows; the rows are
//     the MMA's k slots 2q, 2q + 1, 2q + 8, 2q + 9 (the feed is read in the
//     same order: a dot's sum is the same in any order of its terms). A
//     byte becomes bf16 through the f32 exponent (0x4B000000 | (p ^ 0x80),
//     minus 2^23 + 128, the top half);
//   * the carrier streams through a ring of kRing = 3 stages per warp in
//     shared memory (104 KB a block beside the <= 96 KB feed): a stage is
//     64 rows of the warp's 32-column tile, copied by 16-byte cp.async into
//     a bank-swizzled layout, with the group's scale pair for the tile
//     beside the group's last stage; each stage consumed issues the one two
//     ahead, so ~64 KB an SM stay in flight, and the lanes read their
//     fragment words from shared memory. The products' sums are those of
//     direct loads, bit for bit. (Issuing a product's first stages before
//     the grid-wide barrier that precedes it was measured slower, and is
//     not done.) A diagnostic build (-DK15_NO_MMA) leaves the products'
//     arithmetic out, to time the stream alone;
//   * a warp's item is a run of R scale groups of one 32-column tile (two
//     MMA tiles): per group the f32 sums A.p + B.u and C.u, then
//     hi (first - second) + lo second into the item's f32 result, which
//     goes to a partial per (run, row, column). Each block builds the feed
//     of one run's groups for all B rows in shared memory (at most 96 KB),
//     so the prep costs no barrier. plan_of picks R per product from the
//     grid so that the items fill the warps and the partials stay small; at
//     7B on 132 SMs, B = 16: wqkv 4 runs of 4 groups, wo 16 runs of 1, wgu
//     3 runs of 6, wd 15 runs of 3: 15.5 MB of partials a layer (0.50 GB a
//     step) written and read back through L2, against 3.24 GB of carriers;
//     B = 4 (wqkv then 16 runs of 1): 0.20 GB a step;
//   * the next phase adds each (row, column)'s partials in run order, one
//     element a thread: the result is the same in every run, with no
//     atomics; it also adds each block's sum of squares of each row, which
//     the next RMSNorm adds over the blocks in a fixed order;
//   * attention: B Hkv (row, KV head) pairs, C chunks of slots each, one
//     warp group a chunk (attend_group: fused_step.cuh's chunk for a group
//     of nt threads on a named barrier; at nt = 512, the whole block, it
//     sums as K14 does, bit for bit). While the pairs fit the grid, a group
//     is the whole block and C = blocks / pairs, 1..8. Where the pairs
//     outnumber the blocks (7B with B >= 5 on 132 SMs), a block's warps
//     split into groups of 128 threads (fewer, larger groups where four
//     chunks' shared memory would not fit), each attending a chunk of its
//     own, so that a block has up to four chunks' loads in flight instead
//     of waiting on one chunk's phases at a time;
//   * h, the attention output, SwiGLU, the attention chunks, the sums of
//     squares and the partials live in a per-stream f32 workspace, read
//     through L2 (__ldcg) since other blocks write them during the launch.
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

constexpr int kMaxB = 16;                 // rows of one launch
constexpr int kTN = 32;                   // columns of a warp's tile: two MMA tiles
constexpr size_t kActBytes = 96 * 1024;   // shared memory of a block's feed
constexpr size_t kSmallBytes = 2048;      // rs (kMaxB) and red (kWarps kMaxB) floats before it
constexpr int kStageRows = 64;            // carrier rows of a ring stage: four k-steps
constexpr int kStageBytes = kStageRows * kTN;
constexpr int kSlotBytes = kStageBytes + 128;   // a stage and its group's scale pair
constexpr int kRing = 3;                  // stages of a warp's ring
constexpr size_t kRingBytes = (size_t)kWarps * kRing * kSlotBytes;

// A debug build's record of the step's f32 intermediates
// (tools/torch_k15_ulps.py builds this source with -DSTEP_DUMP): stage s of
// layer l, row b, element i goes to g_dump[((l kStages + s) B + b) g_dump_w
// + i], the stages in the order of the layer: 0 the QKV product's input
// (RMSNorm), 1 its sums, 2 the O product's input (attention), 3 h after the
// O product, 4 the gate|up product's input (RMSNorm), 5 its sums (gate, then
// up), 6 the down product's input (SwiGLU), 7 h after the down product. A
// stage is written where the kernel forms it, with the value it uses; the
// arithmetic is the same as without the flag. Without it DUMP is nothing.
#ifdef STEP_DUMP
constexpr int kStages = 8;
__device__ float* g_dump;
__device__ int g_dump_w;
#define DUMP(l, s, B, b, i, x) \
  (g_dump[(((size_t)(l) * kStages + (s)) * (B) + (b)) * g_dump_w + (i)] = (x))
#else
#define DUMP(l, s, B, b, i, x) ((void)0)
#endif

struct Args {
  const long long* table;   // (L, kPtrs): wqkv, wo, wgu, wd as (q4a, gs3); ln_attn, ln_mlp
  const void* h0;           // (B, D) T
  void* h_out;              // (B, D) T
  float* ws;                // f32 workspace (struct Workspace)
  AttnArgs at;
  int L, D, F, gq, go, gg, gd;
  float eps;
};

// ---------------------------------------------------------------------------
// the plan of a product: runs of groups, the feed's shared-memory layout
// ---------------------------------------------------------------------------

__host__ __device__ inline int gpad(int G) { return (G + 15) / 16 * 16; }
__host__ __device__ inline int pad_rows(int B) { return B <= 8 ? 8 : 16; }
__host__ __device__ inline int tiles_of(int N) { return (N + kTN - 1) / kTN; }

// Elements between two batch rows of one feed vector holding `rows` carrier
// rows: each row starts 32 (bf16) or 64 (f32) bytes past a 128-byte line,
// so that the fragment loads of a half (bf16) or quarter (f32) warp hit
// distinct banks.
template <typename T>
__host__ __device__ inline int act_stride(int rows) {
  return sizeof(T) == 2 ? (rows + 63) / 64 * 64 + 16 : (rows + 31) / 32 * 32 + 16;
}

// Bytes of the feed: three vectors (A, B, C) of Bp rows.
template <typename T>
__host__ __device__ inline size_t act_bytes(int rows, int Bp) {
  return 3 * (size_t)Bp * act_stride<T>(rows) * sizeof(T);
}

// Most groups a block's feed holds within kActBytes (at least 1).
template <typename T>
__host__ __device__ inline int max_run(int G, int gch, int Bp) {
  int R = 1;
  while (R < gch && act_bytes<T>((R + 1) * gpad(G), Bp) <= kActBytes) ++R;
  return R;
}

struct Plan {
  int R, nr;   // groups a run, runs
};

// The run length of a product on `blocks` blocks: block b takes run b mod
// nr (with fewer blocks than runs, runs b, b + blocks, ...), its warps the
// run's column tiles in turn. The cost of a run length is the slowest
// warp's carrier rows plus its partial traffic (a partial's write and read
// count as 8 B rows of 32 bytes); the cheapest wins, the longer run on a
// tie. Host and device compute the same plan.
template <typename T>
__host__ __device__ inline Plan plan_of(int kh, int N, int gch, int B, int blocks) {
  const int G = kh / gch, Gp = gpad(G), nt = tiles_of(N);
  Plan best{1, gch};
  long long best_cost = -1;
  for (int R = max_run<T>(G, gch, pad_rows(B)); R >= 1; --R) {
    const int nr = (gch + R - 1) / R;
    const int per_block = (nr + blocks - 1) / blocks;
    const int warps = (blocks >= nr ? blocks / nr : 1) * kWarps;
    const long long cost = (long long)per_block * ((nt + warps - 1) / warps) * (R * Gp + 8 * B);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = Plan{R, nr};
    }
  }
  return best;
}

// ---------------------------------------------------------------------------
// products: a run of groups of a 32-column tile on the tensor cores
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T to_feed(float x);
template <> __device__ __forceinline__ float to_feed<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 to_feed<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The feed's fragment of 4 consecutive carrier rows of one batch row (the
// MMA's k slots 2q, 2q + 1 | 2q + 8, 2q + 9): one bf16 limb, or three of
// an f32 feed (x = l1 + l2 + l3 exactly).
__device__ __forceinline__ void load_feed(const __nv_bfloat16* p, uint32_t (&f)[1][2]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  f[0][0] = v.x;
  f[0][1] = v.y;
}
__device__ __forceinline__ void load_feed(const float* p, uint32_t (&f)[3][2]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  float r[4] = {v.x, v.y, v.z, v.w};
  __nv_bfloat16 l[3][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      l[k][i] = __float2bfloat16_rn(r[i]);
      r[i] = r[i] - __bfloat162float(l[k][i]);
    }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    f[k][0] = pack_bf16(l[k][0], l[k][1]);
    f[k][1] = pack_bf16(l[k][2], l[k][3]);
  }
}

// Byte j of x (a carrier or u word with each byte's sign bit flipped) as
// an f32: 2^23 + (v + 128) - (2^23 + 128) = v, exact.
__device__ __forceinline__ float byte_value(uint32_t x, int j) {
  return __int_as_float((int)__byte_perm(x, 0x4B000000u, 0x7440u | j)) - 8388736.f;
}

// Two integer-valued f32 (|v| <= 128) as bf16x2: their top halves, exact.
__device__ __forceinline__ uint32_t pack_top(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// The weight fragment of MMA tile t: columns 2t (slot g) and 2t + 1 (slot
// g + 8) of the lane's 4, rows 4q, 4q + 1 (k slots 2q, 2q + 1) and 4q + 2,
// 4q + 3 (k slots 2q + 8, 2q + 9) from the lane's words x[0..3].
__device__ __forceinline__ void weight_frag(const uint32_t (&x)[4], int t, uint32_t (&a)[4]) {
  a[0] = pack_top(byte_value(x[0], 2 * t), byte_value(x[1], 2 * t));
  a[1] = pack_top(byte_value(x[0], 2 * t + 1), byte_value(x[1], 2 * t + 1));
  a[2] = pack_top(byte_value(x[2], 2 * t), byte_value(x[3], 2 * t));
  a[3] = pack_top(byte_value(x[2], 2 * t + 1), byte_value(x[3], 2 * t + 1));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One 16-row k-step of the lane's two MMA tiles: w the lane's 4 carrier
// words (rows 4q .. 4q + 3), f the feed at the k-step's rows 4q .. (vector
// v, batch row b at f + (v Bp + b) stride). acc += A.p + B.u, acc_c += C.u.
template <typename T, int kNb>
__device__ __forceinline__ void mma_step(const uint32_t (&w)[4], const T* f, int stride, int Bp,
                                         float (&acc)[2][kNb][4], float (&acc_c)[2][kNb][4]) {
  constexpr int kLimbs = sizeof(T) == 4 ? 3 : 1;
  const int g = (threadIdx.x & 31) >> 2;
  uint32_t fa[kNb][kLimbs][2], fb[kNb][kLimbs][2], fc[kNb][kLimbs][2];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
    const T* r = f + (size_t)(8 * nb + g) * stride;
    load_feed(r, fa[nb]);
    load_feed(r + (size_t)Bp * stride, fb[nb]);
    load_feed(r + (size_t)2 * Bp * stride, fc[nb]);
  }
  uint32_t x[4], y[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[i] = w[i] ^ 0x80808080u;                           // p
    y[i] = ((w[i] << 4) & 0xF0F0F0F0u) ^ 0x80808080u;    // u = 16 lo, bytewise
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    uint32_t pa[4], ua[4];
    weight_frag(x, t, pa);
    weight_frag(y, t, ua);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int k = 0; k < kLimbs; ++k) {
        mma(acc[t][nb], pa, fa[nb][k]);
        mma(acc[t][nb], ua, fb[nb][k]);
        mma(acc_c[t][nb], ua, fc[nb][k]);
      }
  }
}

// ---------------------------------------------------------------------------
// the carrier ring: each warp streams its items' carrier tiles, and each
// group's scale pair, through kRing stages of its own in shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory: the first n (16 or 0) from src, zeros after.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// The oldest stage in flight has landed (kRing - 2 younger ones may not).
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
}

// Byte offset in a stage of 16-byte chunk h (columns 16 h .. 16 h + 15) of
// carrier row r: rows in 128-byte lines of four, the chunk slots of a line
// XOR-swizzled by the line, so that the 4-byte fragment reads of a warp
// (rows 4q + i of a k-step, columns 4g .. 4g + 3) hit 32 distinct banks.
__device__ __forceinline__ int chunk_off(int r, int h) {
  const int line = r >> 2;
  return line * 128 + (((((r & 3) << 1) | h) ^ ((line & 3) << 1)) << 4);
}

// A product as one block's warps walk it (product_phase's loops): the
// plan's runs, the blocks of a run and this block's rank among them.
struct Walker {
  Product W;
  int G, Gp, steps, spg, nt, nr, R, nb, rank, nbr;   // spg: ring stages a group
  bool spread, async;                                // async: 16-byte copies (N % 16 == 0)
};

template <typename T>
__device__ Walker walker_of(const Product& W, int B) {
  Walker P;
  P.W = W;
  P.G = W.kh / W.gch;
  P.Gp = gpad(P.G);
  P.steps = P.Gp / 16;
  P.spg = (P.steps + 3) / 4;
  P.nt = tiles_of(W.N);
  P.nb = gridDim.x;
  const Plan pl = plan_of<T>(W.kh, W.N, W.gch, B, P.nb);
  P.nr = pl.nr;
  P.R = pl.R;
  P.spread = P.nb >= pl.nr;
  const int r = P.spread ? (int)blockIdx.x % P.nr : (int)blockIdx.x;
  P.rank = P.spread ? (int)blockIdx.x / P.nr : 0;
  P.nbr = P.spread ? (P.nb - r + P.nr - 1) / P.nr : 1;
  P.async = (W.N & 15) == 0;
  return P;
}

// A place in a warp's walk over its stages: run r, tile t, group jj of the
// run, stage u of the group; ok while there is one.
struct Pos {
  int r, t, jj, u;
  bool ok;
};

__device__ __forceinline__ Pos walk_begin(const Walker& P) {
  Pos p;
  p.r = P.spread ? (int)blockIdx.x % P.nr : (int)blockIdx.x;
  p.t = P.rank * kWarps + (int)(threadIdx.x >> 5);
  p.jj = p.u = 0;
  p.ok = p.r < P.nr && p.t < P.nt;
  return p;
}

__device__ __forceinline__ void walk_next(const Walker& P, Pos& p) {
  if (++p.u < P.spg) return;
  p.u = 0;
  if (++p.jj < min(P.R, P.W.gch - p.r * P.R)) return;
  p.jj = 0;
  p.t += P.nbr * kWarps;
  if (p.t < P.nt) return;
  p.t = P.rank * kWarps + (int)(threadIdx.x >> 5);
  p.r += P.nb;
  p.ok = !P.spread && p.r < P.nr;
}

// Stage p of the walk into a ring slot: the 64 carrier rows of the tile's
// 32 columns (zeros past the group's G rows and past N) and, with the
// group's last stage, the tile's scale pair (the hi row's 32 bf16, then the
// lo row's). Lane l copies 16-byte chunk l % 2 of rows l / 2 + 16 i. By
// cp.async where N is a multiple of 16, else by the lanes' own loads (a
// ragged width).
__device__ __forceinline__ void copy_stage(const Walker& P, const Pos& p, unsigned char* slot) {
  const int lane = threadIdx.x & 31, N = P.W.N;
  const int j = p.r * P.R + p.jj, col0 = p.t * kTN;
  const int r = lane >> 1, h = lane & 1, col = col0 + 16 * h, row = p.u * kStageRows + r;
  const int8_t* src = P.W.p + ((size_t)j * P.G + row) * N + col;
  unsigned char* dst = slot + chunk_off(r, h);   // chunk_off(r + 16 i, h) = + 512 i
  if (P.async) {
    const bool cin = col < N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool in = cin && row + 16 * i < P.G;
      cp_async16(dst + 512 * i, in ? src + (size_t)16 * i * N : P.W.p, in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t wd[4] = {0u, 0u, 0u, 0u};
      if (row + 16 * i < P.G)
        for (int b = 0; b < 16 && col + b < N; ++b)
          wd[b >> 2] |= (uint32_t)(uint8_t)src[(size_t)16 * i * N + b] << (8 * (b & 3));
      *reinterpret_cast<uint4*>(dst + 512 * i) = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    }
  }
  if (p.u == P.spg - 1 && lane < 8) {
    const int lo = lane >> 2, sc = col0 + 8 * (lane & 3);
    const __nv_bfloat16* ss = P.W.gs3 + (size_t)(lo ? P.W.gch + j : j) * N;
    unsigned char* sd = slot + kStageBytes + 64 * lo + 16 * (lane & 3);
    if (P.async) {
      cp_async16(sd, ss + (sc < N ? sc : 0), sc < N ? 16 : 0);
    } else {
      __nv_bfloat16 v[8];
      for (int e = 0; e < 8; ++e) v[e] = sc + e < N ? ss[sc + e] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(sd) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// A warp's ring: kRing slots of kSlotBytes, filled and consumed in turn.
struct Ring {
  unsigned char* base;
  int fill, use;   // the next slot to fill, the next to consume
};

__device__ __forceinline__ int next_slot(int s) { return s + 1 == kRing ? 0 : s + 1; }

// Issues the walk's next stage, if any, and commits one cp.async group
// (empty past the walk's end), so that kRing - 1 groups are in flight
// while a stage is consumed.
__device__ __forceinline__ void ring_issue(const Walker& P, Pos& p, Ring& rg) {
  if (p.ok) {
    copy_stage(P, p, rg.base + rg.fill * kSlotBytes);
    rg.fill = next_slot(rg.fill);
    walk_next(P, p);
  }
  cp_commit();
}

// One item of a product, by one warp: groups j0 .. j0 + nj - 1 of the
// 32-column tile, against the feed of those groups (act: vector v, batch
// row b, the run's carrier row k at act[(v Bp + b) stride + k]); the
// result goes to out[b][n] (B rows of N). Lane (g, q) holds columns
// 4g .. 4g + 3 of the tile and rows 4q .. 4q + 3 of each k-step, read from
// the ring stage in four 4-byte words; its accumulator element k of tile t
// and batch block nb is column 4g + 2t + (k >> 1), row 8 nb + 2q + (k & 1).
// Each stage consumed issues the one kRing - 1 ahead (iw). Not inlined: the
// loop keeps its own registers.
template <typename T, int kNb>
__device__ __noinline__ void run_item(const Walker& P, Pos& iw, Ring& rg, int j0, int nj,
                                      int tile, const T* act, int stride, int B, float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int Bp = 8 * kNb, N = P.W.N;
  const int c0 = tile * kTN + 4 * g;
  const int valid = N - c0 < 4 ? N - c0 : 4;
  const bool vec_ok = valid == 4 && (N & 3) == 0;
  int off[4];   // the lane's fragment words in a stage's first k-step (+ 512 a k-step)
#pragma unroll
  for (int i = 0; i < 4; ++i) off[i] = chunk_off(4 * q + i, g >> 2) + 4 * (g & 3);
  float fin[2][kNb][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
      for (int k = 0; k < 4; ++k) fin[t][nb][k] = 0.f;
  for (int jj = 0; jj < nj; ++jj) {
    float acc[2][kNb][4], acc_c[2][kNb][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[t][nb][k] = acc_c[t][nb][k] = 0.f;
    const T* fj = act + (size_t)jj * P.Gp + 4 * q;
    for (int u = 0; u < P.spg; ++u) {
      cp_wait_ring();
      __syncwarp();   // every lane's copies of this stage landed; every lane left the last one
      ring_issue(P, iw, rg);   // into the slot of the stage before this one
      const unsigned char* slot = rg.base + rg.use * kSlotBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int s = 4 * u + ks;
#ifdef K15_NO_MMA   // a diagnostic build: the carrier stream without the products' arithmetic
        if (s >= 0) continue;
#endif
        if (s < P.steps) {
          uint32_t w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            w[i] = *reinterpret_cast<const uint32_t*>(slot + off[i] + 512 * ks);
          mma_step<T, kNb>(w, fj + s * 16, stride, Bp, acc, acc_c);
        }
      }
      if (u == P.spg - 1) {   // the group's scale pair for the lane's 4 columns
        const uint2 vh = *reinterpret_cast<const uint2*>(slot + kStageBytes + 8 * g);
        const uint2 vl = *reinterpret_cast<const uint2*>(slot + kStageBytes + 64 + 8 * g);
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&vh);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&vl);
        float hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 a = __bfloat1622float2(h2[i]), b = __bfloat1622float2(l2[i]);
          hi[2 * i] = a.x;
          hi[2 * i + 1] = a.y;
          lo[2 * i] = b.x;
          lo[2 * i + 1] = b.y;
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int c = 2 * t + (k >> 1);
              fin[t][nb][k] += hi[c] * (acc[t][nb][k] - acc_c[t][nb][k]) + lo[c] * acc_c[t][nb][k];
            }
      }
      rg.use = next_slot(rg.use);
    }
  }
  if (valid <= 0) return;
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int b = 8 * nb + 2 * q + e;
      if (b >= B) continue;
      const float y[4] = {fin[0][nb][e], fin[0][nb][2 + e], fin[1][nb][e], fin[1][nb][2 + e]};
      float* o = out + (size_t)b * N + c0;
      if (vec_ok) {
        *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
      } else {
        for (int c = 0; c < valid; ++c) o[c] = y[c];
      }
    }
}

// A product phase: part[r][b][n] (runs of B rows of N) for every run r of
// the plan. A block fills the feed of its run's groups for all rows from
// src(b, e) (element e of row b of the product's input; rows past B are
// zeros), then its warps take the run's column tiles in turn, each
// streaming its carrier through its ring (the walk's first kRing - 1
// stages are issued before the feed is built).
template <typename T, class Src>
__device__ __noinline__ void product_phase(const Walker& P, int B, float* part, T* act,
                                           Ring& rg, Src src) {
  const int warp = threadIdx.x >> 5;
  const int G = P.G, Gp = P.Gp, Bp = pad_rows(B), kh = P.W.kh;
  const int rows = P.R * Gp, stride = act_stride<T>(rows);
  Pos iw = walk_begin(P);
  for (int i = 0; i < kRing - 1; ++i) ring_issue(P, iw, rg);
  for (int r = P.spread ? (int)blockIdx.x % P.nr : (int)blockIdx.x; r < P.nr;
       r += P.spread ? P.nr : P.nb) {
    if (P.rank * kWarps >= P.nt) break;
    const int j0 = r * P.R, nj = min(P.R, P.W.gch - j0);
    for (int i = threadIdx.x; i < Bp * rows; i += kThreads) {
      const int b = i / rows, k = i % rows, jj = k / Gp, gi = k % Gp;
      float xa = 0.f, xb = 0.f, xc = 0.f;
      if (b < B && jj < nj && gi < G) {
        const int e = (j0 + jj) * G + gi;
        const float xl = src(b, e), xh = src(b, kh + e);
        xa = xh;
        xb = xl - xh * 0.0625f;
        xc = xl;
      }
      T* f = act + (size_t)b * stride + k;
      f[0] = to_feed<T>(xa);
      f[(size_t)Bp * stride] = to_feed<T>(xb);
      f[(size_t)2 * Bp * stride] = to_feed<T>(xc);
    }
    __syncthreads();
    float* out = part + (size_t)r * B * P.W.N;
    for (int t = P.rank * kWarps + warp; t < P.nt; t += P.nbr * kWarps) {
      if (Bp == 8) run_item<T, 1>(P, iw, rg, j0, nj, t, act, stride, B, out);
      else run_item<T, 2>(P, iw, rg, j0, nj, t, act, stride, B, out);
    }
    __syncthreads();
    if (P.spread) break;
  }
}

// The reduce phases. Element (b, i) (b < B, i < n) of a product's output is
// column i of row b of its run partials (nr runs of B rows of N), and with
// pair > 0 column pair + i too, added in run order, one element a thread of
// the grid. fn(b, i, y, y2) returns what it adds to row b's sum of squares;
// with ssq, each block's sums (added over its warps in order) go to
// ssq[block][b].
template <class Fn>
__device__ void reduce_rows(const float* part, int nr, int B, int N, int n, int pair, float* red,
                            float* ssq, Fn fn) {
  const int gtid = blockIdx.x * kThreads + threadIdx.x, gstride = gridDim.x * kThreads;
  float ss[kMaxB];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) ss[b] = 0.f;
  for (int e = gtid; e < B * n; e += gstride) {
    const int b = e / n, i = e % n;
    float y = 0.f, y2 = 0.f;
    for (int r = 0; r < nr; ++r) {
      const float* pr = part + ((size_t)r * B + b) * N;
      y += __ldcg(pr + i);
      if (pair > 0) y2 += __ldcg(pr + pair + i);
    }
    const float v = fn(b, i, y, y2);
#pragma unroll
    for (int bb = 0; bb < kMaxB; ++bb)
      if (bb == b) ss[bb] += v;
  }
  if (ssq == nullptr) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int bb = 0; bb < kMaxB; ++bb) {
    const float s = warp_sum(ss[bb]);
    if (lane == 0) red[warp * kMaxB + bb] = s;
  }
  __syncthreads();
  if ((int)threadIdx.x < B) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[w * kMaxB + threadIdx.x];
    ssq[(size_t)blockIdx.x * kMaxB + threadIdx.x] = s;
  }
  __syncthreads();
}

// rs[b] = 1 / sqrt(mean(h_b^2) + eps) for every row, the same in every
// block: warp b adds the blocks' sums of squares of row b (ssq, nb blocks)
// in a fixed order, or, with h0, the squares of row b of h0 itself.
template <typename T>
__device__ void rms_rows(float* rs, const float* ssq, int nb, const T* h0, int B, int D,
                         float eps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int b = warp; b < B; b += kWarps) {
    float s = 0.f;
    if (h0 != nullptr) {
      for (int i = lane; i < D; i += 32) {
        const float x = to_f(h0[(size_t)b * D + i]);
        s += x * x;
      }
    } else {
      for (int k = lane; k < nb; k += 32) s += __ldcg(ssq + (size_t)k * kMaxB + b);
    }
    s = warp_sum(s);
    if (lane == 0) rs[b] = 1.f / sqrtf(s / (float)D + eps);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// attention: groups of warps, each with a chunk of its own
// ---------------------------------------------------------------------------

// A block's warps split into `groups` groups of nt = kThreads / groups
// threads; each group attends one chunk at a time, so a block keeps that
// many chunks' K / V loads in flight (a chunk's phases, each waiting on the
// one before, would otherwise leave the block waiting on one chunk's
// latency). Named barrier 1 + gid joins a group.
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

// Groups a block's attention splits into: 4, or fewer where four chunks'
// shared memory would not fit.
template <typename KV>
__host__ __device__ inline int att_groups(int rep, int S, int Dh) {
  for (int g = 4; g > 1; g /= 2)
    if (g * group_floats<KV>(rep, S, Dh, kThreads / g) * sizeof(float) <= 200 * 1024) return g;
  return 1;
}

// fused_step.cuh's attend_chunk for a group of nt threads (gid; the same
// arithmetic in the same order, so nt = kThreads gives its bits): one chunk
// of one (row b, KV head) pair: q, K and V of the row's QKV output, RoPE,
// the chunk's logits, its max, exp and sum, its unnormalised PV; chunk 0
// also emits the rotated K row and the V row.
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

// Chunks of each (row, KV head) pair and warp groups a block's attention
// runs with: one group a block while the pairs fit the grid, else as many
// as att_groups allows; the chunks, as many as the groups hold (1..8).
template <typename KV>
__device__ __forceinline__ void att_plan(const AttnArgs& at, int* ng, int* C) {
  const int pairs = at.B * at.Hkv;
  *ng = pairs > (int)gridDim.x ? att_groups<KV>(at.Hq / at.Hkv, at.S, at.Dh) : 1;
  *C = max(1, min(kMaxChunks, (int)gridDim.x * *ng / pairs));
}

// The attention phase of layer l: every chunk of every pair, one warp
// group a chunk; q, K and V from the QKV product's nr_q run partials (nq
// columns a row).
template <typename T, typename KV>
__device__ __noinline__ void attention_phase(const AttnArgs& at, int l, const AttnWs& aw,
                                             const float* qkv_part, int nr_q, int Nq,
                                             float* att_smem) {
  int ng, C;
  att_plan<KV>(at, &ng, &C);
  const int B = at.B, Hkv = at.Hkv, nt = kThreads / ng, gid = (int)threadIdx.x / nt;
  float* smem = att_smem + gid * group_floats<KV>(at.Hq / Hkv, at.S, at.Dh, nt);
  for (int it = (int)blockIdx.x * ng + gid; it < B * Hkv * C; it += (int)gridDim.x * ng) {
    const int pair = it / C, b = pair / Hkv;
    const auto qkv = [=](int m) {
      float s = 0.f;
      for (int r = 0; r < nr_q; ++r) s += __ldcg(qkv_part + ((size_t)r * B + b) * Nq + m);
      DUMP(l, 1, B, b, m, s);
      return s;
    };
    attend_group<T, KV>(at, l, b, pair % Hkv, it % C, C, qkv, aw, smem, gid, nt);
  }
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

// The f32 workspace: h (B, D), the blocks' sums of squares (kMaxBlocks,
// kMaxB), the attention output (B, Hq Dh), SwiGLU (B, F), the attention
// chunks (AttnWs), then the run partials of the widest product (at most
// one run a group); each part 16-byte aligned.
struct Workspace {
  float *h, *ssq, *attn, *sw, *part;
};

__host__ __device__ inline size_t workspace_floats(int B, int D, int F, int Hq, int Hkv, int Dh,
                                                   int S, int gq, int go, int gg, int gd,
                                                   Workspace* w, AttnWs* aw, float* base) {
  const size_t Nq = (size_t)(Hq + 2 * Hkv) * Dh;
  size_t part = (size_t)gq * Nq;
  part = (size_t)go * D > part ? (size_t)go * D : part;
  part = (size_t)gg * 2 * F > part ? (size_t)gg * 2 * F : part;
  part = (size_t)gd * D > part ? (size_t)gd * D : part;
  const size_t o_h = 0, o_ss = o_h + round4((size_t)B * D),
               o_at = o_ss + (size_t)kMaxBlocks * kMaxB,
               o_sw = o_at + round4((size_t)B * Hq * Dh), o_aw = o_sw + round4((size_t)B * F),
               o_part = o_aw + attn_ws_floats(B, Hq, Hkv, Dh, S, nullptr, nullptr);
  if (w != nullptr) {
    *w = Workspace{base + o_h, base + o_ss, base + o_at, base + o_sw, base + o_part};
    attn_ws_floats(B, Hq, Hkv, Dh, S, base + o_aw, aw);
  }
  return o_part + part * B;
}

// Byte offset of the warps' carrier rings in a block's shared memory:
// after rs, red and the feed of the longest run of any product, 128-byte
// aligned. An attention chunk's floats start at 0 (they are not live
// while a product runs).
template <typename T>
__host__ __device__ inline size_t ring_offset(int B, int D, int F, int Hq, int Dh, int gq, int go,
                                              int gg, int gd) {
  const int kh[4] = {D / 2, Hq * Dh / 2, D / 2, F / 2}, gch[4] = {gq, go, gg, gd};
  size_t act = 0;
  for (int i = 0; i < 4; ++i) {
    const int G = kh[i] / gch[i];
    const size_t b = act_bytes<T>(max_run<T>(G, gch[i], pad_rows(B)) * gpad(G), pad_rows(B));
    act = b > act ? b : act;
  }
  return (kSmallBytes + act + 127) / 128 * 128;
}

template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_batch_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  float* rs = reinterpret_cast<float*>(smem_raw);      // kMaxB
  float* red = rs + kMaxB;                             // kWarps * kMaxB
  T* act = reinterpret_cast<T*>(smem_raw + kSmallBytes);
  float* att_smem = reinterpret_cast<float*>(smem_raw);

  const AttnArgs& at = a.at;
  const int B = at.B, D = a.D, F = a.F, Dh = at.Dh, Hq = at.Hq, Hkv = at.Hkv, L = a.L;
  const int nq = Hq * Dh, Nq = (Hq + 2 * Hkv) * Dh, nb = gridDim.x;
  Workspace ws;
  AttnWs aw;
  workspace_floats(B, D, F, Hq, Hkv, Dh, at.S, a.gq, a.go, a.gg, a.gd, &ws, &aw, a.ws);

  const int nr_q = plan_of<T>(D / 2, Nq, a.gq, B, nb).nr;
  const int nr_o = plan_of<T>(nq / 2, D, a.go, B, nb).nr;
  const int nr_g = plan_of<T>(D / 2, 2 * F, a.gg, B, nb).nr;
  const int nr_d = plan_of<T>(F / 2, D, a.gd, B, nb).nr;
  const T* h0 = static_cast<const T*>(a.h0);
  T* h_out = static_cast<T*>(a.h_out);
  // the warp's carrier ring
  Ring rg{smem_raw + ring_offset<T>(B, D, F, Hq, Dh, a.gq, a.go, a.gg, a.gd) +
              (size_t)(threadIdx.x >> 5) * kRing * kSlotBytes,
          0, 0};
  // product i (0..3: wqkv, wo, wgu, wd) of layer l as this block walks it:
  // the plans once a launch, the layer's pointers from its table row
  __shared__ Walker walks[4];
  if (threadIdx.x < 4) {
    const int i = threadIdx.x;
    const int kh[4] = {D / 2, nq / 2, D / 2, F / 2}, n[4] = {Nq, D, 2 * F, D},
              gch[4] = {a.gq, a.go, a.gg, a.gd};
    walks[i] = walker_of<T>(layer_product(a.table, i, kh[i], n[i], gch[i]), B);
  }
  __syncthreads();
  auto walker = [&](int l, int i) {
    const long long* t = a.table + (size_t)l * kPtrs;
    Walker P = walks[i];
    P.W.p = reinterpret_cast<const int8_t*>(t[2 * i]);
    P.W.gs3 = reinterpret_cast<const __nv_bfloat16*>(t[2 * i + 1]);
    return P;
  };

  STAMP_BEGIN();
  for (int l = 0; l < L; ++l) {
    const long long* t = a.table + (size_t)l * kPtrs;
    const T* ln_attn = reinterpret_cast<const T*>(t[8]);
    const T* ln_mlp = reinterpret_cast<const T*>(t[9]);
    const bool first = l == 0, last = l == L - 1;
    const float* hp = ws.h;

    // QKV product of RMSNorm(h)
    rms_rows(rs, ws.ssq, nb, first ? h0 : nullptr, B, D, a.eps);
    product_phase<T>(walker(l, 0), B, ws.part, act, rg, [=](int b, int e) {
      const size_t o = (size_t)b * D + e;
      const float x = (first ? to_f(h0[o]) : __ldcg(hp + o)) * rs[b] * to_f(ln_attn[e]);
      DUMP(l, 0, B, b, e, x);
      return x;
    });
    grid.sync();
    STAMP();

    // attention: C chunks of each (row, KV head) pair's slots
    attention_phase<T, KV>(at, l, aw, ws.part, nr_q, Nq, att_smem);
    grid.sync();
    STAMP();

    // the chunks combined: the attention output, probs and p_new
    {
      int ng, C;
      att_plan<KV>(at, &ng, &C);
      combine_attention(at, aw, ws.attn, l, C);
    }
    grid.sync();
    STAMP();

    // O product of the attention output; then h += its sum
    const float* attn = ws.attn;
    product_phase<T>(walker(l, 1), B, ws.part, act, rg, [=](int b, int e) {
      const float x = __ldcg(attn + (size_t)b * nq + e);
      DUMP(l, 2, B, b, e, x);
      return x;
    });
    grid.sync();
    STAMP();
    float* hw = ws.h;
    reduce_rows(ws.part, nr_o, B, D, D, 0, red, ws.ssq, [=](int b, int n, float y, float) {
      const size_t o = (size_t)b * D + n;
      const float h = (first ? to_f(h0[o]) : __ldcg(hw + o)) + y;
      hw[o] = h;
      DUMP(l, 3, B, b, n, h);
      return h * h;
    });
    grid.sync();
    STAMP();

    // gate|up product of RMSNorm(h); then SwiGLU of its sums
    rms_rows(rs, ws.ssq, nb, (const T*)nullptr, B, D, a.eps);
    product_phase<T>(walker(l, 2), B, ws.part, act, rg, [=](int b, int e) {
      const float x = __ldcg(hp + (size_t)b * D + e) * rs[b] * to_f(ln_mlp[e]);
      DUMP(l, 4, B, b, e, x);
      return x;
    });
    grid.sync();
    STAMP();
    float* sw = ws.sw;
    reduce_rows(ws.part, nr_g, B, 2 * F, F, F, red, nullptr, [=](int b, int i, float g, float up) {
      const float s = g * (1.f / (1.f + expf(-g))) * up;
      sw[(size_t)b * F + i] = s;
      DUMP(l, 5, B, b, i, g);
      DUMP(l, 5, B, b, F + i, up);
      DUMP(l, 6, B, b, i, s);
      return 0.f;
    });
    grid.sync();
    STAMP();

    // down product of SwiGLU; then h += its sum (and h out after the last
    // layer)
    product_phase<T>(walker(l, 3), B, ws.part, act, rg,
                     [=](int b, int e) { return __ldcg(sw + (size_t)b * F + e); });
    grid.sync();
    STAMP();
    reduce_rows(ws.part, nr_d, B, D, D, 0, red, ws.ssq, [=](int b, int n, float y, float) {
      const size_t o = (size_t)b * D + n;
      const float h = __ldcg(hw + o) + y;
      hw[o] = h;
      DUMP(l, 7, B, b, n, h);
      if (last) h_out[o] = from_f<T>(h);
      return h * h;
    });
    if (!last) grid.sync();
    STAMP();
  }
  STAMP_END();
}

// Dynamic shared memory of one block: the larger of the rings' end and the
// attention groups' floats (as many groups as att_groups allows; one group
// of the whole block takes no more).
template <typename T, typename KV>
size_t smem_bytes(int B, int D, int F, int Hq, int Hkv, int Dh, int S, int gq, int go, int gg,
                  int gd) {
  const size_t end = ring_offset<T>(B, D, F, Hq, Dh, gq, go, gg, gd) + kRingBytes;
  const int ng = att_groups<KV>(Hq / Hkv, S, Dh);
  const size_t att = sizeof(float) * ng * group_floats<KV>(Hq / Hkv, S, Dh, kThreads / ng);
  return end > att ? end : att;
}

template <typename T, typename KV>
int launch(const Args& a, int grid, cudaStream_t stream) {
  if (!head_dim_ok<KV>(a.at.Dh)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, KV>(a.at.B, a.D, a.F, a.at.Hq, a.at.Hkv, a.at.Dh, a.at.S,
                                        a.gq, a.go, a.gg, a.gd);
  return cooperative_launch(fused_decode_batch_kernel<T, KV>, a, smem, grid, stream);
}

}  // namespace

extern "C" {

// Floats of the workspace one launch needs.
size_t fused_decode_step_batch_ws(int B, int D, int F, int Hq, int Hkv, int Dh, int S, int gq,
                                  int go, int gg, int gd) {
  return workspace_floats(B, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd, nullptr, nullptr, nullptr);
}

// Dynamic shared memory of one block, in bytes; 0 for a head dim the
// attention phase does not take (a row of 1..32 sixteen-byte loads, a power
// of two). dtype: 0 = float32, 1 = bfloat16; kv_int8: 1 for an int8 cache.
size_t fused_decode_step_batch_smem(int B, int D, int F, int Hq, int Hkv, int Dh, int S, int gq,
                                    int go, int gg, int gd, int dtype, int kv_int8) {
  if (dtype == 0 && kv_int8)
    return head_dim_ok<int8_t>(Dh) ? smem_bytes<float, int8_t>(B, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd) : 0;
  if (dtype == 0)
    return head_dim_ok<float>(Dh) ? smem_bytes<float, float>(B, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd) : 0;
  if (kv_int8)
    return head_dim_ok<int8_t>(Dh)
               ? smem_bytes<__nv_bfloat16, int8_t>(B, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd)
               : 0;
  return head_dim_ok<__nv_bfloat16>(Dh)
             ? smem_bytes<__nv_bfloat16, __nv_bfloat16>(B, D, F, Hq, Hkv, Dh, S, gq, go, gg, gd)
             : 0;
}

// One decode step of all L layers at B rows (1..16). table: (L, 10) device
// pointers per layer (wqkv, wo, wgu, wd as carrier and bf16 scale pair;
// ln_attn, ln_mlp in the compute dtype). k, v (L, B, Hkv, S, Dh) in the
// compute dtype, or int8 with k_scale, v_scale (L, B, Hkv, S) f32 (null
// otherwise); pos (L, B, Hkv, S); h0 (B, D); q_pos (B,); rope_pos (B,) or
// null; inv_freq (Dh/2,) f32; scale the logits' Dh^-0.5; window <= 0: no
// sliding window. Outputs: h_out (B, D), kn, vn (L, B, Hkv, Dh) in the
// compute dtype, probs (L, B, Hkv, S) and p_new (L, B, Hkv) f32. ws:
// fused_decode_step_batch_ws floats, 16-byte aligned. Every cache and weight
// pointer is 16-byte aligned. Returns the launch's error, or
// cudaGetLastError().
int fused_decode_step_batch(const long long* table, const void* k, const void* v, const int* pos,
                            const float* k_scale, const float* v_scale, const void* h0,
                            const int* q_pos, const int* rope_pos, const float* inv_freq,
                            void* h_out, void* kn, void* vn, float* probs, float* p_new,
                            float* ws, int L, int B, int D, int F, int Hq, int Hkv, int Dh, int S,
                            int gq, int go, int gg, int gd, int window, float eps, float scale,
                            int dtype, int kv_int8, int grid, void* stream) {
  if (L < 1 || B < 1 || B > kMaxB || Hkv < 1 || Hq % Hkv != 0 || D % 4 || F % 4 ||
      (Hq * Dh) % 4 || gq < 1 || go < 1 || gg < 1 || gd < 1 || (D / 2) % gq ||
      (Hq * Dh / 2) % go || (D / 2) % gg || (F / 2) % gd ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const AttnArgs at{k, v, pos, k_scale, v_scale, q_pos, rope_pos, inv_freq, kn, vn, probs, p_new,
                    B, Hq, Hkv, Dh, S, window, scale};
  const Args a{reinterpret_cast<const long long*>(table), h0, h_out, ws, at, L, D, F, gq, go, gg,
               gd, eps};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && kv_int8) return launch<float, int8_t>(a, grid, st);
  if (dtype == 0) return launch<float, float>(a, grid, st);
  if (dtype == 1 && kv_int8) return launch<__nv_bfloat16, int8_t>(a, grid, st);
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, grid, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef STEP_STAMPS
// The last launch's clock reads (fused_step.cuh's phase clock).
int fused_decode_batch_stamps(unsigned long long* dst, int* n) { return copy_stamps(dst, n); }
#endif

#ifdef STEP_DUMP
// Where the next launches write their intermediates (DUMP): dst, device
// memory of L kStages B w floats, w at least the widest stage ((Hq + 2 Hkv)
// Dh and 2 F). Returns the copy's error.
int fused_decode_batch_dump(float* dst, int w) {
  cudaError_t err = cudaMemcpyToSymbol(g_dump, &dst, sizeof(dst));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_dump_w, &w, sizeof(w));
  return (int)err;
}
#endif

}  // extern "C"
