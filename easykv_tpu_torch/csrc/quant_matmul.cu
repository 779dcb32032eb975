// w8a16 product (kernel K13) at 1 < M <= 256 on the tensor cores: y (M, N) =
// (x (M, K) @ q (K, N) int8) * s (N,), accumulated in f32 over the whole K,
// scaled once by the f32 column scale and rounded once to the output type
// (x's, or f32 for the int8 LM head). M = 1 has its own stream,
// quant_gemv.cu.
//
// Replaces, at M > 1, the TPU kernel easykv_tpu/ops/pallas/quant_matmul.py
// `quant_matmul`, which casts the weight tile to x's dtype and runs the
// product on the matrix unit.
//
// What bounds it on an H100: the int8 weight bytes at small M (the LM head
// 131 MB, 39 us at 3.35 TB/s; wo 16.8 MB, 5.0 us), the 2 M K N operations
// of the tensor cores at M = 256 (the head: 67 GFLOP, 68 us at 989 TFLOP/s
// of bf16). The design:
//   * exact inputs on the tensor cores: an int8 weight is exact in bf16
//     (|q| <= 127) and its product with a bf16 x exact in f32, so the
//     products run as mma.sync m16n8k16 (bf16 in, f32 accumulate) and the
//     result differs from the plain version only in the order of its f32
//     sums. An f32 x is split into three bf16 limbs, x = x0 + x1 + x2
//     exactly, three products for one. The tensor cores truncate each MMA's
//     sum, so the products go into a zeroed tile that is then added to the
//     running sum with round-to-nearest (bf16 x: two k16 steps a tile in
//     the large configuration, a stage's steps in the small one; the limbs
//     of one step for an f32 x);
//   * one pass over the weight bytes per launch: a block owns a column tile
//     and every row of x, so each weight byte leaves device memory once.
//     A byte becomes bf16 in registers, exactly, straight into the MMA's
//     fragments: its sign bit flipped it is the low mantissa byte of 2^23
//     (one byte permute), less 2^23 + 128 (one subtraction), two such
//     floats packed into a bf16 pair (one conversion);
//   * two configurations (ops/cuda/quant_matmul.py matmul_plan):
//       - small M (<= 16, the batched decode's rows): the weight's columns
//         on the MMA's 16-row side (A), x's rows on its 8-wide side (B, one
//         n8 block for M <= 8, two for M <= 16); a block is 256 columns, a
//         warp 32 of them (two m16 tiles: a lane reads one 4-byte word a
//         row, its columns 4g .. 4g + 3 of the warp's 32);
//       - large M (<= 64, 128, 256 rows: MT = 1, 2, 4 m16 tiles a warp):
//         x's rows the A operand (ldmatrix), the weight the B operand; a
//         block is 128 columns by 64 MT rows, 8 warps as 4 (rows) x 2
//         (columns), a warp 16 MT rows by 64 columns (eight n8 tiles: a
//         lane reads one 8-byte word a row, columns 8g .. 8g + 7, tile j
//         taking column 8g + j);
//   * a ring of `stages` stages in shared memory, each `rs` weight rows of
//     the block's columns and x's rows at the same K columns, all of them
//     in flight from the start. The weight comes as tensor-map boxes of rs
//     rows x 128 columns, x as boxes of its BM rows x 128 bytes of K (x
//     viewed as a byte matrix), both swizzled by 128 bytes (16-byte chunk c
//     of row r at chunk c ^ (r mod 8)) so that the fragment loads fall on
//     distinct banks; zeros past M, N and K. A stage's bytes count on its
//     mbarrier. No block barrier in the loop: each warp, done with a stage,
//     counts itself off the stage's slot, and the last of the eight asks
//     for the stage `stages` ahead into it. The ragged case (N not a
//     multiple of 16, an unaligned weight, x rows that are not whole
//     16-byte segments or an unaligned x) copies element by element into
//     the same layouts;
//   * no workspace and no ticket: where the column tiles are too few to
//     fill 132 SMs, the stages split over the blocks of a thread-block
//     cluster (at most 8), and the partial tiles add through distributed
//     shared memory in rank order. A launch keeps no state between launches
//     and gives the same bits every time, on any stream.
// Built with -DK13_MM_NO_MATH (a diagnostic build) the blocks stream the
// weight and x without the products; with -DK13_MM_DIRECT the bf16 products
// go straight into the running sums (which the tensor cores truncate).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tma_ring;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBox = 128;                // bytes of a box row (its swizzle span)
constexpr int kMaxCluster = 8;
constexpr size_t kSmemLimit = 232448;

// A block's tile: BN columns by BM rows of x. small: R = n8 blocks of x
// rows (1, 2); large: R = m16 tiles of a warp (1, 2, 4).
__host__ __device__ constexpr int tile_n(bool small) { return small ? 256 : 128; }
__host__ __device__ constexpr int tile_m(bool small, int R) { return small ? 8 * R : 64 * R; }

struct Geo {
  size_t stage, ring, part, bars, total;
};

// Shared memory of a block, from a 1024-byte aligned base: the ring (each
// stage the weight's boxes, rs x kBox bytes each, then x's boxes, BM rows x
// kBox bytes each, rs x xsize / kBox of them), reused after the last stage
// for the block's partial tile (BM x BN f32); then the stages' mbarriers and
// release counts, and 1024 bytes of slack for the alignment.
__host__ __device__ inline Geo geometry(bool small, int R, int rs, int stages, int xsize) {
  Geo g;
  g.stage = (size_t)rs * tile_n(small) + (size_t)tile_m(small, R) * rs * xsize;
  g.ring = (size_t)stages * g.stage;
  g.part = (size_t)tile_m(small, R) * tile_n(small) * sizeof(float);
  g.bars = g.ring > g.part ? g.ring : g.part;
  g.total = 1024 + g.bars + (size_t)stages * (sizeof(uint64_t) + sizeof(unsigned));
  return g;
}

struct Args {
  const void* x;
  const int8_t* q;
  const float* s;
  void* out;
  int M, K, N, rs, stages, tma_w, tma_x;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 as three bf16x2 limbs: x = l0 + l1 + l2 exactly (limb k of the
// pair in word k).
__device__ __forceinline__ void split3(float a, float b, uint32_t (&w)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    w[k] = pack_bf16(ha, hb);
    a -= __bfloat162float(ha);
    b -= __bfloat162float(hb);
  }
}

// Byte B of u (a weight word with its sign bits flipped) as the f32 value of
// the signed weight byte, exactly: 2^23 + b + 128 less 2^23 + 128.
template <int B>
__device__ __forceinline__ float byte_f32(uint32_t u, uint32_t magic) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(u), "r"(magic), "n"(0x7650 | B));
  return __uint_as_float(d) - 8388736.f;
}

// The bf16 pair (byte B of row k's word u0, byte B of row k + 1's word u1):
// one MMA fragment register, k in its low half.
template <int B>
__device__ __forceinline__ uint32_t pair(uint32_t u0, uint32_t u1, uint32_t magic) {
  __nv_bfloat162 v = __floats2bfloat162_rn(byte_f32<B>(u0, magic), byte_f32<B>(u1, magic));
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Byte offset of byte c (< kBox) of row r in a 128-byte swizzled box.
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return r * kBox + (((c >> 4) ^ (r & 7)) << 4) + (c & 15);
}

// Byte offset of byte kb of x row m's K bytes in a stage's x boxes (BM rows
// each).
__device__ __forceinline__ int xoff(int m, int kb, int BM) {
  return (kb >> 7) * BM * kBox + swz(m, kb & (kBox - 1));
}

// The ragged parts of stage `st` (weight rows st rs .. + rs - 1; the tile's
// columns, x's first min(BM, M) rows at those K columns) copied element by
// element into `slot`'s layouts by threads t, t + nt, ..: zeros past K and
// N; x rows past M are not copied (they reach only outputs that are not
// stored).
template <typename XT, bool kSmall, int R>
__device__ void copy_stage(const Args& a, int st, uint8_t* slot, int n0, int t, int nt) {
  constexpr int BN = tile_n(kSmall), BM = tile_m(kSmall, R);
  const int k0 = st * a.rs;
  if (!a.tma_w) {
    for (int i = t; i < a.rs * (BN / 16); i += nt) {
      const int r = i / (BN / 16), c = (i - r * (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (k < a.K)
        for (int b = 0; b < 16 && n + b < a.N; ++b)
          w[b >> 2] |= (uint32_t)(uint8_t)a.q[(size_t)k * a.N + n + b] << (8 * (b & 3));
      *reinterpret_cast<uint4*>(slot + (c / kBox) * a.rs * kBox + swz(r, c % kBox)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  if (!a.tma_x) {
    constexpr int E = 16 / sizeof(XT);     // x elements a 16-byte chunk holds
    const XT* x = static_cast<const XT*>(a.x);
    uint8_t* xs = slot + (size_t)a.rs * BN;
    const int xch = a.rs / E, rows = a.M < BM ? a.M : BM;
    for (int i = t; i < rows * xch; i += nt) {
      const int m = i / xch, c = (i - m * xch) * E, k = k0 + c;
      __align__(16) XT v[E];
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = k + e < a.K ? x[(size_t)m * a.K + k + e] : from_f<XT>(0.f);
      *reinterpret_cast<uint4*>(xs + xoff(m, c * (int)sizeof(XT), BM)) =
          *reinterpret_cast<const uint4*>(v);
    }
  }
}

// Stage `st` asked for in `slot` on `bar` by one thread: the weight's boxes
// and x's, where they come by tensor map, and one arrival that expects
// their bytes (after the ragged parts' copies, which the arrival releases).
template <typename XT, bool kSmall, int R>
__device__ void ask_stage(const CUtensorMap* wmap, const CUtensorMap* xmap, const Args& a,
                          int st, uint8_t* slot, int n0, uint64_t* bar) {
  constexpr int BN = tile_n(kSmall), BM = tile_m(kSmall, R);
  const int k0 = st * a.rs, xboxes = a.rs * (int)sizeof(XT) / kBox;
  bar_arrive_tx(bar, (uint32_t)((a.tma_w ? a.rs * BN : 0) + (a.tma_x ? xboxes * BM * kBox : 0)));
  if (a.tma_w)
#pragma unroll
    for (int h = 0; h < BN / kBox; ++h) box_copy(slot + h * a.rs * kBox, wmap, n0 + h * kBox, k0, bar);
  uint8_t* xs = slot + (size_t)a.rs * BN;
  if (a.tma_x)
    for (int b = 0; b < xboxes; ++b)
      box_copy(xs + b * BM * kBox, xmap, k0 * (int)sizeof(XT) + b * kBox, 0, bar);
}

// The block's ring: its shared memory (1024-byte aligned), the stages'
// mbarriers and release counts.
struct Ring {
  uint8_t* smem;
  uint64_t* full;
  unsigned* done;
};

// The ring set up, its first min(stages, n_st) stages asked for.
template <typename XT, bool kSmall, int R>
__device__ Ring start_ring(const CUtensorMap* wmap, const CUtensorMap* xmap, const Args& a,
                           const Geo& g, int s0, int n_st, int n0, uint8_t* raw) {
  Ring ring;
  ring.smem = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  ring.full = reinterpret_cast<uint64_t*>(ring.smem + g.bars);
  ring.done = reinterpret_cast<unsigned*>(ring.full + a.stages);
  const int first = a.stages < n_st ? a.stages : n_st;
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      bar_init(ring.full + i, 1);
      ring.done[i] = 0u;
    }
    bar_fence_init();
    if (a.tma_w) prefetch_map(wmap);
    if (a.tma_x) prefetch_map(xmap);
  }
  for (int i = 0; i < first; ++i)
    copy_stage<XT, kSmall, R>(a, s0 + i, ring.smem + i * g.stage, n0, threadIdx.x, kThreads);
  __syncthreads();
  if (threadIdx.x == 0)
    for (int i = 0; i < first; ++i)
      ask_stage<XT, kSmall, R>(wmap, xmap, a, s0 + i, ring.smem + i * g.stage, n0, ring.full + i);
  return ring;
}

// A warp done with stage i counts itself off its slot; the last of the
// kWarps to do so asks for stage i + stages into it (its lanes copying any
// ragged part first).
template <typename XT, bool kSmall, int R>
__device__ void release_slot(const CUtensorMap* wmap, const CUtensorMap* xmap, const Args& a,
                             const Geo& g, const Ring& ring, int s0, int n_st, int n0, int i) {
  const int S = a.stages, j = i + S;
  if (j >= n_st) return;
  const int lane = threadIdx.x & 31, slot = i % S;
  __syncwarp();
  unsigned last = 0;
  if (lane == 0) {
    __threadfence_block();   // the warp's reads of the slot before its count
    last = atomicAdd(ring.done + slot, 1u) == (unsigned)(kWarps * (i / S + 1) - 1);
  }
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  uint8_t* dst = ring.smem + slot * g.stage;
  copy_stage<XT, kSmall, R>(a, s0 + j, dst, n0, lane, 32);
  __syncwarp();
  if (lane == 0) ask_stage<XT, kSmall, R>(wmap, xmap, a, s0 + j, dst, n0, ring.full + slot);
}

// The stages [s0, s1) this block takes: its rank's share of the K rows.
__device__ __forceinline__ void block_stages(const Args& a, int rank, int cs, int& s0, int& s1) {
  const int ns = (a.K + a.rs - 1) / a.rs;
  s0 = (int)((long long)rank * ns / cs);
  s1 = (int)((long long)(rank + 1) * ns / cs);
}

// The cluster's partial tiles (each block's in its shared memory at
// `part`, BM x BN f32), added in rank order by block `rank` for its share
// of the elements, times the scale, rounded once into out.
template <typename OT, int BM, int BN>
__device__ void finish(const Args& a, cg::cluster_group& cluster, float* part, int n0) {
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();
  const int rows = a.M < BM ? a.M : BM, total = rows * BN;
  const int per = (total + cs - 1) / cs;
  const int e1 = (rank + 1) * per < total ? (rank + 1) * per : total;
  OT* out = static_cast<OT*>(a.out);
  for (int e = rank * per + (int)threadIdx.x; e < e1; e += kThreads) {
    const int m = e / BN, n = n0 + e % BN;
    if (n >= a.N) continue;
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) v[r] = r < cs ? cluster.map_shared_rank(part, r)[e] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) sum += v[r];
    out[(size_t)m * a.N + n] = from_f<OT>(sum * a.s[n]);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// small M: the weight's columns the A operand, x's rows the B operand
// ---------------------------------------------------------------------------

// The B fragments of x rows 8 nb + g at K columns k0 + 2q (+1, +8, +9) of a
// stage: one bf16 limb, or the three of an f32 x.
template <int NB>
__device__ __forceinline__ void x_frag_b(const uint8_t* xs, int k0, uint32_t (&f)[1][NB][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      f[0][nb][i] = *reinterpret_cast<const uint32_t*>(
          xs + xoff(8 * nb + g, (k0 + 2 * q + 8 * i) * 2, 8 * NB));
}
template <int NB>
__device__ __forceinline__ void x_frag_b(const uint8_t* xs, int k0, uint32_t (&f)[3][NB][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          xs + xoff(8 * nb + g, (k0 + 2 * q + 8 * i) * 4, 8 * NB));
      uint32_t w[3];
      split3(v.x, v.y, w);
#pragma unroll
      for (int l = 0; l < 3; ++l) f[l][nb][i] = w[l];
    }
}

template <typename XT, typename OT, int NB>
__global__ void __launch_bounds__(kThreads, 2)
matmul_small(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
             const Args a) {
  constexpr int BN = tile_n(true), BM = tile_m(true, NB);
  constexpr int kLimbs = sizeof(XT) == 4 ? 3 : 1;
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Geo g = geometry(true, NB, a.rs, a.stages, sizeof(XT));
  const int n0 = (int)(blockIdx.x / cs) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q = lane & 3;
  int s0, s1;
  block_stages(a, rank, cs, s0, s1);
  const int n_st = s1 - s0, S = a.stages;
  const Ring ring = start_ring<XT, true, NB>(&wmap, &xmap, a, g, s0, n_st, n0, smem_raw);
  uint32_t magic = 0x4B000000u;
  asm volatile("" : "+r"(magic));   // kept in a register
  // the lane's word of a weight row: columns 4 g8 .. + 3 of the warp's 32, in
  // box warp / 4; rows 2q (+8) at chunk c ^ 2q, rows 2q + 1 (+8) at c ^ (2q + 1)
  const int c = (warp & 3) * 32 + 4 * g8;
  const int co0 = (((c >> 4) ^ (2 * q)) << 4) + (c & 15);
  const int co1 = (((c >> 4) ^ (2 * q + 1)) << 4) + (c & 15);

  float tot[2][NB][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[t][nb][e] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    bar_wait(ring.full + i % S, (uint32_t)((i / S) & 1));
#ifndef K13_MM_NO_MATH
    const uint8_t* ws = ring.smem + (i % S) * g.stage + (warp >> 2) * a.rs * kBox;
    const uint8_t* xs = ring.smem + (i % S) * g.stage + (size_t)a.rs * BN;
    float acc[2][NB][4];   // the stage's sums
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][nb][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < a.rs; k0 += 16) {
      const uint8_t* w = ws + (k0 + 2 * q) * kBox;
      const uint32_t r0 = lds32(w + co0), r1 = lds32(w + kBox + co1);
      const uint32_t r2 = lds32(w + 8 * kBox + co0), r3 = lds32(w + 9 * kBox + co1);
      // m16 tile t: its row g is column 4 g8 + 2 t, row g + 8 column 4 g8 + 2 t + 1
      uint32_t af[2][4];
      af[0][0] = pair<0>(r0, r1, magic);
      af[0][1] = pair<1>(r0, r1, magic);
      af[0][2] = pair<0>(r2, r3, magic);
      af[0][3] = pair<1>(r2, r3, magic);
      af[1][0] = pair<2>(r0, r1, magic);
      af[1][1] = pair<3>(r0, r1, magic);
      af[1][2] = pair<2>(r2, r3, magic);
      af[1][3] = pair<3>(r2, r3, magic);
      uint32_t bf[kLimbs][NB][2];
      x_frag_b<NB>(xs, k0, bf);
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          if constexpr (kLimbs == 1) {
            mma(acc[t][nb], af[t], bf[0][nb]);
          } else {   // the limbs' products apart, the smallest first
            float tt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int l = kLimbs - 1; l >= 0; --l) mma(tt, af[t], bf[l][nb]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[t][nb][e] += tt[e];
          }
        }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) tot[t][nb][e] += acc[t][nb][e];
#endif
    release_slot<XT, true, NB>(&wmap, &xmap, a, g, ring, s0, n_st, n0, i);
  }
  __syncthreads();   // the ring is done with: the partial tile takes its place

  // accumulator element e of (t, nb): column 32 warp + 4 g8 + 2 t + (e >> 1)
  // of the tile, x row 8 nb + 2 q + (e & 1)
  float* part = reinterpret_cast<float*>(ring.smem);
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * nb + 2 * q + (e & 1)) * BN + 32 * warp + 4 * g8 + 2 * t + (e >> 1)] =
            tot[t][nb][e];
  finish<OT, BM, BN>(a, cluster, part, n0);
}

// ---------------------------------------------------------------------------
// large M: x's rows the A operand, the weight the B operand
// ---------------------------------------------------------------------------

// The A fragments of x rows r0 .. r0 + 15 at K columns k0 .. k0 + 15 of a
// stage (BM rows a box): one bf16 limb, or three of an f32 x.
__device__ __forceinline__ void x_frag_a(const __nv_bfloat16*, const uint8_t* xs, int BM, int r0,
                                         int k0, uint32_t (&f)[1][4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f[0], xs + xoff(r0 + (lane & 15), (k0 + (lane >> 4) * 8) * 2, BM));
}
__device__ __forceinline__ void x_frag_a(const float*, const uint8_t* xs, int BM, int r0, int k0,
                                         uint32_t (&f)[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a0a1: (g, 2q); a2a3: (g + 8, 2q); a4a5: (g, 2q + 8); a6a7
    const float2 v = *reinterpret_cast<const float2*>(
        xs + xoff(r0 + g + (i & 1) * 8, (k0 + 2 * q + (i >> 1) * 8) * 4, BM));
    uint32_t w[3];
    split3(v.x, v.y, w);
#pragma unroll
    for (int l = 0; l < 3; ++l) f[l][i] = w[l];
  }
}

// The B fragments of the warp's eight n8 tiles at K rows k0 + 2q (+1, +8,
// +9) of a stage (w: row k0 + 2q of the box; co0 / co1: the lane's 8 bytes
// in rows 2q (+8) / 2q + 1 (+8) of the swizzle): tile j's column g is the
// lane's column 8 g + j.
__device__ __forceinline__ void w_frag_b(const uint8_t* w, int co0, int co1, uint32_t magic,
                                         uint32_t (&f)[8][2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint2 lo = *reinterpret_cast<const uint2*>(w + 8 * h * kBox + co0);
    const uint2 hi = *reinterpret_cast<const uint2*>(w + (8 * h + 1) * kBox + co1);
    const uint32_t a0 = lo.x ^ 0x80808080u, a1 = lo.y ^ 0x80808080u;
    const uint32_t b0 = hi.x ^ 0x80808080u, b1 = hi.y ^ 0x80808080u;
    f[0][h] = pair<0>(a0, b0, magic);
    f[1][h] = pair<1>(a0, b0, magic);
    f[2][h] = pair<2>(a0, b0, magic);
    f[3][h] = pair<3>(a0, b0, magic);
    f[4][h] = pair<0>(a1, b1, magic);
    f[5][h] = pair<1>(a1, b1, magic);
    f[6][h] = pair<2>(a1, b1, magic);
    f[7][h] = pair<3>(a1, b1, magic);
  }
}

template <typename XT, typename OT, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 2 : 1)
matmul_large(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
             const Args a) {
  constexpr int BN = tile_n(false), BM = tile_m(false, MT);
  constexpr int kLimbs = sizeof(XT) == 4 ? 3 : 1;
#ifdef K13_MM_DIRECT
  constexpr int kSteps = 1;
#else
  constexpr int kSteps = kLimbs == 1 ? 2 : 1;   // k16 steps a zeroed tile takes
#endif
  extern __shared__ uint8_t smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Geo g = geometry(false, MT, a.rs, a.stages, sizeof(XT));
  const int n0 = (int)(blockIdx.x / cs) * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  int s0, s1;
  block_stages(a, rank, cs, s0, s1);
  const int n_st = s1 - s0, S = a.stages;
  const Ring ring = start_ring<XT, false, MT>(&wmap, &xmap, a, g, s0, n_st, n0, smem_raw);
  uint32_t magic = 0x4B000000u;
  asm volatile("" : "+r"(magic));
  const int c = wn * 64 + 8 * g8;   // the lane's 8 bytes of a weight row
  const int co0 = (((c >> 4) ^ (2 * q)) << 4) + (c & 15);
  const int co1 = (((c >> 4) ^ (2 * q + 1)) << 4) + (c & 15);

  float tot[MT][8][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][j][e] = 0.f;

  for (int i = 0; i < n_st; ++i) {
    bar_wait(ring.full + i % S, (uint32_t)((i / S) & 1));
#ifndef K13_MM_NO_MATH
    const uint8_t* ws = ring.smem + (i % S) * g.stage;
    const uint8_t* xs = ring.smem + (i % S) * g.stage + (size_t)a.rs * BN;
#pragma unroll 1
    for (int k0 = 0; k0 < a.rs; k0 += 16 * kSteps) {
      uint32_t af[kSteps][MT][kLimbs][4], bf[kSteps][8][2];
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        w_frag_b(ws + (k0 + 16 * st + 2 * q) * kBox, co0, co1, magic, bf[st]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
          x_frag_a(static_cast<const XT*>(nullptr), xs, BM, wm * 16 * MT + 16 * mi,
                   k0 + 16 * st, af[st][mi]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#ifdef K13_MM_DIRECT
          if constexpr (kLimbs == 1) {
            mma(tot[mi][j], af[0][mi][0], bf[0][j]);
            continue;
          }
#endif
          float tt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int st = 0; st < kSteps; ++st)
#pragma unroll
            for (int l = kLimbs - 1; l >= 0; --l) mma(tt, af[st][mi][l], bf[st][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) tot[mi][j][e] += tt[e];
        }
    }
#endif
    release_slot<XT, false, MT>(&wmap, &xmap, a, g, ring, s0, n_st, n0, i);
  }
  __syncthreads();

  // accumulator element e of (mi, j): x row 16 (MT wm + mi) + g8 (+ 8 for
  // e >= 2), column 64 wn + 8 (2 q + (e & 1)) + j of the tile
  float* part = reinterpret_cast<float*>(ring.smem);
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(16 * (MT * wm + mi) + g8 + 8 * (e >> 1)) * BN + 64 * wn + 8 * (2 * q + (e & 1)) + j] =
            tot[mi][j][e];
  finish<OT, BM, BN>(a, cluster, part, n0);
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <typename K>
int launch_kernel(K kernel, const CUtensorMap& wmap, const CUtensorMap& xmap, const Args& a,
                  bool small, int R, int cluster, int xsize, cudaStream_t stream) {
  const size_t smem = geometry(small, R, a.rs, a.stages, xsize).total;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((a.N + tile_n(small) - 1) / tile_n(small) * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, wmap, xmap, a);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <typename XT, typename OT>
int launch_t(const CUtensorMap& wmap, const CUtensorMap& xmap, const Args& a, bool small, int R,
             int cluster, cudaStream_t stream) {
  const int xs = (int)sizeof(XT);
  if (small)
    return R == 1 ? launch_kernel(matmul_small<XT, OT, 1>, wmap, xmap, a, true, 1, cluster, xs,
                                  stream)
                  : launch_kernel(matmul_small<XT, OT, 2>, wmap, xmap, a, true, 2, cluster, xs,
                                  stream);
  if (R == 1)
    return launch_kernel(matmul_large<XT, OT, 1>, wmap, xmap, a, false, 1, cluster, xs, stream);
  if (R == 2)
    return launch_kernel(matmul_large<XT, OT, 2>, wmap, xmap, a, false, 2, cluster, xs, stream);
  return launch_kernel(matmul_large<XT, OT, 4>, wmap, xmap, a, false, 4, cluster, xs, stream);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of a launch with this plan takes
// (x_bytes: 2 for bf16 x, 4 for f32).
size_t quant_matmul_smem(int small, int rows, int rs, int stages, int x_bytes) {
  return geometry(small != 0, rows, rs, stages, x_bytes).total;
}

// x: (M, K) f32 or bf16 (x_bf16); q: (K, N) int8; s: (N,) f32; out: (M, N)
// f32 when out_f32 or x is f32, else bf16. The plan (ops/cuda/
// quant_matmul.py matmul_plan): small (M <= 8 rows: 1 or 2 n8 blocks of x
// rows) or large (rows: 1, 2 or 4 m16 tiles a warp, M <= 64 rows), rs rows
// a stage (32, 64 or 128, rs x's bytes a whole number of 128-byte boxes),
// `stages` (2 to 8), `cluster` blocks a column tile (1 to 8, at most one a
// stage). tma_w: N a multiple of 16 and q 16-byte aligned (else element
// copies of the weight); tma_x: x's rows whole 16-byte segments, x 16-byte
// aligned (else element copies of x). Returns the launch's error or
// cudaGetLastError().
int quant_matmul(const void* x, const int8_t* q, const float* s, void* out, int M, int K, int N,
                 int small, int rows, int rs, int stages, int cluster, int x_bf16, int out_f32,
                 int tma_w, int tma_x, void* stream) {
  const int ns = (rs > 0 ? (K + rs - 1) / rs : 0), xsize = x_bf16 ? 2 : 4;
  const bool rows_ok = small ? (rows == 1 || rows == 2) : (rows == 1 || rows == 2 || rows == 4);
  if (M < 2 || K < 1 || N < 1 || !rows_ok || M > tile_m(small != 0, rows) || rs < 32 ||
      rs > 128 || rs % 32 || (rs * xsize) % kBox || stages < 2 || stages > 8 || cluster < 1 ||
      cluster > kMaxCluster || cluster > ns || (tma_w && (N % 16 || (uintptr_t)q % 16)) ||
      (tma_x && ((K * xsize) % 16 || (uintptr_t)x % 16)))
    return (int)cudaErrorInvalidValue;
  if (quant_matmul_smem(small, rows, rs, stages, xsize) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap = {}, xmap = {};
  if (tma_w) {
    const int err = weight_map(q, K, N, rs, kBox, CU_TENSOR_MAP_SWIZZLE_128B, &wmap);
    if (err != 0) return err;
  }
  if (tma_x) {   // x as a byte matrix: M rows of K xsize bytes, boxes of its BM rows
    const int err = weight_map(x, M, K * xsize, tile_m(small != 0, rows), kBox,
                               CU_TENSOR_MAP_SWIZZLE_128B, &xmap);
    if (err != 0) return err;
  }
  const Args a{x, q, s, out, M, K, N, rs, stages, tma_w, tma_x};
  cudaStream_t st = (cudaStream_t)stream;
  if (!x_bf16) return launch_t<float, float>(wmap, xmap, a, small != 0, rows, cluster, st);
  if (out_f32)
    return launch_t<__nv_bfloat16, float>(wmap, xmap, a, small != 0, rows, cluster, st);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(wmap, xmap, a, small != 0, rows, cluster, st);
}

}  // extern "C"
