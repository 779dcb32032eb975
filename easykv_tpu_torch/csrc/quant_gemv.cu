// Weight products at M = 1 (the decode row) on one asynchronous weight
// stream, two carrier formats of one body:
//   * kernel K13's decode row, w8a16: y (1, N) = (x (1, K) @ q (K, N) int8) *
//     s (N,), accumulated in f32 over the whole K and scaled once, rounded
//     once to the output type (x's, or f32 for the int8 LM head). Replaces,
//     at M = 1, the TPU kernel easykv_tpu/ops/pallas/quant_matmul.py
//     `quant_matmul`; quant_matmul.cu takes 1 < M <= 256 on the tensor
//     cores;
//   * kernel K10, w4a16 over the arithmetic int4 carrier p (K/2, N) int8 =
//     16 hi + lo, nibbles in [-7, 7], rows r of the low half (x[r]) and K/2
//     + r of the high half (x[K/2 + r]), with the bf16 scale pair gs3 (K/G,
//     N) = [gs_hi; gs_lo] / 16 of each group of G carrier rows. Replaces the
//     TPU kernel easykv_tpu/ops/pallas/w4_stream.py `w4a16_gemv_arith`,
//     which recovers the nibble planes from MXU dots against masked copies
//     of x (the 3-functional algebra with xl - xh/16), because Mosaic has no
//     int8 vector arithmetic; nothing of that algebra is carried over.
//
// What bounds it on an H100: the weight bytes (wo at LLaMa-2-7B width: 16.8
// MB of int8, 5.0 us at 3.35 TB/s; the LM head 131 MB; K10's wg carrier
// 22.5 MB and its scale pair 0.7 MB, 6.9 us). The design keeps them
// streaming in one wave, with nothing between the blocks but distributed
// shared memory:
//   * a block owns a 256-column slab over a span of rows; where the slabs
//     are too few to fill 132 SMs, the rows split over the blocks of a
//     thread-block cluster (at most 8), whose partials add through
//     distributed shared memory in rank order. No workspace, no ticket, no
//     fence: the same bits in every run and on any stream;
//   * an asynchronous ring in shared memory, filled by one producer warp:
//     a stage is `rs` rows of the slab, one box of a tensor map (no swizzle:
//     a box row is 256 contiguous bytes of the weight), its completion
//     counted in bytes on the stage's mbarrier; for K10 a stage is a whole
//     number of scale groups where the group allows it (ops/cuda/
//     quant_matmul.py gemv_plan), and the scale rows of every group the
//     stage overlaps come with it, two bulk copies a group (its hi and lo
//     rows of the slab) on the same barrier; the producer issues a stage as
//     soon as the consumers release its slot, so a block keeps its whole
//     ring (two stages of 128 rows, 64 KB) in flight. The tensor map is made
//     once per weight and passed as a __grid_constant__ parameter;
//   * eight consumer warps: a thread owns 16 columns and every 16th row of
//     a stage, reads its 16 bytes with one shared-memory load, and turns
//     each byte into its f32 value exactly with one byte permute and one
//     subtraction (the byte as the low mantissa byte of 2^23), then one FMA
//     with x (held in shared memory as f32 for the block's rows). K13: the
//     byte, sign bit flipped, about 3 operations a weight byte. K10: per
//     4-byte word one LOP3 makes the four lo + 8 (the low nibble, bit 3
//     flipped) and an XOR, an add and an AND the four 16 (hi + 8) (the byte
//     plus 136 carries into no neighbour while the nibbles lie in [-7, 7]);
//     each becomes 2^23 + n and, less 2^23 + 8 or 2^23 + 128, lo or 16 hi
//     exactly; a thread keeps two f32 sums a column, 16 x[r] lo and
//     x[K/2 + r] 16 hi, and at its group's end adds them times the bf16
//     pair (gs / 16: the factors of 16 cancel exactly). About 7 operations
//     a carrier byte, near what the CUDA cores issue while 3.35 TB/s stream
//     (~4 TB/s of carrier at 132 SMs x 128 lanes);
//   * a ragged width (N not a multiple of 16, which a tensor map's row
//     stride needs): the producer warp copies the stage's bytes (and scale
//     rows) itself into the same layout and arrives on the same barrier.
// Built with -DK13_NO_MATH or -DK10_NO_MATH (diagnostic builds) the
// consumers of that format skip the arithmetic: the weight stream alone;
// -DK10_LO_ONLY skips K10's hi plane.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>


#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tma_ring;

enum { kFmtInt8 = 0, kFmtQ4A = 1 };                // K13's int8, K10's arithmetic int4 carrier

constexpr int kWarps = 8;                          // consumer warps
constexpr int kConsumers = 32 * kWarps;
constexpr int kThreads = kConsumers + 32;          // and one producer warp
constexpr int kTN = 256;                           // columns of a slab (bytes of a box row)
constexpr int kVec = 16;                           // columns of a consumer thread
constexpr int kLanesRow = kTN / kVec;              // threads a row: 16
constexpr int kRowLanes = kConsumers / kLanesRow;  // rows a stage's pass takes: 16
constexpr int kXFill = 8;                          // x elements a thread loads at once
constexpr int kMaxCluster = 8, kMaxStages = 16;
constexpr size_t kSmemLimit = 232448;

// Scale groups of G rows a stage of rs rows (its first row a multiple of
// rs) overlaps at most: rs / G where groups tile the stages, one where
// stages tile a group, else any window's bound.
__host__ __device__ inline int stage_groups(int rs, int G) {
  if (rs % G == 0) return rs / G;
  if (G % rs == 0) return 1;
  return (rs + G - 2) / G + 1;
}

// The shared-memory layout of a block, from a 128-byte aligned base: S
// stages of rs x kTN weight bytes (K10: then sg groups' scale rows, hi and
// lo, kTN bf16 each), the warps' partials (kWarps, kTN) f32, the block's
// partial (kTN) f32, x for the block's rows (xrows x xw f32: K10 keeps
// (16 x[r], x[K/2 + r])), 2 S mbarriers; 128 bytes of slack for the
// alignment.
struct Geo {
  size_t stage, part, blk, xs, bars, total;
};

__host__ __device__ inline Geo geometry(int rs, int S, int xrows, int xw, int sg) {
  Geo g;
  g.stage = (size_t)rs * kTN + (size_t)sg * 4 * kTN;
  g.part = (size_t)S * g.stage;
  g.blk = g.part + (size_t)kWarps * kTN * sizeof(float);
  g.xs = g.blk + (size_t)kTN * sizeof(float);
  g.bars = align_to(g.xs + (size_t)xrows * xw * sizeof(float), 8);
  g.total = 128 + g.bars + (size_t)2 * S * sizeof(uint64_t);
  return g;
}

// Rows of x a block holds: its share of the stages, rounded up.
__host__ __device__ inline int x_rows(int R, int rs, int CS) {
  const int NS = (R + rs - 1) / rs;
  return (NS + CS - 1) / CS * rs;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// Byte B of `a` as the low mantissa byte of 2^23 (`magic` holds 0x4B000000
// in a register, so that the byte selector is the permute's immediate and
// nothing is rematerialized a byte).
template <int B>
__device__ __forceinline__ float mantissa_byte(uint32_t a, uint32_t magic) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(magic), "n"(0x7650 | B));
  return __uint_as_float(d);
}

// (a & b) ^ c in one instruction, b and c in registers.
__device__ __forceinline__ uint32_t and_xor(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x6A;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// acc[j0 .. j0 + 3] += xv * the four signed bytes of `word`, each made exact
// in f32: its sign bit flipped, it is the low byte of 2^23's mantissa, so
// the float is 2^23 + b + 128.
__device__ __forceinline__ void mac4(float (&acc)[kVec], int j0, uint32_t word, float xv,
                                     uint32_t magic) {
  const uint32_t u = word ^ 0x80808080u;
  acc[j0 + 0] = fmaf(xv, mantissa_byte<0>(u, magic) - 8388736.f, acc[j0 + 0]);
  acc[j0 + 1] = fmaf(xv, mantissa_byte<1>(u, magic) - 8388736.f, acc[j0 + 1]);
  acc[j0 + 2] = fmaf(xv, mantissa_byte<2>(u, magic) - 8388736.f, acc[j0 + 2]);
  acc[j0 + 3] = fmaf(xv, mantissa_byte<3>(u, magic) - 8388736.f, acc[j0 + 3]);
}

// The four carrier bytes 16 hi + lo of `word` (nibbles in [-7, 7]):
// lo[j0 + b] += xv.x * lo, hi[j0 + b] += xv.y * 16 hi, each value exact in
// f32 as 2^23 + (lo + 8) less 2^23 + 8, or 2^23 + 16 (hi + 8) less 2^23 + 128.
// k0f, k08: 0x0F0F0F0F and 0x08080808 in registers.
__device__ __forceinline__ void mac4_q4(float (&lo)[kVec], float (&hi)[kVec], int j0,
                                        uint32_t word, float2 xv, uint32_t magic, uint32_t k0f,
                                        uint32_t k08) {
  const uint32_t l = and_xor(word, k0f, k08);                             // lo + 8 a byte
  const uint32_t h = ((word ^ 0x80808080u) + 0x08080808u) & 0xF0F0F0F0u;  // 16 (hi + 8)
  lo[j0 + 0] = fmaf(xv.x, mantissa_byte<0>(l, magic) - 8388616.f, lo[j0 + 0]);
  lo[j0 + 1] = fmaf(xv.x, mantissa_byte<1>(l, magic) - 8388616.f, lo[j0 + 1]);
  lo[j0 + 2] = fmaf(xv.x, mantissa_byte<2>(l, magic) - 8388616.f, lo[j0 + 2]);
  lo[j0 + 3] = fmaf(xv.x, mantissa_byte<3>(l, magic) - 8388616.f, lo[j0 + 3]);
#ifndef K10_LO_ONLY
  hi[j0 + 0] = fmaf(xv.y, mantissa_byte<0>(h, magic) - 8388736.f, hi[j0 + 0]);
  hi[j0 + 1] = fmaf(xv.y, mantissa_byte<1>(h, magic) - 8388736.f, hi[j0 + 1]);
  hi[j0 + 2] = fmaf(xv.y, mantissa_byte<2>(h, magic) - 8388736.f, hi[j0 + 2]);
  hi[j0 + 3] = fmaf(xv.y, mantissa_byte<3>(h, magic) - 8388736.f, hi[j0 + 3]);
#endif
}

// grid: (N / kTN slabs) x CS blocks, clusters of CS consecutive blocks (one
// slab); R weight rows (K13: K, K10: the carrier's K/2), rs rows a stage, S
// stages; K10: groups of G carrier rows, scales gs3 (2 R / G, N); tma: the
// stages come by the tensor map and bulk copies (else the producer warp's
// own loads).
template <int FMT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ CUtensorMap map, const XT* __restrict__ x,
            const int8_t* __restrict__ w, const float* __restrict__ s,
            const __nv_bfloat16* __restrict__ gs3, OT* __restrict__ out, int R, int N, int G,
            int rs, int S, int tma) {
  constexpr bool kQ4 = FMT == kFmtQ4A;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int sg = kQ4 ? stage_groups(rs, G) : 0;
  const Geo geo = geometry(rs, S, x_rows(R, rs, CS), kQ4 ? 2 : 1, sg);
  float* part = reinterpret_cast<float*>(smem + geo.part);
  float* blk = reinterpret_cast<float*>(smem + geo.blk);
  float* xs = reinterpret_cast<float*>(smem + geo.xs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.bars);
  uint64_t* empty = full + S;

  const int c0 = (int)(blockIdx.x / CS) * kTN;
  const int tnv = N - c0 < kTN ? N - c0 : kTN;          // the slab's columns
  const int NS = (R + rs - 1) / rs;
  const int s_begin = (int)((long long)rank * NS / CS);
  const int n_st = (int)((long long)(rank + 1) * NS / CS) - s_begin;
  const int stage_bytes = rs * kTN;
  const int gch = kQ4 ? R / G : 0;                     // groups a half
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(full + i, 1);         // the producer's one arrival (with the bytes)
      bar_init(empty + i, kWarps);   // one arrival a consumer warp
    }
    bar_fence_init();
  }
  __syncthreads();

  if (warp == kWarps) {
    // producer: stage s_begin + i into slot i mod S, once its consumers
    // released the slot's previous stage
    if (tma && lane == 0) prefetch_map(&map);
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % S, r0 = (s_begin + i) * rs;
      if (i >= S) bar_wait(empty + slot, (uint32_t)((i / S - 1) & 1));
      unsigned char* st = smem + (size_t)slot * geo.stage;
      // K10: the groups [g0, g0 + ng) the stage overlaps, their scale rows
      // after its weight bytes
      const int g0 = kQ4 ? r0 / G : 0;
      const int ng = kQ4 ? ((r0 + rs < R ? r0 + rs : R) - 1) / G - g0 + 1 : 0;
      unsigned char* sc = st + stage_bytes;
      if (tma) {
        if (lane == 0) {
          bar_arrive_tx(full + slot, (uint32_t)(stage_bytes + ng * 4 * tnv));
          box_copy(st, &map, c0, r0, full + slot);
          for (int gi = 0; gi < ng; ++gi) {
            bulk_copy(sc + gi * 4 * kTN, gs3 + (size_t)(g0 + gi) * N + c0, 2 * tnv, full + slot);
            bulk_copy(sc + gi * 4 * kTN + 2 * kTN, gs3 + (size_t)(gch + g0 + gi) * N + c0,
                      2 * tnv, full + slot);
          }
        }
      } else {
        for (int e = lane; e < stage_bytes / 4; e += 32) {
          const int r = e / (kTN / 4), c = e % (kTN / 4) * 4;
          uint32_t word = 0;
          if (r0 + r < R)
            for (int b = 0; b < 4; ++b)
              if (c + b < tnv)
                word |= (uint32_t)(uint8_t)w[(size_t)(r0 + r) * N + c0 + c + b] << (8 * b);
          *reinterpret_cast<uint32_t*>(st + r * kTN + c) = word;
        }
        for (int e = lane; e < ng * 2 * kTN; e += 32) {
          const int gi = e / (2 * kTN), h = e / kTN % 2, c = e % kTN;
          const int row = (h ? gch : 0) + g0 + gi;
          reinterpret_cast<__nv_bfloat16*>(sc)[e] =
              c < tnv ? gs3[(size_t)row * N + c0 + c] : __float2bfloat16_rn(0.f);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(full + slot);
      }
    }
  } else {
    // consumers: thread t takes columns 16 (t mod 16) .. + 15 of rows
    // t / 16, t / 16 + 16, ... of every stage
    const int t = threadIdx.x, cl = t % kLanesRow, rl = t / kLanesRow;
    const int r_begin = s_begin * rs;
    for (int i0 = t; i0 < n_st * rs; i0 += kConsumers * kXFill) {   // loads first
      float v[kXFill], vh[kXFill];
#pragma unroll
      for (int f = 0; f < kXFill; ++f) {
        const int r = r_begin + i0 + f * kConsumers;
        v[f] = r < R ? to_f32(x[r]) : 0.f;
        if (kQ4) vh[f] = r < R ? to_f32(x[R + r]) : 0.f;
      }
#pragma unroll
      for (int f = 0; f < kXFill; ++f) {
        const int i = i0 + f * kConsumers;
        if (i >= n_st * rs) continue;
        if (kQ4)
          reinterpret_cast<float2*>(xs)[i] = make_float2(16.f * v[f], vh[f]);
        else
          xs[i] = v[f];
      }
    }
    named_sync(1, kConsumers);
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    uint32_t magic = 0x4B000000u, k0f = 0x0F0F0F0Fu, k08 = 0x08080808u;
    asm volatile("" : "+r"(magic), "+r"(k0f), "+r"(k08));   // kept in registers
    if constexpr (!kQ4) {
      for (int i = 0; i < n_st; ++i) {
        const int slot = i % S;
        bar_wait(full + slot, (uint32_t)((i / S) & 1));
#ifndef K13_NO_MATH
        const unsigned char* st = smem + (size_t)slot * geo.stage + cl * kVec;
        const float* xr = xs + i * rs;
#pragma unroll 4
        for (int r = rl; r < rs; r += kRowLanes) {
          const uint4 v = *reinterpret_cast<const uint4*>(st + r * kTN);
          const float xv = xr[r];
          mac4(acc, 0, v.x, xv, magic);
          mac4(acc, 4, v.y, xv, magic);
          mac4(acc, 8, v.z, xv, magic);
          mac4(acc, 12, v.w, xv, magic);
        }
#endif
        __syncwarp();
        if (lane == 0) bar_arrive(empty + slot);
      }
    } else {
      // per group: lo and hi sums of the thread's rows, added times the
      // group's scale pair where the group (or the block's rows) ends
      const float2* x2 = reinterpret_cast<const float2*>(xs);
      const int r_end = (s_begin + n_st) * rs < R ? (s_begin + n_st) * rs : R;
      float alo[kVec], ahi[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) alo[j] = ahi[j] = 0.f;
      for (int i = 0; i < n_st; ++i) {
        const int slot = i % S;
        bar_wait(full + slot, (uint32_t)((i / S) & 1));
#ifndef K10_NO_MATH
        const unsigned char* st = smem + (size_t)slot * geo.stage;
        const int sr0 = (s_begin + i) * rs, sr1 = sr0 + rs < R ? sr0 + rs : R, g0 = sr0 / G;
        for (int gs = sr0; gs < sr1;) {
          const int g = gs / G, ge = (g + 1) * G < sr1 ? (g + 1) * G : sr1;
#pragma unroll 4
          for (int r = gs + ((rl - gs) & (kRowLanes - 1)); r < ge; r += kRowLanes) {
            const uint4 v = *reinterpret_cast<const uint4*>(st + (r - sr0) * kTN + cl * kVec);
            const float2 xv = x2[r - r_begin];
            mac4_q4(alo, ahi, 0, v.x, xv, magic, k0f, k08);
            mac4_q4(alo, ahi, 4, v.y, xv, magic, k0f, k08);
            mac4_q4(alo, ahi, 8, v.z, xv, magic, k0f, k08);
            mac4_q4(alo, ahi, 12, v.w, xv, magic, k0f, k08);
          }
          if (ge == (g + 1) * G || ge == r_end) {
            const uint4* sp = reinterpret_cast<const uint4*>(st + stage_bytes +
                                                             (size_t)(g - g0) * 4 * kTN + cl * 32);
            const uint4 hv[2] = {sp[0], sp[1]}, lv[2] = {sp[kTN / 8], sp[kTN / 8 + 1]};
            const __nv_bfloat16* hs = reinterpret_cast<const __nv_bfloat16*>(hv);
            const __nv_bfloat16* ls = reinterpret_cast<const __nv_bfloat16*>(lv);
#pragma unroll
            for (int j = 0; j < kVec; ++j) {
              acc[j] = fmaf(ahi[j], __bfloat162float(hs[j]),
                            fmaf(alo[j], __bfloat162float(ls[j]), acc[j]));
              alo[j] = ahi[j] = 0.f;
            }
          }
          gs = ge;
        }
#endif
        __syncwarp();
        if (lane == 0) bar_arrive(empty + slot);
      }
    }
    // the block's partial: a warp's two row lanes (lanes l and l + 16),
    // then the warps in order
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], 16);
    if (lane < kLanesRow)
#pragma unroll
      for (int j = 0; j < kVec; ++j) part[warp * kTN + cl * kVec + j] = acc[j];
    named_sync(1, kConsumers);
    for (int c = t; c < kTN; c += kConsumers) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) sum += part[wi * kTN + c];
      blk[c] = sum;
    }
  }

  // the cluster's partials, added in rank order: block `rank` finishes its
  // share of the slab's columns
  cluster.sync();
  const int per = (kTN + CS - 1) / CS;
  const int c_end = (rank + 1) * per < tnv ? (rank + 1) * per : tnv;
  for (int c = rank * per + (int)threadIdx.x; c < c_end; c += kThreads) {
    float v[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) v[r] = r < CS ? cluster.map_shared_rank(blk, r)[c] : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < CS) sum += v[r];
    store(out + c0 + c, kQ4 ? sum : sum * s[c0 + c]);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// host: tensor maps, launch
// ---------------------------------------------------------------------------

template <int FMT, typename XT, typename OT>
int launch_t(const CUtensorMap& map, const void* x, const int8_t* w, const float* s,
             const void* gs3, void* out, int R, int N, int G, int rs, int S, int CS, int tma,
             cudaStream_t stream) {
  auto kernel = gemv_kernel<FMT, XT, OT>;
  const bool q4 = FMT == kFmtQ4A;
  const size_t smem =
      geometry(rs, S, x_rows(R, rs, CS), q4 ? 2 : 1, q4 ? stage_groups(rs, G) : 0).total;
  cudaError_t ea =   // on the current device, for this launch's size
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ea != cudaSuccess) return (int)ea;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + kTN - 1) / kTN * CS));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = (unsigned)CS;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const XT*>(x), w, s,
                         static_cast<const __nv_bfloat16*>(gs3), static_cast<OT*>(out), R, N, G,
                         rs, S, tma);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

bool plan_ok(int R, int N, int rs, int stages, int cluster) {
  return R >= 1 && N >= 1 && rs >= kRowLanes && rs % kRowLanes == 0 && rs <= 256 &&
         stages >= 2 && stages <= kMaxStages && cluster >= 1 && cluster <= kMaxCluster &&
         cluster <= (R + rs - 1) / rs;
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of a K13 launch with this plan takes.
size_t quant_gemv_smem(int K, int rs, int stages, int cluster) {
  return geometry(rs, stages, x_rows(K, rs, cluster), 1, 0).total;
}

// Bytes of shared memory one block of a K10 launch with this plan takes
// (K: x's length; the carrier has K / 2 rows in groups of G).
size_t w4a16_gemv_arith_smem(int K, int G, int rs, int stages, int cluster) {
  return geometry(rs, stages, x_rows(K / 2, rs, cluster), 2, stage_groups(rs, G)).total;
}

// x: (1, K) f32 or bf16 (x_bf16), any alignment; q: (K, N) int8, 16-byte
// aligned; s: (N,) f32; out: (1, N) f32 when out_f32 or x is f32, else bf16.
// The plan (ops/cuda/quant_matmul.py gemv_plan): rs rows a stage (a
// multiple of 16, at most 256), `stages` stages in the ring (2 to 16),
// `cluster` blocks a slab (1 to 8, at most one a stage); tma: N a multiple
// of 16 (else the producer's own loads). Returns the launch's error or
// cudaGetLastError().
int quant_gemv(const void* x, const int8_t* q, const float* s, void* out, int K, int N, int rs,
               int stages, int cluster, int x_bf16, int out_f32, int tma, void* stream) {
  if (!plan_ok(K, N, rs, stages, cluster) || (tma && (N % 16 || (uintptr_t)q % 16)))
    return (int)cudaErrorInvalidValue;
  if (quant_gemv_smem(K, rs, stages, cluster) > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    const int err = weight_map(q, K, N, rs, kTN, CU_TENSOR_MAP_SWIZZLE_NONE, &map);
    if (err != 0) return err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (!x_bf16)
    return launch_t<kFmtInt8, float, float>(map, x, q, s, nullptr, out, K, N, 0, rs, stages,
                                            cluster, tma, st);
  if (out_f32)
    return launch_t<kFmtInt8, __nv_bfloat16, float>(map, x, q, s, nullptr, out, K, N, 0, rs,
                                                    stages, cluster, tma, st);
  return launch_t<kFmtInt8, __nv_bfloat16, __nv_bfloat16>(map, x, q, s, nullptr, out, K, N, 0,
                                                          rs, stages, cluster, tma, st);
}

// K10: x (1, K) f32 or bf16 (x_bf16), any alignment; p (K/2, N) int8
// arithmetic carrier, 16-byte aligned; gs3 (K/G, N) bf16 = [gs_hi; gs_lo] /
// 16, G a multiple of 8 dividing K/2; out (1, N) in x's type. The plan
// (quant_matmul.gemv_plan with G): rs carrier rows a stage, `stages`,
// `cluster` as above; tma: N a multiple of 16 and gs3 16-byte aligned (else
// the producer's own loads). Returns the launch's error or
// cudaGetLastError().
int w4a16_gemv_arith(const void* x, const int8_t* p, const void* gs3, void* out, int K, int N,
                     int G, int rs, int stages, int cluster, int x_bf16, int tma, void* stream) {
  const int R = K / 2;
  if (K % 2 || G < 8 || G % 8 || R % G || !plan_ok(R, N, rs, stages, cluster) ||
      (tma && (N % 16 || (uintptr_t)p % 16 || (uintptr_t)gs3 % 16)))
    return (int)cudaErrorInvalidValue;
  if (w4a16_gemv_arith_smem(K, G, rs, stages, cluster) > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    const int err = weight_map(p, R, N, rs, kTN, CU_TENSOR_MAP_SWIZZLE_NONE, &map);
    if (err != 0) return err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (!x_bf16)
    return launch_t<kFmtQ4A, float, float>(map, x, p, nullptr, gs3, out, R, N, G, rs, stages,
                                           cluster, tma, st);
  return launch_t<kFmtQ4A, __nv_bfloat16, __nv_bfloat16>(map, x, p, nullptr, gs3, out, R, N, G,
                                                         rs, stages, cluster, tma, st);
}

}  // extern "C"
