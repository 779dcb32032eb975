// w8a16 product at M = 1 (kernel K13's decode row): y (1, N) = (x (1, K) @
// q (K, N) int8) * s (N,), accumulated in f32 over the whole K and scaled
// once, rounded once to the output type (x's, or f32 for the int8 LM head).
// quant_matmul.cu takes 1 < M <= 256 on weight_stream.cuh.
//
// Replaces, at M = 1, the TPU kernel easykv_tpu/ops/pallas/quant_matmul.py
// `quant_matmul` (f32 accumulation, one scale multiply).
//
// What bounds it on an H100: the int8 weight bytes (wo at LLaMa-2-7B width:
// 16.8 MB, 5.0 us at 3.35 TB/s; the LM head 131 MB). The design keeps them
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
//     counted in bytes on the stage's mbarrier; the producer issues a stage
//     as soon as the consumers release its slot, so a block keeps its whole
//     ring (two stages of 128 rows, 64 KB) in flight. The tensor map is made
//     once per weight and passed as a __grid_constant__ parameter;
//   * eight consumer warps: a thread owns 16 columns and every 16th row of
//     a stage, reads its 16 bytes with one shared-memory load, and turns
//     each byte into its f32 value exactly with one byte permute and one
//     subtraction (the byte, sign bit flipped, as the low mantissa byte of
//     2^23), then one FMA with x (held in shared memory as f32 for the
//     block's rows). About 3 operations a weight byte, a quarter of what the
//     CUDA cores can do while the bytes stream;
//   * a ragged width (N not a multiple of 16, which a tensor map's row
//     stride needs): the producer warp copies the stage's bytes itself into
//     the same layout and arrives on the same barrier.
// Built with -DK13_NO_MATH (a diagnostic build) the consumers skip the
// arithmetic: the weight stream alone.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "tma_ring.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tma_ring;

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

// The shared-memory layout of a block, from a 128-byte aligned base: S
// stages of rs x kTN bytes, the warps' partials (kWarps, kTN) f32, the
// block's partial (kTN) f32, x for the block's rows (xrows f32), 2 S
// mbarriers; 128 bytes of slack for the alignment.
struct Geo {
  size_t part, blk, xs, bars, total;
};

__host__ __device__ inline Geo geometry(int rs, int S, int xrows) {
  Geo g;
  g.part = (size_t)S * rs * kTN;
  g.blk = g.part + (size_t)kWarps * kTN * sizeof(float);
  g.xs = g.blk + (size_t)kTN * sizeof(float);
  g.bars = align_to(g.xs + (size_t)xrows * sizeof(float), 8);
  g.total = 128 + g.bars + (size_t)2 * S * sizeof(uint64_t);
  return g;
}

// Rows of x a block holds: its share of the stages, rounded up.
__host__ __device__ inline int x_rows(int K, int rs, int CS) {
  const int NS = (K + rs - 1) / rs;
  return (NS + CS - 1) / CS * rs;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// acc[j0 .. j0 + 3] += xv * the four signed bytes of `word`, each made exact
// in f32: its sign bit flipped, it is the low byte of 2^23's mantissa, so
// the float is 2^23 + b + 128.
__device__ __forceinline__ void mac4(float (&acc)[kVec], int j0, uint32_t word, float xv) {
  const uint32_t u = word ^ 0x80808080u;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const float f = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650u | b)) - 8388736.f;
    acc[j0 + b] = fmaf(xv, f, acc[j0 + b]);
  }
}

// grid: (N / kTN slabs) x CS blocks, clusters of CS consecutive blocks (one
// slab); rs rows a stage, S stages; tma: the stages come by the tensor map
// (else the producer warp's own loads).
template <typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ CUtensorMap map, const XT* __restrict__ x,
            const int8_t* __restrict__ w, const float* __restrict__ s, OT* __restrict__ out,
            int K, int N, int rs, int S, int tma) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const Geo geo = geometry(rs, S, x_rows(K, rs, CS));
  float* part = reinterpret_cast<float*>(smem + geo.part);
  float* blk = reinterpret_cast<float*>(smem + geo.blk);
  float* xs = reinterpret_cast<float*>(smem + geo.xs);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.bars);
  uint64_t* empty = full + S;

  const int c0 = (int)(blockIdx.x / CS) * kTN;
  const int tnv = N - c0 < kTN ? N - c0 : kTN;          // the slab's columns
  const int NS = (K + rs - 1) / rs;
  const int s_begin = (int)((long long)rank * NS / CS);
  const int n_st = (int)((long long)(rank + 1) * NS / CS) - s_begin;
  const int stage_bytes = rs * kTN;
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
      unsigned char* st = smem + (size_t)slot * stage_bytes;
      if (tma) {
        if (lane == 0) {
          bar_arrive_tx(full + slot, (uint32_t)stage_bytes);
          box_copy(st, &map, c0, r0, full + slot);
        }
      } else {
        for (int e = lane; e < stage_bytes / 4; e += 32) {
          const int r = e / (kTN / 4), c = e % (kTN / 4) * 4;
          uint32_t word = 0;
          if (r0 + r < K)
            for (int b = 0; b < 4; ++b)
              if (c + b < tnv)
                word |= (uint32_t)(uint8_t)w[(size_t)(r0 + r) * N + c0 + c + b] << (8 * b);
          *reinterpret_cast<uint32_t*>(st + r * kTN + c) = word;
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
      float v[kXFill];
#pragma unroll
      for (int f = 0; f < kXFill; ++f) {
        const int r = r_begin + i0 + f * kConsumers;
        v[f] = r < K ? to_f32(x[r]) : 0.f;
      }
#pragma unroll
      for (int f = 0; f < kXFill; ++f)
        if (i0 + f * kConsumers < n_st * rs) xs[i0 + f * kConsumers] = v[f];
    }
    named_sync(1, kConsumers);
    float acc[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[j] = 0.f;
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % S;
      bar_wait(full + slot, (uint32_t)((i / S) & 1));
#ifndef K13_NO_MATH
      const unsigned char* st = smem + (size_t)slot * stage_bytes + cl * kVec;
      const float* xr = xs + i * rs;
#pragma unroll 4
      for (int r = rl; r < rs; r += kRowLanes) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + r * kTN);
        const float xv = xr[r];
        mac4(acc, 0, v.x, xv);
        mac4(acc, 4, v.y, xv);
        mac4(acc, 8, v.z, xv);
        mac4(acc, 12, v.w, xv);
      }
#endif
      __syncwarp();
      if (lane == 0) bar_arrive(empty + slot);
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
    float sum = 0.f;
    for (int r = 0; r < CS; ++r) sum += cluster.map_shared_rank(blk, r)[c];
    store(out + c0 + c, sum * s[c0 + c]);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// host: tensor maps, launch
// ---------------------------------------------------------------------------

// The tensor map of a weight (K rows of N bytes at w) in boxes of rs rows x
// kTN columns, made once per (address, shape) and kept (open addressing
// over a fixed table; a weight freed and another allocated at its address
// with its shape gets the same map, which is right for it).
int weight_map(const int8_t* w, int K, int N, int rs, CUtensorMap* out) {
  struct Entry {
    const void* w;
    int K, N, rs;
    CUtensorMap map;
  };
  constexpr int kSlots = 4096, kProbe = 16;
  static std::mutex mu;
  static Entry table[kSlots];
  std::lock_guard<std::mutex> lock(mu);
  const uint64_t key = reinterpret_cast<uint64_t>(w) ^ ((uint64_t)K << 40) ^ ((uint64_t)N << 20) ^
                       (uint64_t)rs;
  const int h = (int)((key * 0x9E3779B97F4A7C15ull) >> 52);   // 12 bits
  Entry* free_slot = nullptr;
  for (int i = 0; i < kProbe; ++i) {
    Entry& e = table[(h + i) % kSlots];
    if (e.w == w && e.K == K && e.N == N && e.rs == rs) {
      *out = e.map;
      return 0;
    }
    if (e.w == nullptr && free_slot == nullptr) free_slot = &e;
  }
  CUtensorMap map;
  const int err = byte_map(w, K, N, rs, kTN, CU_TENSOR_MAP_L2_PROMOTION_L2_256B, &map);
  if (err != 0) return err;
  Entry* e = free_slot != nullptr ? free_slot : &table[h % kSlots];   // full: replace the first
  *e = Entry{w, K, N, rs, map};
  *out = map;
  return 0;
}

template <typename XT, typename OT>
int launch_t(const CUtensorMap& map, const void* x, const int8_t* w, const float* s, void* out,
             int K, int N, int rs, int S, int CS, int tma, cudaStream_t stream) {
  auto kernel = gemv_kernel<XT, OT>;
  const size_t smem = geometry(rs, S, x_rows(K, rs, CS)).total;
  const cudaError_t ea =   // on the current device, for this launch's size
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const XT*>(x), w, s,
                                           static_cast<OT*>(out), K, N, rs, S, tma);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

}  // namespace

extern "C" {

// Bytes of shared memory one block of a launch with this plan takes.
size_t quant_gemv_smem(int K, int rs, int stages, int cluster) {
  return geometry(rs, stages, x_rows(K, rs, cluster)).total;
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
  if (K < 1 || N < 1 || rs < kRowLanes || rs % kRowLanes || rs > 256 || stages < 2 ||
      stages > kMaxStages || cluster < 1 || cluster > kMaxCluster ||
      cluster > (K + rs - 1) / rs || (tma && (N % 16 || (uintptr_t)q % 16)))
    return (int)cudaErrorInvalidValue;
  if (quant_gemv_smem(K, rs, stages, cluster) > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    const int err = weight_map(q, K, N, rs, &map);
    if (err != 0) return err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  if (!x_bf16)
    return launch_t<float, float>(map, x, q, s, out, K, N, rs, stages, cluster, tma, st);
  if (out_f32)
    return launch_t<__nv_bfloat16, float>(map, x, q, s, out, K, N, rs, stages, cluster, tma, st);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(map, x, q, s, out, K, N, rs, stages, cluster, tma,
                                                st);
}

}  // extern "C"
