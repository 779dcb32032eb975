// w4a16 GEMV over halves-packed int4 (kernel K12): y (M, N) = x (M, K) @
// dequant(q4p (K/2, N), gs (K/G, N) f32), M <= 8.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/w4_matmul.py `w4a16_gemv`
// (one (K/2, 512) tile per grid step, nibbles unpacked in VMEM). Packed row
// r carries row r of x's first half in its low nibble and row r + K/2 of
// its second half in its high one; the two halves take the first and the
// second K/(2G) scale rows, applied to each group's f32 sums.
//
// What bounds it on an H100: the packed bytes and scales (wq at LLaMa-2-7B
// width: 8.4 MB + 0.5 MB of f32 scales, 2.67 us at 3.35 TB/s). The design
// keeps them streaming:
//   * one wave, no global combine: a block owns a 256-column slab over a
//     span of packed rows. Where the slabs are too few to fill 132 SMs, the
//     rows split over the blocks of a thread-block cluster (at most 8):
//     each block adds its partials for its share of the slab's (row,
//     column) elements over the cluster's blocks in rank order, reading
//     them from their shared memory. No workspace, no ticket, no fence; the
//     sum is the same in every run;
//   * an asynchronous ring of S >= 3 stages in shared memory, filled by the
//     Tensor Memory Accelerator: a stage is RS packed rows of the slab (RS
//     = gcd(G, 64), inside one group) as two 128-column boxes of one
//     tensor map (128-byte swizzle), the rows of x that multiply them, and,
//     where the stage closes a group's sums in this block, that group's two
//     scale rows (bulk copies). One producer warp issues a stage (a handful
//     of copies, completion counted in bytes on the stage's mbarrier) as
//     soon as the eight consumer warps release its slot, so a block keeps
//     up to S - 1 stages (~75 KB) in flight and no scale read waits behind
//     the dots. The tensor map is made once per weight (cuTensorMapEncodeTiled
//     from the driver entry point, cached by address and shape) and passed
//     as a __grid_constant__ parameter, so a CUDA graph replays it;
//   * the consumers: warp w owns 32 columns of the slab (two 16-column MMA
//     tiles). Per 16-row k-step, one ldmatrix.trans gives a lane its bytes
//     of both tiles (rows 2q, 2q + 1, 2q + 8, 2q + 9 of columns 2g, 2g + 1:
//     the m16n8k16 A fragments, the columns in the MMA's row slots g and
//     g + 8); each nibble plane becomes bf16 by a byte permute into 0x43nn
//     (128 + (n ^ 8)) minus 136, exact; mma.sync takes x's rows as the
//     8-wide B operand (bf16, or an f32 x as three bf16 limbs summed
//     smallest first in a zeroed tile, since the tensor cores truncate a
//     sum), f32 accumulators per group, then the group's scales;
//   * a ragged width (N not a multiple of 16) or an operand not 16-byte
//     aligned, where neither a tensor map nor a bulk copy can take it: the
//     producer warp copies the stage's elements itself into the same layout
//     and arrives on the same barrier.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                       // consumer warps: 32 columns each
constexpr int kThreads = 32 * (kWarps + 1);     // and one producer warp
constexpr int kTN = 256;                        // columns of a slab (carrier bytes a row)
constexpr int kBox = 128;                       // columns of a tensor-map box (its swizzle span)
constexpr int kMaxCluster = 8;
constexpr int kMinStages = 3, kMaxStages = 8;
constexpr size_t kSmemLimit = 232448;

__host__ __device__ inline size_t align_to(size_t n, size_t a) { return (n + a - 1) / a * a; }

// The shared-memory layout of a block, from a 1024-byte aligned base: S
// stages of 1024-byte aligned
// size (the carrier's two boxes of RS x 128 bytes, x as 2 x MT rows of RS16
// = RS rounded up to 16 elements, the two scale rows of kTN f32), then the
// block's partial (8 x kTN f32) and the 2 S mbarriers; 1024 bytes of slack
// for the alignment.
struct Geo {
  size_t carrier, x, stage, part, total;
  int rs16;
};

__host__ __device__ inline Geo geometry(int MT, int RS, int S, int xsize) {
  Geo g;
  g.rs16 = (RS + 15) / 16 * 16;
  g.carrier = (size_t)2 * RS * kBox;
  g.x = align_to((size_t)2 * MT * g.rs16 * xsize, 16);
  g.stage = align_to(g.carrier + g.x + (size_t)2 * kTN * sizeof(float), 1024);
  g.part = (size_t)S * g.stage;
  g.total = 1024 + g.part + (size_t)8 * kTN * sizeof(float) + (size_t)2 * S * sizeof(uint64_t);
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_expect_tx(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Arrives (release: the thread's earlier shared-memory stores are seen by a
// thread whose wait completes this phase).
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_u32(b))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n\t}" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to
// shared memory; completion counts against b's expected bytes.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(b))
      : "memory");
}

// The box of the tensor map at (column c, row r) into dst (1024-byte
// aligned); completion counts against b's expected bytes (the whole box:
// columns past N arrive as zeros).
__device__ __forceinline__ void box_copy(void* dst, const CUtensorMap* map, int c, int r,
                                         uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(b))
      : "memory");
}

// Byte offset of (row r, byte column b) in a box of 128-byte rows under the
// 128-byte swizzle: the 16-byte chunk b / 16 of row r sits at chunk
// (b / 16) ^ (r mod 8).
__device__ __forceinline__ int swz(int r, int b) {
  return r * kBox + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B over the limbs of x (one bf16 limb, or the three of an f32 x:
// their products, the smallest first, into a zeroed tile that is added to
// d with round-to-nearest, since each MMA truncates its sum).
template <int L>
__device__ __forceinline__ void mma_limbs(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[L][2]) {
  if constexpr (L == 1) {
    mma(d, a, b[0]);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = L - 1; l >= 0; --l) mma(t, a, b[l]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two consecutive x elements as the B operand's limbs: bf16 as they are,
// f32 as three bf16 limbs (x = l0 + l1 + l2 exactly); zeros where not live.
__device__ __forceinline__ void x_limbs(const __nv_bfloat16* p, bool live, uint32_t (&w)[1]) {
  w[0] = live ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}
__device__ __forceinline__ void x_limbs(const float* p, bool live, uint32_t (&w)[3]) {
  float a = live ? p[0] : 0.f, b = live ? p[1] : 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const __nv_bfloat16 ha = __float2bfloat16_rn(a), hb = __float2bfloat16_rn(b);
    w[k] = pack_bf16(ha, hb);
    a -= __bfloat162float(ha);
    b -= __bfloat162float(hb);
  }
}

// The A fragment of one nibble plane (0: low, 1: high) of an MMA tile from
// the two ldmatrix.trans words of its k-step (lo: rows 0..7, hi: rows
// 8..15; a word holds rows 2q, 2q + 1 of columns 2g, 2g + 1 as bytes
// (2q, 2g), (2q, 2g + 1), (2q + 1, 2g), (2q + 1, 2g + 1)): column 2g in row
// slot g, 2g + 1 in slot g + 8; each nibble n as the bf16 0x43nn' (n' = n
// ^ 8, so 128 + n'), minus 136.
__device__ __forceinline__ void a_frag(uint32_t wlo, uint32_t whi, int plane, uint32_t (&a)[4]) {
  const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
  const uint32_t nl = ((plane ? wlo >> 4 : wlo) & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t nh = ((plane ? whi >> 4 : whi) & 0x0F0F0F0Fu) ^ 0x08080808u;
  uint32_t v[4] = {__byte_perm(nl, 0x43434343u, 0x4240), __byte_perm(nl, 0x43434343u, 0x4341),
                   __byte_perm(nh, 0x43434343u, 0x4240), __byte_perm(nh, 0x43434343u, 0x4341)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 f = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v[i]), off);
    a[i] = *reinterpret_cast<uint32_t*>(&f);
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grid: (N / kTN slabs) x CS blocks, clusters of CS consecutive blocks (one
// slab). M <= MT rows of x; K = 2 Kh; G rows a group; RS rows a stage; S
// stages; tma: the copies go by the tensor map and bulk copies (else the
// producer warp's own loads).
template <int MT, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
gemv_kernel(const __grid_constant__ CUtensorMap map, const XT* __restrict__ x,
            const int8_t* __restrict__ w, const float* __restrict__ gs, OT* __restrict__ out,
            int M, int Kh, int N, int G, int RS, int S, int tma) {
  constexpr int kLimbs = sizeof(XT) == 4 ? 3 : 1;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const Geo geo = geometry(MT, RS, S, (int)sizeof(XT));
  float* part = reinterpret_cast<float*>(smem + geo.part);   // (8, kTN)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + geo.part + 8 * kTN * sizeof(float));
  uint64_t* empty = full + S;

  cg::cluster_group cluster = cg::this_cluster();
  const int CS = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int c0 = (int)(blockIdx.x / CS) * kTN;
  const int tnv = N - c0 < kTN ? N - c0 : kTN;        // the slab's columns
  const int NS = Kh / RS, gch = Kh / G, rs16 = geo.rs16;
  const int s_begin = (int)((long long)rank * NS / CS);
  const int s_end = (int)((long long)(rank + 1) * NS / CS);
  const int n_st = s_end - s_begin;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(full + i, 32);        // the producer warp's lanes
      bar_init(empty + i, kWarps);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage s closes a group's sums in this block: the group's last stage, or
  // the block's last
  auto closes = [&](int s) { return ((s + 1) * RS) % G == 0 || s == s_end - 1; };

  float tot[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[t][e] = 0.f;

  if (warp == kWarps) {
    // producer: stage s_begin + i into slot i mod S, once its consumers
    // released the slot's previous stage
    if (tma && lane == 0)
      asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % S, s = s_begin + i, r0 = s * RS, g = r0 / G;
      if (i >= S) bar_wait(empty + slot, (uint32_t)((i / S - 1) & 1));
      unsigned char* st = smem + (size_t)slot * geo.stage;
      XT* xs = reinterpret_cast<XT*>(st + geo.carrier);
      float* sc = reinterpret_cast<float*>(st + geo.carrier + geo.x);
      const bool cl = closes(s);
      if (tma) {
        if (lane == 0) {
          bar_expect_tx(full + slot, (uint32_t)(geo.carrier + 2 * M * RS * sizeof(XT) +
                                                (cl ? 2 * tnv * sizeof(float) : 0)));
          box_copy(st, &map, c0, r0, full + slot);
          box_copy(st + RS * kBox, &map, c0 + kBox, r0, full + slot);
        }
        __syncwarp();
        if (lane < 2 * M) {
          const int h = lane / M, m = lane % M;
          bulk_copy(xs + (size_t)(h * MT + m) * rs16, x + (size_t)m * 2 * Kh + (size_t)h * Kh + r0,
                    (uint32_t)(RS * sizeof(XT)), full + slot);
        }
        if (cl && lane >= 16 && lane < 18) {
          const int h = lane - 16;
          bulk_copy(sc + h * kTN, gs + (size_t)(h * gch + g) * N + c0,
                    (uint32_t)(tnv * sizeof(float)), full + slot);
        }
      } else {
        for (int e = lane; e < RS * kTN; e += 32) {
          const int r = e / kTN, c = e % kTN;
          st[(c >= kBox ? RS * kBox : 0) + swz(r, c & (kBox - 1))] =
              c < tnv ? static_cast<unsigned char>(w[(size_t)(r0 + r) * N + c0 + c]) : 0;
        }
        for (int e = lane; e < 2 * M * RS; e += 32) {
          const int hm = e / RS, r = e % RS, h = hm / M, m = hm % M;
          xs[(size_t)(h * MT + m) * rs16 + r] = x[(size_t)m * 2 * Kh + (size_t)h * Kh + r0 + r];
        }
        if (cl)
          for (int c = lane; c < tnv; c += 32) {
            sc[c] = gs[(size_t)g * N + c0 + c];
            sc[kTN + c] = gs[(size_t)(gch + g) * N + c0 + c];
          }
      }
      bar_arrive(full + slot);
    }
  } else {
    // consumers: warp w's 32 columns (two MMA tiles) of every stage
    const int g8 = lane >> 2, q = lane & 3;
    const int box = warp >> 2, wc = (warp & 3) * 32;   // the warp's box, its columns in it
    // ldmatrix rows: lane l feeds matrix l / 8 (tile (l / 8) / 2, rows
    // 8 ((l / 8) % 2) .. + 7 of the k-step), row l % 8
    const int lm = lane >> 3, lrow = 8 * (lm & 1) + (lane & 7), lcol = wc + 16 * (lm >> 1);
    const bool live = g8 < M;            // the B operand's column g8 is row g8 of x
    float acc[2][2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[t][p][e] = 0.f;
    for (int i = 0; i < n_st; ++i) {
      const int slot = i % S, s = s_begin + i;
      bar_wait(full + slot, (uint32_t)((i / S) & 1));
      const unsigned char* st = smem + (size_t)slot * geo.stage;
      const unsigned char* bx = st + box * RS * kBox;
      const XT* xs = reinterpret_cast<const XT*>(st + geo.carrier);
#ifdef K12_NO_MATH   // a diagnostic build: the stream without the arithmetic
      if (RS > 0) {
        __syncwarp();
        if (lane == 0) bar_arrive(empty + slot);
        continue;
      }
#endif
#pragma unroll 4
      for (int k0 = 0; k0 < RS; k0 += 16) {
        uint32_t wm[4];
        const int row = k0 + lrow < RS ? k0 + lrow : RS - 1;   // rows past RS: x is 0 there
        ldsm_x4_t(wm, bx + swz(row, lcol));
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t b[kLimbs][2];
#pragma unroll
          for (int kh = 0; kh < 2; ++kh) {
            const int r = k0 + 8 * kh + 2 * q;
            uint32_t l[kLimbs];
            x_limbs(xs + (size_t)(p * MT + (live ? g8 : 0)) * rs16 + r, live && r < RS, l);
#pragma unroll
            for (int k = 0; k < kLimbs; ++k) b[k][kh] = l[k];
          }
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            uint32_t a[4];
            a_frag(wm[2 * t], wm[2 * t + 1], p, a);
            mma_limbs<kLimbs>(acc[t][p], a, b);
          }
        }
      }
      if (closes(s)) {   // the group's scales on its sums
        const float* sc = reinterpret_cast<const float*>(st + geo.carrier + geo.x);
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = box * kBox + wc + 16 * t + 2 * g8 + (e >> 1);
            tot[t][e] += acc[t][0][e] * sc[c] + acc[t][1][e] * sc[kTN + c];
            acc[t][0][e] = acc[t][1][e] = 0.f;
          }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(empty + slot);
    }
    // the block's partial: accumulator element e of tile t is column
    // 2 g8 + (e >> 1) of the tile, row 2q + (e & 1) of x
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(2 * q + (e & 1)) * kTN + box * kBox + wc + 16 * t + 2 * g8 + (e >> 1)] = tot[t][e];
  }

  // the cluster's partials, added in rank order: block `rank` writes its
  // share of the slab's (row, column) elements
  cluster.sync();
  const int n = M * kTN, per = (n + CS - 1) / CS;
  const int e_end = (rank + 1) * per < n ? (rank + 1) * per : n;
  for (int e = rank * per + (int)threadIdx.x; e < e_end; e += kThreads) {
    const int m = e / kTN, c = e % kTN;
    if (c >= tnv) continue;
    float s = 0.f;
    for (int r = 0; r < CS; ++r) s += cluster.map_shared_rank(part, r)[e];
    store(out + (size_t)m * N + c0 + c, s);
  }
  cluster.sync();   // no block leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// host: tensor maps, launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  static std::once_flag once;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  });
  return fn;
}

// The tensor map of a carrier (Kh rows of N bytes at w) in boxes of RS rows
// x kBox columns with the 128-byte swizzle, made once per (address, shape)
// and kept (open addressing over a fixed table; a weight freed and another
// allocated at its address with its shape gets the same map, which is
// right for it).
int carrier_map(const int8_t* w, int Kh, int N, int RS, CUtensorMap* out) {
  struct Entry {
    const void* w;
    int Kh, N, RS;
    CUtensorMap map;
  };
  constexpr int kSlots = 4096, kProbe = 16;
  static std::mutex mu;
  static Entry table[kSlots];
  std::lock_guard<std::mutex> lock(mu);
  const uint64_t key = reinterpret_cast<uint64_t>(w) ^ ((uint64_t)Kh << 40) ^ ((uint64_t)N << 20) ^
                       (uint64_t)RS;
  const int h = (int)((key * 0x9E3779B97F4A7C15ull) >> 52);   // 12 bits
  Entry* free_slot = nullptr;
  for (int i = 0; i < kProbe; ++i) {
    Entry& e = table[(h + i) % kSlots];
    if (e.w == w && e.Kh == Kh && e.N == N && e.RS == RS) {
      *out = e.map;
      return 0;
    }
    if (e.w == nullptr && free_slot == nullptr) free_slot = &e;
  }
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)Kh};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)RS};
  const cuuint32_t estr[2] = {1, 1};
  CUtensorMap map;
  if (enc(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(w), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  Entry* e = free_slot != nullptr ? free_slot : &table[h % kSlots];   // full: replace the first
  *e = Entry{w, Kh, N, RS, map};
  *out = map;
  return 0;
}

template <int MT, typename XT, typename OT>
int launch_t(const CUtensorMap& map, const void* x, const int8_t* w, const float* gs, void* out,
             int M, int Kh, int N, int G, int RS, int S, int CS, int tma, cudaStream_t stream) {
  auto kernel = gemv_kernel<MT, XT, OT>;
  const size_t smem = geometry(MT, RS, S, (int)sizeof(XT)).total;
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, map, static_cast<const XT*>(x), w, gs,
                                           static_cast<OT*>(out), M, Kh, N, G, RS, S, tma);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

template <int MT>
int launch_mt(const CUtensorMap& map, const void* x, const int8_t* w, const float* gs, void* out,
              int M, int Kh, int N, int G, int RS, int S, int CS, int x_bf16, int out_f32, int tma,
              cudaStream_t st) {
  if (!x_bf16)
    return launch_t<MT, float, float>(map, x, w, gs, out, M, Kh, N, G, RS, S, CS, tma, st);
  if (out_f32)
    return launch_t<MT, __nv_bfloat16, float>(map, x, w, gs, out, M, Kh, N, G, RS, S, CS, tma,
                                              st);
  return launch_t<MT, __nv_bfloat16, __nv_bfloat16>(map, x, w, gs, out, M, Kh, N, G, RS, S, CS,
                                                    tma, st);
}

}  // namespace

extern "C" {

// x: (M, K) f32 or bf16; q4p: (K/2, N) int8; gs: (K/G, N) f32, one row a
// group of G packed rows of each half (the low half's groups first); out:
// (M, N) in x's type (f32 with out_f32; an f32 x gives an f32 out). The plan
// (ops/cuda/w4_matmul.py plan): mt >= M rows of x a tile, rs rows a stage
// (a multiple of 8 dividing G), ring_bytes of shared memory for the ring
// (as many stages as fit, 3 to 8), `cluster` blocks a slab (at most 8, at
// most K/2 / rs); tma: N a multiple of 16 and x, q4p, gs 16-byte aligned
// (else the producer's own loads). Returns the launch's error or
// cudaGetLastError().
int w4a16_gemv(const void* x, const int8_t* q4p, const float* gs, void* out, int M, int K, int N,
               int G, int mt, int rs, int ring_bytes, int cluster, int x_bf16, int out_f32,
               int tma, void* stream) {
  const int Kh = K / 2;
  const bool mt_ok = mt == 1 || mt == 2 || mt == 4 || mt == 8;
  if (!mt_ok || M < 1 || M > mt || K < 2 || K % 2 || N < 1 || G < 8 || G % 8 || Kh % G ||
      rs < 8 || rs % 8 || G % rs || rs > 256 || ring_bytes < 1 || cluster < 1 ||
      cluster > kMaxCluster || cluster > Kh / rs)
    return (int)cudaErrorInvalidValue;
  if (tma && (N % 16 || ((uintptr_t)x | (uintptr_t)q4p | (uintptr_t)gs) % 16))
    return (int)cudaErrorInvalidValue;
  const int xsize = x_bf16 ? 2 : 4;
  const size_t fit = (size_t)ring_bytes / geometry(mt, rs, 1, xsize).stage;
  const int stages = (int)(fit < kMinStages ? kMinStages : fit > kMaxStages ? kMaxStages : fit);
  if (geometry(mt, rs, stages, xsize).total > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map = {};
  if (tma) {
    const int err = carrier_map(q4p, Kh, N, rs, &map);
    if (err != 0) return err;
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (mt) {
    case 1:
      return launch_mt<1>(map, x, q4p, gs, out, M, Kh, N, G, rs, stages, cluster, x_bf16, out_f32,
                          tma, st);
    case 2:
      return launch_mt<2>(map, x, q4p, gs, out, M, Kh, N, G, rs, stages, cluster, x_bf16, out_f32,
                          tma, st);
    case 4:
      return launch_mt<4>(map, x, q4p, gs, out, M, Kh, N, G, rs, stages, cluster, x_bf16, out_f32,
                          tma, st);
    default:
      return launch_mt<8>(map, x, q4p, gs, out, M, Kh, N, G, rs, stages, cluster, x_bf16, out_f32,
                          tma, st);
  }
}

}  // extern "C"
