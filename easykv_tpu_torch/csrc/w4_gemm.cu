// K11 `w4a16_gemm_arith` on the tensor cores: out (M, N) = x (M, K) @ the
// arithmetic int4 carrier p (K/2, N) (byte b = 16 hi + lo, the nibbles in
// [-7, 7]: hi = (b + 8) >> 4, lo = b - 16 hi), lo multiplying x[:, :K/2] and
// hi x[:, K/2:], with one f32 scale per (group of 128 rows of a half,
// column): gs[g] for the lo half, gs[K/256 + g] for the hi half, on the f32
// sum of each group. 1 < M <= 512, (K/2) % 128 == 0, any N.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/w4_stream.py
// `w4a16_gemm_arith`, which recovers the nibble planes from MXU dots
// against masked copies of x (Mosaic has no int8 vector arithmetic). Here
// the integer units unpack each carrier byte once per block tile.
//
// What bounds it on an H100: at M = 512 the 2 M K N multiply-adds (wq at
// LLaMa-2-7B width: 17.2 GFLOP, 17.4 us at 989 TFLOP/s of bf16); at M <= 16
// the carrier bytes (wq 8.4 MB, 2.5 us at 3.35 TB/s). The nibbles are exact
// in bf16, and so is their product with a bf16 x, so the products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) and the result
// differs from the plain version only in the order of its f32 sums. An f32 x
// is split in the kernel into three bf16 limbs, x = x0 + x1 + x2 exactly,
// three products for one, summed apart and added to the group sum with
// round-to-nearest (mma_limbs: the tensor cores' accumulation truncates).
//
// Design. A block owns a tile of 128 columns and walks its groups (all of
// them, or a run of them when the groups are split over blocks) in steps of
// half a group, 64 carrier rows. Per step:
//   * cp.async (16-byte) has brought the step's carrier rows of the tile and
//     the x rows at its lo and hi columns (bf16 or f32) into a three-stage
//     ring, two steps ahead of the one being multiplied;
//   * the block unpacks the carrier rows into two bf16 planes in shared
//     memory, the lo and the hi nibbles: per byte v = b + 8 (bytewise, no
//     carry), lo + 8 = v & 15 and hi + 8 = (v >> 4) ^ 8, each set into the
//     mantissa of bf16 128 (0x43nn = 128 + n) and 136 subtracted: exact;
//   * the warps multiply the lo plane with x's lo columns and the hi plane
//     with its hi columns into two f32 group sums (ldmatrix for both
//     operands); after a group's second step each sum, times the lo or hi
//     scale of its column, goes into the running f32 total. One carrier
//     tile in shared memory feeds both halves, and the carrier leaves device
//     memory once per output tile.
// Shared memory is kept small enough for two blocks an SM (three at small
// M), so one block's unpack overlaps another's products. Two tile
// configurations, picked by the wrapper's plan:
//   * large M (M > 16): a block is 64 rows of x by 128 columns, 8 warps as 2
//     (rows) x 4 (columns), a warp 32 x 32: x is the 16-row A operand, the
//     plane the 8-wide B operand (ldmatrix.trans); 109 KB (bf16 x);
//   * small M (M <= 16, the split tree's batched decode): the carrier bytes
//     bound it, so nothing is wasted on padding x: the plane is the 16-row A
//     operand (ldmatrix.trans gives the transpose), the x rows the 8-wide B
//     operand (one MMA column block for M <= 8, two for M <= 16), a warp 16
//     columns; 71 KB.
// Where the column tiles are fewer than the blocks the card holds at once,
// the groups are split over gridDim.z blocks: each writes its f32 partial
// to a per-stream workspace and the last block of a tile to finish (an
// atomic ticket, reset by that block) adds them in split order. Every run
// gives the same bits; no float atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kG = 128;             // rows of a scale group
constexpr int kKS = 64;             // carrier rows of a ring stage: half a group
constexpr int kStages = 3;          // ring stages
constexpr int kBN = 128;            // columns of a block tile
constexpr int kPS = kBN + 8;        // bf16 between plane rows: ldmatrix rows on distinct banks
constexpr int kSmallM = 16;         // the small configuration's rows of x
constexpr int kLargeM = 64;         // the large configuration's rows of x

// elements between two x rows of a stage (the stage's lo and hi columns,
// padded so that eight rows of a fragment load fall on distinct banks)
template <typename XT>
__host__ __device__ constexpr int x_stride() { return sizeof(XT) == 2 ? 2 * kKS + 8 : 2 * kKS + 4; }

template <typename XT, bool kSmall>
struct Layout {
  static constexpr int kBM = kSmall ? kSmallM : kLargeM;
  static constexpr size_t kCarrier = (size_t)kKS * kBN;                        // bytes a stage
  static constexpr size_t kX = (size_t)kBM * x_stride<XT>() * sizeof(XT);      // bytes a stage
  static constexpr size_t kPlane = (size_t)kKS * kPS * 2;                      // lo, then hi
  static constexpr size_t bytes() { return kStages * (kCarrier + kX) + 2 * kPlane; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared, the first `bytes` of them read, the rest 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B for the limbs of an x operand (one bf16 limb, or the three of an
// f32 x). Three limbs' products go, the smallest first, into a zeroed tile
// that is then added to d with round-to-nearest: the tensor cores truncate
// each MMA's sum to d's precision, so the small limbs added straight into a
// large d would lose their bits, an ulp or so every MMA.
template <int L>
__device__ __forceinline__ void mma_limbs(float (&d)[4], const uint32_t (&a)[L][4],
                                          const uint32_t* b) {
  if constexpr (L == 1) {
    mma(d, a[0], b);
  } else {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = L - 1; l >= 0; --l) mma(t, a[l], b);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
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

// Four carrier bytes (four columns of one row) as the bf16 values of one
// nibble plane: (lo or hi) + 8 in [1, 15] per byte, into 0x43nn = 128 + n,
// minus 136. Exact.
__device__ __forceinline__ uint2 unpack4(uint32_t w, int half) {
  const uint32_t v = ((w & 0x7F7F7F7Fu) + 0x08080808u) ^ (w & 0x80808080u);   // b + 8 per byte
  const uint32_t n = half == 0 ? (v & 0x0F0F0F0Fu) : (((v >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u);
  const __nv_bfloat162 off = __float2bfloat162_rn(136.f);
  uint32_t a = __byte_perm(n, 0x43434343u, 0x4140), b = __byte_perm(n, 0x43434343u, 0x4342);
  __nv_bfloat162 fa = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a), off);
  __nv_bfloat162 fb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&b), off);
  return make_uint2(*reinterpret_cast<uint32_t*>(&fa), *reinterpret_cast<uint32_t*>(&fb));
}

struct Args {
  const void* x;
  const int8_t* p;
  const float* gs;
  void* out;
  float* ws;
  unsigned* tickets;
  int M, Kh, N, gps;
};

// Starts the loads of step k (carrier rows k kKS .. k kKS + 63, half of
// group k / 2) into ring stage k % kStages: the tile's carrier rows and the
// block's x rows at the step's lo and hi columns (zeros past M and N). A
// carrier whose rows are not whole 16-byte segments is copied byte by byte.
template <typename XT, bool kSmall>
__device__ void load_stage(const Args& a, int k, uint8_t* craw, XT* xs, int m0, int n0) {
  using L = Layout<XT, kSmall>;
  constexpr int XS = x_stride<XT>();
  constexpr int VX = 16 / sizeof(XT);             // x elements a 16-byte copy moves
  const int tid = threadIdx.x, st = k % kStages;
  uint8_t* cdst = craw + st * L::kCarrier;
  const int8_t* csrc = a.p + (size_t)k * kKS * a.N + n0;
  if (a.N % 16 == 0) {
    for (int i = tid; i < kKS * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const bool in = n0 + c < a.N;
      cp_async16(cdst + r * kBN + c, in ? csrc + (size_t)r * a.N + c : a.p, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < kKS * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      cdst[r * kBN + c] = n0 + c < a.N ? (uint8_t)csrc[(size_t)r * a.N + c] : 0;
    }
  }
  XT* xdst = xs + (size_t)st * L::kBM * XS;
  const XT* x = static_cast<const XT*>(a.x);
  const int K = 2 * a.Kh;
  for (int i = tid; i < L::kBM * (2 * kKS / VX); i += kThreads) {
    const int r = i / (2 * kKS / VX), c = (i % (2 * kKS / VX)) * VX;   // c < kKS: lo, else hi
    const int col = (c < kKS ? 0 : a.Kh - kKS) + k * kKS + c;
    const bool in = m0 + r < a.M;
    cp_async16(xdst + r * XS + c, in ? x + (size_t)(m0 + r) * K + col : x, in ? 16 : 0);
  }
}

// The carrier rows of a stage as the bf16 planes of the lo and the hi
// nibbles.
__device__ void unpack_stage(const uint8_t* craw, __nv_bfloat16* plane) {
  for (int i = threadIdx.x; i < kKS * (kBN / 16); i += kThreads) {
    const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
    const uint4 w = *reinterpret_cast<const uint4*>(craw + r * kBN + c);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint2 a = unpack4(w.x, half), b = unpack4(w.y, half);
      const uint2 e = unpack4(w.z, half), f = unpack4(w.w, half);
      uint4* dst = reinterpret_cast<uint4*>(plane + (half * kKS + r) * kPS + c);
      dst[0] = make_uint4(a.x, a.y, b.x, b.y);
      dst[1] = make_uint4(e.x, e.y, f.x, f.y);
    }
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float scale_at(const Args& a, int gi, int n) {
  return n < a.N ? __ldg(a.gs + (size_t)gi * a.N + n) : 0.f;
}

// The f32 result `v` of element (m, n): to out, or with split groups to the
// block's partial in the workspace.
template <typename XT>
__device__ __forceinline__ void put(const Args& a, int m, int n, float v) {
  if (m >= a.M || n >= a.N) return;
  if (gridDim.z > 1)
    a.ws[((size_t)blockIdx.z * a.M + m) * a.N + n] = v;
  else
    static_cast<XT*>(a.out)[(size_t)m * a.N + n] = from_f<XT>(v);
}

// With split groups: the last block of the tile to finish adds the
// partials in split order and writes out.
template <typename XT>
__device__ void reduce_splits(const Args& a, int m0, int bm, int n0) {
  __shared__ bool last_block;
  __threadfence();
  __syncthreads();
  const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last_block = atomicAdd(&a.tickets[tile], 1u) == gridDim.z - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const size_t stride = (size_t)a.M * a.N;
  for (int i = threadIdx.x; i < bm * kBN; i += kThreads) {
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m >= a.M || n >= a.N) continue;
    const float* col = a.ws + (size_t)m * a.N + n;
    float s = 0.f;
    for (int z = 0; z < (int)gridDim.z; ++z) s += __ldcg(col + z * stride);
    static_cast<XT*>(a.out)[(size_t)m * a.N + n] = from_f<XT>(s);
  }
  if (threadIdx.x == 0) a.tickets[tile] = 0u;
}

// ---------------------------------------------------------------------------
// large M: x the A operand (a warp's 32 rows), the plane the B operand (its
// 32 columns)
// ---------------------------------------------------------------------------

// The A fragments of x rows r0 .. r0 + 15, columns c0 .. c0 + 15 of a stage:
// one bf16 limb, or three of an f32 x.
__device__ __forceinline__ void a_frag(const __nv_bfloat16* xs, int r0, int c0,
                                       uint32_t (&f)[1][4]) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(f[0], xs + (r0 + (lane & 15)) * x_stride<__nv_bfloat16>() + c0 + (lane >> 4) * 8);
}
__device__ __forceinline__ void a_frag(const float* xs, int r0, int c0, uint32_t (&f)[3][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  constexpr int XS = x_stride<float>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {   // a0a1: (g, 2q); a2a3: (g + 8, 2q); a4a5: (g, 2q + 8); a6a7
    const float2 v = *reinterpret_cast<const float2*>(
        xs + (r0 + g + (i & 1) * 8) * XS + c0 + 2 * q + (i >> 1) * 8);
    uint32_t w[3];
    split3(v.x, v.y, w);
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k][i] = w[k];
  }
}

template <typename XT>
__global__ void __launch_bounds__(kThreads, sizeof(XT) == 2 ? 2 : 1) gemm_large(const Args a) {
  using L = Layout<XT, false>;
  constexpr int XS = x_stride<XT>();
  constexpr int kLimbs = sizeof(XT) == 4 ? 3 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* craw = smem;
  XT* xs = reinterpret_cast<XT*>(smem + kStages * L::kCarrier);
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(smem + kStages * (L::kCarrier + L::kX));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * L::kBM, n0 = blockIdx.x * kBN;
  const int gch = a.Kh / kG;
  const int kb = 2 * blockIdx.z * a.gps, ke = 2 * min(gch, (int)blockIdx.z * a.gps + a.gps);

  float tot[2][4][4], acc[2][2][4][4];   // acc[half]: the group's f32 sums
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[mi][j][e] = acc[0][mi][j][e] = acc[1][mi][j][e] = 0.f;

  load_stage<XT, false>(a, kb, craw, xs, m0, n0);
  cp_commit();
  if (kb + 1 < ke) load_stage<XT, false>(a, kb + 1, craw, xs, m0, n0);
  cp_commit();
  for (int k = kb; k < ke; ++k) {
    const int st = k % kStages;
    cp_wait_one();
    __syncthreads();   // step k landed; every warp is done with step k - 1
    if (k + 2 < ke) load_stage<XT, false>(a, k + 2, craw, xs, m0, n0);
    cp_commit();
    unpack_stage(craw + st * L::kCarrier, plane);
    __syncthreads();
    const XT* xst = xs + (size_t)st * L::kBM * XS;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll 2
      for (int kk = 0; kk < kKS / 16; ++kk) {
        uint32_t af[2][kLimbs][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) a_frag(xst, wm * 32 + mi * 16, half * kKS + kk * 16, af[mi]);
        uint32_t bf[4][2];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t r[4];
          ldsm_x4_t(r, plane + (half * kKS + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kPS +
                           wn * 32 + jj * 16 + (lane >> 4) * 8);
          bf[2 * jj][0] = r[0];
          bf[2 * jj][1] = r[1];
          bf[2 * jj + 1][0] = r[2];
          bf[2 * jj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_limbs(acc[half][mi][j], af[mi], bf[j]);
      }
    if (k & 1) {   // the group's scales of the lane's columns, on its two f32 sums
      const int gi = k >> 1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + 8 * j + 2 * q;
        const float l0 = scale_at(a, gi, n), l1 = scale_at(a, gi, n + 1);
        const float h0 = scale_at(a, gch + gi, n), h1 = scale_at(a, gch + gi, n + 1);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          float* t = tot[mi][j];
          const float* lo = acc[0][mi][j];
          const float* hi = acc[1][mi][j];
          t[0] += lo[0] * l0 + hi[0] * h0;
          t[1] += lo[1] * l1 + hi[1] * h1;
          t[2] += lo[2] * l0 + hi[2] * h0;
          t[3] += lo[3] * l1 + hi[3] * h1;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][mi][j][e] = acc[1][mi][j][e] = 0.f;
        }
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + wm * 32 + mi * 16 + g8, n = n0 + wn * 32 + 8 * j + 2 * q;
      put<XT>(a, m, n, tot[mi][j][0]);
      put<XT>(a, m, n + 1, tot[mi][j][1]);
      put<XT>(a, m + 8, n, tot[mi][j][2]);
      put<XT>(a, m + 8, n + 1, tot[mi][j][3]);
    }
  if (gridDim.z > 1) reduce_splits<XT>(a, m0, L::kBM, n0);
}

// ---------------------------------------------------------------------------
// small M: the plane the A operand (a warp's 16 columns as MMA rows), x the
// B operand (its rows as MMA columns, 8 or 16)
// ---------------------------------------------------------------------------

// The B fragments of x rows 0 .. 8 nb - 1, columns c0 .. c0 + 15 of a stage.
template <int kNb>
__device__ __forceinline__ void b_frag(const __nv_bfloat16* xs, int c0, uint32_t (&f)[1][2][2]) {
  const int lane = threadIdx.x & 31;
  constexpr int XS = x_stride<__nv_bfloat16>();
  if constexpr (kNb == 2) {
    uint32_t r[4];
    ldsm_x4(r, xs + ((lane & 7) + (lane >> 4) * 8) * XS + c0 + ((lane >> 3) & 1) * 8);
    f[0][0][0] = r[0];
    f[0][0][1] = r[1];
    f[0][1][0] = r[2];
    f[0][1][1] = r[3];
  } else {
    uint32_t r[2];
    ldsm_x2(r, xs + (lane & 7) * XS + c0 + ((lane >> 3) & 1) * 8);
    f[0][0][0] = r[0];
    f[0][0][1] = r[1];
  }
}
template <int kNb>
__device__ __forceinline__ void b_frag(const float* xs, int c0, uint32_t (&f)[3][2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  constexpr int XS = x_stride<float>();
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // b0b1: (k 2q, row g); b2b3: (k 2q + 8, row g)
      const float2 v =
          *reinterpret_cast<const float2*>(xs + (8 * nb + g) * XS + c0 + 2 * q + 8 * i);
      uint32_t w[3];
      split3(v.x, v.y, w);
#pragma unroll
      for (int k = 0; k < 3; ++k) f[k][nb][i] = w[k];
    }
}

template <typename XT, int kNb>
__global__ void __launch_bounds__(kThreads, sizeof(XT) == 2 ? 3 : 2) gemm_small(const Args a) {
  using L = Layout<XT, true>;
  constexpr int XS = x_stride<XT>();
  constexpr int kLimbs = sizeof(XT) == 4 ? 3 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* craw = smem;
  XT* xs = reinterpret_cast<XT*>(smem + kStages * L::kCarrier);
  __nv_bfloat16* plane = reinterpret_cast<__nv_bfloat16*>(smem + kStages * (L::kCarrier + L::kX));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g8 = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * kBN, nw = warp * 16;
  const int gch = a.Kh / kG;
  const int kb = 2 * blockIdx.z * a.gps, ke = 2 * min(gch, (int)blockIdx.z * a.gps + a.gps);

  float tot[kNb][4], acc[2][kNb][4];
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) tot[nb][e] = acc[0][nb][e] = acc[1][nb][e] = 0.f;

  load_stage<XT, true>(a, kb, craw, xs, 0, n0);
  cp_commit();
  if (kb + 1 < ke) load_stage<XT, true>(a, kb + 1, craw, xs, 0, n0);
  cp_commit();
  for (int k = kb; k < ke; ++k) {
    const int st = k % kStages;
    cp_wait_one();
    __syncthreads();
    if (k + 2 < ke) load_stage<XT, true>(a, k + 2, craw, xs, 0, n0);
    cp_commit();
    unpack_stage(craw + st * L::kCarrier, plane);
    __syncthreads();
    const XT* xst = xs + (size_t)st * L::kBM * XS;
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int kk = 0; kk < kKS / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4_t(af, plane + (half * kKS + kk * 16 + (lane & 7) + (lane >> 4) * 8) * kPS + nw +
                          ((lane >> 3) & 1) * 8);
        uint32_t bf[kLimbs][2][2];
        b_frag<kNb>(xst, half * kKS + kk * 16, bf);
#pragma unroll
        for (int nb = 0; nb < kNb; ++nb) {
          if constexpr (kLimbs == 1) {
            mma(acc[half][nb], af, bf[0][nb]);
          } else {   // as mma_limbs: the limbs' products apart, smallest first
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int l = kLimbs - 1; l >= 0; --l) mma(t, af, bf[l][nb]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[half][nb][e] += t[e];
          }
        }
      }
    if (k & 1) {
      const int gi = k >> 1;
      const int n = n0 + nw + g8;
      const float l0 = scale_at(a, gi, n), l1 = scale_at(a, gi, n + 8);
      const float h0 = scale_at(a, gch + gi, n), h1 = scale_at(a, gch + gi, n + 8);
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
        tot[nb][0] += acc[0][nb][0] * l0 + acc[1][nb][0] * h0;
        tot[nb][1] += acc[0][nb][1] * l0 + acc[1][nb][1] * h0;
        tot[nb][2] += acc[0][nb][2] * l1 + acc[1][nb][2] * h1;
        tot[nb][3] += acc[0][nb][3] * l1 + acc[1][nb][3] * h1;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nb][e] = acc[1][nb][e] = 0.f;
      }
    }
  }

  // accumulator element e of column block nb: column n0 + nw + g8 (+ 8 for
  // e >= 2) of the weight, row 8 nb + 2q (+ 1 for odd e) of x
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      put<XT>(a, 8 * nb + 2 * q + (e & 1), n0 + nw + g8 + (e >> 1) * 8, tot[nb][e]);
  if (gridDim.z > 1) reduce_splits<XT>(a, 0, kSmallM, n0);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename XT>
int launch(const Args& a, int small, int ksplit, cudaStream_t stream) {
  const int gch = a.Kh / kG;
  const dim3 grid((a.N + kBN - 1) / kBN, small ? 1 : (a.M + kLargeM - 1) / kLargeM, ksplit);
  if ((long long)a.gps * (ksplit - 1) >= gch || (long long)a.gps * ksplit < gch)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (small) {
    const size_t smem = Layout<XT, true>::bytes();
    if (a.M <= 8) {
      err = allow_smem(gemm_small<XT, 1>, smem);
      if (err == cudaSuccess) gemm_small<XT, 1><<<grid, kThreads, smem, stream>>>(a);
    } else {
      err = allow_smem(gemm_small<XT, 2>, smem);
      if (err == cudaSuccess) gemm_small<XT, 2><<<grid, kThreads, smem, stream>>>(a);
    }
  } else {
    const size_t smem = Layout<XT, false>::bytes();
    err = allow_smem(gemm_large<XT>, smem);
    if (err == cudaSuccess) gemm_large<XT><<<grid, kThreads, smem, stream>>>(a);
  }
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (M, K) f32 or bf16 (x_bf16), 16-byte aligned; p (K/2, N) int8
// arithmetic carrier; gs (K/128, N) f32; out (M, N) in x's type. small: the
// M <= 16 tiles, else the 64-row ones; the groups of each half are split
// over ksplit blocks of gps groups (ws: (ksplit, M, N) f32 and one zeroed
// ticket per tile when ksplit > 1). Returns cudaGetLastError().
int w4a16_gemm_arith(const void* x, const int8_t* p, const float* gs, void* out, float* ws,
                     unsigned* tickets, int M, int K, int N, int small, int gps, int ksplit,
                     int x_bf16, void* stream) {
  const int Kh = K / 2;
  if (M < 2 || M > 512 || K % 2 != 0 || Kh % kG != 0 || N < 1 || gps < 1 || ksplit < 1 ||
      ksplit > 65535 || (small && M > kSmallM) ||
      (ksplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{x, p, gs, out, ws, tickets, M, Kh, N, gps};
  if (x_bf16) return launch<__nv_bfloat16>(a, small, ksplit, (cudaStream_t)stream);
  return launch<float>(a, small, ksplit, (cudaStream_t)stream);
}

}  // extern "C"
