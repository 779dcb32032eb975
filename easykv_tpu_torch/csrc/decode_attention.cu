// Single-token decode attention over the budgeted KV ring buffer, with the
// eviction probabilities emitted in the same pass: two entry points on one
// kernel body.
//
// `decode_attend_inflight` replaces the TPU kernel
// easykv_tpu/ops/pallas/decode_attention.py `fused_decode_attend_inflight`
// (body `_kernel_inflight`): the current token's K/V joins the softmax in
// flight, float or int8 KV, optional sliding window, and two StreamingLLM
// variants that rotate each cached K row by a row of f32 cos/sin tables
// (S, D/2), [x1*c - x2*s, x2*c + x1*s], before its QK product:
//   * `ordered` (the age-ordered, rotate-at-read cache of `decoding`): the
//     row at slot s by table row s;
//   * `rank` (the unordered cache of the encoding family): the row at slot
//     s by table row rank[b, h, s], its age rank (0 <= rank < S).
// An int8 row is rotated raw (rotation is linear) and its scale still folds
// into the logit. The TPU kernel builds the rotation from split-bf16 tables
// on its matrix unit (for `rank`, a two-level one-hot pick, R(128*qh) o
// R(m)); here the f32 table row is read directly (from L2: every block of a
// launch reads the same tables), which computes the same rotation.
//
// `decode_attend` replaces `fused_decode_attend` (body `_kernel`): the same
// attention over a cache that already holds the token's row, with no
// in-flight term and no p_new; float or int8 KV and the sliding window, no
// rotation (the TPU kernel has none). The in-flight term is a template flag
// of the one body, compiled out of this entry.
//
// What bounds it on an H100: bytes. Each launch reads the K and V rows of
// one layer's visible slots once (11.7 MB at LLaMa-2-7B width with 712 of
// 768 slots visible, bf16; half that for an int8 cache) and does
// 4*B*Hq*S*D flops, ~0.5 flop per byte (1 for int8), far below the card's
// balance point. The design:
//   * reads each visible K and V row exactly once, with 16-byte loads
//     (a row of D=128 is 16 lanes' loads in bf16, 8 in int8), and skips the rows of
//     masked slots, whose probability is exactly 0;
//   * keeps many rows in flight per SM (each warp loads kUnroll rows of K,
//     each thread kUnroll rows of V, before it uses any), since one block
//     per (batch, kv-head) means 32 blocks on 132 SMs at B=1 and a launch
//     is bound by what each SM can stream;
//   * keeps the rep x S fp32 logits in shared memory: no intermediate goes
//     back to device memory.
// Splitting S across blocks (and tensor-core QK^T for rep > 1) is later
// work.
//
// Per block:
//   1. q's rep rows go to shared memory as fp32;
//   2. logits: dot(q_r, k_s) * scale (* k_scale[s] for int8 K) for every
//      visible slot s and row r, -inf for a masked slot (pos < 0,
//      pos > q_pos, outside the window);
//   3. per r: m = max(-1e30, logits, logit_new); e = exp(l - m); denom =
//      max(sum e + e_new, 1e-30); p = e / denom; p_new = e_new / denom
//      (without the in-flight term: logit_new = -1e30, e_new = 0);
//   4. out[r] = sum_s p[r][s] (* v_scale[s]) * v[s] + p_new[r] * vn (fp32
//      accumulation; the int8 cache is never dequantized into a copy, and
//      the in-flight vn stays in q's type);
//   5. probs[s] = mean_r p[r][s], p_new = mean_r p_new[r].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"

namespace {

using namespace decode_common;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// R(t*theta) of one lane's V elements of a cached K row, t its table row
// (the slot, or its age rank).
// A row spans LPR lanes; element d < D/2 pairs with d + D/2, which sits
// LPR/2 lanes away at the same index j, or in the same lane when a row is
// one lane. The shuffle runs on every lane (the warp stays
// converged); only a visible row reads the table.
template <int V>
__device__ __forceinline__ void rotate_row(float* kr, int li, int LPR, int D, int t, bool vis,
                                           const float* cosv, const float* sinv) {
  const int d2 = D / 2;
  if (LPR >= 2) {
    const int half = LPR / 2;
    float part[V];
#pragma unroll
    for (int j = 0; j < V; ++j) part[j] = __shfl_xor_sync(0xffffffffu, kr[j], half);
    if (!vis) return;
    const bool first = li < half;
    const float* cr = cosv + (size_t)t * d2 + (li % half) * V;
    const float* sr = sinv + (size_t)t * d2 + (li % half) * V;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a = __fmul_rn(kr[j], cr[j]), b = __fmul_rn(part[j], sr[j]);
      kr[j] = first ? __fsub_rn(a, b) : __fadd_rn(a, b);
    }
  } else if (vis) {
    const float* cr = cosv + (size_t)t * d2;
    const float* sr = sinv + (size_t)t * d2;
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      const float x1 = kr[j], x2 = kr[j + V / 2];
      kr[j] = __fsub_rn(__fmul_rn(x1, cr[j]), __fmul_rn(x2, sr[j]));
      kr[j + V / 2] = __fadd_rn(__fmul_rn(x2, cr[j]), __fmul_rn(x1, sr[j]));
    }
  }
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  return decode_common::block_reduce<kMax, kWarps>(x, red);
}

// T: the type of q, kn, vn and out; KV: the cache's type (T, or int8 with
// per-slot scales ksc / vsc). kInflight: the in-flight token (kn, vn,
// p_new); without it those pointers are null and unread.
template <typename T, typename KV, bool kInflight>
__global__ void __launch_bounds__(kThreads)
decode_attend_inflight_kernel(const T* __restrict__ q, const T* __restrict__ kn,
                              const T* __restrict__ vn, const KV* __restrict__ k,
                              const KV* __restrict__ v, const int* __restrict__ pos,
                              const int* __restrict__ q_pos, const float* __restrict__ ksc,
                              const float* __restrict__ vsc, const float* __restrict__ rcos,
                              const float* __restrict__ rsin, const int* __restrict__ rank,
                              T* __restrict__ out,
                              float* __restrict__ probs, float* __restrict__ p_new,
                              int Hkv, int rep, int S, int D, float scale, int window) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int V = VecOf<KV>::n;  // cache elements per 16-byte load
  extern __shared__ float smem[];
  const int LPR = D / V;           // lanes per row (a power of two <= 32)
  const int G = kThreads / LPR;    // row groups in the PV pass
  float* qs = smem;                // rep * D
  float* lg = qs + rep * D;        // rep * S: logits, then probabilities
  float* lnew = lg + rep * S;      // rep: logit_new, then p_new
  float* red = lnew + rep;         // kWarps
  float* part = red + kWarps;      // G * D: PV partial sums

  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = q_pos[b];
  const bool live = qp >= 0;
  const size_t row0 = (size_t)bh * S;
  const KV* kb = k + row0 * D;
  const KV* vb = v + row0 * D;
  const int* pb = pos + row0;

  for (int i = tid; i < rep * D; i += kThreads) qs[i] = to_f(q[(size_t)bh * rep * D + i]);
  __syncthreads();

  for (int r = warp; r < rep; r += kWarps) {
    float acc = 0.f;
    if constexpr (kInflight) {
      for (int d = lane; d < D; d += 32) acc += qs[r * D + d] * to_f(kn[(size_t)bh * D + d]);
      acc = warp_sum(acc);
    }
    if (lane == 0) lnew[r] = kInflight && live ? acc * scale : kNegInf;
  }

  // logits: each warp takes RPW = 32 / LPR rows at a time, kUnroll times
  {
    const int rpw = 32 / LPR;
    const int sub = lane / LPR, li = lane % LPR;
    const int step = kWarps * rpw * kUnroll;
    for (int base = warp * rpw * kUnroll; base < S; base += step) {
      float kr[kUnroll][V];
      bool vis[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = base + u * rpw + sub;
        const int p = s < S ? pb[s] : -1;
        vis[u] = s < S && p >= 0 && p <= qp && (window <= 0 || p > qp - window);
        if (vis[u]) {
          load16(kb + (size_t)s * D + li * V, kr[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) kr[u][j] = 0.f;
        }
      }
      if (rcos != nullptr) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = base + u * rpw + sub;
          const int t = rank == nullptr ? s : (vis[u] ? rank[row0 + s] : 0);
          rotate_row<V>(kr[u], li, LPR, D, t, vis[u], rcos, rsin);
        }
      }
      for (int r = 0; r < rep; ++r) {
        const float* qr = qs + r * D + li * V;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < V; ++j) acc += qr[j] * kr[u][j];
          for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
          const int s = base + u * rpw + sub;
          if (li == 0 && s < S) {
            float x = acc * scale;
            if (kQuant) x *= ksc[row0 + s];
            lg[r * S + s] = vis[u] ? x : -INFINITY;
          }
        }
      }
    }
  }
  __syncthreads();

  // fp32 softmax per query row; masked slots (-inf) get exactly 0
  for (int r = 0; r < rep; ++r) {
    float* l = lg + r * S;
    float m = kNegInf;
    for (int s = tid; s < S; s += kThreads) m = fmaxf(m, l[s]);
    m = fmaxf(block_reduce<true>(m, red), lnew[r]);
    float sum = 0.f;
    for (int s = tid; s < S; s += kThreads) {
      const float e = l[s] == -INFINITY ? 0.f : expf(l[s] - m);
      l[s] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    const float e_new = kInflight && live ? expf(lnew[r] - m) : 0.f;
    const float denom = fmaxf(sum + e_new, 1e-30f);
    for (int s = tid; s < S; s += kThreads) l[s] = l[s] / denom;
    __syncthreads();
    if (tid == 0) lnew[r] = e_new / denom;
    __syncthreads();
  }

  for (int s = tid; s < S; s += kThreads) {
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) acc += lg[r * S + s];
    probs[row0 + s] = acc / (float)rep;
  }
  if (kInflight && tid == 0) {
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) acc += lnew[r];
    p_new[bh] = acc / (float)rep;
  }

  // out[r] = P V + p_new * vn: thread = (row group g, lane-in-row li)
  const int li = tid % LPR, g = tid / LPR;
  for (int r = 0; r < rep; ++r) {
    const float* pr = lg + r * S;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int base = g; base < S; base += G * kUnroll) {
      float vr[kUnroll][V];
      float w[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = base + u * G;
        w[u] = s < S ? pr[s] : 0.f;
        if (w[u] != 0.f) {
          if (kQuant) w[u] *= vsc[row0 + s];
          load16(vb + (size_t)s * D + li * V, vr[u]);
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) vr[u][j] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] += w[u] * vr[u][j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) part[g * D + li * V + j] = acc[j];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
      for (int j = 0; j < G; ++j) o += part[j * D + d];
      if constexpr (kInflight) o += lnew[r] * to_f(vn[(size_t)bh * D + d]);
      out[((size_t)bh * rep + r) * D + d] = from_f<T>(o);
    }
    __syncthreads();
  }
}

template <typename KV>
size_t smem_bytes(int rep, int S, int D) {
  const int G = kThreads / (D / VecOf<KV>::n);
  return sizeof(float) * ((size_t)rep * D + (size_t)rep * S + rep + kWarps + (size_t)G * D);
}

template <typename KV>
bool shape_ok(int D) {
  const int lpr = D / VecOf<KV>::n;
  return D % VecOf<KV>::n == 0 && lpr >= 1 && lpr <= 32 && (lpr & (lpr - 1)) == 0;
}

template <typename T, typename KV, bool kInflight>
int launch(const void* q, const void* kn, const void* vn, const void* k, const void* v,
           const int* pos, const int* q_pos, const float* ksc, const float* vsc,
           const float* rcos, const float* rsin, const int* rank, void* out,
           float* probs, float* p_new, int B, int Hkv, int rep, int S, int D, float scale,
           int window, cudaStream_t stream) {
  if (!shape_ok<KV>(D)) return (int)cudaErrorInvalidValue;
  if (std::is_same<KV, int8_t>::value && (ksc == nullptr || vsc == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<KV>(rep, S, D);
  auto kernel = decode_attend_inflight_kernel<T, KV, kInflight>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<B * Hkv, kThreads, smem, stream>>>(
      (const T*)q, (const T*)kn, (const T*)vn, (const KV*)k, (const KV*)v, pos, q_pos, ksc,
      vsc, rcos, rsin, rank, (T*)out, probs, p_new, Hkv, rep, S, D, scale, window);
  return (int)cudaGetLastError();
}

// One launch of either entry: the cache type picks KV, `dtype` T.
template <bool kInflight>
int dispatch(const void* q, const void* kn, const void* vn, const void* k, const void* v,
             const int* pos, const int* q_pos, const float* ksc, const float* vsc,
             const float* rcos, const float* rsin, const int* rank, void* out, float* probs,
             float* p_new, int B, int Hkv, int rep, int S, int D, float scale, int window,
             int dtype, int kv_int8, cudaStream_t st) {
  if (dtype == 0 && kv_int8)
    return launch<float, int8_t, kInflight>(q, kn, vn, k, v, pos, q_pos, ksc, vsc, rcos, rsin,
                                            rank, out, probs, p_new, B, Hkv, rep, S, D, scale,
                                            window, st);
  if (dtype == 0)
    return launch<float, float, kInflight>(q, kn, vn, k, v, pos, q_pos, nullptr, nullptr, rcos,
                                           rsin, rank, out, probs, p_new, B, Hkv, rep, S, D,
                                           scale, window, st);
  if (dtype == 1 && kv_int8)
    return launch<__nv_bfloat16, int8_t, kInflight>(q, kn, vn, k, v, pos, q_pos, ksc, vsc,
                                                    rcos, rsin, rank, out, probs, p_new, B, Hkv,
                                                    rep, S, D, scale, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, kInflight>(
        q, kn, vn, k, v, pos, q_pos, nullptr, nullptr, rcos, rsin, rank, out, probs, p_new, B,
        Hkv, rep, S, D, scale, window, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one launch needs, in bytes; 0 if D is not supported
// (a cache row must be 1..32 sixteen-byte loads, a power of two).
// dtype: 0 = float32, 1 = bfloat16; kv_int8: 1 for an int8 cache.
size_t decode_attend_inflight_smem(int rep, int S, int D, int dtype, int kv_int8) {
  if (kv_int8) return shape_ok<int8_t>(D) ? smem_bytes<int8_t>(rep, S, D) : 0;
  if (dtype == 0) return shape_ok<float>(D) ? smem_bytes<float>(rep, S, D) : 0;
  if (dtype == 1)
    return shape_ok<__nv_bfloat16>(D) ? smem_bytes<__nv_bfloat16>(rep, S, D) : 0;
  return 0;
}

// q, kn, vn and out share `dtype`; k and v too, unless kv_int8 = 1: then
// they are int8 with per-slot dequant scales k_scale, v_scale (B, Hkv, S)
// f32 (null otherwise). Every pointer of q..v is 16-byte aligned.
// rot_cos, rot_sin (S, D/2) f32: the cached K row at slot s rotates by their
// row s (ordered), or by their row rank[b, h, s] when rank (B, Hkv, S) int32
// is given; null for no rotation (rank then null too). window <= 0: no
// sliding window. Returns cudaGetLastError().
int decode_attend_inflight(const void* q, const void* kn, const void* vn, const void* k,
                           const void* v, const int* pos, const int* q_pos,
                           const float* k_scale, const float* v_scale, const float* rot_cos,
                           const float* rot_sin, const int* rank, void* out,
                           float* probs, float* p_new, int B, int Hkv, int rep, int S,
                           int D, float scale, int window, int dtype, int kv_int8,
                           void* stream) {
  if ((rot_cos == nullptr) != (rot_sin == nullptr)) return (int)cudaErrorInvalidValue;
  if (rank != nullptr && rot_cos == nullptr) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kn, vn, k, v, pos, q_pos, k_scale, v_scale, rot_cos, rot_sin, rank,
                        out, probs, p_new, B, Hkv, rep, S, D, scale, window, dtype, kv_int8,
                        (cudaStream_t)stream);
}

// The same attention over a cache that already holds the query token's row:
// no in-flight token, no p_new, no rotation. Arguments as above.
int decode_attend(const void* q, const void* k, const void* v, const int* pos,
                  const int* q_pos, const float* k_scale, const float* v_scale, void* out,
                  float* probs, int B, int Hkv, int rep, int S, int D, float scale, int window,
                  int dtype, int kv_int8, void* stream) {
  return dispatch<false>(q, nullptr, nullptr, k, v, pos, q_pos, k_scale, v_scale, nullptr,
                         nullptr, nullptr, out, probs, nullptr, B, Hkv, rep, S, D, scale, window,
                         dtype, kv_int8, (cudaStream_t)stream);
}

}  // extern "C"
