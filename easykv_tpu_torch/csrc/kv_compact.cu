// Age-ordered compaction of the KV cache after a k = 1 eviction, for
// ordered StreamingLLM decoding: per (layer, batch, kv-head), every slot at
// and above the head's victim takes the slot above it, so the valid slots
// stay contiguous from 0 and in age order (the reference's physical
// removal, truncate_kv_cache_silo, as a shift of a static buffer).
//
// Two kernels:
//   * K9 `kv_compact` replaces the TPU kernel
//     easykv_tpu/ops/pallas/sidecar_update.py `fused_kv_compact` (body
//     `_kv_compact_kernel`): the K and V rows (and the int8 cache's scales)
//     shift at a given victim slot per head (S: none). With `rotate` (the
//     pre-rotated cache) each shifted K row also takes one fixed R(-theta),
//     [x1*c + x2*s, x2*c - x1*s] with c, s = cos, sin(inv_freq), since its
//     age rank dropped by one; an int8 row is rotated raw and requantized
//     without its scale: q = clip(rint(y * (127 / max(amax, 1e-30))), +-127)
//     and scale = max(old scale * amax, 1e-8) * f32(1/127), amax = max|y|.
//   * K8 `compact` replaces `fused_compact` (body `_compact_kernel`): each
//     head finds its victim as the first slot valid in pos_mid (before the
//     eviction) and invalid in pos (after it), then pos, score, score_sq,
//     counter, the scales, K and V shift unrotated; slot S-1 gets pos -1.
// As jnp.roll does, slot S-1 takes slot 0's row (rotated and requantized
// under `rotate`); its pos is -1, so its bytes are inert.
//
// What bounds them on an H100: bytes. Rows below the victim never move, so
// a launch moves only the tails: each row at and above the victim is read
// once and written once (K and V, 256 + 256 bytes per row at LLaMa-2-7B
// width in bf16, 128 + 128 in int8), plus, for K8, the pos rows it searches.
//
// K9 deals the work by rows, so that the longest tail no longer sets the
// launch's time by a chain of dependent tiles: a block a head takes its tail
// in rounds of R rows (ops/cuda/kv_compact.py shift_plan: 64 KB of K and V,
// so one round at S = 768 in int8, at most two in bf16), all of a round's
// rows in flight at once. A round's sources are one run of rows, so one
// thread asks for them as two bulk copies into shared memory (slot S-1
// takes slot 0's row, copied with the first round); once they are in, K
// goes out from a group of G lanes a row (G = min(16-byte units, 32): 16
// lanes a bf16 row, 8 an int8 row at D = 128), rotated in registers on the
// way (the half-row partner G / 2 lanes away, or the lane's other unit; an
// int8 row's amax a reduction over its G lanes), and V as it is. Every
// source row of a round is in shared memory before any row of it is
// written, and a round's sources lie above every row an earlier round
// wrote. A row whose units are not a power of two takes K8's walk.
//
// K8 keeps the walk: one block per head walks its tail upward in tiles of
// kTile rows, staging tile t's source rows (slots t0+1 .. t0+n, slot 0 kept
// from the start for the wraparound) in shared memory with 16-byte loads,
// then writing slots t0 .. t0+n-1. A tile reads its rows before the next
// tile overwrites them, and heads are disjoint, so the in-place shift has
// no race. This file is built with --fmad=false so that the rotation rounds
// as the plain version's separate products and sums do: the int8 requant is
// then bit-exact with it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tma_ring.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                 // rows staged per tile
constexpr int kMaxPairs = 4;              // (head_dim / 2) / 32 per lane: head_dim <= 256
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float ld(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, int i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float ld(const int8_t* p, int i) { return (float)p[i]; }
__device__ __forceinline__ void st(float* p, int i, float x) { p[i] = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, int i, float x) {
  p[i] = __float2bfloat16_rn(x);
}

// Rotates the n staged K rows by R(-theta) in place; with an int8 cache it
// requantizes each and turns its staged source scale into the new one.
template <typename T>
__device__ void rotate_rows(uint4* tile, float* kst, int n, int D, const float* cosv,
                            const float* sinv) {
  constexpr bool kQuant = sizeof(T) == 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d2 = D / 2;
  for (int i = warp; i < n; i += kWarps) {
    T* row = reinterpret_cast<T*>(tile) + (size_t)i * D;
    float y1[kMaxPairs], y2[kMaxPairs];
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxPairs; ++j) {
      const int p = lane + 32 * j;
      if (p < d2) {
        const float x1 = ld(row, p), x2 = ld(row, p + d2);
        const float c = cosv[p], s = sinv[p];
        y1[j] = x1 * c + x2 * s;
        y2[j] = x2 * c - x1 * s;
        amax = fmaxf(amax, fmaxf(fabsf(y1[j]), fabsf(y2[j])));
      }
    }
    if constexpr (kQuant) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float f = __fdiv_rn(127.0f, fmaxf(amax, 1e-30f));
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        const int p = lane + 32 * j;
        if (p < d2) {
          int8_t* r8 = reinterpret_cast<int8_t*>(row);
          r8[p] = (int8_t)fminf(fmaxf(rintf(y1[j] * f), -127.f), 127.f);
          r8[p + d2] = (int8_t)fminf(fmaxf(rintf(y2[j] * f), -127.f), 127.f);
        }
      }
      if (lane == 0) kst[i] = fmaxf(kst[i] * amax, 1e-8f) * kInv127;
    } else {
#pragma unroll
      for (int j = 0; j < kMaxPairs; ++j) {
        const int p = lane + 32 * j;
        if (p < d2) {
          st(row, p, y1[j]);
          st(row, p + d2, y2[j]);
        }
      }
    }
  }
}

__host__ __device__ size_t kv_smem_bytes(int row_bytes) {
  const size_t units = (size_t)row_bytes / 16;
  return 16 * (2 * kTile * units + 2 * units) + sizeof(float) * (2 * kTile + 2);
}

// Shifts rows [vs, S) of one head's K and V down by one, in place (and its
// scales when ksc != null; an int8 K under kRotate needs them).
template <typename T, bool kRotate>
__device__ void shift_kv(T* k, T* v, float* ksc, float* vsc, int S, int D, int vs,
                         const float* cosv, const float* sinv, unsigned char* smem) {
  const int U = D * (int)sizeof(T) / 16;   // 16-byte units per row
  uint4* kt = reinterpret_cast<uint4*>(smem);
  uint4* vt = kt + kTile * U;
  uint4* k0 = vt + kTile * U;              // slot 0's rows as they were
  uint4* v0 = k0 + U;
  float* kst = reinterpret_cast<float*>(v0 + U);
  float* vst = kst + kTile;
  float* s0 = vst + kTile;                 // slot 0's scales
  uint4* kg = reinterpret_cast<uint4*>(k);
  uint4* vg = reinterpret_cast<uint4*>(v);
  const int tid = threadIdx.x;
  for (int u = tid; u < U; u += kThreads) {
    k0[u] = kg[u];
    v0[u] = vg[u];
  }
  if (tid == 0 && ksc != nullptr) {
    s0[0] = ksc[0];
    s0[1] = vsc[0];
  }
  __syncthreads();
  for (int t0 = vs; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    for (int e = tid; e < n * U; e += kThreads) {
      const int i = e / U, u = e - i * U, src = t0 + i + 1;
      kt[e] = src < S ? kg[(size_t)src * U + u] : k0[u];
      vt[e] = src < S ? vg[(size_t)src * U + u] : v0[u];
    }
    if (ksc != nullptr) {
      for (int i = tid; i < n; i += kThreads) {
        const int src = t0 + i + 1;
        kst[i] = src < S ? ksc[src] : s0[0];
        vst[i] = src < S ? vsc[src] : s0[1];
      }
    }
    __syncthreads();
    if constexpr (kRotate) {
      rotate_rows<T>(kt, kst, n, D, cosv, sinv);
      __syncthreads();
    }
    for (int e = tid; e < n * U; e += kThreads) {
      const int i = e / U, u = e - i * U;
      kg[(size_t)(t0 + i) * U + u] = kt[e];
      vg[(size_t)(t0 + i) * U + u] = vt[e];
    }
    if (ksc != nullptr) {
      for (int i = tid; i < n; i += kThreads) {
        ksc[t0 + i] = kst[i];
        vsc[t0 + i] = vst[i];
      }
    }
    __syncthreads();
  }
}

template <typename T, bool kRotate>
__global__ void __launch_bounds__(kThreads)
kv_compact_kernel(T* __restrict__ k, T* __restrict__ v, const int* __restrict__ v_slot,
                  float* __restrict__ ksc, float* __restrict__ vsc,
                  const float* __restrict__ cosv, const float* __restrict__ sinv, int S,
                  int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row = blockIdx.x;
  const int vs = max(v_slot[row], 0);     // iota >= v_slot: a negative slot moves every row
  if (vs >= S) return;                    // no eviction in this head
  const size_t off = (size_t)row * S;
  shift_kv<T, kRotate>(k + off * D, v + off * D, ksc ? ksc + off : nullptr,
                       vsc ? vsc + off : nullptr, S, D, vs, cosv, sinv, smem);
}

// ---------------------------------------------------------------------------
// K9 by rows: a head's tail in rounds of rows in shared memory
// ---------------------------------------------------------------------------

constexpr int kShiftMaxThreads = 512;
constexpr int kMaxUnits = 2;              // 16-byte units a lane holds of a row, at most

// Element e of a 16-byte unit of T as f32.
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int e) {
  return reinterpret_cast<const float*>(&u)[e];
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int e) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&u)[e]);
}
template <> __device__ __forceinline__ float elem<int8_t>(const uint4& u, int e) {
  return (float)reinterpret_cast<const int8_t*>(&u)[e];
}

__device__ __forceinline__ uint4 shfl_unit(const uint4& u, int mask) {
  return make_uint4(__shfl_xor_sync(0xffffffffu, u.x, mask), __shfl_xor_sync(0xffffffffu, u.y, mask),
                    __shfl_xor_sync(0xffffffffu, u.z, mask), __shfl_xor_sync(0xffffffffu, u.w, mask));
}

// Element e of a rotated unit: R(-theta) on (own, its half-row partner), x1
// in `own` when `first`, with the element's (cos, sin), each product and sum
// rounded apart (--fmad=false).
template <typename T>
__device__ __forceinline__ float rot_elem(const uint4& own, const uint4& oth, bool first, int e,
                                          float c, float sn) {
  const float x = elem<T>(own, e), o = elem<T>(oth, e);
  return first ? x * c + o * sn : x * c - o * sn;
}

// The (cos, sin) of the E pairs of each unit a lane holds (unit vv G + l of
// a row: pair indices p0 .. p0 + E - 1, p0 E times the lane's place in its
// half of the row when V = 1, E l when V = 2), the same for every row: read
// once.
template <typename T, int V>
__device__ __forceinline__ void lane_rotation(int l, int G, const float* cosv, const float* sinv,
                                              float (&c)[V][16 / sizeof(T)],
                                              float (&sn)[V][16 / sizeof(T)]) {
  constexpr int E = 16 / (int)sizeof(T);
#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    const int p0 = (V == 1 ? (l < G / 2 ? l : l - G / 2) : l) * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      c[vv][e] = cosv[p0 + e];
      sn[vv][e] = sinv[p0 + e];
    }
  }
}

// R(-theta) on the units a lane holds of one row (V of them: unit vv G + l
// of the row for lane l of its group of G), in place; an int8 row is
// requantized (its amax a reduction over the group's lanes) and `ks` (its
// source k scale, meaningful in the group's lane 0) becomes the new scale.
// The half-row partner of unit u is u + units / 2: G / 2 lanes away when
// V = 1, the lane's other unit when V = 2.
template <typename T, int V>
__device__ __forceinline__ void rotate_units(uint4 (&kr)[V], float& ks, int l, int G,
                                             const float (&c)[V][16 / sizeof(T)],
                                             const float (&sn)[V][16 / sizeof(T)]) {
  constexpr int E = 16 / (int)sizeof(T);
  uint4 oth[V];
  bool first[V];
#pragma unroll
  for (int vv = 0; vv < V; ++vv) {
    first[vv] = V == 1 ? l < G / 2 : vv == 0;
    oth[vv] = V == 1 ? shfl_unit(kr[0], G / 2) : kr[V - 1 - vv];
  }
  uint4 out[V];
  if constexpr (sizeof(T) == 1) {
    float y[V][E];
    float amax = 0.f;
#pragma unroll
    for (int vv = 0; vv < V; ++vv)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        y[vv][e] = rot_elem<T>(kr[vv], oth[vv], first[vv], e, c[vv][e], sn[vv][e]);
        amax = fmaxf(amax, fabsf(y[vv][e]));
      }
    for (int o = G / 2; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float f = __fdiv_rn(127.0f, fmaxf(amax, 1e-30f));
#pragma unroll
    for (int vv = 0; vv < V; ++vv) {
      int8_t* q = reinterpret_cast<int8_t*>(&out[vv]);
#pragma unroll
      for (int e = 0; e < E; ++e) q[e] = (int8_t)fminf(fmaxf(rintf(y[vv][e] * f), -127.f), 127.f);
    }
    ks = fmaxf(ks * amax, 1e-8f) * kInv127;
  } else {
#pragma unroll
    for (int vv = 0; vv < V; ++vv) {
      T* o = reinterpret_cast<T*>(&out[vv]);
#pragma unroll
      for (int e = 0; e < E; ++e)
        st(o, e, rot_elem<T>(kr[vv], oth[vv], first[vv], e, c[vv][e], sn[vv][e]));
    }
  }
#pragma unroll
  for (int vv = 0; vv < V; ++vv) kr[vv] = out[vv];
}

// Shared memory of a block of the row kernel: its mbarrier (16 bytes), R
// source rows of K and of V (U 16-byte units each), slot 0's K and V rows
// as they were, then R k and R v scales and slot 0's two.
__host__ __device__ inline size_t shift_smem(int R, int U) {
  return 16 + (size_t)16 * (2 * R * U + 2 * U) + sizeof(float) * (2 * R + 2);
}

// grid: one block a head. Rows [vs, S) of the head's K and V (and scales)
// take the row above them (S-1 takes row 0), in rounds of R rows. A round's
// sources are one run of rows, so one thread asks for them as two bulk
// copies (K's and V's) into shared memory, counted on the block's mbarrier
// (in the first round with slot 0's rows, which slot S-1 takes); once they
// are in, each row goes out from a group of G lanes (V units a lane, G V
// the row's 16-byte units): K rotated in registers on the way, V as it is.
template <typename T, bool kRotate, int V>
__global__ void __launch_bounds__(kShiftMaxThreads)
shift_rows_kernel(T* __restrict__ k, T* __restrict__ v, const int* __restrict__ v_slot,
                  float* __restrict__ ksc, float* __restrict__ vsc,
                  const float* __restrict__ cosv, const float* __restrict__ sinv, int S, int G,
                  int R) {
  using namespace tma_ring;
  extern __shared__ __align__(16) unsigned char smem[];
  const int vs = max(v_slot[blockIdx.x], 0);   // iota >= v_slot: a negative slot moves every row
  if (vs >= S) return;                         // no eviction in this head
  const int U = G * V;                         // 16-byte units a row
  const size_t off = (size_t)blockIdx.x * S;
  uint4* kg = reinterpret_cast<uint4*>(k) + off * U;
  uint4* vg = reinterpret_cast<uint4*>(v) + off * U;
  float* ks_row = ksc ? ksc + off : nullptr;
  float* vs_row = vsc ? vsc + off : nullptr;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint4* kt = reinterpret_cast<uint4*>(smem + 16);
  uint4* vt = kt + R * U;
  uint4* k0 = vt + R * U;                 // slot 0's rows as they were
  uint4* v0 = k0 + U;
  float* kst = reinterpret_cast<float*>(v0 + U);
  float* vst = kst + R;
  float* s0 = vst + R;                    // slot 0's scales
  const int tid = threadIdx.x, nt = blockDim.x;
  const int l = tid & (G - 1), grp = tid / G, groups = nt / G;
  const int tail = S - vs, rounds = (tail + R - 1) / R;
  if (tid == 0) {
    bar_init(bar, 1);
    bar_fence_init();
  }
  __syncthreads();
  float cr[V][16 / sizeof(T)], sr[V][16 / sizeof(T)];   // the lane's (cos, sin)
  for (int r = 0; r < rounds; ++r) {
    const int first = vs + r * R;                             // the round's first row
    const int n = min(R, S - first);                          // its rows
    const bool wraps = first + n == S;                        // its last row is S-1
    const int nbulk = wraps ? n - 1 : n;                      // rows first + 1 .. first + nbulk
    if (tid == 0) {   // the round's rows, and in the first round slot 0's, all in flight
      const uint32_t bytes = (uint32_t)nbulk * U * 16, row = (uint32_t)U * 16;
      bar_arrive_tx(bar, 2 * bytes + (r == 0 ? 2 * row : 0));
      if (r == 0) {
        bulk_copy(k0, kg, row, bar);
        bulk_copy(v0, vg, row, bar);
        if (ks_row != nullptr) {
          s0[0] = ks_row[0];
          s0[1] = vs_row[0];
        }
      }
      if (nbulk > 0) {
        bulk_copy(kt, kg + (size_t)(first + 1) * U, bytes, bar);
        bulk_copy(vt, vg + (size_t)(first + 1) * U, bytes, bar);
      }
    }
    if (ks_row != nullptr)   // slot 0's scales read here in the first round (not yet written)
      for (int i = tid; i < n; i += nt) {
        const int src = first + i + 1;
        kst[i] = src < S ? ks_row[src] : r == 0 ? ks_row[0] : s0[0];
        vst[i] = src < S ? vs_row[src] : r == 0 ? vs_row[0] : s0[1];
      }
    if constexpr (kRotate)
      if (r == 0) lane_rotation<T, V>(l, G, cosv, sinv, cr, sr);   // while the rows come
    bar_wait(bar, (uint32_t)(r & 1));
    if (wraps)
      for (int u = tid; u < U; u += nt) {
        kt[nbulk * U + u] = k0[u];
        vt[nbulk * U + u] = v0[u];
      }
    __syncthreads();   // every source row of the round is in before any is written
    for (int i0 = 0; i0 < n; i0 += groups) {   // the same trip count in every lane (shuffles)
      const int i = i0 + grp;
      const bool on = i < n;
      uint4 kr[V];
#pragma unroll
      for (int vv = 0; vv < V; ++vv) kr[vv] = on ? kt[i * U + vv * G + l] : make_uint4(0u, 0u, 0u, 0u);
      float ks = on && ks_row != nullptr ? kst[i] : 0.f;
      if constexpr (kRotate) rotate_units<T, V>(kr, ks, l, G, cr, sr);
      if (!on) continue;
#pragma unroll
      for (int vv = 0; vv < V; ++vv) kg[(size_t)(first + i) * U + vv * G + l] = kr[vv];
      if (ks_row != nullptr && l == 0) ks_row[first + i] = ks;
    }
    for (int e = tid; e < n * U; e += nt) {
      const int i = e / U;
      vg[(size_t)(first + i) * U + (e - i * U)] = vt[e];
    }
    if (vs_row != nullptr)
      for (int i = tid; i < n; i += nt) vs_row[first + i] = vst[i];
    __syncthreads();   // the block is done with its rows before the next round's copies
  }
}

__device__ int block_min_i(int x, int* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  int y = lane < kWarps ? red[lane] : 0x7fffffff;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) y = min(y, __shfl_xor_sync(0xffffffffu, y, o));
  __syncthreads();
  return y;
}

// a[s] <- a[(s + 1) % S] for s in [vs, S), through the staging row buf.
template <typename A>
__device__ void shift_row(A* a, A* buf, int S, int vs) {
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (s >= vs || s == 0) buf[s] = a[s];
  __syncthreads();
  for (int s = vs + threadIdx.x; s < S; s += kThreads) a[s] = buf[s + 1 < S ? s + 1 : 0];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const int* __restrict__ pos_mid, int* __restrict__ pos,
               float* __restrict__ score, float* __restrict__ ssq,
               float* __restrict__ counter, T* __restrict__ k, T* __restrict__ v,
               float* __restrict__ ksc, float* __restrict__ vsc, int S, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps];
  const int row = blockIdx.x;
  const size_t off = (size_t)row * S;
  int first = S;
  for (int s = threadIdx.x; s < S; s += kThreads)
    if (pos_mid[off + s] >= 0 && pos[off + s] < 0) { first = s; break; }
  const int vs = block_min_i(first, red);
  if (vs >= S) return;                    // no eviction in this head
  float* buf = reinterpret_cast<float*>(smem + kv_smem_bytes(D * (int)sizeof(T)));
  shift_row(pos + off, reinterpret_cast<int*>(buf), S, vs);
  if (threadIdx.x == 0) pos[off + S - 1] = -1;
  shift_row(score + off, buf, S, vs);
  shift_row(ssq + off, buf, S, vs);
  shift_row(counter + off, buf, S, vs);
  if (ksc != nullptr) {
    shift_row(ksc + off, buf, S, vs);
    shift_row(vsc + off, buf, S, vs);
  }
  shift_kv<T, false>(k + off * D, v + off * D, nullptr, nullptr, S, D, vs, nullptr, nullptr,
                     smem);
}

template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

// rows_round 0: the per-head walk; else the row kernel, `threads` threads
// a block and `rows_round` rows a round.
template <typename T, bool kRotate>
int launch_kv(void* k, void* v, const int* v_slot, float* ksc, float* vsc, const float* cosv,
              const float* sinv, int rows, int S, int D, int threads, int R,
              cudaStream_t stream) {
  if (R == 0) {
    const size_t smem = kv_smem_bytes(D * (int)sizeof(T));
    auto kernel = kv_compact_kernel<T, kRotate>;
    int err = prepare(kernel, smem);
    if (err) return err;
    kernel<<<rows, kThreads, smem, stream>>>((T*)k, (T*)v, v_slot, ksc, vsc, cosv, sinv, S, D);
    return (int)cudaGetLastError();
  }
  const int units = D * (int)sizeof(T) / 16;
  const int G = units < 32 ? units : 32, V = units / G;
  const size_t smem = shift_smem(R, units);
  auto kernel = V == 1 ? shift_rows_kernel<T, kRotate, 1> : shift_rows_kernel<T, kRotate, 2>;
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<rows, threads, smem, stream>>>((T*)k, (T*)v, v_slot, ksc, vsc, cosv, sinv, S, G, R);
  return (int)cudaGetLastError();
}

// Whether the row kernel takes rows of D elements of `eb` bytes: a power of
// two number of 16-byte units, at least 2 (whole half rows), at most 2 a
// lane of 32.
bool rows_ok(int D, int eb) {
  const int units = D * eb / 16;
  return units >= 2 && units <= 32 * kMaxUnits && (units & (units - 1)) == 0;
}

template <typename T>
int launch_compact(const int* pos_mid, int* pos, float* score, float* ssq, float* counter,
                   void* k, void* v, float* ksc, float* vsc, int rows, int S, int D,
                   cudaStream_t stream) {
  const size_t smem = kv_smem_bytes(D * (int)sizeof(T)) + sizeof(float) * S;
  auto kernel = compact_kernel<T>;
  int err = prepare(kernel, smem);
  if (err) return err;
  kernel<<<rows, kThreads, smem, stream>>>(pos_mid, pos, score, ssq, counter, (T*)k, (T*)v,
                                           ksc, vsc, S, D);
  return (int)cudaGetLastError();
}

int elem_bytes(int dtype) { return dtype == 0 ? 4 : dtype == 1 ? 2 : dtype == 2 ? 1 : 0; }

}  // namespace

extern "C" {

// Dynamic shared memory of one launch in bytes (K8 with with_row = 1).
// dtype: 0 float32, 1 bfloat16, 2 int8.
size_t kv_compact_smem(int S, int D, int dtype, int with_row) {
  return kv_smem_bytes(D * elem_bytes(dtype)) + (with_row ? sizeof(float) * (size_t)S : 0);
}

// Shared memory of a block of K9's row kernel taking `rows` rows a round.
size_t kv_shift_smem(int rows, int D, int dtype) {
  return shift_smem(rows, D * elem_bytes(dtype) / 16);
}

// K9. k, v: (rows, S, D) of `dtype`, rows = L * B * H, each row a multiple
// of 16 bytes, D even and <= 256; v_slot (rows,) int32, S = no eviction;
// k_scale, v_scale (rows, S) f32 for an int8 cache, else null; rotate = 1
// needs cosv, sinv (D/2,) f32 (and the scales for int8). The plan
// (ops/cuda/kv_compact.py shift_plan): the row kernel's threads a block (a
// multiple of 32, at most 512) and rows a round (rows_ok; its shared memory
// within the card's), or rows_round 0 for the per-head walk. In place.
// Returns the launch's error or cudaGetLastError().
int kv_compact(void* k, void* v, const int* v_slot, float* k_scale, float* v_scale,
               const float* cosv, const float* sinv, int rows, int S, int D, int dtype,
               int rotate, int threads, int rows_round, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int eb = elem_bytes(dtype);
  if (eb == 0 || (D * eb) % 16 != 0 || D % 2 != 0 || D > 2 * 32 * kMaxPairs || rows_round < 0 ||
      (rows_round > 0 && (!rows_ok(D, eb) || threads < 32 || threads > kShiftMaxThreads ||
                          threads % 32 || shift_smem(rows_round, D * eb / 16) > 232448)))
    return (int)cudaErrorInvalidValue;
  if ((dtype == 2) != (k_scale != nullptr) || (k_scale == nullptr) != (v_scale == nullptr) ||
      (rotate && (cosv == nullptr || sinv == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return rotate ? launch_kv<float, true>(k, v, v_slot, k_scale, v_scale, cosv, sinv, rows,
                                           S, D, threads, rows_round, st)
                  : launch_kv<float, false>(k, v, v_slot, k_scale, v_scale, cosv, sinv, rows,
                                            S, D, threads, rows_round, st);
  if (dtype == 1)
    return rotate ? launch_kv<__nv_bfloat16, true>(k, v, v_slot, k_scale, v_scale, cosv,
                                                   sinv, rows, S, D, threads, rows_round, st)
                  : launch_kv<__nv_bfloat16, false>(k, v, v_slot, k_scale, v_scale, cosv,
                                                    sinv, rows, S, D, threads, rows_round, st);
  return rotate ? launch_kv<int8_t, true>(k, v, v_slot, k_scale, v_scale, cosv, sinv, rows, S,
                                          D, threads, rows_round, st)
                : launch_kv<int8_t, false>(k, v, v_slot, k_scale, v_scale, cosv, sinv, rows, S,
                                           D, threads, rows_round, st);
}

// K8. pos_mid, pos (rows, S) int32; score, score_sq, counter (rows, S) f32;
// k, v (rows, S, D) of `dtype`; k_scale, v_scale as for K9. In place.
// Returns cudaGetLastError().
int compact(const int* pos_mid, int* pos, float* score, float* score_sq, float* counter,
            void* k, void* v, float* k_scale, float* v_scale, int rows, int S, int D,
            int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int eb = elem_bytes(dtype);
  if (eb == 0 || (D * eb) % 16 != 0 || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_compact<float>(pos_mid, pos, score, score_sq, counter, k, v, k_scale,
                                 v_scale, rows, S, D, st);
  if (dtype == 1)
    return launch_compact<__nv_bfloat16>(pos_mid, pos, score, score_sq, counter, k, v,
                                         k_scale, v_scale, rows, S, D, st);
  return launch_compact<int8_t>(pos_mid, pos, score, score_sq, counter, k, v, k_scale,
                                v_scale, rows, S, D, st);
}

}  // extern "C"
