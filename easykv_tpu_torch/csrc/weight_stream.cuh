// Weight-streaming product y (M, N) = (x (M, K) @ q (K, N) int8) * s (N,)
// of kernel K13 at 1 < M <= 256 (quant_matmul.cu; M = 1 has its own stream,
// quant_gemv.cu): accumulated in f32 over the whole K, the per-column f32
// scale applied once after the whole contraction (acc_f32 * scale_f32).
//
// What bounds it on an H100: the weight bytes at small M (every byte is read
// once per M tile), the fp32 FMAs of the CUDA cores at large M (M = 256).
//
// Design. A block is 8 warps; a lane owns VEC consecutive columns and reads
// them as one 16-byte load per row, so a warp reads a contiguous 32*VEC-byte
// row segment. Each warp takes a chunk of RC rows and accumulates its
// products in f32 per column and row of its M tile. A block covers 8*RC
// rows per pass (x staged for them in shared memory as f32) and `passes`
// passes; the 8 warps' partials then add in shared memory in warp order. To
// fill 132 SMs at N = 4096, the rows are also split over gridDim.y blocks:
// each writes its partial to a workspace, and the last block of a column
// tile to finish (an atomic ticket decides which; it resets the ticket)
// adds the partials in split order, so the sum is the same in every run. No
// atomics touch the sums. The tickets belong to the launching stream
// (ops/cuda/_wstream.py keeps one zeroed row of them a stream): launches in
// flight on two streams never share one, and launches on one stream run one
// after the other.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wstream {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// An int of magnitude below 2^22 as a float, exactly, in two full-rate ops
// (the int-to-float conversion unit runs at an eighth of the FMA rate).
__device__ __forceinline__ float i2f(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.f;
}

// Byte j (0..3) of a word, sign-extended.
__device__ __forceinline__ int sbyte(uint32_t word, int j) {
  return static_cast<int>(word << (24 - 8 * j)) >> 24;
}

// VEC bytes at p into VEC/4 words: one vector load where the segment is
// whole and aligned, else byte loads of the first `valid` bytes (zeros after).
template <int VEC>
__device__ __forceinline__ void load_row(const int8_t* p, bool vec_ok, int valid,
                                         uint32_t (&wd)[VEC / 4]) {
  static_assert(VEC == 16, "a lane reads one 16-byte segment a row");
  if (vec_ok) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    wd[0] = v.x; wd[1] = v.y; wd[2] = v.z; wd[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * i + b < valid) word |= static_cast<uint32_t>(static_cast<uint8_t>(p[4 * i + b])) << (8 * b);
      wd[i] = word;
    }
  }
}

template <int MT, int VEC, typename XT, typename OT>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, OT* __restrict__ out, float* __restrict__ ws,
              unsigned* __restrict__ tickets, int M, int R, int N, int RC, int passes) {
  constexpr int TN = 32 * VEC;
  extern __shared__ float smem[];
  __shared__ bool last_block;
  const int BR = kWarps * RC;
  float* xs = smem;                     // (MT, BR) this pass's x, f32
  float* red = smem + MT * BR;          // (kWarps, TN) partials of one M row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.z * MT;
  const int c0 = n0 + lane * VEC;
  const int valid = N - c0 < VEC ? N - c0 : VEC;
  const bool vec_ok = valid == VEC && (N % VEC) == 0;
  const int nb = (R + BR - 1) / BR;     // row blocks of BR rows

  float tot[MT][VEC];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < VEC; ++j) tot[m][j] = 0.f;

  for (int pb = blockIdx.y * passes; pb < (blockIdx.y + 1) * passes && pb < nb; ++pb) {
    const int r_blk = pb * BR;
    __syncthreads();                    // the previous pass is done with xs
    for (int i = threadIdx.x; i < MT * BR; i += kThreads) {
      const int m = i / BR, r = r_blk + i % BR;
      xs[i] = (m0 + m < M && r < R) ? to_f32(x[(size_t)(m0 + m) * R + r]) : 0.f;
    }
    __syncthreads();
    const int rw0 = r_blk + warp * RC;
    if (rw0 >= R || valid <= 0) continue;
    const int rend = rw0 + RC < R ? rw0 + RC : R;
    float acc[MT][VEC];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[m][j] = 0.f;
    for (int r = rw0; r < rend; r += 8) {
      uint32_t wd[8][VEC / 4];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (r + u < rend) {
          load_row<VEC>(w + (size_t)(r + u) * N + c0, vec_ok, valid, wd[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) wd[u][i] = 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int li = r + u - r_blk;   // < BR: rows past rend read zero weights
        float xl[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) xl[m] = xs[m * BR + li];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float v = i2f(sbyte(wd[u][j >> 2], j & 3));
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[m][j] = fmaf(xl[m], v, acc[m][j]);
        }
      }
    }
    // the chunk's sums
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) tot[m][j] += acc[m][j];
  }

  // the 8 warps' partials, added in warp order, then out (or the workspace)
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < VEC; ++j) red[warp * TN + lane * VEC + j] = tot[m][j];
    __syncthreads();
    const int mm = m0 + m;
    for (int c = threadIdx.x; c < TN; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) s += red[wi * TN + c];
      const int n = n0 + c;
      if (n < N && mm < M) {
        if (split)
          ws[((size_t)blockIdx.y * M + mm) * N + n] = s;
        else
          store(out + (size_t)mm * N + n, s * scale[n]);
      }
    }
  }
  if (!split) return;

  __threadfence();
  __syncthreads();
  const unsigned tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last_block = atomicAdd(&tickets[tile], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = threadIdx.x; i < MT * TN; i += kThreads) {
    const int mm = m0 + i / TN, n = n0 + i % TN;
    if (n >= N || mm >= M) continue;
    // 8 partials in flight at a time, added in split order
    const float* col = ws + (size_t)mm * N + n;
    const size_t stride = (size_t)M * N;
    const int ky = gridDim.y;
    float s = 0.f;
    int y = 0;
    for (; y + 8 <= ky; y += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = __ldcg(col + (size_t)(y + u) * stride);
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; y < ky; ++y) s += __ldcg(col + (size_t)y * stride);
    store(out + (size_t)mm * N + n, s * scale[n]);
  }
  if (threadIdx.x == 0) tickets[tile] = 0u;
}

template <int MT, typename XT, typename OT>
int launch_one(const void* x, const int8_t* w, const float* scale, void* out, float* ws,
               unsigned* tickets, int M, int R, int N, int RC, int passes, int ksplit,
               cudaStream_t stream) {
  constexpr int VEC = 16;
  constexpr int TN = 32 * VEC;
  const size_t smem = sizeof(float) * ((size_t)MT * kWarps * RC + (size_t)kWarps * TN);
  const dim3 grid((N + TN - 1) / TN, ksplit, (M + MT - 1) / MT);
  stream_kernel<MT, VEC, XT, OT><<<grid, kThreads, smem, stream>>>(
      static_cast<const XT*>(x), w, scale, static_cast<OT*>(out), ws, tickets, M, R, N, RC,
      passes);
  return (int)cudaGetLastError();
}

// The tile shape the wrapper plans with: MT rows of x per block (1 at
// M = 1, else 4) and 16 columns per lane.
template <int MT>
int launch_mt(const void* x, const int8_t* w, const float* scale, void* out, float* ws,
              unsigned* tickets, int M, int R, int N, int RC, int passes, int ksplit,
              int x_bf16, int out_f32, cudaStream_t stream) {
  if (!x_bf16)
    return launch_one<MT, float, float>(x, w, scale, out, ws, tickets, M, R, N, RC, passes,
                                        ksplit, stream);
  if (out_f32)
    return launch_one<MT, __nv_bfloat16, float>(x, w, scale, out, ws, tickets, M, R, N, RC,
                                                passes, ksplit, stream);
  return launch_one<MT, __nv_bfloat16, __nv_bfloat16>(x, w, scale, out, ws, tickets, M, R, N,
                                                      RC, passes, ksplit, stream);
}

// Checks the plan and launches. RC: rows per warp chunk, a multiple of 8;
// passes: row blocks of 8*RC rows per block; ksplit: blocks along the rows
// (ws (ksplit, M, N) f32 and one zeroed ticket per column tile of the grid
// when ksplit > 1).
inline int launch(const void* x, const int8_t* w, const float* scale, void* out, float* ws,
                  unsigned* tickets, int M, int R, int N, int RC, int passes, int ksplit,
                  int x_bf16, int out_f32, cudaStream_t stream) {
  if (M < 1 || R < 1 || N < 1 || RC < 8 || RC % 8 != 0 || passes < 1 || ksplit < 1 ||
      ksplit > 65535 || (ksplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int nb = (R + kWarps * RC - 1) / (kWarps * RC);
  if ((long long)ksplit * passes < nb) return (int)cudaErrorInvalidValue;
  if (M == 1)
    return launch_mt<1>(x, w, scale, out, ws, tickets, M, R, N, RC, passes, ksplit, x_bf16,
                        out_f32, stream);
  return launch_mt<4>(x, w, scale, out, ws, tickets, M, R, N, RC, passes, ksplit, x_bf16,
                      out_f32, stream);
}

}  // namespace wstream
