// Device helpers of the decode attention kernels: K1 (decode_attention.cu)
// and the attention phase of K14 (fused_decode.cu).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace decode_common {

constexpr float kNegInf = -1e30f;

template <typename T> struct VecOf { static constexpr int n = 16 / sizeof(T); };

// 16 bytes of T at p (16-byte aligned) as floats.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float* out) {
  const int4 v = *reinterpret_cast<const int4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (float)b[i];
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Block-wide max or sum of a block of kWarps warps through `red` (kWarps
// floats); every thread gets it.
template <bool kMax, int kWarps>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = lane < kWarps ? red[lane] : (kMax ? kNegInf : 0.f);
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();
  return x;
}

}  // namespace decode_common
