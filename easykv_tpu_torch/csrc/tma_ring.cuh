// The pieces of an asynchronous ring on Hopper, shared by K10 and K13 at
// M = 1 (quant_gemv.cu) and K14 (fused_decode.cu); K1 (decode_attention.cu)
// takes its mbarriers: mbarriers in shared
// memory, copies by the Tensor Memory Accelerator (a 2-D box of a tensor
// map, or a bulk copy of contiguous bytes) that count their bytes against a
// barrier, and the host side that encodes a tensor map of a byte matrix
// (cuTensorMapEncodeTiled, found through the CUDA runtime: no -lcuda).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace tma_ring {

__host__ __device__ inline size_t align_to(size_t n, size_t a) { return (n + a - 1) / a * a; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the copy engine.
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrives once and expects `bytes` more of copies on the barrier's phase.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(smem_u32(b)),
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

// The box of the tensor map at (column c, row r) into dst (128-byte
// aligned); completion counts against b's expected bytes (the whole box:
// columns and rows past the matrix arrive as zeros). The map may lie in
// the kernel's parameters or in global memory.
__device__ __forceinline__ void box_copy(void* dst, const void* map, int c, int r, uint64_t* b) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, "
      "{%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(b))
      : "memory");
}

// box_copy with the L2 told to evict the box's lines first: a stream read
// once, which should not push out what the kernel reads back.
__device__ __forceinline__ void box_copy_once(void* dst, const void* map, int c, int r,
                                              uint64_t* b) {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(smem_u32(b)), "l"(pol)
      : "memory");
}

// Before the first use of a tensor map in global memory that the host
// wrote (by a copy before the launch): the copy engine's view of it
// acquired.
__device__ __forceinline__ void map_acquire(const void* map) {
  asm volatile("fence.proxy.tensormap::generic.acquire.sys [%0], 128;" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void prefetch_map(const void* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Named barrier `id` (1..15) of the block's first `threads` threads.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
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

// The tensor map of a byte matrix (rows x cols at w, row stride cols, a
// multiple of 16) in boxes of box_rows x box_cols bytes, no swizzle: a box
// lands as box_rows rows of box_cols contiguous bytes; `promo` is the L2
// promotion of a box row's fetch (none where a box row is narrower than
// what the promotion would fetch, which then reads bytes nobody asked for).
// Returns 0 or a CUDA error.
inline int byte_map(const void* w, long long rows, long long cols, int box_rows, int box_cols,
                    CUtensorMapL2promotion promo, CUtensorMap* out) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  if (enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, promo,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace tma_ring
