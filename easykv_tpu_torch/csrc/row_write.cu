// In-place K/V row write of a decode step: one Dh-row of K and one of V per
// (layer, batch, kv-head), at the slot the sidecar pass chose.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/row_write.py `write_rows`.
// The TPU kernel reads and rewrites whole (8|16|32, 128) tiles because its
// DMA engine cannot move one row; on Hopper a row is a plain store, so
// there is no read-modify-write and any head width whose row is a multiple
// of 16 bytes works (Dh=64 as well as Dh=128).
//
// What bounds it on an H100: launch latency. It moves 2 * L*B*H rows of
// Dh elements (1 MB at LLaMa-2-7B width in bf16, 0.3 us at 3.35 TB/s),
// less than one launch costs. One warp per (row, k|v), 16-byte loads and
// stores, all rows of all layers in one launch. The copy is byte-wise, so
// one kernel serves every element type.
//
// Rows are written unconditionally, as the JAX package does: a dead batch
// row's slot keeps pos < 0, so its bytes are never attended. A slot outside
// [0, S) is dropped, as an out-of-bounds scatter is in JAX.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
write_rows_kernel(uint8_t* __restrict__ k, uint8_t* __restrict__ v,
                  const uint8_t* __restrict__ kn, const uint8_t* __restrict__ vn,
                  const int* __restrict__ slots, int rows, int S, int row_bytes) {
  const int w = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= 2 * rows) return;
  const int r = w >> 1;
  const bool is_v = w & 1;
  const int slot = slots[r];
  if (slot < 0 || slot >= S) return;
  const uint4* src = (const uint4*)((is_v ? vn : kn) + (size_t)r * row_bytes);
  uint4* dst = (uint4*)((is_v ? v : k) + ((size_t)r * S + slot) * row_bytes);
  for (int i = lane; i < row_bytes / 16; i += 32) dst[i] = src[i];
}

}  // namespace

extern "C" {

// rows = L*B*H; row_bytes = Dh * element size, a multiple of 16 (and every
// pointer 16-byte aligned). Returns cudaGetLastError().
int write_rows(void* k, void* v, const void* kn, const void* vn, const int* slots,
               int rows, int S, int row_bytes, void* stream) {
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int warps_per_block = kThreads / 32;
  const int blocks = (2 * rows + warps_per_block - 1) / warps_per_block;
  write_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (uint8_t*)k, (uint8_t*)v, (const uint8_t*)kn, (const uint8_t*)vn, slots, rows, S,
      row_bytes);
  return (int)cudaGetLastError();
}

}  // extern "C"
