// w4a16 GEMV over halves-packed int4 (kernel K12): y (M, N) = x (M, K) @
// dequant(q4p (K/2, N), gs (K/G, N) f32), M <= 8.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/w4_matmul.py `w4a16_gemv`
// (one (K/2, 512) tile per grid step, nibbles unpacked in VMEM). Here the
// packed bytes stream through weight_stream.cuh: the low nibble sign-extends
// as (b << 28) >> 28 on int32, the high one as b >> 4; packed row r carries
// row r of x's first half and row r + K/2 of its second, so the two halves
// take the first and the second gc/2 scale rows, applied to each chunk's f32
// sums. Bound: the packed bytes and scales (wq at 7B: 8.4 MB + 0.5 MB of
// f32 scales, 2.7 us at 3.35 TB/s).
#include "weight_stream.cuh"

extern "C" {

// x: (M, K) f32 or bf16; q4p: (K/2, N) int8; gs: (K/G, N) f32; out: (M, N)
// in x's type (f32 with out_f32). G: group size (rows). The signature of
// every entry over weight_stream.cuh. Returns cudaGetLastError().
int w4a16_gemv(const void* x, const int8_t* q4p, const void* gs, void* out, float* ws,
               unsigned* tickets, int M, int K, int N, int G, int rc, int passes, int ksplit,
               int x_bf16, int out_f32, void* stream) {
  if (K % 2 != 0) return (int)cudaErrorInvalidValue;
  return wstream::launch<wstream::kQ4P, wstream::kScaleGroupF32>(
      x, q4p, gs, out, ws, tickets, M, K / 2, N, G, rc, passes, ksplit, x_bf16, out_f32,
      (cudaStream_t)stream);
}

}  // extern "C"
