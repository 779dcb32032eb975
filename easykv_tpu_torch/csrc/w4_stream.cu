// w4a16 product over the arithmetic int4 carrier (16*hi + lo, nibbles in
// [-7, 7]): K10 `w4a16_gemv_arith` (M = 1, the bf16 scale pair gs3). K11,
// the same carrier at 1 < M <= 512, is its own tensor-core kernel
// (w4_gemm.cu).
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/w4_stream.py
// `w4a16_gemv_arith`. It recovers the nibble planes from MXU dots against
// masked copies of x (the 3-functional algebra with xl - xh/16,
// w4_stream.py:20-31), because Mosaic has no int8 vector arithmetic.
// Hopper's integer units unpack a byte directly: hi = (b + 8) >> 4, lo = b -
// 16*hi (quant.py:78-83), so nothing of that algebra is carried over: the
// carrier streams through weight_stream.cuh once, each chunk's lo and hi
// sums take their group scales in registers. K10 reads the bf16 pair gs3 =
// [gs_hi; gs_lo] / 16 (half the scale bytes; times 16 it is gs exactly,
// since quantize_linear_int4 keeps the scales bf16-representable).
// Bound: the carrier and pair bytes (wgu at 7B: 45.1 MB + 1.4 MB, 13.9 us at
// 3.35 TB/s).
#include "weight_stream.cuh"

extern "C" {

// The signature of every entry over weight_stream.cuh (quant_matmul.cu,
// w4_matmul.cu): x (1, K) f32 or bf16 (x_bf16); p: (K/2, N) int8 carrier;
// gs3 (K/G, N) bf16; out (1, N) in x's type (f32 with out_f32). Returns
// cudaGetLastError().
int w4a16_gemv_arith(const void* x, const int8_t* p, const void* gs3, void* out, float* ws,
                     unsigned* tickets, int M, int K, int N, int G, int rc, int passes,
                     int ksplit, int x_bf16, int out_f32, void* stream) {
  if (M != 1 || K % 2 != 0) return (int)cudaErrorInvalidValue;
  return wstream::launch<wstream::kQ4A, wstream::kScalePairBf16>(
      x, p, gs3, out, ws, tickets, 1, K / 2, N, G, rc, passes, ksplit, x_bf16, out_f32,
      (cudaStream_t)stream);
}

}  // extern "C"
