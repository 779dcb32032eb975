// w8a16 product (kernel K13) at 1 < M <= 256: y (M, N) = (x (M, K) @ q (K,
// N) int8) * s (N,), accumulated in f32 over the whole K and scaled once,
// rounded once to the output type (x's, or f32 for the int8 LM head). M = 1
// has its own stream, quant_gemv.cu.
//
// Replaces the TPU kernel easykv_tpu/ops/pallas/quant_matmul.py
// `quant_matmul` (M <= 256, f32 accumulation, one scale multiply). The TPU
// kernel reads a (K, 256) weight tile per grid step with the full K in VMEM;
// here the weight streams through weight_stream.cuh: a warp reads 512
// contiguous bytes of a row, 8 warps and several blocks split K, and the
// partial sums add in a fixed order. Bound: the int8 weight bytes at small
// M (16.8 MB for wo, 5.0 us at 3.35 TB/s), the fp32 FMAs of the CUDA cores
// at M = 256.
#include "weight_stream.cuh"

extern "C" {

// x: (M, K) f32 or bf16 (x_bf16); q: (K, N) int8; s: (N,) f32; out: (M, N)
// f32 when out_f32 or x is f32, else bf16; ws, tickets and the plan (rc,
// passes, ksplit) from ops/cuda/_wstream.py. Returns cudaGetLastError().
int quant_matmul(const void* x, const int8_t* q, const float* s, void* out, float* ws,
                 unsigned* tickets, int M, int K, int N, int rc, int passes, int ksplit,
                 int x_bf16, int out_f32, void* stream) {
  return wstream::launch(x, q, s, out, ws, tickets, M, K, N, rc, passes, ksplit, x_bf16, out_f32,
                         (cudaStream_t)stream);
}

}  // extern "C"
