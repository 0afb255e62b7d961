// W8A8 matmul: int8 x int8 -> int32 on the tensor cores, then a rank-1 f32
// dequant epilogue, out[m, n] = (float(acc[m, n]) * sa[m]) * sb[n], written
// in bf16 or f32.
//
// Replaces: triton_distributed_tpu/kernels/quantized.py `matmul_w8a8` ->
//   `_w8a8_kernel` (pallas_call :120).  The layouts are the JAX package's:
//   a (m, k) int8 row-major, b (k, n) int8 row-major, sa (m,) and sb (n,)
//   f32.  The epilogue multiplies in the TPU kernel's order (:85-86) and
//   int32 accumulation is exact, so the result is bit-identical to an exact
//   plain product with the same epilogue.
//
// What bounds it on the H100: at the Qwen3-8B MLP shapes in a prefill
// bucket (m = 2048, k = 4096, n = 24576) the operations, 412 GOP at
// 1,979 TOP/s of int8 tensor cores (0.21 ms) against 126 MB of operands
// (0.04 ms at 3.35 TB/s); in a decode batch (m = 8) the bytes of b, which
// are nearly all of the 100 MB moved (0.03 ms), against 1.6 GOP.
//
// Design: csrc/w8a8_body.cuh, shared with K9.

#include "w8a8_body.cuh"

using namespace tdt::w8a8;

// a (M,K) int8, b (K,N) int8, sa (M,) f32, sb (N,) f32, out (M,N) in
// out_dtype, all contiguous; a and b 16-byte aligned; K a multiple of 16.
// Returns a cudaError_t code.
extern "C" int matmul_w8a8(const void* a, const void* b, const void* sa,
                           const void* sb, void* out, int out_dtype, int M,
                           int N, int K, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (M < 0 || N < 0 || K <= 0 || K % 16) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const int8_t* bp = static_cast<const int8_t*>(b);
  const float* sap = static_cast<const float*>(sa);
  const float* sbp = static_cast<const float*>(sb);
  if (out_dtype == tdt::DTYPE_BF16)
    w8a8_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        ap, bp, sap, sbp, static_cast<__nv_bfloat16*>(out), M, N, K);
  else if (out_dtype == tdt::DTYPE_F32)
    w8a8_kernel<float><<<grid, NT, 0, s>>>(ap, bp, sap, sbp,
                                           static_cast<float*>(out), M, N, K);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
