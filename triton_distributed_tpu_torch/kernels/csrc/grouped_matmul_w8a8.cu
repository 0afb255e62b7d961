// Grouped W8A8 matmul: for every group (expert) e, int8 x int8 -> int32 on
// the tensor cores, then out[e, m, n] = (float(acc) * sa[e, m]) * sb[e, n]
// in bf16 or f32.
//
// Replaces: triton_distributed_tpu/kernels/grouped_gemm.py
//   `grouped_matmul_w8a8` -> `_grouped_w8a8_kernel` (pallas_call :266).
//   The layouts are the JAX package's: a (E, m, k) and b (E, k, n) int8
//   row-major, sa (E, m) per token and sb (E, n) per expert and output
//   channel, f32 (the TPU kernel's lane-broadcast copy of sa is a Mosaic
//   tiling workaround and does not carry over).  The epilogue multiplies in
//   the TPU kernel's order (:225-226) and int32 accumulation is exact, so
//   the result is bit-identical to an exact plain product with the same
//   epilogue.
//
// What bounds it on the H100: the bytes of b at the Qwen3-30B-A3B expert
// shapes.  A decode step's gate_up (128 experts, 32-row int8 buckets,
// b 128 x 2048 x 1536) moves 402 MB for 1.6 GOP (0.120 ms at 3.35 TB/s).
//
// Design: the first int8 tile (csrc/w8a8_body.cuh) with the group in
// blockIdx.z.

#include "w8a8_body.cuh"

using namespace tdt::w8a8;

// a (E,M,K) int8, b (E,K,N) int8, sa (E,M) f32, sb (E,N) f32, out (E,M,N)
// in out_dtype, all contiguous; a and b 16-byte aligned; K a multiple of
// 16.  Returns a cudaError_t code.
extern "C" int grouped_matmul_w8a8(const void* a, const void* b,
                                   const void* sa, const void* sb, void* out,
                                   int out_dtype, int E, int M, int N, int K,
                                   void* stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  if (E < 0 || E > 65535 || M < 0 || N < 0 || K <= 0 || K % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, E);
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
