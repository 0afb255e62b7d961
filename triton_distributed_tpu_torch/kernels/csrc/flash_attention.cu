// Causal / non-causal GQA flash attention, forward (prefill).
//
// Replaces: triton_distributed_tpu/kernels/flash_attention.py
//   `flash_attention` -> `_flash_kernel_single_diag` (pallas_call :564),
//   `_flash_kernel_packed` (:614) and `_flash_kernel` (:680).  The three
//   TPU kernels are three schedules of one function; this file computes
//   all of them (static or run-time kv_offset, causal or not) with one
//   kernel per input type.
//
// What bounds it on the H100: at the Qwen3-8B prefill shape (q 4x32x512x128,
// k/v 4x8x512x128, bf16, causal) the function moves ~42 MB (12.5 us at
// 3.35 TB/s) and does ~8.6 GFLOP (8.7 us at 989 TFLOP/s of bf16 tensor
// cores), so its least time is set by the bytes, with the products close
// behind.  The bf16 kernel therefore does both products on the tensor
// cores (mma.sync m16n8k16, f32 accumulators) and reads each K/V tile from
// device memory once per block of 64 query rows; the f32 kernel (inputs
// the main path never gives it) stays on the CUDA cores.
//
// Design, both kernels: one thread block = one (batch, query head, tile of
// 64 query rows), running the tile bodies of `flash_body.cuh` (shared with
// K20): `begin` stages the query tile, one `attend` walks the K/V tiles of
// 64 keys up to the exact causal limit of the tile's last row (q_row +
// kv_offset) with the online softmax state (m, l, acc) in registers, and
// `finish` stores out and the natural-log lse.  The TPU kernels carried
// that state across sequential grid steps in VMEM scratch; CUDA blocks run
// in no order, so the loop replaces that grid dimension.  GQA: query head h
// reads KV head h / (H / Hkv).  Ragged edges and fully masked rows (possible
// only with a negative kv_offset: lse ~ -inf, out unspecified, as on the
// TPU, :211-219) are handled in the bodies.
//
// bf16 kernel: 4 warps of 16 query rows each on the tensor cores
// (`bf16_begin/attend/finish`).  Heavy causal tiles (last query rows) are
// scheduled first.  f32 kernel: 256 threads on the CUDA cores
// (`f32_begin/attend/finish`).

#include "flash_body.cuh"

namespace {

using namespace tdt::flash;

// ---- bf16: tensor cores ---------------------------------------------------

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale) {
  __shared__ __align__(16) Bf16Smem<D> sm;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)(b * H + h);
  const size_t bhk = (size_t)(b * Hkv + hk);

  Bf16State<D> st;
  bf16_begin<D>(sm, q + bh * Sq * D, q0, Sq, st);
  bf16_attend<D>(sm, k + bhk * Sk * D, v + bhk * Sk * D, q0, Sk,
                 tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset), causal,
                 kv_offset, qscale, st);
  bf16_finish<D>(sm, out + bh * Sq * D, lse + bh * Sq, q0, Sq, st);
}

// ---- f32: CUDA cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(F32_NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)(b * H + h);
  const size_t bhk = (size_t)(b * Hkv + hk);

  F32State<D> st;
  f32_begin<D>(smem, q + bh * Sq * D, q0, Sq, qscale, st);
  f32_attend<D>(smem, k + bhk * Sk * D, v + bhk * Sk * D, q0, Sk,
                tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset), causal,
                kv_offset, st);
  f32_finish<D>(out + bh * Sq * D, lse + bh * Sq, q0, Sq, st);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                int kv_offset, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D><<<grid, MMA_NT, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, kv_offset,
      scale * tdt::LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               int kv_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, kv_offset,
      scale * tdt::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D), out (B,H,Sq,D) contiguous, same dtype;
// lse (B,H,Sq) f32.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int dtype, int B,
                                   int H, int Hkv, int Sq, int Sk, int D,
                                   int causal, int kv_offset, float scale,
                                   void* stream) {
  if (Sq == 0 || B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16 && D == 128)
    return launch_bf16<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                            kv_offset, scale, s);
  if (dtype == tdt::DTYPE_BF16 && D == 64)
    return launch_bf16<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                           kv_offset, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 128)
    return launch_f32<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                           kv_offset, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 64)
    return launch_f32<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                          kv_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
