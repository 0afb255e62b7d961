// Helpers shared by the kernels: vector loads that widen to float, stores
// that narrow from float, cp.async copies, bf16 tensor-core fragments
// (ldmatrix, mma.sync), and the C error-string entry.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

constexpr float NEG_INF = -1e30f;  // finite "minus infinity", as the TPU kernels use
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// Eight consecutive elements, widened to float.  bf16: one 16-byte load;
// f32: two; int8 (cache codes, exact in float): one 8-byte load.  The
// caller guarantees 16-byte (int8: 8-byte) alignment.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros instead when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Number of K/V tiles of BK keys that a tile of query rows [q0, q0 + BQ)
// must visit: all of them, or under a causal mask (query row i sees keys
// <= i + kv_offset) those up to the tile's last row's limit.
template <int BQ, int BK>
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal,
                                        int kv_offset) {
  if (!causal) return (Sk + BK - 1) / BK;
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int last_k = min(last_q + kv_offset, Sk - 1);
  return last_k < 0 ? 0 : last_k / BK + 1;
}

// ---- bf16 tensor-core fragments (mma.sync m16n8k16, ldmatrix) ----------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Rows [r0, r0 + 64) of a (n, D) bf16 matrix into a padded shared tile by
// cp.async from NT threads; rows at or past n are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16 (*dst)[D + 8],
                                                const __nv_bfloat16* src,
                                                int r0, int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n;
    cp_async16(&dst[r][ch * 8], src + (size_t)(ok ? r0 + r : 0) * D + ch * 8,
               ok);
  }
}

}  // namespace tdt

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
