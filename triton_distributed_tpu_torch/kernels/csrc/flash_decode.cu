// One-position GQA decode attention over a dense float KV cache.
//
// Replaces: triton_distributed_tpu/kernels/flash_decode.py `flash_decode`
//   -> `_decode_kernel` (pallas_call :195), float-cache form.
//
// What bounds it on the H100: bytes.  Each step reads the K and V rows
// below kv_len once (at the Qwen3-8B decode shape, 4 x 8 KV heads x ~530
// positions x 128 x 2 B x 2 = ~8.7 MB, ~2.6 us at 3.35 TB/s) and does
// only 4 FLOP per cached element per query head, ~30 times below the
// tensor-core balance point.
//
// Design:
// - One block of 128 threads per (batch row, KV head) holds all G = H/Hkv
//   query heads of that group (flash_decode.py:41-42, 183), so each K/V
//   row is read once for all G heads.
// - D/8 lanes share one cached position (8 elements, one 16-byte load
//   each for bf16); a warp covers 32/(D/8) positions at a time.  Each
//   such lane group is a "stream" with its own f32 online softmax
//   (natural exp, as :89-114), walking positions stream, stream+NS, ...
//   below kv_len[b], U positions in flight per stream to keep loads
//   outstanding.  The TPU kernel carried (m, l, acc) across sequential
//   grid steps; here the streams are combined once at the end through
//   shared memory with log-sum-exp weights.
// - Positions at or past kv_len are never read, so they contribute
//   exactly 0 whatever the cache holds there.
// - Known limit: the grid is only B*Hkv blocks (32 at the Qwen3-8B decode
//   shape, for 132 SMs).  A split-KV second pass is the later fix.

#include "common.cuh"

namespace {

using tdt::NEG_INF;

constexpr int NT = 128;  // threads per block (4 warps)

template <typename T, int D, int G>
__global__ void __launch_bounds__(NT) flash_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const int* __restrict__ kv_len,
    T* __restrict__ out, float* __restrict__ lse, int Hkv, int S,
    float scale) {
  constexpr int LPK = D / 8;            // lanes per position
  constexpr int KPW = 32 / LPK;         // positions per warp step
  constexpr int NS = (NT / 32) * KPW;   // streams per block
  constexpr int U = G >= 8 ? 2 : 4;     // positions in flight per stream
  __shared__ float sm_acc[NS][G][D];
  __shared__ float sm_m[NS][G];
  __shared__ float sm_l[NS][G];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int stream = (tid / 32) * KPW + lane / LPK;
  const int sl = lane % LPK;  // this lane's 8 columns: sl*8 .. sl*8+7
  const int len = min(max(kv_len[b], 0), S);

  const size_t head0 = (size_t)b * Hkv * G + (size_t)hk * G;
  const T* kp = kc + (size_t)(b * Hkv + hk) * S * D + sl * 8;
  const T* vp = vc + (size_t)(b * Hkv + hk) * S * D + sl * 8;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    tdt::load8(q + (head0 + g) * D + sl * 8, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  // The trip count depends on len only, so every lane of the warp runs
  // the shuffles below the same number of times.
  for (int j0 = 0; j0 < len; j0 += NS * U) {
    float kf[U][8], vf[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NS + stream;
      if (j < len) {
        tdt::load8(kp + (size_t)j * D, kf[u]);
        tdt::load8(vp + (size_t)j * D, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NS + stream;
      float s[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) t = fmaf(qf[g][i], kf[u][i], t);
        s[g] = t;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < G; ++g)
          s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      if (j < len) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);
          const float p = expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = fmaf(p, vf[u][i], acc[g][i] * alpha);
          m[g] = m_new;
        }
      }
    }
  }

  // Combine the streams with log-sum-exp weights.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) sm_acc[stream][g][sl * 8 + i] = acc[g][i];
    if (sl == 0) {
      sm_m[stream][g] = m[g];
      sm_l[stream][g] = l[g];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < NS; ++s) mx = fmaxf(mx, sm_m[s][g]);
    float lt = 0.f, o = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float w = expf(sm_m[s][g] - mx);
      lt = fmaf(w, sm_l[s][g], lt);
      o = fmaf(w, sm_acc[s][g][d], o);
    }
    lt = fmaxf(lt, 1e-30f);
    tdt::store1(out + (head0 + g) * D + d, o / lt);
    if (d == 0) lse[head0 + g] = mx + logf(lt);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* kv_len,
           void* out, void* lse, int B, int Hkv, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  flash_decode_kernel<T, D, G><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(kv_len),
      static_cast<T*>(out), static_cast<float*>(lse), Hkv, S, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v,
               const void* kv_len, void* out, void* lse, int B, int Hkv,
               int S, float scale, cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
    case 2: return launch<T, D, 2>(q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
    case 4: return launch<T, D, 4>(q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
    case 8: return launch<T, D, 8>(q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D), k/v cache (B,Hkv,S,D), out (B,H,D) contiguous, same dtype;
// kv_len (B,) int32; lse (B,H) f32.  Returns a cudaError_t code.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* lse,
                            int dtype, int B, int H, int Hkv, int S, int D,
                            float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16 && D == 128)
    return dispatch_g<__nv_bfloat16, 128>(G, q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
  if (dtype == tdt::DTYPE_BF16 && D == 64)
    return dispatch_g<__nv_bfloat16, 64>(G, q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 128)
    return dispatch_g<float, 128>(G, q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 64)
    return dispatch_g<float, 64>(G, q, k, v, kv_len, out, lse, B, Hkv, S, scale, s);
  return (int)cudaErrorInvalidValue;
}
