// One-position GQA decode attention, shared by the dense (flash_decode.cu)
// and the paged (flash_decode_paged.cu) kernels.  The two differ only in
// how a cached position's K/V row is found (`Rows::row`); the loads, the
// per-stream online softmax and the combine are this one body, so the two
// kernels return bit-identical out and lse for the same logical K/V.
//
// What bounds it on the H100: bytes.  Each step reads the K and V rows
// below kv_len once and does only 4 FLOP per cached element per query
// head, ~30 times below the tensor-core balance point.
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
//   exactly 0 whatever the cache (or an unmapped page) holds there.
// - int8 cache (C = int8_t, the TPU kernel's `quantized` form, :44-48,
//   :66-103): q, out and the arithmetic stay in T (bf16 or f32), lse f32.
//   A lane still covers 8 positions' columns, now as one 8-byte load of
//   codes: the lane and stream layout, and so the order of every sum, is
//   the float kernel's, and each position's two f32 scales are one more
//   load each.  The K scale multiplies the score after `scale` (:76-82);
//   l sums the unscaled p, and the V scale multiplies p only in the
//   accumulation (:93-103).  `Rows::row(b, hk, j)` is also the index of
//   position j's scale, (B, Hkv, S) dense or (P, Hkv, ps) paged, so the
//   dense and paged int8 kernels stay bit-identical too.  Positions at or
//   past kv_len load no scale, so a stale or NaN scale there (a reused
//   slot, the null page) never reaches the sums.
// - Known limit: the grid is only B*Hkv blocks (32 at the Qwen3-8B decode
//   shape with 4 rows, 64 with 8, for 132 SMs).  A split-KV second pass
//   is the later fix.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace tdt {

constexpr int DECODE_NT = 128;  // threads per block (4 warps)

// Dense cache (B, Hkv, S, D): position j of (b, hk) is row (b*Hkv+hk)*S+j.
struct DenseRows {
  int Hkv, S;
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    return (size_t)(b * Hkv + hk) * S + j;
  }
};

// Page pool (P, Hkv, ps, D) with a (B, T) int32 page table: position j of
// (b, hk) is row ps*(table[b, j/ps]*Hkv + hk) + j%ps.  A table entry
// outside [0, P) is clamped into the pool (the TPU's out-of-range block
// index is clamped too), so a bad table reads wrong data, never memory
// outside the pool.
struct PagedRows {
  const int* table;
  int T, ps, Hkv, P;
  __device__ __forceinline__ int capacity() const { return T * ps; }
  __device__ __forceinline__ size_t row(int b, int hk, int j) const {
    const int page = min(max(table[(size_t)b * T + j / ps], 0), P - 1);
    return ((size_t)page * Hkv + hk) * ps + j % ps;
  }
};

// T: q and out (bf16 or f32); C: the cache, T itself or int8_t with f32
// scales ks/vs (null for a float cache).
template <typename T, typename C, int D, int G, typename Rows>
__global__ void __launch_bounds__(DECODE_NT) decode_kernel(
    const T* __restrict__ q, const C* __restrict__ kc,
    const C* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, Rows rows, const int* __restrict__ kv_len,
    T* __restrict__ out, float* __restrict__ lse, int Hkv, float scale) {
  constexpr bool QUANT = std::is_same<C, int8_t>::value;
  constexpr int NT = DECODE_NT;
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
  const int len = min(max(kv_len[b], 0), rows.capacity());

  const size_t head0 = (size_t)b * Hkv * G + (size_t)hk * G;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + (head0 + g) * D + sl * 8, qf[g]);
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
    float kf[U][8], vf[U][8], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * NS + stream;
      if (j < len) {
        const size_t r = rows.row(b, hk, j);
        load8(kc + r * D + sl * 8, kf[u]);
        load8(vc + r * D + sl * 8, vf[u]);
        if constexpr (QUANT) {
          ksc[u] = ks[r];
          vsc[u] = vs[r];
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kf[u][i] = vf[u][i] = 0.f;
        ksc[u] = vsc[u] = 0.f;
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
          if constexpr (QUANT) s[g] *= ksc[u];
          const float m_new = fmaxf(m[g], s[g]);
          const float alpha = expf(m[g] - m_new);
          float p = expf(s[g] - m_new);
          l[g] = l[g] * alpha + p;
          if constexpr (QUANT) p *= vsc[u];
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
    store1(out + (head0 + g) * D + d, o / lt);
    if (d == 0) lse[head0 + g] = mx + logf(lt);
  }
}

// The kernel's arguments apart from its template parameters.
template <typename Rows>
struct DecodeArgs {
  const void *q, *k, *v;
  const float *ks, *vs;  // null for a float cache
  Rows rows;
  const int* kv_len;
  void *out, *lse;
  int B, Hkv;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int G, typename Rows>
int launch_decode(const DecodeArgs<Rows>& a) {
  const dim3 grid(a.Hkv, a.B);
  decode_kernel<T, C, D, G, Rows><<<grid, DECODE_NT, 0, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k),
      static_cast<const C*>(a.v), a.ks, a.vs, a.rows, a.kv_len,
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.Hkv, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename C, int D, typename Rows>
int dispatch_group(int G, const DecodeArgs<Rows>& a) {
  switch (G) {
    case 1: return launch_decode<T, C, D, 1>(a);
    case 2: return launch_decode<T, C, D, 2>(a);
    case 4: return launch_decode<T, C, D, 4>(a);
    case 8: return launch_decode<T, C, D, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows>
int dispatch_cache(bool quant, int G, int D, const DecodeArgs<Rows>& a) {
  if (quant && D == 128) return dispatch_group<T, int8_t, 128>(G, a);
  if (quant && D == 64) return dispatch_group<T, int8_t, 64>(G, a);
  if (D == 128) return dispatch_group<T, T, 128>(G, a);
  if (D == 64) return dispatch_group<T, T, 64>(G, a);
  return (int)cudaErrorInvalidValue;
}

// q (B,H,D), out (B,H,D) contiguous in dtype; the cache in dtype, or int8
// with f32 scales when ks and vs are given (both or neither); kv_len (B,)
// int32; lse (B,H) f32.  Returns a cudaError_t code.
template <typename Rows>
int dispatch_decode(int dtype, int H, int D, const DecodeArgs<Rows>& a) {
  if (a.B == 0 || H == 0) return 0;
  if (a.Hkv <= 0 || H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if ((a.ks == nullptr) != (a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = a.ks != nullptr;
  const int G = H / a.Hkv;
  if (dtype == DTYPE_BF16) return dispatch_cache<__nv_bfloat16>(quant, G, D, a);
  if (dtype == DTYPE_F32) return dispatch_cache<float>(quant, G, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace tdt
