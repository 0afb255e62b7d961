// Communication bodies shared by the collective kernels, as device
// functions over `dl.cuh`:
// - `emit_push_allgather`: port of triton_distributed_tpu/kernels/
//   allgather.py `emit_push_allgather` (:150), the one-shot push
//   all-gather (K12's `ll` body; K15's push kernel later);
// - `emit_scatter_reduce`: port of kernels/reduce_scatter.py
//   `emit_scatter_reduce` (:144), one-shot scatter then local reduce
//   (K14's `ll` body; K16's scatter kernel later);
// - `reduce_sum`: port of reduce_scatter.py `_emit_reduce_sum` (:94), the
//   f32 sum over the ranks' partials in rank order 0 .. W-1, cast to the
//   output type.
// Every block of a rank calls them with its share (blockIdx.x of
// gridDim.x).
#pragma once

#include "common.cuh"
#include "dl.cuh"

namespace tdt {
namespace comm {

using dl::u64;

// Eight consecutive elements read through L2, widened to float (16-byte
// aligned).
__device__ __forceinline__ void load8_cg(const __nv_bfloat16* p, float* f) {
  const uint4 u = __ldcg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8_cg(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float* f) {
  reinterpret_cast<float4*>(p)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(f[4], f[5], f[6], f[7]);
}

__device__ __forceinline__ float load1_cg(const __nv_bfloat16* p) {
  return __bfloat162float(__ldcg(p));
}
__device__ __forceinline__ float load1_cg(const float* p) {
  return __ldcg(p);
}

// out[i] = sum over w = 0 .. world-1 of src[w * elems + i], each term
// widened to f32 and added in that order, the sum cast to T: block
// ``part`` of ``parts`` takes its share of the elements.
template <typename T>
__device__ __forceinline__ void reduce_sum(const T* src, T* out, int world,
                                           size_t elems, int part,
                                           int parts) {
  const bool vec = elems % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(src) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const size_t unit = vec ? 8 : 1;
  const size_t units = elems / unit;
  const size_t share = (units + parts - 1) / parts;
  const size_t start = (size_t)part * share;
  const size_t lo = start < units ? start : units;
  const size_t hi = units - lo < share ? units : lo + share;
  for (size_t i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (vec) {
      float acc[8], v[8];
      load8_cg(src + i * 8, acc);
      for (int w = 1; w < world; ++w) {
        load8_cg(src + w * elems + i * 8, v);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] = acc[j] + v[j];
      }
      store8(out + i * 8, acc);
    } else {
      float acc = load1_cg(src + i);
      for (int w = 1; w < world; ++w) acc = acc + load1_cg(src + w * elems + i);
      store1(out + i, acc);
    }
  }
}

// One-shot push all-gather: this rank's ``bytes``-byte shard goes to slot
// rank(t) of every rank's ``gathered`` buffer (its own included, which
// stands for the JAX body's local copy), one arrival signal a block; then
// the block waits until every rank's shard has arrived in its own buffer.
// With ``barrier``, the entry barrier comes first.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void emit_push_allgather(
    const dl::Team& t, const void* shard, dl::Symm<char> gathered,
    size_t bytes, dl::Symm<u64> sig, u64 target, bool barrier) {
  const int me = dl::rank(t);
  if (barrier) dl::entry_barrier<S>(t, sig, target, false);
  for (int p = 0; p < t.world; ++p)
    dl::put_nbi(gathered[p] + me * bytes, shard, bytes, blockIdx.x,
                gridDim.x);
  u64* words[dl::MAX_RANKS];
  for (int p = 0; p < t.world; ++p) words[p] = sig[p] + dl::ARRIVAL_WORD + me;
  dl::signal_after_puts<S>(words, t.world);
  dl::wait<S>(sig[me] + dl::ARRIVAL_WORD, t.world, 1, target,
              "push all-gather arrival");
}

// One-shot scatter-reduce: chunk c of this rank's partials ``src`` (world
// chunks of ``elems``) goes to slot rank(t) of rank c's ``rbuf`` (its own
// chunk included), one arrival signal a block; then, once every rank's
// partial of this rank's chunk has arrived, `reduce_sum` of ``rbuf`` into
// ``out``.  Every block of the rank must have finished writing ``src``
// (`dl::barrier_rank`).  With ``barrier``, the entry barrier comes first.
template <typename T, dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void emit_scatter_reduce(
    const dl::Team& t, const T* src, T* out, dl::Symm<char> rbuf,
    size_t elems, dl::Symm<u64> sig, u64 target, bool barrier) {
  const int me = dl::rank(t);
  if (barrier) dl::entry_barrier<S>(t, sig, target, false);
  for (int c = 0; c < t.world; ++c)
    dl::put_nbi(reinterpret_cast<T*>(rbuf[c]) + me * elems, src + c * elems,
                elems * sizeof(T), blockIdx.x, gridDim.x);
  u64* words[dl::MAX_RANKS];
  for (int c = 0; c < t.world; ++c) words[c] = sig[c] + dl::ARRIVAL_WORD + me;
  dl::signal_after_puts<S>(words, t.world);
  dl::wait<S>(sig[me] + dl::ARRIVAL_WORD, t.world, 1, target,
              "scatter-reduce arrival");
  reduce_sum(reinterpret_cast<const T*>(rbuf[me]), out, t.world, elems,
             blockIdx.x, gridDim.x);
}

}  // namespace comm
}  // namespace tdt
