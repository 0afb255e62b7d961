// Communication bodies shared by the collective kernels, as device
// functions over `dl.cuh`:
// - `emit_push_allgather`: port of triton_distributed_tpu/kernels/
//   allgather.py `emit_push_allgather` (:150), the one-shot push
//   all-gather (K12's `ll` body; K15's push kernel later);
// - `emit_ag_ring`: port of allgather_gemm.py `_emit_ag_ring` (:122) and
//   allgather_group_gemm.py `_emit_ag_ring_grouped` (:67), the ring
//   all-gather that hands each chunk to a computation as it arrives (the
//   body of K12's `fused` method, K11 and its int8 form, and K13);
// - `emit_scatter_reduce`: port of kernels/reduce_scatter.py
//   `emit_scatter_reduce` (:144), one-shot scatter then local reduce
//   (K14's `ll` body; K16's scatter kernel later);
// - `reduce_sum`: port of reduce_scatter.py `_emit_reduce_sum` (:94), the
//   f32 sum over the ranks' partials in rank order 0 .. W-1, cast to the
//   output type (`reduce_sum_to` stores it to several ranks at once);
// - `add_into`: port of reduce_scatter.py `emit_add_into` (:120), one
//   f32 add of two chunks rounded to their type, over a block's range;
// - `Crew` and the crew forms `emit_ag_ring_forward` (the ring's copies
//   and signals alone) and `emit_push_allgather_send` (the push alone),
//   with `ring_wait_chunk`, the consumer's wait: K12's `wgmma` body, where
//   spare warps communicate while the others compute;
// - `Faults` and `inject_faults`: the contexts' straggler and
//   for_correctness knobs (language/core.py :304, :331);
// - `launch_cooperative`: the launch of every collective kernel.
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

// outs[o][i] = sum over w = 0 .. world-1 of src[w * elems + i] for each
// of the ``nouts`` destinations, each term widened to f32 and added in
// that order, the sum cast to T: block ``part`` of ``parts`` takes its
// share of the elements.
template <typename T>
__device__ __forceinline__ void reduce_sum_to(const T* src, T* const* outs,
                                              int nouts, int world,
                                              size_t elems, int part,
                                              int parts) {
  uintptr_t align = reinterpret_cast<uintptr_t>(src);
  for (int o = 0; o < nouts; ++o) align |= reinterpret_cast<uintptr_t>(outs[o]);
  const bool vec = elems % 8 == 0 && align % 16 == 0;
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
      for (int o = 0; o < nouts; ++o) store8(outs[o] + i * 8, acc);
    } else {
      float acc = load1_cg(src + i);
      for (int w = 1; w < world; ++w) acc = acc + load1_cg(src + w * elems + i);
      for (int o = 0; o < nouts; ++o) store1(outs[o] + i, acc);
    }
  }
}

// out[i] = sum over w of src[w * elems + i] (`reduce_sum_to` with one
// destination).
template <typename T>
__device__ __forceinline__ void reduce_sum(const T* src, T* out, int world,
                                           size_t elems, int part,
                                           int parts) {
  reduce_sum_to(src, &out, 1, world, elems, part, parts);
}

// The elements [lo, hi) of a chunk that block ``part`` of ``parts`` owns:
// whole units of 8 elements (so a bf16 or f32 range starts 16-byte aligned
// when the chunk does), the last block also the tail.  A method whose
// block copies what it computed (the rings, the chain) uses the same range
// for both, so no block reads another's unsynchronised stores.
struct Range {
  size_t lo, hi;
};

__device__ __forceinline__ Range block_range(size_t elems, int part,
                                             int parts) {
  const size_t units = elems / 8;
  const size_t share = (units + parts - 1) / parts;
  const size_t a = (size_t)part * share, b = a + share;
  Range r{(a < units ? a : units) * 8, (b < units ? b : units) * 8};
  if (part == parts - 1) r.hi = elems;
  return r;
}

// dst[i] = T(float(a[i]) + float(b[i])) over ``r`` (dst may alias a): the
// JAX `emit_add_into`, one rounded f32 add a hop.
template <typename T>
__device__ __forceinline__ void add_into(T* dst, const T* a, const T* b,
                                         Range r) {
  const bool vec = (reinterpret_cast<uintptr_t>(dst + r.lo) |
                    reinterpret_cast<uintptr_t>(a + r.lo) |
                    reinterpret_cast<uintptr_t>(b + r.lo)) % 16 == 0;
  const size_t nvec = vec ? (r.hi - r.lo) / 8 : 0;
  for (size_t v = threadIdx.x; v < nvec; v += blockDim.x) {
    const size_t i = r.lo + v * 8;
    float fa[8], fb[8];
    load8_cg(a + i, fa);
    load8_cg(b + i, fb);
#pragma unroll
    for (int j = 0; j < 8; ++j) fa[j] = fa[j] + fb[j];
    store8(dst + i, fa);
  }
  for (size_t i = r.lo + nvec * 8 + threadIdx.x; i < r.hi; i += blockDim.x)
    store1(dst + i, load1_cg(a + i) + load1_cg(b + i));
}

// A block's share of a copy of elements ``r`` (its own range, by its own
// threads) from ``src`` to ``dst``.
template <typename T>
__device__ __forceinline__ void put_range(T* dst, const T* src, Range r) {
  dl::put_nbi(dst + r.lo, src + r.lo, (r.hi - r.lo) * sizeof(T), 0, 1);
}

// The contexts' fault injection: rank ``straggler`` (none when negative)
// spins ``cycles`` before it communicates; with ``for_correctness`` every
// rank spins (rank + 1) * 100000 cycles first.
struct Faults {
  int straggler;
  long long cycles;
  int for_correctness;
};

__device__ __forceinline__ void inject_faults(const dl::Team& t,
                                              const Faults& f) {
  dl::maybe_straggle(t, f.straggler, f.cycles);
  dl::correctness_delay(t, f.for_correctness != 0);
}

//: Threads of a collective block.
constexpr int COMM_THREADS = 256;

// One cooperative launch of ``fn`` with P blocks a rank for ``ranks``
// ranks (gridDim = (P, ranks)): P is ``want`` (at least 1), at most as
// many as can be resident together with every other rank's, so a block
// that spins on a peer never starves it; a grid that cannot be resident
// is refused.  P goes to ``*blocks``.  Returns a cudaError_t code.
inline int launch_cooperative(void* fn, void** args, int ranks, int want,
                              int* blocks, cudaStream_t s) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, COMM_THREADS,
                                                      0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int P = want < 1 ? 1 : (want < fit ? want : fit);
  *blocks = P;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks),
                                          dim3(COMM_THREADS), args, 0, s);
}

// Blocks a rank for a step that moves ``bytes``: one per 32 KiB.
inline int blocks_for(size_t bytes) {
  const size_t p = (bytes + (32u << 10) - 1) / (32u << 10);
  return p > 4096 ? 4096 : (int)p;
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
              tdt::WAIT_PUSH_ALLGATHER);
}

// The ring all-gather feeding a computation: the neighbour entry barrier;
// this rank's ``bytes``-byte shard into its own slot of ``gathered`` and
// the right neighbour's (one arrival signal a block), then
// ``compute(me, shard)``; then for s = 1 .. W-1 the chunk c = (r - s) mod
// W: wait until all P blocks of the left neighbour have delivered it,
// forward it to the right neighbour unless s = W-1, and
// ``compute(c, held)`` on the held copy.  A block forwards before it
// computes, so the copy of step s overlaps the computation of the blocks
// still at step s - 1.  ``compute`` reads a held chunk through L2 only
// (cp.async.cg, ld.global.cg): it was written by another rank's blocks.
template <class Compute, dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void emit_ag_ring(const dl::Team& t,
                                             const void* shard,
                                             dl::Symm<char> gathered,
                                             size_t bytes, dl::Symm<u64> sig,
                                             u64 target, int what,
                                             Compute&& compute) {
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  char* mine = gathered[me];
  const int right = dl::peer_id(t, me + 1);
  char* theirs = gathered[right];
  dl::entry_barrier<S>(t, sig, target, /*neighbors_only=*/true);
  dl::put_nbi(mine + me * bytes, shard, bytes, part, parts);
  dl::put_nbi(theirs + me * bytes, shard, bytes, part, parts);
  u64* sent[2] = {sig[me] + dl::ARRIVAL_WORD + me,
                  sig[right] + dl::ARRIVAL_WORD + me};
  dl::signal_after_puts<S>(sent, 2);
  compute(me, static_cast<const char*>(shard));
  for (int s = 1; s < t.world; ++s) {
    const int c = dl::peer_id(t, me - s);
    dl::wait<S>(sig[me] + dl::ARRIVAL_WORD + c, 1, 0, target, what);
    const char* held = mine + c * bytes;
    if (s < t.world - 1) {
      dl::put_nbi(theirs + c * bytes, held, bytes, part, parts);
      u64* word = sig[right] + dl::ARRIVAL_WORD + c;
      dl::signal_after_puts<S>(&word, 1);
    }
    compute(c, held);
  }
}

// ---- crews: the communication of a warp-specialised block ----------------
//
// A crew is the threads [0, n) of some whole warps of a block that sync
// among themselves on named barrier ``id`` (never `__syncthreads`), so they
// move and signal data while the block's other warps compute.  K12's
// `wgmma` body runs its ring on the producer warpgroup's three spare warps
// (`wgmma_tile.cuh`).  Its copies are inlined 16-byte loops: the crew runs
// at the producer's 40 registers, where a call of `dl::put_nbi` would
// spill.
struct Crew {
  int tid, n, id;
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
  }
};

// Block ``part`` of ``parts`` copies its share of ``bytes`` (a multiple of
// 16, under 64 GiB, both addresses 16-byte aligned) from ``src`` to
// ``dst``, the source read through L2, four 16-byte loads in flight a
// thread.  32-bit unit counts: a 64-bit division compiles to a subroutine
// call, and ptxas serializes the `wgmma`s of a kernel that holds a call.
__device__ __forceinline__ void crew_copy(void* dst, const void* src,
                                          size_t bytes, int part, int parts,
                                          const Crew& c) {
  const unsigned units = (unsigned)(bytes / 16);
  const unsigned share = (units + parts - 1) / (unsigned)parts;
  const unsigned start = (unsigned)part * share;
  const unsigned lo = start < units ? start : units;
  const unsigned hi = units - lo < share ? units : lo + share;
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  const unsigned step = c.n;
  unsigned i = lo + c.tid;
  for (; i + 3 * step < hi; i += 4 * step) {
    const uint4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + step);
    const uint4 v2 = __ldcg(s + i + 2 * step), v3 = __ldcg(s + i + 3 * step);
    d[i] = v0;
    d[i + step] = v1;
    d[i + 2 * step] = v2;
    d[i + 3 * step] = v3;
  }
  for (; i < hi; i += step) d[i] = __ldcg(s + i);
}

// `dl::wait` for a crew: thread i < n spins on word i, then the crew syncs.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void crew_wait(const u64* sig, int n, int stride,
                                          u64 value, int what,
                                          const Crew& c) {
  if (c.tid < n) dl::signal_wait_until<S>(sig + c.tid * stride, value, what);
  c.sync();
}

// `dl::signal_after_puts` for a crew: its stores fenced, then thread i < n
// adds one to ``words[i]``.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void crew_signal(u64* const* words, int n,
                                            const Crew& c) {
  dl::fence<S>();
  c.sync();
  if (c.tid < n) dl::notify<S>(words[c.tid]);
}

// `dl::entry_barrier` for a crew (one add a block to each peer's barrier
// word, as the block-wide barrier makes).
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void crew_entry_barrier(const dl::Team& t,
                                                   dl::Symm<u64> sig,
                                                   u64 target,
                                                   bool neighbors_only,
                                                   const Crew& c) {
  if (t.world <= 1) return;
  const int me = dl::rank(t);
  if (neighbors_only) {
    if (c.tid < 2)
      dl::notify<S>(sig[dl::peer_id(t, me + (c.tid ? 1 : -1))] +
                    dl::BARRIER_WORD);
    crew_wait<S>(sig[me] + dl::BARRIER_WORD, 1, 0, 2 * target,
                 tdt::WAIT_BARRIER_NEIGHBORS, c);
  } else {
    if (c.tid < t.world && c.tid != me)
      dl::notify<S>(sig[c.tid] + dl::BARRIER_WORD);
    crew_wait<S>(sig[me] + dl::BARRIER_WORD, 1, 0,
                 (u64)(t.world - 1) * target, tdt::WAIT_BARRIER_ALL, c);
  }
}

// The copies and signals of `emit_ag_ring` on a crew, without the
// computation: the neighbour entry barrier; this rank's shard into its own
// slot and the right neighbour's (one arrival signal a block); then for s =
// 1 .. W-2 the chunk c = (r - s) mod W: wait until all P blocks of the left
// neighbour have delivered it and forward the block's share to the right
// neighbour.  The consumer of the chunks waits on the same arrival words
// itself (`ring_wait_chunk`), so the forward never waits on it.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void emit_ag_ring_forward(
    const dl::Team& t, const void* shard, dl::Symm<char> gathered,
    size_t bytes, dl::Symm<u64> sig, u64 target, int what,
    const Crew& c) {
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  char* mine = gathered[me];
  const int right = dl::peer_id(t, me + 1);
  char* theirs = gathered[right];
  crew_entry_barrier<S>(t, sig, target, /*neighbors_only=*/true, c);
  crew_copy(mine + me * bytes, shard, bytes, part, parts, c);
  crew_copy(theirs + me * bytes, shard, bytes, part, parts, c);
  u64* sent[2] = {sig[me] + dl::ARRIVAL_WORD + me,
                  sig[right] + dl::ARRIVAL_WORD + me};
  crew_signal<S>(sent, 2, c);
  for (int s = 1; s < t.world - 1; ++s) {
    const int ch = dl::peer_id(t, me - s);
    crew_wait<S>(sig[me] + dl::ARRIVAL_WORD + ch, 1, 0, target, what, c);
    crew_copy(theirs + ch * bytes, mine + ch * bytes, bytes, part, parts, c);
    u64* word = sig[right] + dl::ARRIVAL_WORD + ch;
    crew_signal<S>(&word, 1, c);
  }
}

// The push of `emit_push_allgather` on a crew, without its wait: the entry
// barrier, this rank's shard into slot rank(t) of every rank's buffer, one
// arrival signal a block to each.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void emit_push_allgather_send(
    const dl::Team& t, const void* shard, dl::Symm<char> gathered,
    size_t bytes, dl::Symm<u64> sig, u64 target, const Crew& c) {
  const int me = dl::rank(t);
  crew_entry_barrier<S>(t, sig, target, /*neighbors_only=*/false, c);
  for (int p = 0; p < t.world; ++p)
    crew_copy(gathered[p] + me * bytes, shard, bytes, blockIdx.x, gridDim.x,
              c);
  u64* words[dl::MAX_RANKS];
  for (int p = 0; p < t.world; ++p) words[p] = sig[p] + dl::ARRIVAL_WORD + me;
  crew_signal<S>(words, t.world, c);
}

// One thread (a TMA producer) waits until chunk ``c``'s arrival word holds
// ``target`` (every block of the sender delivered it), then fences the
// generic proxy, through which the peers wrote the chunk, against the async
// proxy, through which its TMA loads read it.  Without the fence a load may
// read stale bytes.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void ring_wait_chunk(dl::Symm<u64> sig, int me,
                                                int c, u64 target,
                                                int what) {
  dl::signal_wait_until<S>(sig[me] + dl::ARRIVAL_WORD + c, target, what);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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
              tdt::WAIT_SCATTER_REDUCE);
  reduce_sum(reinterpret_cast<const T*>(rbuf[me]), out, t.world, elems,
             blockIdx.x, gridDim.x);
}

}  // namespace comm
}  // namespace tdt
