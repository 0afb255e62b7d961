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
//   (K14's first body, K10 and K17; K16 and K21b have their own body in
//   reduce_scatter.cu);
// - `reduce_sum`: port of reduce_scatter.py `_emit_reduce_sum` (:94), the
//   f32 sum over the ranks' partials in rank order 0 .. W-1, cast to the
//   output type;
// - `add_into`: port of reduce_scatter.py `emit_add_into` (:120), one
//   f32 add of two chunks rounded to their type, over a block's range;
// - `Crew` and the crew forms `emit_ag_ring_forward` (the ring's copies
//   and signals alone), `emit_push_allgather_send` (the push alone) and
//   `crew_grid_barrier`, with `ring_wait_chunk` / `wait_word_for_tma`, the
//   consumer's wait: the `wgmma` bodies of K12 and K21c, where spare warps
//   communicate while the others compute;
// - `Faults` and `inject_faults`: the contexts' straggler and
//   for_correctness knobs (language/core.py :304, :331);
// - `launch_cooperative`: the launch of every collective kernel;
// - `Staging` and `bulk_runs`: bulk copies (`cp.async.bulk` global ->
//   shared -> global) through a few shared buffers, issued by one thread
//   of a block, and `signal_blocks`, the arrival words paired by range of
//   the bodies with a word a block (K16, K17 `two_shot`, K18 broadcast,
//   K21b).
// Every block of a rank calls them with its share (blockIdx.x of
// gridDim.x).
#pragma once

#include "common.cuh"
#include "dl.cuh"
#include "mbarrier.cuh"

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
  const uintptr_t align = reinterpret_cast<uintptr_t>(src) |
                          reinterpret_cast<uintptr_t>(out);
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
      store8(out + i * 8, acc);
    } else {
      float acc = load1_cg(src + i);
      for (int w = 1; w < world; ++w) acc = acc + load1_cg(src + w * elems + i);
      store1(out + i, acc);
    }
  }
}

// The elements [lo, hi) of a chunk that block ``part`` of ``parts`` owns:
// whole units of 8 elements (so a bf16 or f32 range starts 16-byte aligned
// when the chunk does), the last block also the tail.  A method whose
// block copies what it computed (the rings, the chain) uses the same range
// for both, so no block reads another's unsynchronised stores.
struct Range {
  size_t lo, hi;
};

// The part [lo, hi) of ``n`` that ``part`` of ``parts`` owns: whole
// ``unit``s, the share rounded up (the last parts may be empty), the last
// part also the tail past the last whole unit.
__device__ __forceinline__ Range share(size_t n, size_t unit, int part,
                                       int parts) {
  const size_t units = n / unit;
  const size_t each = (units + parts - 1) / parts;
  const size_t a = (size_t)part * each, b = a + each;
  Range r{(a < units ? a : units) * unit, (b < units ? b : units) * unit};
  if (part == parts - 1) r.hi = n;
  return r;
}

__device__ __forceinline__ Range block_range(size_t elems, int part,
                                             int parts) {
  return share(elems, 8, part, parts);
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

//: Blocks a rank at most of a body with an arrival word a block: the words
//: a source rank owns in one bank at each destination.
constexpr int MAX_BLOCKS = 256;

// One cooperative launch of ``fn`` with P blocks a rank for ``ranks``
// ranks (gridDim = (P, ranks)): P is ``want`` (at least 1), at most as
// many as can be resident together with every other rank's, so a block
// that spins on a peer never starves it; a grid that cannot be resident
// is refused.  P goes to ``*blocks``.  ``smem``: dynamic shared memory a
// block (at most 48 KB).  ``bank`` (a field of the arguments, or null): set
// before the launch to the most blocks a rank any launch of ``fn`` at this
// world can have, at most MAX_BLOCKS (the words of a bank that
// `signal_blocks` keeps).  ``per_sm`` (0: none): at most so many blocks an
// SM, every rank's together, below what fits.  Returns a cudaError_t code.
inline int launch_cooperative(void* fn, void** args, int ranks, int want,
                              int* blocks, cudaStream_t s, size_t smem = 0,
                              int* bank = nullptr, int per_sm = 0) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, COMM_THREADS,
                                                      smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm > 0 && per_sm < occ) occ = per_sm;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  if (bank != nullptr) *bank = fit < MAX_BLOCKS ? fit : MAX_BLOCKS;
  const int P = want < 1 ? 1 : (want < fit ? want : fit);
  *blocks = P;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks),
                                          dim3(COMM_THREADS), args, smem, s);
}

// Blocks a rank for a step that moves ``bytes``: one per 32 KiB.
inline int blocks_for(size_t bytes) {
  const size_t p = (bytes + (32u << 10) - 1) / (32u << 10);
  return p > 4096 ? 4096 : (int)p;
}

// ---- bulk copies and arrival words paired by range ----------------------

//: The bulk copies' staging: STAGE_BUFS shared buffers of STAGE_BYTES, the
//: dynamic shared memory of a block (STAGE_SMEM).
constexpr int STAGE_BUFS = 4;
constexpr unsigned STAGE_BYTES = 8192;
constexpr size_t STAGE_SMEM = STAGE_BUFS * STAGE_BYTES;

// A block's staging: the buffers, a transaction barrier a buffer, and the
// pieces they have carried so far (piece j goes through buffer j %
// STAGE_BUFS in its barrier's phase j / STAGE_BUFS), so one thread may run
// `bulk_runs` several times a call.
struct Staging {
  uint8_t* buf;
  uint64_t* bar;
  unsigned pieces;
};

// Thread 0 initialises the barriers; the block syncs.
__device__ __forceinline__ Staging staging(uint8_t* buf, uint64_t* bar) {
  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGE_BUFS; ++k) mbar_init(&bar[k], 1);
    mbar_init_fence();
  }
  __syncthreads();
  return Staging{buf, bar, 0};
}

// Pieces of STAGE_BYTES that ``bytes`` take.
__device__ __forceinline__ unsigned pieces(size_t bytes) {
  return (unsigned)((bytes + STAGE_BYTES - 1) / STAGE_BYTES);
}

// One thread's bulk copies (`cp.async.bulk` global -> shared -> global) of
// ``runs`` runs: run k's ``len(k)`` bytes are read once from ``src(k)`` and
// stored to ``dst(k, d)`` for every d < ``fan``, in ``per`` pieces of
// STAGE_BYTES a run (pieces past a run's end carry nothing); lengths and
// addresses are multiples of 16.  Every buffer's load is in flight before
// the first store, and a buffer is loaded again once the stores before
// last have read it.  The stores are performed and fenced against the
// generic proxy before it returns, so a release that follows covers them.
// A bulk store's destination is any global address: a peer's buffer
// mapped over NVLink included.
template <class Len, class Src, class Dst>
__device__ __forceinline__ void bulk_runs(Staging& s, unsigned runs,
                                          unsigned per, int fan, Len len,
                                          Src src, Dst dst) {
  const unsigned n = runs * per;
  auto bytes = [&](unsigned i) {
    const unsigned l = len(i / per), off = i % per * STAGE_BYTES;
    return off < l ? min(STAGE_BYTES, l - off) : 0u;
  };
  auto load = [&](unsigned i) {
    const unsigned k = (s.pieces + i) % STAGE_BUFS, b = bytes(i);
    mbar_expect_tx(&s.bar[k], b);
    if (b)
      bulk_load(s.buf + k * STAGE_BYTES,
                src(i / per) + i % per * STAGE_BYTES, b, &s.bar[k]);
  };
  for (unsigned i = 0; i < n && i < STAGE_BUFS; ++i) load(i);
  for (unsigned i = 0; i < n; ++i) {
    const unsigned j = s.pieces + i, k = j % STAGE_BUFS, b = bytes(i);
    mbar_wait(&s.bar[k], (j / STAGE_BUFS) & 1);
    if (b)
      for (int d = 0; d < fan; ++d)
        bulk_store(dst(i / per, d) + i % per * STAGE_BYTES,
                   s.buf + k * STAGE_BYTES, b);
    bulk_commit();
    const unsigned next = i - 1 + STAGE_BUFS;  // piece i - 1's buffer
    if (i > 0 && next < n) {
      bulk_wait_read<1>();
      load(next);
    }
  }
  s.pieces += n;
  bulk_wait_all();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// The block's copy of ``bytes`` from ``src`` into ``dst(d)`` for every d <
// ``fan``: with ``bulk`` (addresses and bytes multiples of 16) by thread 0's
// bulk copies through ``s``, else by every thread (`dl::put_nbi`, 16-, 4- or
// 1-byte units).  No fence or sync after it.
template <class Dst>
__device__ __forceinline__ void copy_fan(Staging& s, bool bulk,
                                         const char* src, size_t bytes,
                                         int fan, Dst dst) {
  if (!bulk) {
    for (int d = 0; d < fan; ++d) dl::put_nbi(dst(d), src, bytes, 0, 1);
    return;
  }
  if (threadIdx.x == 0)
    bulk_runs(s, 1, pieces(bytes), fan, [&](unsigned) {
      return (unsigned)bytes; }, [&](unsigned) { return src; },
      [&](unsigned, int d) { return dst(d); });
}

// Arrival paired by range: this block adds P (gridDim.x) to each word it
// owns, b, b + P, .. < ``words``, of each of ``banks`` banks (``bank(i)``
// the i-th bank's word 0), so every word of a bank receives adds summing
// to P in every call whatever P is, and a wait's target stays the epoch
// plus this call's P.  ``words``: the most blocks a rank any launch of the
// kernel can have (`launch_cooperative`'s ``bank``), the same in every
// call of an instance.  The block's stores come first, fenced, then a
// sync; each thread fences again and its adds are relaxed (the fence and
// the adds are a release pattern, cumulative over what the sync showed it).
template <class Bank>
__device__ __forceinline__ void signal_blocks(int banks, int words,
                                              Bank bank) {
  const int b = blockIdx.x, P = gridDim.x;
  const int owned = (words - 1 - b) / P + 1;
  if (threadIdx.x < banks * owned) dl::fence<dl::Scope::gpu>();
  for (int i = threadIdx.x; i < banks * owned; i += blockDim.x)
    dl::red_relaxed_add<dl::Scope::gpu>(bank(i / owned) + b + i % owned * P,
                                        (u64)P);
}

// Block b waits until word b of the bank ``bank(i)`` holds ``target`` for
// every i < ``n`` but ``skip``: the blocks that wrote its own range, not
// all P of every source.  Thread i spins on bank i; the block syncs.
template <class Bank>
__device__ __forceinline__ void wait_blocks(int n, int skip, Bank bank,
                                            u64 target, int what) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (i != skip)
      dl::signal_wait_until(bank(i) + blockIdx.x, target, what);
  __syncthreads();
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

// `dl::grid_barrier` for a crew: one add from the crew's block to word
// ``word`` of each ring neighbour along every axis (``neighbors_only``) or
// of every other rank of each axis, then the wait for ``target`` times the
// adds it receives from one block of each of those peers.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void crew_grid_barrier(const dl::Team& t,
                                                  const dl::Grid& g,
                                                  const dl::Symm<u64>& sig,
                                                  int word,
                                                  u64 target,
                                                  bool neighbors_only,
                                                  const Crew& c) {
  const int me = dl::rank(t);
  int n = 0;
  for (int a = 0; a < g.nd; ++a) {
    const int w = g.size[a];
    if (w < 2) continue;
    const int k = neighbors_only ? 2 : w - 1;
    for (int j = 0; j < k; ++j, ++n)
      if (c.tid == n)
        dl::notify<S>(sig[dl::grid_neighbor(
                          g, me, a, neighbors_only ? (j ? -1 : 1) : j + 1)] +
                      word);
  }
  crew_wait<S>(sig[me] + word, 1, 0, (u64)n * target, tdt::WAIT_GRID_BARRIER,
               c);
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

// One thread (a TMA producer) waits until an arrival word holds ``target``
// (every block of the sender delivered what it announces), then fences the
// generic proxy, through which the peers wrote the data, against the async
// proxy, through which its TMA loads read it.  Without the fence a load may
// read stale bytes.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void wait_word_for_tma(const u64* word, u64 target,
                                                  int what) {
  dl::signal_wait_until<S>(word, target, what);
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// `wait_word_for_tma` on chunk ``c``'s arrival word of the flat ring.
template <dl::Scope S = dl::Scope::gpu>
__device__ __forceinline__ void ring_wait_chunk(dl::Symm<u64> sig, int me,
                                                int c, u64 target,
                                                int what) {
  wait_word_for_tma<S>(sig[me] + dl::ARRIVAL_WORD + c, target, what);
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
