// Device-side communication primitives: the port of
// triton_distributed_tpu/language/core.py (`dl`): rank / num_ranks /
// peer_id (:35-52), put / put_nbi (:70-92), notify (:129),
// signal_wait_until / wait (:153-165), barrier_all (:193), entry_barrier
// (:223), barrier_neighbors (:364), and the fault injection of
// maybe_straggle (:304) and correctness_delay (:331); `team_arrive` /
// `team_wait` are barrier_all with one add a peer from each rank (K18, whose
// broadcast, JAX `emit_broadcast` (:247), is common_ops.cu's own).
//
// A collective runs over a team of `world` ranks.  Every rank owns the same
// symmetric buffers and signal words; a device function reaches rank p's
// copy through a table of peer pointers (`Symm`).  One launch holds the
// blocks of ranks base .. base + gridDim.y - 1: rank base + blockIdx.y, and
// each rank's gridDim.x blocks (P, persistent) share its work.  On one card
// (the one-process emulation) a launch holds every rank, its buffers are
// slices of one allocation and every put is a copy inside one HBM, so the
// memory scope is `.gpu`.  A backend of one process per GPU launches the
// same kernels with one rank each over peer pointers of other GPUs and the
// `.sys` scope.
//
// Signals are monotonic 64-bit counters, never reset.  In a call every
// signal word receives the same number of adds from each block of the
// ranks that signal it, or one add of P from one block of each of its
// signallers (`team_arrive`; the words paired by range of
// `comm::signal_blocks`: K16, K17 `two_shot`, K18's broadcast, K21b), so
// after the call it holds k * T, where T is the sum, over this instance's
// calls so far, of P: the host keeps T (its epoch, `language/core.py`
// SymmetricBuffers) and passes the value before the call; the kernel adds
// gridDim.x.  A wait is "counter >= k * T" and can never be satisfied by
// a later call's signals arriving early, nor stall on an earlier call's.
//
// Memory model.  The producer's threads store, each runs __threadfence(),
// the block syncs, and one thread does a release add (`red.release`) on
// the consumer's counter.  The consumer's thread spins on an acquire load
// (`ld.acquire`) with __nanosleep, then the block syncs; the arrived data
// is then read through L2 (cp.async.cg, ld.global.cg), never through L1 or
// the read-only path.  A spin that outlasts its cycle budget records what
// it waited for (a `tdt::Wait`) and traps (`tdt::spin_timeout`,
// common.cuh), so a protocol fault fails the launch instead of hanging the
// card.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace dl {

//: Largest team a launch takes (the peer tables are passed by value).
constexpr int MAX_RANKS = 8;

//: Signal words of one rank (`language/core.py` SIGNAL_WORDS): the entry
//: barrier, a rank-local barrier, then 2 * MAX_RANKS arrival counters.  A
//: method names its arrival words: one per source rank, per chunk, per
//: ring step or per step's ack, the second bank (ARRIVAL_WORD + MAX_RANKS
//: ..) for a second phase or direction.  Each word a method waits on
//: receives one add from each block of its signaller in every call (the
//: scatter-then-sum body's words, one a (source, block) past these: one add
//: of P from the block that owns it), so a wait's target is always the
//: instance's epoch plus this call's blocks.
constexpr int BARRIER_WORD = 0;
constexpr int LOCAL_WORD = 1;
constexpr int ARRIVAL_WORD = 2;
constexpr int ARRIVAL_WORDS = 2 * MAX_RANKS;
constexpr int SIGNAL_WORDS = ARRIVAL_WORD + ARRIVAL_WORDS;

enum class Scope { gpu, sys };

using u64 = unsigned long long;

// One symmetric allocation: rank r's copy at ptr[r].
template <typename T>
struct Symm {
  T* ptr[MAX_RANKS];
  __device__ __forceinline__ T* operator[](int r) const { return ptr[r]; }
};

// The ranks of a collective and the first rank this launch holds.
struct Team {
  int world;
  int base;
};

// A team's ranks as a process grid of nd <= 3 axes, rank g row-major over
// them: g's coordinate along axis a is (g / stride[a]) % size[a].  The torus
// kernels (torus.cu) walk it; the other kernels see only the flat Team.
struct Grid {
  int nd;
  int size[3];
  int stride[3];
};

__device__ __forceinline__ int grid_coord(const Grid& g, int r, int axis) {
  return r / g.stride[axis] % g.size[axis];
}

// The ring neighbour of rank r ``dir`` steps along ``axis``, every other
// coordinate kept (JAX torus.py `_neighbor`).
__device__ __forceinline__ int grid_neighbor(const Grid& g, int r, int axis,
                                             int dir) {
  const int w = g.size[axis], c = grid_coord(g, r, axis);
  return r + ((((c + dir) % w) + w) % w - c) * g.stride[axis];
}

__device__ __forceinline__ int rank(const Team& t) {
  return t.base + blockIdx.y;
}
__device__ __forceinline__ int num_ranks(const Team& t) { return t.world; }
// The rank at ``index`` along the team, wrapped (ring neighbours).
__device__ __forceinline__ int peer_id(const Team& t, int index) {
  return ((index % t.world) + t.world) % t.world;
}

template <Scope S>
__device__ __forceinline__ void fence();
template <>
__device__ __forceinline__ void fence<Scope::gpu>() { __threadfence(); }
template <>
__device__ __forceinline__ void fence<Scope::sys>() {
  __threadfence_system();
}

template <Scope S>
__device__ __forceinline__ void red_release_add(u64* p, u64 v);
template <>
__device__ __forceinline__ void red_release_add<Scope::gpu>(u64* p, u64 v) {
  asm volatile("red.release.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
template <>
__device__ __forceinline__ void red_release_add<Scope::sys>(u64* p, u64 v) {
  asm volatile("red.release.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

template <Scope S>
__device__ __forceinline__ void red_relaxed_add(u64* p, u64 v);
template <>
__device__ __forceinline__ void red_relaxed_add<Scope::gpu>(u64* p, u64 v) {
  asm volatile("red.relaxed.gpu.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}
template <>
__device__ __forceinline__ void red_relaxed_add<Scope::sys>(u64* p, u64 v) {
  asm volatile("red.relaxed.sys.global.add.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

template <Scope S>
__device__ __forceinline__ u64 ld_acquire(const u64* p);
template <>
__device__ __forceinline__ u64 ld_acquire<Scope::gpu>(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}
template <>
__device__ __forceinline__ u64 ld_acquire<Scope::sys>(const u64* p) {
  u64 v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// Add ``inc`` to a signal word, local or a peer's (one thread; the data it
// announces was fenced and the block synced before).
template <Scope S = Scope::gpu>
__device__ __forceinline__ void notify(u64* sig, u64 inc = 1) {
  red_release_add<S>(sig, inc);
}

// One thread spins until ``*sig >= value`` (NVSHMEM_CMP_GE), or records
// ``what`` (a `tdt::Wait`) and traps after TDT_SPIN_BUDGET_CYCLES.
template <Scope S = Scope::gpu>
__device__ __forceinline__ void signal_wait_until(const u64* sig, u64 value,
                                                  int what) {
  if (ld_acquire<S>(sig) >= value) return;
  const long long t0 = clock64();
  unsigned ns = 32;
  while (ld_acquire<S>(sig) < value) {
    __nanosleep(ns);
    if (ns < 1024) ns *= 2;
    if (clock64() - t0 > TDT_SPIN_BUDGET_CYCLES)
      tdt::spin_timeout(what, sig, value, ld_acquire<S>(sig));
  }
}

// The whole block waits until each of the ``n`` words sig[0 .. n) (stride
// ``stride``) reaches ``value`` (n <= blockDim.x): thread i spins on word
// i, then the block syncs.  (JAX `dl.wait`.)
template <Scope S = Scope::gpu>
__device__ __forceinline__ void wait(const u64* sig, int n, int stride,
                                     u64 value, int what) {
  const int tid = threadIdx.x;
  if (tid < n) signal_wait_until<S>(sig + tid * stride, value, what);
  __syncthreads();
}

// Block ``part`` of ``parts`` copies its share of ``bytes`` from ``src``
// to ``dst`` (a peer's buffer or this rank's) in the widest unit, 16 or 4
// bytes, that both addresses allow, else bytes, the source read through
// L2; the last part copies the tail past the last whole unit.  16-byte
// units go four at a time, so each thread keeps four loads in flight.  Not
// inlined: one copy of the loop a kernel keeps small launches small (K19's
// decode exchange, which calls it three times a destination, took 1.5x as
// long with the loop inlined).  Returns without a fence: follow with
// `signal_after_puts` (or a sync) before anyone reads ``dst``.  (JAX
// `dl.put_nbi`.)
__device__ __noinline__ void put_nbi(void* dst, const void* src,
                                     size_t bytes, int part, int parts) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src);
  const size_t unit = a % 16 == 0 ? 16 : a % 4 == 0 ? 4 : 1;
  const size_t units = bytes / unit;
  const size_t share = (units + parts - 1) / parts;
  const size_t start = (size_t)part * share;
  size_t lo = start < units ? start : units;
  size_t hi = units - lo < share ? units : lo + share;
  const size_t step = blockDim.x;
  if (unit == 16) {
    const uint4* s = static_cast<const uint4*>(src);
    uint4* d = static_cast<uint4*>(dst);
    size_t i = lo + threadIdx.x;
    for (; i + 3 * step < hi; i += 4 * step) {
      const uint4 v0 = __ldcg(s + i), v1 = __ldcg(s + i + step);
      const uint4 v2 = __ldcg(s + i + 2 * step), v3 = __ldcg(s + i + 3 * step);
      d[i] = v0;
      d[i + step] = v1;
      d[i + 2 * step] = v2;
      d[i + 3 * step] = v3;
    }
    for (; i < hi; i += step) d[i] = __ldcg(s + i);
  } else if (unit == 4) {
    const unsigned* s = static_cast<const unsigned*>(src);
    unsigned* d = static_cast<unsigned*>(dst);
    for (size_t i = lo + threadIdx.x; i < hi; i += step) d[i] = __ldcg(s + i);
  }
  if (unit > 1) {  // what is left is the tail, the last part's
    if (part != parts - 1) return;
    lo = units * unit;
    hi = bytes;
  }
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  for (size_t i = lo + threadIdx.x; i < hi; i += step) d[i] = __ldcg(s + i);
}

// Make this block's stores visible at scope S, then thread i < n adds one
// to word ``words[i]`` (the release half of put-with-signal).
template <Scope S = Scope::gpu>
__device__ __forceinline__ void signal_after_puts(u64* const* words, int n) {
  fence<S>();
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < n) notify<S>(words[tid]);
}

// A blocking put with its signal: the block's share of the copy, then one
// add to ``sig`` (JAX `dl.put` with the recv semaphore of
// `make_async_remote_copy`).
template <Scope S = Scope::gpu>
__device__ __forceinline__ void put(void* dst, const void* src, size_t bytes,
                                    int part, int parts, u64* sig) {
  put_nbi(dst, src, bytes, part, parts);
  signal_after_puts<S>(&sig, 1);
}

// Every block of every rank signals each peer's barrier word once, then
// waits for (world - 1) signals a block of each peer: after it, every peer
// has entered this call.  (JAX `dl.barrier_all`.)
template <Scope S = Scope::gpu>
__device__ __forceinline__ void barrier_all(const Team& t, Symm<u64> sig,
                                            u64 target) {
  const int me = rank(t), tid = threadIdx.x;
  if (tid < t.world && tid != me) notify<S>(sig[tid] + BARRIER_WORD);
  wait<S>(sig[me] + BARRIER_WORD, 1, 0, (u64)(t.world - 1) * target,
          tdt::WAIT_BARRIER_ALL);
}

// The team barrier with one add a peer from each rank: thread i of block 0
// adds P (gridDim.x) to peer i's BARRIER_WORD.  One block of this rank
// running this call is enough: every block of its last call has ended (the
// stream orders a rank's calls).  Each word receives world - 1 adds of P a
// call.  Returns at once; `team_wait` waits.
template <Scope S = Scope::gpu>
__device__ __forceinline__ void team_arrive(const Team& t, Symm<u64> sig) {
  const int me = rank(t), tid = threadIdx.x;
  if (blockIdx.x == 0 && tid < t.world && tid != me)
    notify<S>(sig[tid] + BARRIER_WORD, gridDim.x);
}

// The whole block waits until every peer has arrived (`team_arrive`):
// ``target`` is the instance's blocks a rank with this call's.
template <Scope S = Scope::gpu>
__device__ __forceinline__ void team_wait(const Team& t, Symm<u64> sig,
                                          u64 target) {
  wait<S>(sig[rank(t)] + BARRIER_WORD, 1, 0, (u64)(t.world - 1) * target,
          tdt::WAIT_TEAM_BARRIER);
}

// Ring barrier with the left and right neighbours only (two signals a
// block in, two out).  (JAX `dl.barrier_neighbors`.)
template <Scope S = Scope::gpu>
__device__ __forceinline__ void barrier_neighbors(const Team& t,
                                                  Symm<u64> sig,
                                                  u64 target) {
  const int me = rank(t), tid = threadIdx.x;
  if (tid < 2) notify<S>(sig[peer_id(t, me + (tid ? 1 : -1))] + BARRIER_WORD);
  wait<S>(sig[me] + BARRIER_WORD, 1, 0, 2 * target,
          tdt::WAIT_BARRIER_NEIGHBORS);
}

// The barrier at kernel entry, before the first put into a peer: a peer's
// buffers are written only after it has entered this call, so a rank that
// runs ahead never overwrites what a peer is still reading from the last
// call (with one process per GPU, the last call may still run there).  A
// no-op at world 1.  (JAX `dl.entry_barrier`, reason at core.py:224-233.)
template <Scope S = Scope::gpu>
__device__ __forceinline__ void entry_barrier(const Team& t, Symm<u64> sig,
                                              u64 target,
                                              bool neighbors_only) {
  if (t.world <= 1) return;
  if (neighbors_only)
    barrier_neighbors<S>(t, sig, target);
  else
    barrier_all<S>(t, sig, target);
}

// The entry barrier of a grid (JAX `dl.entry_barrier(axis, w,
// neighbors_only)` over each axis in turn): every block of every rank adds
// one to word ``word`` of, along every axis of size > 1, its two ring
// neighbours (``neighbors_only``) or every other rank of the axis; then
// waits until the word holds ``target`` times the adds it receives from one
// block of each of those peers (as many as it makes).  ``target`` is the
// blocks a rank over the instance's calls, this one's included.
template <Scope S = Scope::gpu>
__device__ __forceinline__ void grid_barrier(const Team& t, const Grid& g,
                                             Symm<u64> sig, int word,
                                             u64 target,
                                             bool neighbors_only) {
  const int me = rank(t), tid = threadIdx.x;
  int n = 0;
  for (int a = 0; a < g.nd; ++a) {
    const int w = g.size[a];
    if (w < 2) continue;
    const int k = neighbors_only ? 2 : w - 1;
    for (int j = 0; j < k; ++j, ++n)
      if (tid == n)
        notify<S>(sig[grid_neighbor(g, me, a,
                                    neighbors_only ? (j ? -1 : 1) : j + 1)] +
                  word);
  }
  wait<S>(sig[me] + word, 1, 0, (u64)n * target, tdt::WAIT_GRID_BARRIER);
}

// The P blocks of this rank wait for each other (one signal a block on the
// rank's LOCAL_WORD): what one block wrote before it is visible to all.
template <Scope S = Scope::gpu>
__device__ __forceinline__ void barrier_rank(const Team& t, Symm<u64> sig,
                                             u64 target) {
  u64* word = sig[rank(t)] + LOCAL_WORD;
  signal_after_puts<S>(&word, 1);
  wait<S>(word, 1, 0, target, tdt::WAIT_BARRIER_RANK);
}

// Spin ``cycles`` SM clock cycles (the TPU's `pl.delay`).
__device__ __forceinline__ void spin_cycles(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// Fault injection, before a collective communicates: every block of rank
// ``straggler`` spins ``cycles`` (JAX `dl.maybe_straggle`; no straggler
// when it is negative).
__device__ __forceinline__ void maybe_straggle(const Team& t, int straggler,
                                               long long cycles) {
  if (straggler >= 0 && rank(t) == straggler && cycles > 0)
    spin_cycles(cycles);
}

// Every rank spins (rank + 1) * ``cycles``: staggered arrivals widen the
// race windows so that an ordering fault shows on every run (JAX
// `dl.correctness_delay`, the reference's ``for_correctness``).
__device__ __forceinline__ void correctness_delay(const Team& t, bool enabled,
                                                  long long cycles = 100000) {
  if (enabled) spin_cycles((rank(t) + 1) * cycles);
}

}  // namespace dl
