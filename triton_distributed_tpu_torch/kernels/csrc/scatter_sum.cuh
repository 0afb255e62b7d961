// The scatter-then-sum body: K16 `scatter_reduce` and K21b
// (reduce_scatter.cu, entry `reduce_scatter_sum`), and K17 `two_shot`
// (all_reduce.cu, entry `all_reduce_two_shot`), which adds a second half
// that puts the sum into every rank's output.  One scatter of every piece
// straight to its destination, then one ordered sum there; no hop chain,
// staging slot, ack or stage result between ranks.
// - One cooperative launch holds every rank's P blocks (`dl.cuh`), P one a
//   32 KiB of a rank's partials, at most MAX_BLOCKS and what can be
//   resident.  Block b owns the elements `block_range(elems, b, P)` of
//   every chunk, on every rank alike.
// - The entry barrier of the whole team (every rank writes into every
//   other's receive buffer).
// - Scatter: block b of rank r puts its range of each foreign chunk c into
//   slot r of rank c's rbuf, in destination order r + 1, r + 2, .., so the
//   ranks do not all write one destination at once.  The own chunk is never
//   copied: the sum reads it from x.  Writes go only into symmetric
//   buffers, as the JAX kernels' remote DMAs do; no block reads a peer's x
//   (x is not symmetric: a pull works on one card only because the ranks
//   share one HBM).
// - Arrival paired by range (`comm::signal_blocks`): each source rank owns
//   MAX_BLOCKS words at every destination, word (s, g) at ARRIVAL_WORD + s
//   MAX_BLOCKS + g.  Block b of rank r, its copies done, adds P to its
//   words b, b + P, .. below the most blocks a launch of the kernel can
//   have at every destination, so every word receives adds summing to P in
//   every call whatever P is.  Block b of a
//   destination waits only on word (s, b) of each source s: the blocks that
//   wrote its own range, not all P of every source.  So a block sums as
//   soon as its range has landed, and the copies of some blocks overlap the
//   sums of others (and the landed pieces may still be in L2 when they are
//   summed).
// - The sum: the order is a host-built table (`Order`, passed by value):
//   for each lane (a chunk's piece of ``piece`` elements) and destination
//   rank, the W sources in evaluation order, and the lane's chain lengths
//   at each of its nested levels, innermost first (K16 and K17: one lane,
//   rank order, one level of W; K21b: `kernels/torus.py` `rs_order`).  A
//   thread folds a 16-byte unit (8 bf16 or 4 f32) of every source through
//   one accumulator a level (`Chains`; the depth a template parameter, K16
//   one level, K21b nd): the k-th source into level 0, a finished chain
//   into the next level; all W loads of a unit are in flight before the
//   first fold.  K16 and K17 keep their sums in f32 and round once at the
//   store; K21b rounds every add.
// - K17 `two_shot` (ALL): block b sums its range into shared-memory slabs
//   of 16 KB, each bulk-stored into chunk r of every rank's output, its own
//   included (the JAX kernel's reduce and its broadcast in one pass), while
//   the threads sum the next (`sum_to_slabs`; chunks off 16 bytes: stores
//   from registers), then adds P to its words in a second bank (OUT_WORD +
//   r MAX_BLOCKS + g) at every other rank and waits only for word (s, b) of
//   that bank from each other rank: its range of the W - 1 other chunks.
//   On an H100 80GB HBM3 at 700 W the slabs were 1-3% faster than 16-byte
//   stores from registers into the W outputs (PERF.md,
//   `scripts/torch_collectives_ab.py --variants` `regs`).
// - Copies: bulk copies (`comm::bulk_runs`) through the STAGE_BUFS buffers,
//   issued by one thread a block while its other threads wait; chunks off
//   16 bytes take the threads' copies of `dl::put_nbi` (16-, 4- or 1-byte
//   units).  On an H100 80GB HBM3 at 700 W the bulk form was 3-5% faster
//   than the threads' 16-byte copies with four loads in flight a thread
//   (PERF.md, `scripts/torch_rs_ab.py --variants` `threads`).
#pragma once

#include <algorithm>

#include "comm_body.cuh"

namespace tdt {
namespace sum {

using bf16 = __nv_bfloat16;
using dl::u64;
using comm::MAX_BLOCKS;

//: Lanes (a chunk's pieces) and nested levels of a sum at most: K21b's 2 nd
//: and nd on a grid of three axes.
constexpr int MAX_LANES = 6, MAX_LEVELS = 3;
//: Signal words a rank: the entry barrier, the local word, then MAX_BLOCKS
//: arrival words for each source rank (`kernels/reduce_scatter.py`
//: SUM_WORDS); K17 `two_shot` a second bank of as many from OUT_WORD on
//: (`kernels/allreduce.py` TWO_SHOT_WORDS).
constexpr int SUM_WORDS = dl::ARRIVAL_WORD + dl::MAX_RANKS * MAX_BLOCKS;
constexpr int OUT_WORD = SUM_WORDS;
constexpr int TWO_SHOT_WORDS = OUT_WORD + dl::MAX_RANKS * MAX_BLOCKS;

// The order of a destination's sum, built on the host: lane q (elements
// [q piece, (q + 1) piece) of a chunk) sums, at destination g, the sources
// src[q][g][0 ..W) in that order, folded through chains of len[q][0] at
// level 0, len[q][1] at level 1 and len[q][2] at level 2 (their product
// is W).
struct Order {
  int lanes;
  unsigned char len[MAX_LANES][MAX_LEVELS];
  unsigned char src[MAX_LANES][dl::MAX_RANKS][dl::MAX_RANKS];
};

template <typename T>
struct SumArgs {
  const T* x;           // (R, W, elems): the launched ranks' partials
  T* out;               // (R, elems); K17: unused
  dl::Symm<char> outs;  // K17: rank r's (W, elems) result
  dl::Symm<char> rbuf;  // rank r's receive buffer (W, elems)
  dl::Symm<u64> sig;    // rank r's SUM_WORDS (K17 TWO_SHOT_WORDS) counters
  dl::Team team;
  size_t elems;         // one chunk
  size_t piece;         // one lane's piece
  int vec;              // every chunk, slot and piece on 16 bytes
  int bank;             // words a bank in use (`launch_cooperative`)
  u64 epoch;            // the instance's sum of P before this call
  comm::Faults faults;
  Order order;
};

__device__ __forceinline__ int sum_word(int source, int g) {
  return dl::ARRIVAL_WORD + source * MAX_BLOCKS + g;
}

__device__ __forceinline__ int out_word(int source, int g) {
  return OUT_WORD + source * MAX_BLOCKS + g;
}

// 16 bytes of T: N elements widened to float and narrowed back (to nearest
// even), and an f32 value rounded to T.
template <typename T>
struct Vec;

template <>
struct Vec<bf16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return u;
  }
  __device__ __forceinline__ static float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  __device__ __forceinline__ static float round(float v) { return v; }
};

// A lane's LEVELS nested chains over N elements: the k-th operand folds
// into level 0 (the first of a chain taken as it is, every later one added
// in f32, rounded to T when EACH); a finished chain of level l (len[l]
// operands) folds into level l + 1; the last level's value, ``a[LEVELS -
// 1]``, is the sum.  Every index is a constant once unrolled, so the
// accumulators stay in registers.
template <typename T, bool EACH, int N, int LEVELS>
struct Chains {
  float a[LEVELS][N];
  int c[LEVELS] = {};
  const int* len;

  __device__ __forceinline__ static void fold(float* acc, const float* v,
                                              bool first) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float s = acc[j] + v[j];
      acc[j] = first ? v[j] : (EACH ? Vec<T>::round(s) : s);
    }
  }

  __device__ __forceinline__ void add(const float* v) {
    fold(a[0], v, c[0] == 0);
#pragma unroll
    for (int l = 0; l + 1 < LEVELS; ++l) {
      if (++c[l] < len[l]) return;
      c[l] = 0;
      fold(a[l + 1], a[l], c[l + 1] == 0);
    }
    ++c[LEVELS - 1];
  }
};

// Elements [lo, hi) of one lane of this rank's chunk of the sum: the own
// partial from ``own`` (x), the others from the receive slots ``rb``, in
// the order ``src`` with chains ``len``, stored to ``out[0]`` (ALL: to
// ``out[0 .. w)``).  With ``vec``, whole 16-byte units (lo on one) with
// every source's load in flight before the first fold, then the tail
// element by element.
template <typename T, bool EACH, int LEVELS, bool ALL>
__device__ __forceinline__ void ordered_sum(const T* own, const T* rb,
                                            T* const* out, int me, int w,
                                            size_t elems, size_t lo,
                                            size_t hi,
                                            const unsigned char* src,
                                            const int* len, bool vec) {
  constexpr int N = Vec<T>::N;
  const int nout = ALL ? w : 1;
  int s[dl::MAX_RANKS];
#pragma unroll
  for (int k = 0; k < dl::MAX_RANKS; ++k) s[k] = k < w ? src[k] : 0;
  auto at = [&](int k) {
    return s[k] == me ? own : rb + (size_t)s[k] * elems;
  };
  size_t tail = lo;
  if (vec) {
    tail = lo + (hi - lo) / N * N;
    for (size_t i = lo + (size_t)threadIdx.x * N; i < tail;
         i += (size_t)blockDim.x * N) {
      uint4 raw[dl::MAX_RANKS];
#pragma unroll
      for (int k = 0; k < dl::MAX_RANKS; ++k)
        if (k < w) raw[k] = __ldcg(reinterpret_cast<const uint4*>(at(k) + i));
      Chains<T, EACH, N, LEVELS> ch;
      ch.len = len;
#pragma unroll
      for (int k = 0; k < dl::MAX_RANKS; ++k) {
        if (k >= w) break;
        float v[N];
        Vec<T>::widen(raw[k], v);
        ch.add(v);
      }
      const uint4 u = Vec<T>::narrow(ch.a[LEVELS - 1]);
#pragma unroll
      for (int o = 0; o < (ALL ? dl::MAX_RANKS : 1); ++o)
        if (o < nout) *reinterpret_cast<uint4*>(out[o] + i) = u;
    }
  }
  for (size_t i = tail + threadIdx.x; i < hi; i += blockDim.x) {
    Chains<T, EACH, 1, LEVELS> ch;
    ch.len = len;
#pragma unroll
    for (int k = 0; k < dl::MAX_RANKS; ++k) {
      if (k >= w) break;
      const float v = comm::load1_cg(at(k) + i);
      ch.add(&v);
    }
#pragma unroll
    for (int o = 0; o < (ALL ? dl::MAX_RANKS : 1); ++o)
      if (o < nout) tdt::store1(out[o] + i, ch.a[LEVELS - 1][0]);
  }
}

// The block's range ``r`` of each foreign chunk into slot ``me`` of its
// destination's receive buffer, destinations me + 1, me + 2, ..  With
// 16-byte chunks (``vec``), thread 0's bulk copies through ``s``; else the
// threads' copies.
template <typename T>
__device__ __forceinline__ void scatter(const T* x, const dl::Symm<char>& rbuf,
                                        int me, int w, size_t elems,
                                        comm::Range r, bool vec,
                                        comm::Staging& s) {
  const size_t slot = (size_t)me * elems;
  if (!vec) {
    for (int j = 1; j < w; ++j) {
      const int c = (me + j) % w;
      comm::put_range(reinterpret_cast<T*>(rbuf[c]) + slot,
                      x + (size_t)c * elems, r);
    }
    return;
  }
  if (threadIdx.x != 0) return;
  const unsigned bytes = (unsigned)((r.hi - r.lo) * sizeof(T));
  auto dest = [&](unsigned k) { return (me + 1 + (int)k) % w; };
  comm::bulk_runs(
      s, w - 1, comm::pieces(bytes), 1, [&](unsigned) { return bytes; },
      [&](unsigned k) {
        return reinterpret_cast<const char*>(x + (size_t)dest(k) * elems +
                                             r.lo);
      },
      [&](unsigned k, int) {
        return rbuf[dest(k)] + (slot + r.lo) * sizeof(T);
      });
}

// K17's range ``r`` of its chunk of the sum (one lane, rounded once) into
// every rank's output through shared-memory slabs of SLAB_BYTES (two of the
// staging's buffers each, 16-byte chunks): the threads sum into one slab
// while thread 0's bulk stores of the other put it into all W outputs; a
// slab is written again once its last stores have read it.  Its stores are
// performed and fenced against the generic proxy before it returns.
constexpr unsigned SLAB_BYTES = 2 * comm::STAGE_BYTES;

template <typename T>
__device__ __forceinline__ void sum_to_slabs(const T* own, const T* rb,
                                             T* slabs,
                                             const dl::Symm<char>& outs,
                                             int me, int w, size_t elems,
                                             comm::Range r,
                                             const unsigned char* src,
                                             const int* len) {
  constexpr size_t SLAB = SLAB_BYTES / sizeof(T);
  int k = 0;
  for (size_t a = r.lo; a < r.hi; a += SLAB, k ^= 1) {
    const size_t e = a + SLAB < r.hi ? a + SLAB : r.hi;
    if (threadIdx.x == 0) tdt::bulk_wait_read<1>();
    __syncthreads();
    T* slab = slabs + k * SLAB;
    T* dst[1] = {slab - a};  // element i of the range at slab[i - a]
    ordered_sum<T, false, 1, false>(own, rb, dst, me, w, elems, a, e, src,
                                    len, true);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int q = 0; q < w; ++q)
        tdt::bulk_store(reinterpret_cast<T*>(outs[q]) + me * elems + a, slab,
                        (unsigned)((e - a) * sizeof(T)));
      tdt::bulk_commit();
    }
  }
  if (threadIdx.x == 0) {
    tdt::bulk_wait_all();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
}

template <typename T, bool EACH, int LEVELS, bool ALL>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    scatter_sum_kernel(const __grid_constant__ SumArgs<T> p) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bar[comm::STAGE_BUFS];
  __shared__ unsigned char src[MAX_LANES][dl::MAX_RANKS];
  __shared__ int len[MAX_LANES][2];
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, b = blockIdx.x, P = gridDim.x;
  const u64 target = p.epoch + P;
  const size_t elems = p.elems;
  const T* x = p.x + (size_t)blockIdx.y * w * elems;
  const int tid = threadIdx.x;
  for (int i = tid; i < p.order.lanes * dl::MAX_RANKS; i += blockDim.x)
    src[i / dl::MAX_RANKS][i % dl::MAX_RANKS] =
        p.order.src[i / dl::MAX_RANKS][me][i % dl::MAX_RANKS];
  if (tid < p.order.lanes) {
    len[tid][0] = p.order.len[tid][0];
    len[tid][1] = p.order.len[tid][1];
  }
  comm::Staging s = comm::staging(stage, bar);
  const comm::Range r = comm::block_range(elems, b, P);

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  scatter<T>(x, p.rbuf, me, w, elems, r, p.vec != 0, s);
  // Arrival: this block's copies visible, then one add of P to each word
  // it owns at every destination (words b, b + P, .. of source me).
  dl::fence<dl::Scope::gpu>();
  __syncthreads();
  comm::signal_blocks(w - 1, p.bank, [&](int i) {
    return p.sig[(me + 1 + i) % w] + sum_word(me, 0); });
  // Block b waits only for its own range, from each other source.
  comm::wait_blocks(w, me, [&](int i) { return p.sig[me] + sum_word(i, 0); },
                    target, ALL ? tdt::WAIT_TWO_SHOT_SCATTER
                                : tdt::WAIT_SCATTER_SUM);
  const T* own = x + (size_t)me * elems;
  const T* rb = reinterpret_cast<const T*>(p.rbuf[me]);
  T* out[ALL ? dl::MAX_RANKS : 1];
  if constexpr (ALL) {
#pragma unroll
    for (int q = 0; q < dl::MAX_RANKS; ++q)
      out[q] = reinterpret_cast<T*>(p.outs[q < w ? q : 0]) +
               (size_t)me * elems;
  } else {
    out[0] = p.out + (size_t)blockIdx.y * elems;
  }
  if (ALL && p.vec) {
    sum_to_slabs<T>(own, rb, reinterpret_cast<T*>(stage), p.outs, me, w,
                    elems, r, src[0], len[0]);
  } else {
    for (size_t a = r.lo; a < r.hi;) {
      const int q = (int)(a / p.piece);
      const size_t end = (size_t)(q + 1) * p.piece;
      const size_t e = end < r.hi ? end : r.hi;
      ordered_sum<T, EACH, LEVELS, ALL>(own, rb, out, me, w, elems, a, e,
                                        src[q], len[q], p.vec != 0);
      a = e;
    }
  }
  if constexpr (ALL) {
    // The block's range of the sum is in every rank's output: its words
    // (me, b + k P) of the second bank at every other rank, then the wait
    // for its range of the other chunks.
    dl::fence<dl::Scope::gpu>();
    __syncthreads();
    comm::signal_blocks(w - 1, p.bank, [&](int i) {
      return p.sig[(me + 1 + i) % w] + out_word(me, 0); });
    comm::wait_blocks(w, me, [&](int i) { return p.sig[me] + out_word(i, 0); },
                      target, tdt::WAIT_TWO_SHOT_BROADCAST);
  }
}

// The body for a sum of ``levels`` nested levels, rounding every add or
// once.
template <typename T, bool EACH>
void* kernel(int levels) {
  if (levels == 1)
    return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 1, false>);
  if (levels == 2)
    return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 2, false>);
  return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 3, false>);
}

// One launch of the body ``fn`` (`kernel`, or K17's `scatter_sum_kernel<T,
// false, 1, true>`): ``p``'s team, sizes, epoch, faults and order filled;
// x (ranks, world, elems); ``out`` (ranks, elems), or (K17) ``outs`` a host
// table of every rank's (world, elems) output; ``rbuf`` and ``sig`` host
// tables of every rank's receive buffer and counters.
template <typename T>
int launch(SumArgs<T>& p, void* fn, const void* x, void* out,
           void* const* outs, void* const* rbuf, void* const* sig, int ranks,
           int* blocks, cudaStream_t s) {
  const int world = p.team.world;
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out);
  for (int r = 0; r < world; ++r) {
    p.rbuf.ptr[r] = static_cast<char*>(rbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(rbuf[r]);
    if (outs != nullptr) {
      p.outs.ptr[r] = static_cast<char*>(outs[r]);
      align |= reinterpret_cast<uintptr_t>(outs[r]);
    }
  }
  p.vec = align % 16 == 0 && p.elems * sizeof(T) % 16 == 0 &&
          p.piece * sizeof(T) % 16 == 0;
  void* args[] = {&p};
  const int want = std::min(
      comm::blocks_for((size_t)world * p.elems * sizeof(T)), MAX_BLOCKS);
  return comm::launch_cooperative(fn, args, ranks, want, blocks, s,
                                  comm::STAGE_SMEM, &p.bank);
}

}  // namespace sum
}  // namespace tdt
