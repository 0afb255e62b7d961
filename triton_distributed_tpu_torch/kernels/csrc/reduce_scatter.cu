// ReduceScatter (K16), and the reduce-scatter over a process grid (K21b) on
// the same body: rank c of a team of W gets chunk c of the sum of the W
// ranks' partials, out_c = sum over r of x_r[c].
//
// Replaces: triton_distributed_tpu/kernels/reduce_scatter.py
//   `reduce_scatter` -> pallas_call :295 (`_scatter_reduce_kernel` :184
//   over `emit_scatter_reduce` :144, summing with `_emit_reduce_sum` :94)
//   and :314 (`_ring_rs_kernel` :197, adding with `emit_add_into` :120);
// and triton_distributed_tpu/kernels/torus.py `reduce_scatter_torus` ->
//   pallas_call :613 (`_torus_rs_kernel` :472, `_ReduceLane` :383).
// Layouts are the JAX wrappers' per rank: the partials x_r (W, elems) as W
// chunks (K21b: (W, m, n), elems = m n), out_r (elems); the receive buffer
// rbuf_r (W, elems), slot s holding rank s's partial of chunk r; the
// ring's staging_r and accum_r (2, elems), in x's dtype as the JAX buffers
// are.
//
// Numerics, as the JAX kernels:
// - `scatter_reduce` sums the W partials in f32 in rank order 0 .. W-1 and
//   rounds once (`reduce_sum`);
// - K21b evaluates `kernels/torus.py` `reduce_scatter_torus_plain`: for the
//   lane q of a row (row // ms), nd nested chains, stage t's along the axis
//   of the lane's phase nd-1-t, each chain from position c + d to c, the
//   first operand taken as it is and every later add one f32 add rounded to
//   x's dtype;
// - the ring adds one hop at a time in f32 and rounds to x's dtype at every
//   hop, chunk c's sum running x_{c+1}, + x_{c+2}, .., + x_c.
//
// What bounds it on the H100: bytes.  Each rank reads its W chunks once,
// receives W - 1 of them and writes its chunk of the sum; on one card every
// receive is a copy inside one HBM, W - 1 chunks read and written again.
//
// Design of K16 `scatter_reduce` and K21b (`scatter_sum_kernel`): one scatter
// of every piece straight to its destination, then one ordered sum there;
// no hop chain, staging slot, ack or stage result between ranks.
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
// - Arrival paired by range: each source rank owns MAX_BLOCKS words at every
//   destination, word (s, g) at ARRIVAL_WORD + s MAX_BLOCKS + g.  Block b of
//   rank r, its copies done, adds P to its words b, b + P, .. < MAX_BLOCKS
//   at every destination, so every word receives adds summing to P in
//   every call whatever P is, and a wait's target stays the epoch plus this
//   call's P (`dl.cuh`).  Block b of a destination waits only on word (s,
//   b) of each source s: the blocks that wrote its own range, not all P of
//   every source.  So a block sums as soon as its range has landed, and the
//   copies of some blocks overlap the sums of others (and the landed
//   pieces may still be in L2 when they are summed).
// - The sum: the order is a host-built table (`Order`, passed by value):
//   for each lane (a chunk's piece of ``piece`` elements) and destination
//   rank, the W sources in evaluation order, and the lane's chain lengths
//   at each of its nested levels, innermost first (K16: one lane, rank
//   order, one level of W; K21b: `kernels/torus.py` `rs_order`).  A
//   thread folds a 16-byte unit (8 bf16 or 4 f32) of every source through
//   one accumulator a level (`Chains`; the depth a template parameter, K16
//   one level, K21b nd): the k-th source into level 0, a finished chain
//   into the next level; all W loads of a unit are in flight before the
//   first fold.  K16 keeps its sums in f32 and rounds once at the store;
//   K21b rounds every add.
// - Copies: bulk copies (`cp.async.bulk` global -> shared -> global)
//   through STAGE_BUFS buffers, issued by one thread a block while its
//   other threads wait; chunks off 16 bytes take the threads' copies of
//   `dl::put_nbi` (16-, 4- or 1-byte units).  On an H100 80GB HBM3 at 700 W
//   the bulk form was 3-5% faster than the threads' 16-byte copies with
//   four loads in flight a thread (PERF.md, `scripts/torch_rs_ab.py
//   --variants` `threads`).  It carries over to a peer's memory on a real
//   node: a bulk store's destination is any global address, a peer's
//   buffer mapped over NVLink included, and its loads read only this
//   rank's own x (not measured on a multi-GPU node here).
// - `ring`: the neighbour entry barrier; for s = 0 .. W-2 the rank sends
//   chunk (r - 1 - s) mod W (its own partial at s = 0, else its running
//   sum) into staging slot s % 2 of its right neighbour, waits for the
//   left's delivery into its own slot, adds its partial of chunk
//   (r - 2 - s) mod W into the other accum slot (into out at the last
//   step) and acks the left neighbour.  From step 2 on a rank writes a
//   slot of its right neighbour only after that neighbour has acked the
//   step that last filled it (the JAX two-slot flow control); the last two
//   acks are drained before the kernel ends.  Arrival and ack words are
//   one a step (words s and MAX_RANKS + s), so every word sees one add
//   from each block in every call.  Each block adds and forwards the same
//   range of elements (`block_range`), so it never forwards a sum that
//   another block is still writing.

#include <algorithm>

#include "comm_body.cuh"
#include "mbarrier.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace comm = tdt::comm;

//: Blocks a rank at most: the arrival words a source rank owns at each
//: destination.
constexpr int MAX_BLOCKS = 256;
//: Lanes (a chunk's pieces) and nested levels of a sum at most: K21b's 2 nd
//: and nd on a grid of three axes.
constexpr int MAX_LANES = 6, MAX_LEVELS = 3;
//: Signal words a rank of the scatter-then-sum body: the entry barrier,
//: the local word, then MAX_BLOCKS arrival words for each source rank
//: (`kernels/reduce_scatter.py` SUM_WORDS).
constexpr int SUM_WORDS = dl::ARRIVAL_WORD + dl::MAX_RANKS * MAX_BLOCKS;

//: The bulk copies' staging: STAGE_BUFS shared buffers of STAGE_BYTES.
constexpr int STAGE_BUFS = 4;
constexpr unsigned STAGE_BYTES = 8192;

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
  T* out;               // (R, elems)
  dl::Symm<char> rbuf;  // rank r's receive buffer (W, elems)
  dl::Symm<u64> sig;    // rank r's SUM_WORDS counters
  dl::Team team;
  size_t elems;         // one chunk
  size_t piece;         // one lane's piece
  int vec;              // every chunk, slot and piece on 16 bytes
  u64 epoch;            // the instance's sum of P before this call
  comm::Faults faults;
  Order order;
};

__device__ __forceinline__ int sum_word(int source, int g) {
  return dl::ARRIVAL_WORD + source * MAX_BLOCKS + g;
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
// the order ``src`` with chains ``len``.  With ``vec``, whole 16-byte units
// (lo on one) with every source's load in flight before the first fold,
// then the tail element by element.
template <typename T, bool EACH, int LEVELS>
__device__ __forceinline__ void ordered_sum(const T* own, const T* rb,
                                            T* out, int me, int w,
                                            size_t elems, size_t lo,
                                            size_t hi,
                                            const unsigned char* src,
                                            const int* len, bool vec) {
  constexpr int N = Vec<T>::N;
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
      *reinterpret_cast<uint4*>(out + i) = Vec<T>::narrow(ch.a[LEVELS - 1]);
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
    tdt::store1(out + i, ch.a[LEVELS - 1][0]);
  }
}

// The block's range ``r`` of each foreign chunk into slot ``me`` of its
// destination's receive buffer, destinations me + 1, me + 2, ..  With
// 16-byte chunks (``vec``), bulk copies global -> shared -> global by
// thread 0 through ``stage``'s buffers (barriers ``bar``), every buffer's
// load in flight before the first store, a buffer loaded again once the
// store before last has read it; its stores are performed and fenced
// against the generic proxy before it returns.  Else the threads' copies.
template <typename T>
__device__ __forceinline__ void scatter(const T* x, const dl::Symm<char>& rbuf,
                                        int me, int w, size_t elems,
                                        comm::Range r, bool vec,
                                        uint8_t* stage, uint64_t* bar) {
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
  const unsigned per = (bytes + STAGE_BYTES - 1) / STAGE_BYTES;
  const unsigned n = per * (unsigned)(w - 1);
  auto dest = [&](unsigned i) { return (me + 1 + (int)(i / per)) % w; };
  auto off = [&](unsigned i) { return i % per * STAGE_BYTES; };
  auto len = [&](unsigned i) { return min(STAGE_BYTES, bytes - off(i)); };
  auto load = [&](unsigned i) {
    const unsigned k = i % STAGE_BUFS;
    tdt::mbar_expect_tx(&bar[k], len(i));
    tdt::bulk_load(stage + k * STAGE_BYTES,
                   reinterpret_cast<const char*>(
                       x + (size_t)dest(i) * elems + r.lo) + off(i),
                   len(i), &bar[k]);
  };
  for (unsigned i = 0; i < n && i < STAGE_BUFS; ++i) load(i);
  for (unsigned i = 0; i < n; ++i) {
    const unsigned k = i % STAGE_BUFS;
    tdt::mbar_wait(&bar[k], (i / STAGE_BUFS) & 1);
    tdt::bulk_store(rbuf[dest(i)] + (slot + r.lo) * sizeof(T) + off(i),
                    stage + k * STAGE_BYTES, len(i));
    tdt::bulk_commit();
    const unsigned next = i - 1 + STAGE_BUFS;  // piece i - 1's buffer
    if (i > 0 && next < n) {
      tdt::bulk_wait_read<1>();
      load(next);
    }
  }
  tdt::bulk_wait_all();
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

template <typename T, bool EACH, int LEVELS>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    scatter_sum_kernel(const __grid_constant__ SumArgs<T> p) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bar[STAGE_BUFS];
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
  if (tid == 0) {
    for (int k = 0; k < STAGE_BUFS; ++k) tdt::mbar_init(&bar[k], 1);
    tdt::mbar_init_fence();
  }
  __syncthreads();
  const comm::Range r = comm::block_range(elems, b, P);

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  scatter<T>(x, p.rbuf, me, w, elems, r, p.vec != 0, stage, bar);
  // Arrival: this block's copies visible, then one add of P to each word
  // it owns at every destination (words b, b + P, .. of source me).
  dl::fence<dl::Scope::gpu>();
  __syncthreads();
  const int owned = (MAX_BLOCKS - 1 - b) / P + 1;
  for (int i = tid; i < (w - 1) * owned; i += blockDim.x)
    dl::notify(p.sig[(me + 1 + i / owned) % w] +
                   sum_word(me, b + i % owned * P),
               (u64)P);
  // Block b waits only for its own range, from each other source.
  for (int i = tid; i < w; i += blockDim.x)
    if (i != me)
      dl::signal_wait_until(p.sig[me] + sum_word(i, b), target,
                            tdt::WAIT_SCATTER_SUM);
  __syncthreads();
  const T* own = x + (size_t)me * elems;
  const T* rb = reinterpret_cast<const T*>(p.rbuf[me]);
  T* out = p.out + (size_t)blockIdx.y * elems;
  for (size_t a = r.lo; a < r.hi;) {
    const int q = (int)(a / p.piece);
    const size_t end = (size_t)(q + 1) * p.piece;
    const size_t e = end < r.hi ? end : r.hi;
    ordered_sum<T, EACH, LEVELS>(own, rb, out, me, w, elems, a, e, src[q],
                                 len[q], p.vec != 0);
    a = e;
  }
}

template <typename T>
struct RingArgs {
  const T* x;          // (R, W, elems): the launched ranks' partials
  T* out;              // (R, elems)
  dl::Symm<char> buf;  // rank r's staging (2, elems)
  T* accum;            // (R, 2, elems), the running sums sent on
  dl::Symm<u64> sig;   // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t elems;        // one chunk
  u64 epoch;           // the instance's sum of P before this call
  comm::Faults faults;
};

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    ring_kernel(RingArgs<T> p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, y = blockIdx.y;
  const u64 target = p.epoch + gridDim.x;
  const size_t elems = p.elems;
  const T* x = p.x + (size_t)y * w * elems;
  T* acc = p.accum + (size_t)y * 2 * elems;
  T* stage = reinterpret_cast<T*>(p.buf[me]);
  const int right = dl::peer_id(t, me + 1), left = dl::peer_id(t, me - 1);
  T* stage_right = reinterpret_cast<T*>(p.buf[right]);
  constexpr int ACK = dl::ARRIVAL_WORD + dl::MAX_RANKS;
  const comm::Range r = comm::block_range(elems, blockIdx.x, gridDim.x);

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  for (int s = 0; s < w - 1; ++s) {
    const int slot = s % 2;
    if (s >= 2)
      dl::wait(p.sig[me] + ACK + s - 2, 1, 0, target,
               tdt::WAIT_REDUCE_SCATTER_ACK);
    const T* src = s == 0 ? x + dl::peer_id(t, me - 1 - s) * elems
                          : acc + slot * elems;
    comm::put_range(stage_right + slot * elems, src, r);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + s;
    dl::signal_after_puts(&word, 1);
    dl::wait(p.sig[me] + dl::ARRIVAL_WORD + s, 1, 0, target,
             tdt::WAIT_REDUCE_SCATTER_RING);
    T* dst = s < w - 2 ? acc + (1 - slot) * elems : p.out + y * elems;
    comm::add_into(dst, stage + slot * elems,
                   x + dl::peer_id(t, me - 2 - s) * elems, r);
    // The slot is free again (this block's reads of it are done), and
    // the block's sums are stored before the next step forwards them.
    u64* ack = p.sig[left] + ACK + s;
    dl::signal_after_puts(&ack, 1);
  }
  for (int s = w - 3 < 0 ? 0 : w - 3; s < w - 1; ++s)
    dl::wait(p.sig[me] + ACK + s, 1, 0, target,
             tdt::WAIT_REDUCE_SCATTER_ACK_DRAIN);
}

void set_ranks(dl::Symm<char>* buf, dl::Symm<u64>* sig, void* const* bufs,
               void* const* sigs, int world) {
  for (int r = 0; r < world; ++r) {
    buf->ptr[r] = static_cast<char*>(bufs[r]);
    sig->ptr[r] = static_cast<u64*>(sigs[r]);
  }
}

template <typename T>
int run_ring(const void* x, void* out, void* const* staging, void* accum,
             void* const* sig, int world, int base, int ranks, size_t elems,
             u64 epoch, comm::Faults f, int* blocks, cudaStream_t s) {
  RingArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.accum = static_cast<T*>(accum);
  set_ranks(&p.buf, &p.sig, staging, sig, world);
  p.team = dl::Team{world, base};
  p.elems = elems;
  p.epoch = epoch;
  p.faults = f;
  void* args[] = {&p};
  return comm::launch_cooperative(reinterpret_cast<void*>(ring_kernel<T>),
                                  args, ranks,
                                  comm::blocks_for(elems * sizeof(T)), blocks,
                                  s);
}

// The body for a sum of ``levels`` nested levels, rounding every add or
// once.
template <typename T, bool EACH>
void* sum_kernel(int levels) {
  if (levels == 1)
    return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 1>);
  if (levels == 2)
    return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 2>);
  return reinterpret_cast<void*>(scatter_sum_kernel<T, EACH, 3>);
}

template <typename T>
int run_sum(SumArgs<T>& p, const void* x, void* out, void* const* rbuf,
            void* const* sig, int ranks, int levels, bool each, int* blocks,
            cudaStream_t s) {
  const int world = p.team.world;
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  set_ranks(&p.rbuf, &p.sig, rbuf, sig, world);
  uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(out);
  for (int r = 0; r < world; ++r)
    align |= reinterpret_cast<uintptr_t>(rbuf[r]);
  p.vec = align % 16 == 0 && p.elems * sizeof(T) % 16 == 0 &&
          p.piece * sizeof(T) % 16 == 0;
  void* fn =
      each ? sum_kernel<T, true>(levels) : sum_kernel<T, false>(levels);
  void* args[] = {&p};
  const int want = std::min(
      comm::blocks_for((size_t)world * p.elems * sizeof(T)), MAX_BLOCKS);
  return comm::launch_cooperative(
      fn, args, ranks, want, blocks, s,
      STAGE_BUFS * STAGE_BYTES);
}

}  // namespace

// The entries share their leading and trailing arguments: x (ranks, world,
// elems), the launched ranks' partials (ranks base .. base + ranks - 1 of a
// team of ``world``), chunk c for rank c; out (ranks, elems); ``dtype``
// (tdt::DTYPE_*) of both and of the buffers; ``sig`` a host table of
// ``world`` device pointers, rank r's u64 counters; ``epoch`` the
// instance's sum of blocks a rank over its earlier calls, the blocks a rank
// of this launch going to ``*blocks``; ``straggler`` (-1: none) spins
// ``cycles`` first, ``for_correctness`` staggers every rank.  Each returns
// a cudaError_t code.

// K16 `scatter_reduce` and K21b: ``rbuf`` a host table of rank r's receive
// buffer (world, elems); ``words`` counters a rank (at least SUM_WORDS);
// ``piece`` elements a lane, ``lanes`` lanes covering the chunk; ``lens``
// (lanes, 3) each lane's chain lengths, innermost first, their product
// ``world``; ``srcs`` (lanes, world, world) each lane's sources at each
// destination in evaluation order, a permutation of the ranks;
// ``round_each``: every add rounded to the dtype (K21b), else one rounding
// of the f32 sum (K16).
extern "C" int reduce_scatter_sum(const void* x, void* out,
                                  void* const* rbuf, void* const* sig,
                                  int words, int world, int base, int ranks,
                                  int dtype, unsigned long long elems,
                                  unsigned long long piece, int lanes,
                                  const int* lens, const int* srcs,
                                  int round_each, unsigned long long epoch,
                                  int straggler, long long cycles,
                                  int for_correctness, int* blocks,
                                  void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || elems < 1 || piece < 1 || lanes < 1 ||
      lanes > MAX_LANES || (unsigned long long)lanes * piece < elems ||
      words < SUM_WORDS)
    return (int)cudaErrorInvalidValue;
  Order o{};
  o.lanes = lanes;
  int levels = 1;  // the deepest level with a chain of more than one
  for (int q = 0; q < lanes; ++q) {
    int prod = 1;
    for (int l = 0; l < MAX_LEVELS; ++l) {
      const int n = lens[q * MAX_LEVELS + l];
      if (n < 1 || n > world) return (int)cudaErrorInvalidValue;
      o.len[q][l] = (unsigned char)n;
      prod *= n;
      if (n > 1 && l >= levels) levels = l + 1;
    }
    if (prod != world) return (int)cudaErrorInvalidValue;
    for (int g = 0; g < world; ++g) {
      unsigned seen = 0;
      for (int k = 0; k < world; ++k) {
        const int s = srcs[(q * world + g) * world + k];
        if (s < 0 || s >= world || (seen >> s & 1))
          return (int)cudaErrorInvalidValue;
        seen |= 1u << s;
        o.src[q][g][k] = (unsigned char)s;
      }
    }
  }
  const comm::Faults f{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto& p) {
    p.team = dl::Team{world, base};
    p.elems = elems;
    p.piece = piece;
    p.epoch = epoch;
    p.faults = f;
    p.order = o;
  };
  if (dtype == tdt::DTYPE_BF16) {
    SumArgs<bf16> p{};
    fill(p);
    return run_sum<bf16>(p, x, out, rbuf, sig, ranks, levels,
                         round_each != 0, blocks, s);
  }
  if (dtype == tdt::DTYPE_F32) {
    SumArgs<float> p{};
    fill(p);
    return run_sum<float>(p, x, out, rbuf, sig, ranks, levels,
                          round_each != 0, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K16 `ring`: ``staging`` a host table of rank r's staging (2, elems);
// ``accum`` (ranks, 2, elems); the counters dl::SIGNAL_WORDS a rank.
extern "C" int reduce_scatter_ring(const void* x, void* out,
                                   void* const* staging, void* accum,
                                   void* const* sig, int world, int base,
                                   int ranks, int dtype,
                                   unsigned long long elems,
                                   unsigned long long epoch, int straggler,
                                   long long cycles, int for_correctness,
                                   int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || elems < 1 || accum == nullptr)
    return (int)cudaErrorInvalidValue;
  const comm::Faults f{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run_ring<bf16>(x, out, staging, accum, sig, world, base, ranks,
                          elems, epoch, f, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run_ring<float>(x, out, staging, accum, sig, world, base, ranks,
                           elems, epoch, f, blocks, s);
  return (int)cudaErrorInvalidValue;
}
