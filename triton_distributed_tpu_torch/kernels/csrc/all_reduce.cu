// AllReduce (K17): every rank of a team of W gets the sum of the W ranks'
// partials, out_r = sum over w of x_w.
//
// Replaces: triton_distributed_tpu/kernels/allreduce.py `all_reduce`
//   -> pallas_call :373 (`_one_shot_kernel` :108), :352
//   (`_two_shot_kernel` :134) and :330 (`_chain_kernel` :182).  The RING
//   method composes K16's ring and K15's ring (allreduce.py :282-310) and
//   launches no kernel of its own.  Layouts are the JAX wrapper's per rank:
//   x_r (elems), out_r (elems); one-shot's rbuf_r (W, elems), slot w holding
//   rank w's x; two-shot's rbuf_r (W, elems / W), slot w holding rank w's
//   partial of chunk r; the chain's staging_r (elems), as C chunks.
//
// Numerics, as the JAX kernels: one-shot and two-shot sum the W partials
// in f32 in rank order 0 .. W-1 and round once (`reduce_sum`); the chain
// adds one hop at a time from rank W-1 down to rank 0 in f32, rounding to
// x's dtype at every hop (`add_into`), and broadcasts rank 0's sum.
//
// What bounds it on the H100: bytes.  Each rank reads its x once and
// writes its out once; one-shot receives W - 1 whole partials, two-shot
// W - 1 partial chunks and W - 1 reduced chunks, the chain one partial sum
// and one result.  On one card every receive is a copy inside one HBM.
//
// Design.  One cooperative launch holds every rank's blocks (`dl.cuh`);
// each rank's P blocks share its copies and sums.
// - `two_shot` (redesigned for Hopper): the scatter-then-sum body that K16
//   runs (scatter_sum.cuh, `scatter_sum_kernel<T, false, 1, true>`): the
//   entry barrier; block b bulk-copies its range of each foreign chunk c
//   into slot r of rank c's rbuf (the own chunk never copied), adds P to
//   its arrival words paired by range and waits only for word (s, b) of
//   each source; sums its range in rank order in f32 into 16 KB slabs of
//   shared memory, each slab bulk-stored into chunk r of every rank's out,
//   its own included, while the next is summed (`sum_to_slabs`; a chunk
//   off 16 bytes stores from registers instead); then the same pairing in
//   a second bank for the W - 1 other chunks of its range.  The first body (chunks by thread copies, every
//   block waiting on every block of every source, twice) took 0.1283 ms at
//   4 x 2048 x 4096 bf16 on an H100 80GB HBM3 at 700 W (PERF.md).
// - `one_shot`: `emit_push_allgather` of x into every rank's rbuf slot r
//   (with the entry barrier), then `reduce_sum` into out; a rank waits
//   until all P blocks of a sender have delivered.
// - `chain`: the neighbour entry barrier; for each of the C chunks (JAX
//   `_chain_chunks`) rank W-1 sends its partial left into staging, ranks
//   W-2 .. 1 wait, add their partial and send the sum left, and rank 0
//   waits, adds into out and starts the chunk rightwards; then ranks
//   1 .. W-2 forward each arriving chunk right and rank W-1 waits for it.
//   Reduce words are 0 .. C-1 (signalled on ranks 0 .. W-2), broadcast
//   words MAX_RANKS + c (on ranks 1 .. W-1); the wrapper keys an instance
//   by C, so every word sees the same adds in every call.  Each block adds
//   and forwards the same range of elements (`block_range`).

#include "comm_body.cuh"
#include "scatter_sum.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace comm = tdt::comm;
namespace sum = tdt::sum;

enum Method { ONE_SHOT = 0, CHAIN = 2 };

template <typename T>
struct ArArgs {
  const T* x;          // (R, elems): the launched ranks' partials
  dl::Symm<char> out;  // rank r's (elems) result
  dl::Symm<char> buf;  // one_shot: rbuf (W, elems); chain: staging (elems)
  dl::Symm<u64> sig;   // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t elems;
  int chunks;          // chain: the pipeline's chunks (C divides elems)
  u64 epoch;           // the instance's sum of P before this call
  comm::Faults faults;
};

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    one_shot_kernel(ArArgs<T> p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t);
  comm::inject_faults(t, p.faults);
  comm::emit_push_allgather(t, p.x + blockIdx.y * p.elems, p.buf,
                            p.elems * sizeof(T), p.sig, p.epoch + gridDim.x,
                            /*barrier=*/true);
  comm::reduce_sum(reinterpret_cast<const T*>(p.buf[me]),
                   reinterpret_cast<T*>(p.out[me]), t.world, p.elems,
                   blockIdx.x, gridDim.x);
}

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    chain_kernel(ArArgs<T> p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world;
  const u64 target = p.epoch + gridDim.x;
  const size_t ce = p.elems / p.chunks;
  const T* x = p.x + blockIdx.y * p.elems;
  T* stage = reinterpret_cast<T*>(p.buf[me]);
  T* stage_left = reinterpret_cast<T*>(p.buf[me > 0 ? me - 1 : 0]);
  T* out = reinterpret_cast<T*>(p.out[me]);
  T* out_right = reinterpret_cast<T*>(p.out[me < w - 1 ? me + 1 : w - 1]);
  u64* red_left = p.sig[me > 0 ? me - 1 : 0] + dl::ARRIVAL_WORD;
  u64* bcast_right =
      p.sig[me < w - 1 ? me + 1 : w - 1] + dl::ARRIVAL_WORD + dl::MAX_RANKS;
  u64* red_mine = p.sig[me] + dl::ARRIVAL_WORD;
  u64* bcast_mine = p.sig[me] + dl::ARRIVAL_WORD + dl::MAX_RANKS;
  const comm::Range r = comm::block_range(ce, blockIdx.x, gridDim.x);

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  // Reduce: partial sums flow left, chunk by chunk.
  for (int c = 0; c < p.chunks; ++c) {
    const size_t o = c * ce;
    if (me == w - 1) {
      comm::put_range(stage_left + o, x + o, r);
      u64* word = red_left + c;
      dl::signal_after_puts(&word, 1);
    } else {
      dl::wait(red_mine + c, 1, 0, target, tdt::WAIT_CHAIN_REDUCE);
      T* dst = me > 0 ? stage + o : out + o;
      comm::add_into(dst, stage + o, x + o, r);
      __syncthreads();
      if (me > 0) {
        comm::put_range(stage_left + o, dst, r);
        u64* word = red_left + c;
        dl::signal_after_puts(&word, 1);
      } else {  // rank 0 starts the chunk's broadcast at once
        comm::put_range(out_right + o, dst, r);
        u64* word = bcast_right + c;
        dl::signal_after_puts(&word, 1);
      }
    }
  }
  // Broadcast: the reduced chunks flow right.
  if (me == 0) return;
  for (int c = 0; c < p.chunks; ++c) {
    const size_t o = c * ce;
    dl::wait(bcast_mine + c, 1, 0, target, tdt::WAIT_CHAIN_BROADCAST);
    if (me < w - 1) {
      comm::put_range(out_right + o, out + o, r);
      u64* word = bcast_right + c;
      dl::signal_after_puts(&word, 1);
    }
  }
}

template <typename T>
int run(const void* x, void* const* out, void* const* buf, void* const* sig,
        int world, int base, int ranks, int method, size_t elems, int chunks,
        u64 epoch, comm::Faults f, int* blocks, cudaStream_t s) {
  ArArgs<T> p{};
  p.x = static_cast<const T*>(x);
  for (int r = 0; r < world; ++r) {
    p.out.ptr[r] = static_cast<char*>(out[r]);
    p.buf.ptr[r] = static_cast<char*>(buf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.elems = elems;
  p.chunks = chunks;
  p.epoch = epoch;
  p.faults = f;
  void* fn = method == ONE_SHOT ? reinterpret_cast<void*>(one_shot_kernel<T>)
                                : reinterpret_cast<void*>(chain_kernel<T>);
  void* args[] = {&p};
  const size_t step = method == ONE_SHOT ? world * elems : elems / chunks;
  return comm::launch_cooperative(fn, args, ranks,
                                  comm::blocks_for(step * sizeof(T)), blocks,
                                  s);
}

}  // namespace

// x (ranks, elems): the launched ranks' partials (ranks base .. base +
// ranks - 1 of a team of ``world``); ``out``, ``buf`` and ``sig``: host
// tables of ``world`` device pointers, rank r's result (elems), its
// receive or staging buffer (one_shot: (world, elems); chain: (elems)) and
// its dl::SIGNAL_WORDS u64 counters; all contiguous, in ``dtype``
// (tdt::DTYPE_*) but the counters.  ``method``: 0 one_shot, 2 chain (world
// > 1, ``chunks`` of at most MAX_RANKS dividing elems; `two_shot` has its
// own entry, `all_reduce_two_shot`).  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a
// rank of this launch go to ``*blocks``.  ``straggler`` (-1: none) spins
// ``cycles`` first; ``for_correctness`` staggers every rank.  Returns a
// cudaError_t code.
extern "C" int all_reduce(const void* x, void* const* out, void* const* buf,
                          void* const* sig, int world, int base, int ranks,
                          int method, int dtype, unsigned long long elems,
                          int chunks, unsigned long long epoch, int straggler,
                          long long cycles, int for_correctness, int* blocks,
                          void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || elems < 1 ||
      (method != ONE_SHOT && method != CHAIN) ||
      (method == CHAIN && (world < 2 || chunks < 1 ||
                           chunks > dl::MAX_RANKS || elems % chunks)))
    return (int)cudaErrorInvalidValue;
  const comm::Faults f{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(x, out, buf, sig, world, base, ranks, method, elems,
                     chunks, epoch, f, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(x, out, buf, sig, world, base, ranks, method, elems,
                      chunks, epoch, f, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// `two_shot`: as `all_reduce`, x (ranks, world, elems) as W chunks of
// ``elems``; ``out`` a table of rank r's (world, elems) result, ``rbuf`` of
// its receive buffer (world, elems), ``sig`` of its ``words`` counters (at
// least sum::TWO_SHOT_WORDS).
extern "C" int all_reduce_two_shot(const void* x, void* const* out,
                                   void* const* rbuf, void* const* sig,
                                   int words, int world, int base, int ranks,
                                   int dtype, unsigned long long elems,
                                   unsigned long long epoch, int straggler,
                                   long long cycles, int for_correctness,
                                   int* blocks, void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || elems < 1 || words < sum::TWO_SHOT_WORDS)
    return (int)cudaErrorInvalidValue;
  auto fill = [&](auto& p) {
    p.team = dl::Team{world, base};
    p.elems = elems;
    p.piece = elems;
    p.epoch = epoch;
    p.faults = comm::Faults{straggler, cycles, for_correctness};
    p.order.lanes = 1;
    p.order.len[0][0] = (unsigned char)world;
    p.order.len[0][1] = p.order.len[0][2] = 1;
    for (int g = 0; g < world; ++g)
      for (int k = 0; k < world; ++k) p.order.src[0][g][k] = (unsigned char)k;
  };
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16) {
    sum::SumArgs<bf16> p{};
    fill(p);
    void* fn =
        reinterpret_cast<void*>(sum::scatter_sum_kernel<bf16, false, 1, true>);
    return sum::launch(p, fn, x, nullptr, out, rbuf, sig, ranks, blocks, s);
  }
  if (dtype == tdt::DTYPE_F32) {
    sum::SumArgs<float> p{};
    fill(p);
    void* fn =
        reinterpret_cast<void*>(sum::scatter_sum_kernel<float, false, 1, true>);
    return sum::launch(p, fn, x, nullptr, out, rbuf, sig, ranks, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
