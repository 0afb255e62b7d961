// ReduceScatter (K16): rank c of a team of W gets chunk c of the sum of the
// W ranks' partials, out_c = sum over r of x_r[c].
//
// Replaces: triton_distributed_tpu/kernels/reduce_scatter.py
//   `reduce_scatter` -> pallas_call :295 (`_scatter_reduce_kernel` :184
//   over `emit_scatter_reduce` :144) and :314 (`_ring_rs_kernel` :197,
//   adding with `emit_add_into` :120).  Layouts are the JAX wrapper's per
//   rank: the partials x_r (W, elems) as W chunks, out_r (elems); the
//   scatter's receive buffer rbuf_r (W, elems), slot w holding rank w's
//   partial of chunk r; the ring's staging_r and accum_r (2, elems), in x's
//   dtype as the JAX buffers are.
//
// Numerics, as the JAX kernels: `scatter_reduce` sums the W partials in f32
// in rank order 0 .. W-1 and rounds once (`reduce_sum`); the ring adds one
// hop at a time in f32 and rounds to x's dtype at every hop, chunk c's sum
// running x_{c+1}, + x_{c+2}, .., + x_c.
//
// What bounds it on the H100: bytes.  Each rank reads its W chunks once
// and receives W - 1 of them (summed, or staged and added); on one card
// every receive is a copy inside one HBM.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`); each rank's P blocks share its copies
// and sums.
// - `scatter_reduce`: the entry barrier, then `emit_scatter_reduce` (K14's
//   ll body): chunk c to slot r of rank c's rbuf, one arrival word a
//   source rank, the wait, the sum.
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

#include "comm_body.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace comm = tdt::comm;

enum Method { SCATTER_REDUCE = 0, RING = 1 };

template <typename T>
struct RsArgs {
  const T* x;          // (R, W, elems): the launched ranks' partials
  T* out;              // (R, elems)
  dl::Symm<char> buf;  // scatter_reduce: rank r's rbuf (W, elems);
                       // ring: its staging (2, elems)
  T* accum;            // ring: (R, 2, elems), the running sums sent on
  dl::Symm<u64> sig;   // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t elems;        // one chunk
  u64 epoch;           // the instance's sum of P before this call
  comm::Faults faults;
};

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    scatter_reduce_kernel(RsArgs<T> p) {
  const dl::Team& t = p.team;
  const int y = blockIdx.y;
  comm::inject_faults(t, p.faults);
  comm::emit_scatter_reduce<T>(t, p.x + (size_t)y * t.world * p.elems,
                               p.out + y * p.elems, p.buf, p.elems, p.sig,
                               p.epoch + gridDim.x, /*barrier=*/true);
}

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    ring_kernel(RsArgs<T> p) {
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
      dl::wait(p.sig[me] + ACK + s - 2, 1, 0, target, "reduce_scatter ack");
    const T* src = s == 0 ? x + dl::peer_id(t, me - 1 - s) * elems
                          : acc + slot * elems;
    comm::put_range(stage_right + slot * elems, src, r);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + s;
    dl::signal_after_puts(&word, 1);
    dl::wait(p.sig[me] + dl::ARRIVAL_WORD + s, 1, 0, target,
             "reduce_scatter ring arrival");
    T* dst = s < w - 2 ? acc + (1 - slot) * elems : p.out + y * elems;
    comm::add_into(dst, stage + slot * elems,
                   x + dl::peer_id(t, me - 2 - s) * elems, r);
    // The slot is free again (this block's reads of it are done), and
    // the block's sums are stored before the next step forwards them.
    u64* ack = p.sig[left] + ACK + s;
    dl::signal_after_puts(&ack, 1);
  }
  for (int s = w - 3 < 0 ? 0 : w - 3; s < w - 1; ++s)
    dl::wait(p.sig[me] + ACK + s, 1, 0, target, "reduce_scatter ack drain");
}

template <typename T>
int run(const void* x, void* out, void* const* buf, void* accum,
        void* const* sig, int world, int base, int ranks, int method,
        size_t elems, u64 epoch, comm::Faults f, int* blocks,
        cudaStream_t s) {
  RsArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.accum = static_cast<T*>(accum);
  for (int r = 0; r < world; ++r) {
    p.buf.ptr[r] = static_cast<char*>(buf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.elems = elems;
  p.epoch = epoch;
  p.faults = f;
  void* fn = method == RING ? reinterpret_cast<void*>(ring_kernel<T>)
                            : reinterpret_cast<void*>(scatter_reduce_kernel<T>);
  void* args[] = {&p};
  const size_t step = (method == RING ? 1 : world) * elems * sizeof(T);
  return comm::launch_cooperative(fn, args, ranks, comm::blocks_for(step),
                                  blocks, s);
}

}  // namespace

// x (ranks, world, elems): the launched ranks' partials (ranks base .. base
// + ranks - 1 of a team of ``world``), chunk c for rank c; out (ranks,
// elems); ``buf`` and ``sig``: host tables of ``world`` device pointers,
// rank r's receive buffer (scatter_reduce: (world, elems); ring: the
// staging (2, elems)) and its dl::SIGNAL_WORDS u64 counters; ``accum``
// (ranks, 2, elems), read and written by the ring only; all contiguous, in
// ``dtype`` (tdt::DTYPE_*) but the counters.  ``method``: 0
// scatter_reduce, 1 ring.  ``epoch``: the instance's sum of blocks a rank
// over its earlier calls; the blocks a rank of this launch go to
// ``*blocks``.  ``straggler`` (-1: none) spins ``cycles`` first;
// ``for_correctness`` staggers every rank.  Returns a cudaError_t code.
extern "C" int reduce_scatter(const void* x, void* out, void* const* buf,
                              void* accum, void* const* sig, int world,
                              int base, int ranks, int method, int dtype,
                              unsigned long long elems,
                              unsigned long long epoch, int straggler,
                              long long cycles, int for_correctness,
                              int* blocks, void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || elems < 1 ||
      (method != SCATTER_REDUCE && method != RING) ||
      (method == RING && (world < 2 || accum == nullptr)))
    return (int)cudaErrorInvalidValue;
  const comm::Faults f{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(x, out, buf, accum, sig, world, base, ranks, method,
                     elems, epoch, f, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(x, out, buf, accum, sig, world, base, ranks, method,
                      elems, epoch, f, blocks, s);
  return (int)cudaErrorInvalidValue;
}
