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
// Design of K16 `scatter_reduce` and K21b: the scatter-then-sum body of
// scatter_sum.cuh (`tdt::sum::scatter_sum_kernel`), which K17 `two_shot`
// shares: every foreign piece bulk-copied straight into its owner's receive
// slot, arrival words paired by range, then one ordered sum.
//
// Design of `ring`: the neighbour entry barrier; for s = 0 .. W-2 the rank
// sends chunk (r - 1 - s) mod W (its own partial at s = 0, else its running
// sum) into staging slot s % 2 of its right neighbour, waits for the
// left's delivery into its own slot, adds its partial of chunk
// (r - 2 - s) mod W into the other accum slot (into out at the last
// step) and acks the left neighbour.  From step 2 on a rank writes a
// slot of its right neighbour only after that neighbour has acked the
// step that last filled it (the JAX two-slot flow control); the last two
// acks are drained before the kernel ends.  Arrival and ack words are
// one a step (words s and MAX_RANKS + s), so every word sees one add
// from each block in every call.  Each block adds and forwards the same
// range of elements (`block_range`), so it never forwards a sum that
// another block is still writing.

#include "comm_body.cuh"
#include "scatter_sum.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace comm = tdt::comm;
namespace sum = tdt::sum;

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


template <typename T>
int run_ring(const void* x, void* out, void* const* staging, void* accum,
             void* const* sig, int world, int base, int ranks, size_t elems,
             u64 epoch, comm::Faults f, int* blocks, cudaStream_t s) {
  RingArgs<T> p{};
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.accum = static_cast<T*>(accum);
  for (int r = 0; r < world; ++r) {
    p.buf.ptr[r] = static_cast<char*>(staging[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
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
// buffer (world, elems); ``words`` counters a rank (at least
// sum::SUM_WORDS);
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
      lanes > sum::MAX_LANES || (unsigned long long)lanes * piece < elems ||
      words < sum::SUM_WORDS)
    return (int)cudaErrorInvalidValue;
  sum::Order o{};
  o.lanes = lanes;
  int levels = 1;  // the deepest level with a chain of more than one
  for (int q = 0; q < lanes; ++q) {
    int prod = 1;
    for (int l = 0; l < sum::MAX_LEVELS; ++l) {
      const int n = lens[q * sum::MAX_LEVELS + l];
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
    sum::SumArgs<bf16> p{};
    fill(p);
    void* fn = round_each ? sum::kernel<bf16, true>(levels)
                          : sum::kernel<bf16, false>(levels);
    return sum::launch(p, fn, x, out, nullptr, rbuf, sig, ranks, blocks, s);
  }
  if (dtype == tdt::DTYPE_F32) {
    sum::SumArgs<float> p{};
    fill(p);
    void* fn = round_each ? sum::kernel<float, true>(levels)
                          : sum::kernel<float, false>(levels);
    return sum::launch(p, fn, x, out, nullptr, rbuf, sig, ranks, blocks, s);
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
