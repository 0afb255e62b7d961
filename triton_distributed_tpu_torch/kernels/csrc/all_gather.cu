// AllGather (K15): every rank of a team of W gets the W ranks' shards in
// rank order, out_r = [x_0; x_1; ..; x_{W-1}], byte for byte (any dtype).
//
// Replaces: triton_distributed_tpu/kernels/allgather.py `all_gather`
//   -> pallas_call :283 (`_bidir_ring_ag_kernel` :202) and :301
//   (`_ring_ag_kernel` :106, `_push_all_ag_kernel` :190 over
//   `emit_push_allgather` :150).  Layouts are the JAX wrapper's per rank:
//   the shard x_r of ``bytes`` and the gathered out_r (W, bytes), slot c
//   holding rank c's shard; the bidirectional ring splits a shard into two
//   halves of rows, (2, bytes / 2).
//
// What bounds it on the H100: bytes.  Each rank reads its shard once and
// receives W - 1 shards; on one card every receive is a copy inside one
// HBM (3.35 TB/s), which NVLink would carry between cards.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`): blockIdx.y is the rank, and its P blocks
// share each copy (16-byte `put_nbi`).  A rank waits until all P blocks of
// the sender have delivered a chunk (one arrival word a chunk, one add a
// block), so a block may forward any part of it.
// - `ring`: the neighbour entry barrier; the own shard into the own slot;
//   then for s = 0 .. W-2 the chunk c = (r - s) mod W goes to the right
//   neighbour's slot c (from the shard itself at s = 0, else from the slot
//   it arrived in), and the rank waits for chunk (r - 1 - s) mod W from the
//   left.
// - `push_all`: the entry barrier, then every rank's shard straight into
//   every rank's slot (`emit_push_allgather`, as K12's ll method).
// - `bidir_ring`: the ring on each half, half 0 rightwards (arrival words
//   0 .. W-1), half 1 leftwards (words MAX_RANKS ..); taken for an even row
//   count at W > 2, as the JAX wrapper does.

#include "comm_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;

enum Method { RING = 0, PUSH_ALL = 1, BIDIR_RING = 2 };

struct AgArgs {
  const char* x;       // (R, bytes): the launched ranks' shards
  dl::Symm<char> out;  // rank r's (W, bytes)
  dl::Symm<u64> sig;   // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t bytes;        // one shard
  u64 epoch;           // the instance's sum of P before this call
  comm::Faults faults;
};

__global__ void __launch_bounds__(comm::COMM_THREADS)
    ring_kernel(AgArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t bytes = p.bytes;
  const char* x = p.x + blockIdx.y * bytes;
  char* mine = p.out[me];
  const int right = dl::peer_id(t, me + 1);
  char* theirs = p.out[right];

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  dl::put_nbi(mine + me * bytes, x, bytes, part, parts);
  for (int s = 0; s < t.world - 1; ++s) {
    const int c = dl::peer_id(t, me - s);
    dl::put_nbi(theirs + c * bytes, s == 0 ? x : mine + c * bytes, bytes,
                part, parts);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + c;
    dl::signal_after_puts(&word, 1);
    dl::wait(p.sig[me] + dl::ARRIVAL_WORD + dl::peer_id(t, me - 1 - s), 1, 0,
             target, tdt::WAIT_ALL_GATHER_RING);
  }
}

__global__ void __launch_bounds__(comm::COMM_THREADS)
    push_all_kernel(AgArgs p) {
  const dl::Team& t = p.team;
  comm::inject_faults(t, p.faults);
  comm::emit_push_allgather(t, p.x + blockIdx.y * p.bytes, p.out, p.bytes,
                            p.sig, p.epoch + gridDim.x, /*barrier=*/true);
}

__global__ void __launch_bounds__(comm::COMM_THREADS)
    bidir_ring_kernel(AgArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t bytes = p.bytes, half = bytes / 2;
  const char* x = p.x + blockIdx.y * bytes;
  char* mine = p.out[me];
  const int right = dl::peer_id(t, me + 1), left = dl::peer_id(t, me - 1);
  constexpr int BWD = dl::ARRIVAL_WORD + dl::MAX_RANKS;

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  dl::put_nbi(mine + me * bytes, x, bytes, part, parts);
  for (int s = 0; s < t.world - 1; ++s) {
    const int fwd = dl::peer_id(t, me - s), bwd = dl::peer_id(t, me + s);
    dl::put_nbi(p.out[right] + fwd * bytes, s == 0 ? x : mine + fwd * bytes,
                half, part, parts);
    dl::put_nbi(p.out[left] + bwd * bytes + half,
                s == 0 ? x + half : mine + bwd * bytes + half, half, part,
                parts);
    u64* words[2] = {p.sig[right] + dl::ARRIVAL_WORD + fwd,
                     p.sig[left] + BWD + bwd};
    dl::signal_after_puts(words, 2);
    dl::wait(p.sig[me] + dl::ARRIVAL_WORD + dl::peer_id(t, me - 1 - s), 1, 0,
             target, tdt::WAIT_ALL_GATHER_BIDIR_RIGHT);
    dl::wait(p.sig[me] + BWD + dl::peer_id(t, me + 1 + s), 1, 0, target,
             tdt::WAIT_ALL_GATHER_BIDIR_LEFT);
  }
}

}  // namespace

// x (ranks, bytes): the launched ranks' shards (ranks base .. base + ranks
// - 1 of a team of ``world``); ``out`` and ``sig``: host tables of
// ``world`` device pointers, rank r's gathered (world, bytes) buffer and
// its dl::SIGNAL_WORDS u64 counters.  ``method``: 0 ring, 1 push_all, 2
// bidir_ring (even ``bytes``, world > 2).  ``epoch``: the instance's sum of
// blocks a rank over its earlier calls; the blocks a rank of this launch
// go to ``*blocks``.  ``straggler`` (-1: none) spins ``cycles`` first;
// ``for_correctness`` staggers every rank.  Returns a cudaError_t code.
extern "C" int all_gather(const void* x, void* const* out, void* const* sig,
                          int world, int base, int ranks, int method,
                          unsigned long long bytes, unsigned long long epoch,
                          int straggler, long long cycles,
                          int for_correctness, int* blocks, void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || bytes < 1 || method < RING ||
      method > BIDIR_RING ||
      (method == BIDIR_RING && (world <= 2 || bytes % 2)))
    return (int)cudaErrorInvalidValue;
  AgArgs p{};
  p.x = static_cast<const char*>(x);
  for (int r = 0; r < world; ++r) {
    p.out.ptr[r] = static_cast<char*>(out[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.bytes = bytes;
  p.epoch = epoch;
  p.faults = comm::Faults{straggler, cycles, for_correctness};
  void* fn = method == RING ? reinterpret_cast<void*>(ring_kernel)
             : method == PUSH_ALL ? reinterpret_cast<void*>(push_all_kernel)
                                  : reinterpret_cast<void*>(bidir_ring_kernel);
  void* args[] = {&p};
  return comm::launch_cooperative(
      fn, args, ranks,
      comm::blocks_for(method == PUSH_ALL ? world * bytes : bytes), blocks,
      static_cast<cudaStream_t>(stream));
}
