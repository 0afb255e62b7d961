// AllToAll (K19): the low-latency token exchange of expert parallelism.
// Rank r sends block p of its capacity-padded send buffer (cap rows of
// ``row_bytes``) with its count and, optionally, its scale rows to rank p,
// which receives it in slot r: recv_p[r] = send_r[p], byte for byte (any
// dtype), the whole capacity block, so rows past the count are the sender's
// bytes as on the TPU.
//
// Replaces: triton_distributed_tpu/kernels/low_latency_all_to_all.py
//   `fast_all_to_all` -> `_a2a_kernel` (:74, pallas_call :211).  Layouts are
//   the JAX kernel's per rank: send (W, cap, hidden), counts (W, 1) int32,
//   scales (W, cap, ns); the JAX wrapper pads counts to 128 lanes and scales
//   to a multiple of 128 for Mosaic (:166-189), which this kernel does not
//   need: every payload is copied at its own width.
//
// What bounds it on the H100: bytes.  Every rank's send buffer is read
// once and every receive block written once; on one card each put is a
// copy inside one HBM (3.35 TB/s) that NVLink would carry between cards.
//
// Design (K15's push_all with one block per destination; a first kernel
// that is right).  One cooperative launch holds every rank's blocks
// (`dl.cuh`): blockIdx.y is the rank, and its P blocks share each copy.
// - The entry barrier (all ranks): a peer's receive buffer is written only
//   after the peer has entered this call, so the previous call's readers
//   are done with it (with one process a GPU they may still run).
// - For each destination p (the own rank included, the JAX kernel's local
//   copy) the block's share of the token block, the count and the scale
//   rows go to slot r of rank p's buffers (`dl::put_nbi`: 16- or 4-byte
//   units as the two addresses allow, else bytes; an f32 scale row of width
//   1 is 4 bytes).
// - One arrival signal a block to each destination (`signal_after_puts`,
//   the put-with-signal of the TPU's DMA semaphore), then the block waits
//   until every source rank's P blocks have delivered.  Signals are the
//   monotonic epoch counters of `dl.cuh`, never reset, so back-to-back
//   calls need no parity.

#include "comm_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;

struct A2aArgs {
  const char* send;        // (R, W, cap * row_bytes): launched ranks' sends
  const char* counts;      // (R, W, count_bytes)
  const char* scales;      // (R, W, cap * scale_row_bytes) or null
  dl::Symm<char> recv;     // rank r's (W, cap * row_bytes)
  dl::Symm<char> rcounts;  // rank r's (W, count_bytes)
  dl::Symm<char> rscales;  // rank r's (W, cap * scale_row_bytes) or null
  dl::Symm<u64> sig;       // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t block_bytes;      // cap * row_bytes
  size_t count_bytes;      // one count row
  size_t scale_bytes;      // cap * scale_row_bytes (0: no scales)
  u64 epoch;               // the instance's sum of P before this call
  comm::Faults faults;
};

__global__ void __launch_bounds__(comm::COMM_THREADS)
    all_to_all_kernel(A2aArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const int W = t.world;
  const char* send = p.send + (size_t)blockIdx.y * W * p.block_bytes;
  const char* counts = p.counts + (size_t)blockIdx.y * W * p.count_bytes;
  const char* scales =
      p.scales ? p.scales + (size_t)blockIdx.y * W * p.scale_bytes : nullptr;

  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  // Destinations in the order me, me + 1, ..: the local block first, then
  // one peer after another (the JAX kernel's put order).
  for (int i = 0; i < W; ++i) {
    const int dst = dl::peer_id(t, me + i);
    dl::put_nbi(p.recv[dst] + me * p.block_bytes,
                send + dst * p.block_bytes, p.block_bytes, part, parts);
    if (part == 0)
      dl::put_nbi(p.rcounts[dst] + me * p.count_bytes,
                  counts + dst * p.count_bytes, p.count_bytes, 0, 1);
    if (scales)
      dl::put_nbi(p.rscales[dst] + me * p.scale_bytes,
                  scales + dst * p.scale_bytes, p.scale_bytes, part, parts);
  }
  u64* words[dl::MAX_RANKS];
  for (int q = 0; q < W; ++q) words[q] = p.sig[q] + dl::ARRIVAL_WORD + me;
  dl::signal_after_puts(words, W);
  dl::wait(p.sig[me] + dl::ARRIVAL_WORD, W, 1, target,
           "all_to_all arrival");
}

}  // namespace

// send (ranks, world, block_bytes), counts (ranks, world, count_bytes) and
// scales (ranks, world, scale_bytes, or null): the launched ranks' (ranks
// base .. base + ranks - 1 of a team of ``world``) per-destination blocks;
// ``recv``, ``rcounts``, ``rscales`` (null without scales) and ``sig``:
// host tables of ``world`` device pointers, rank r's receive buffers (world
// slots each) and its dl::SIGNAL_WORDS u64 counters.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a rank
// of this launch go to ``*blocks``.  ``straggler`` (-1: none) spins
// ``cycles`` first; ``for_correctness`` staggers every rank.  Returns a
// cudaError_t code.
extern "C" int all_to_all(const void* send, const void* counts,
                          const void* scales, void* const* recv,
                          void* const* rcounts, void* const* rscales,
                          void* const* sig, int world, int base, int ranks,
                          unsigned long long block_bytes,
                          unsigned long long count_bytes,
                          unsigned long long scale_bytes,
                          unsigned long long epoch, int straggler,
                          long long cycles, int for_correctness, int* blocks,
                          void* stream) {
  *blocks = 0;
  if (world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || block_bytes < 1 || count_bytes < 1 ||
      (scales != nullptr) != (scale_bytes > 0) ||
      (scales != nullptr && rscales == nullptr))
    return (int)cudaErrorInvalidValue;
  A2aArgs p{};
  p.send = static_cast<const char*>(send);
  p.counts = static_cast<const char*>(counts);
  p.scales = static_cast<const char*>(scales);
  for (int r = 0; r < world; ++r) {
    p.recv.ptr[r] = static_cast<char*>(recv[r]);
    p.rcounts.ptr[r] = static_cast<char*>(rcounts[r]);
    p.rscales.ptr[r] = scales ? static_cast<char*>(rscales[r]) : nullptr;
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.block_bytes = block_bytes;
  p.count_bytes = count_bytes;
  p.scale_bytes = scale_bytes;
  p.epoch = epoch;
  p.faults = comm::Faults{straggler, cycles, for_correctness};
  void* args[] = {&p};
  return comm::launch_cooperative(
      reinterpret_cast<void*>(all_to_all_kernel), args, ranks,
      comm::blocks_for(world * (block_bytes + scale_bytes)), blocks,
      static_cast<cudaStream_t>(stream));
}
