// Barrier and broadcast (K18) over a team of W ranks.
//
// Replaces: triton_distributed_tpu/kernels/common_ops.py
//   `barrier_all_on_axis` -> pallas_call :52 (`_barrier_kernel` :38: the
//   barrier, then a local copy of x, the data dependency that orders what
//   follows) and `broadcast` -> pallas_call :91 (`_broadcast_kernel` :71:
//   the entry barrier, then `dl.emit_broadcast`, language/core.py :247).
//   Layouts are the JAX wrappers' per rank: x_r and out_r of ``bytes``.
//
// What bounds it on the H100: the barrier's round trip of signals (a few
// microseconds) and the copy of x (bytes); the broadcast's bytes, the
// root's x read once and written into W outputs, each a copy inside one
// HBM on one card.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`).  `barrier_all` has every block signal
// every peer once and wait for all of theirs, then the blocks share the
// copy.  The broadcast reads its root from device memory in every call
// (a 0-d int32 tensor: the kernel is not specialised on it), runs the
// entry barrier, then the root's blocks push x into every rank's out and
// add one to every rank's arrival word, its own too, so each word sees the
// same adds whichever rank is the root; every rank waits on its word.  A
// root outside the team traps at once instead of leaving the others
// waiting.

#include "comm_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;

struct CommonArgs {
  const char* x;         // (R, bytes)
  dl::Symm<char> out;    // rank r's (bytes)
  const int* root;       // broadcast: the root rank (device memory)
  dl::Symm<u64> sig;     // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  size_t bytes;
  u64 epoch;             // the instance's sum of P before this call
  comm::Faults faults;
};

__global__ void __launch_bounds__(comm::COMM_THREADS)
    barrier_kernel(CommonArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t);
  comm::inject_faults(t, p.faults);
  dl::barrier_all(t, p.sig, p.epoch + gridDim.x);
  dl::put_nbi(p.out[me], p.x + blockIdx.y * p.bytes, p.bytes, blockIdx.x,
              gridDim.x);
}

__global__ void __launch_bounds__(comm::COMM_THREADS)
    broadcast_kernel(CommonArgs p) {
  const dl::Team& t = p.team;
  const u64 target = p.epoch + gridDim.x;
  const int root = *p.root;
  if (root < 0 || root >= t.world)
    tdt::spin_timeout(tdt::WAIT_BROADCAST_ROOT, p.root, t.world, root);
  comm::inject_faults(t, p.faults);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  dl::emit_broadcast(t, root, p.x + blockIdx.y * p.bytes, p.out, p.bytes,
                     p.sig, dl::ARRIVAL_WORD, target);
}

// ``moved``: the bytes a rank's blocks copy, which sets their number.
int launch(void* fn, const void* x, void* const* out, const int* root,
           void* const* sig, int world, int base, int ranks, size_t bytes,
           size_t moved, u64 epoch, comm::Faults f, int* blocks,
           cudaStream_t s) {
  CommonArgs p{};
  p.x = static_cast<const char*>(x);
  p.root = root;
  for (int r = 0; r < world; ++r) {
    p.out.ptr[r] = static_cast<char*>(out[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.bytes = bytes;
  p.epoch = epoch;
  p.faults = f;
  void* args[] = {&p};
  return comm::launch_cooperative(fn, args, ranks, comm::blocks_for(moved),
                                  blocks, s);
}

bool bad_team(int world, int base, int ranks) {
  return world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
         base + ranks > world;
}

}  // namespace

// x (ranks, bytes): the launched ranks' data (ranks base .. base + ranks -
// 1 of a team of ``world``); ``out`` and ``sig``: host tables of ``world``
// device pointers, rank r's (bytes) output and its dl::SIGNAL_WORDS u64
// counters.  Every rank waits for every other, then copies its x to its
// out.  ``epoch``: the instance's sum of blocks a rank over its earlier
// calls; the blocks a rank of this launch go to ``*blocks``.
// ``straggler`` (-1: none) spins ``cycles`` first; ``for_correctness``
// staggers every rank.  Returns a cudaError_t code.
extern "C" int barrier_all_on_axis(const void* x, void* const* out,
                                   void* const* sig, int world, int base,
                                   int ranks, unsigned long long bytes,
                                   unsigned long long epoch, int straggler,
                                   long long cycles, int for_correctness,
                                   int* blocks, void* stream) {
  *blocks = 0;
  if (bad_team(world, base, ranks)) return (int)cudaErrorInvalidValue;
  return launch(reinterpret_cast<void*>(barrier_kernel), x, out, nullptr,
                sig, world, base, ranks, bytes, bytes, epoch,
                comm::Faults{straggler, cycles, for_correctness}, blocks,
                static_cast<cudaStream_t>(stream));
}

// As `barrier_all_on_axis`, but every rank's out gets the x of the rank
// that ``root`` (a device int32) names; ``bytes`` >= 1.
extern "C" int broadcast(const void* x, void* const* out, const void* root,
                         void* const* sig, int world, int base, int ranks,
                         unsigned long long bytes, unsigned long long epoch,
                         int straggler, long long cycles,
                         int for_correctness, int* blocks, void* stream) {
  *blocks = 0;
  if (bad_team(world, base, ranks) || bytes < 1 || root == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch(reinterpret_cast<void*>(broadcast_kernel), x, out,
                static_cast<const int*>(root), sig, world, base, ranks, bytes,
                world * bytes, epoch,
                comm::Faults{straggler, cycles, for_correctness}, blocks,
                static_cast<cudaStream_t>(stream));
}
