// Barrier and broadcast (K18) over a team of W ranks.
//
// Replaces: triton_distributed_tpu/kernels/common_ops.py
//   `barrier_all_on_axis` -> pallas_call :52 (`_barrier_kernel` :38: the
//   barrier, then a local copy of x, the data dependency that orders what
//   follows) and `broadcast` -> pallas_call :91 (`_broadcast_kernel` :71:
//   the entry barrier, then `dl.emit_broadcast`, language/core.py :247).
//   Layouts are the JAX wrappers' per rank: x_r and out_r of ``bytes``.
//
// What bounds it on the H100: bytes.  The barrier copies each rank's x
// into its out (its round trip of signals is a few microseconds); the
// broadcast reads the root's x and writes it into W outputs, each a copy
// inside one HBM on one card.
//
// Design (redesigned for Hopper).  One cooperative launch holds every
// rank's P blocks (`dl.cuh`).
// - The team barrier takes one add of P from block 0 of each rank to each
//   peer's word (`dl::team_arrive`): W (W - 1) remote adds a call, not
//   W (W - 1) P.
// - `barrier_kernel`: the arrival, then the block's share of the copy of x
//   by the threads' copies of `dl::put_nbi`, then the wait, so the copy
//   runs while the ranks arrive.  No rank's kernel ends before every rank
//   has arrived; the function is the JAX kernel's, which waits, then
//   copies.  Its blocks are at most BARRIER_BLOCKS_PER_SM an SM, every
//   rank's together: a copy of 16 MiB a rank by every block that fits (8
//   an SM) lost to the first body, its streams contending for HBM
//   (PERF.md, `scripts/torch_collectives_ab.py --variants`).
// - `broadcast_kernel`: the root's blocks copy by bulk copies
//   (`cp.async.bulk` global -> shared -> global, `comm::bulk_runs`) through
//   4 x 8 KB of shared memory, issued by one thread a block, each reading
//   its share of x into shared memory once and bulk-storing it into all W
//   outputs, its own included; x off 16 bytes takes the threads' copies of
//   `dl::put_nbi`.  The root is read from device memory in every call (a
//   0-d int32 tensor: the kernel is not specialised on it); a root outside
//   the team traps at once instead of leaving the others waiting.  After
//   the team barrier, block b of the root, its stores done, adds P to its
//   words b, b + P, .. of the arrival bank at every rank, its own too
//   (`comm::signal_blocks`), so every word receives adds summing to P in
//   every call whichever rank is the root and whatever P is; block b of
//   every rank waits only for word b (the root's block b, which wrote its
//   part of the rank's out).  On an H100 80GB HBM3 at 700 W this form beat
//   a scatter of the root's chunks followed by an all-gather of them (every
//   rank's blocks copying, the root reading x once and sending it once) at
//   every payload measured, 0.0474 against 0.0507 ms at 4 x 2048 x 4096
//   bf16 a rank and 0.0104 against 0.0166 at 4 x 64 x 1024 (PERF.md,
//   `scripts/torch_collectives_ab.py --variants` `gather`): on one card the
//   gather's second hop costs more than the root's W - 1 extra stores.  On
//   a real node the root's link would carry x W - 1 times (not measured).
//   The first body (the root's blocks pushing x into every out by thread
//   copies, every block of every rank adding to each peer's barrier word)
//   took 0.0636 ms at 4 x 2048 x 4096 (0.0777 in PERF.md's earlier runs),
//   the barrier 0.0615.

#include "comm_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;
using comm::MAX_BLOCKS;

//: The broadcast's words a rank: the barrier word, the local word, then
//: the arrival bank (word g: the root's block g delivered).
constexpr int BROADCAST_WORDS = dl::ARRIVAL_WORD + MAX_BLOCKS;
//: The barrier's blocks an SM at most, every launched rank's together
//: (`launch_cooperative`'s ``per_sm``).
constexpr int BARRIER_BLOCKS_PER_SM = 2;

struct CommonArgs {
  const char* x;         // (R, bytes)
  dl::Symm<char> out;    // rank r's (bytes)
  const int* root;       // broadcast: the root rank (device memory)
  dl::Symm<u64> sig;     // rank r's counters
  dl::Team team;
  size_t bytes;
  u64 epoch;             // the instance's sum of P before this call
  int bulk;              // broadcast: x and every out on 16 bytes, bytes too
  int bank;              // broadcast: words a bank in use
  comm::Faults faults;
};

__global__ void __launch_bounds__(comm::COMM_THREADS)
    barrier_kernel(const __grid_constant__ CommonArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t);
  comm::inject_faults(t, p.faults);
  dl::team_arrive(t, p.sig);
  const comm::Range r = comm::share(p.bytes, 16, blockIdx.x, gridDim.x);
  dl::put_nbi(p.out[me] + r.lo, p.x + blockIdx.y * p.bytes + r.lo,
              r.hi - r.lo, 0, 1);
  dl::team_wait(t, p.sig, p.epoch + gridDim.x);
}

__global__ void __launch_bounds__(comm::COMM_THREADS)
    broadcast_kernel(const __grid_constant__ CommonArgs p) {
  extern __shared__ __align__(128) uint8_t stage[];
  __shared__ uint64_t bar[comm::STAGE_BUFS];
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world;
  const u64 target = p.epoch + gridDim.x;
  const bool bulk = p.bulk != 0;
  const int root = *p.root;
  if (root < 0 || root >= w)
    tdt::spin_timeout(tdt::WAIT_BROADCAST_ROOT, p.root, w, root);
  comm::Staging s = comm::staging(stage, bar);
  comm::inject_faults(t, p.faults);
  dl::team_arrive(t, p.sig);
  dl::team_wait(t, p.sig, target);
  // The root's block b: its share of x into every rank's out.
  if (me == root) {
    const comm::Range r = comm::share(p.bytes, 16, blockIdx.x, gridDim.x);
    comm::copy_fan(s, bulk, p.x + blockIdx.y * p.bytes + r.lo, r.hi - r.lo,
                   w, [&](int d) { return p.out[d] + r.lo; });
    dl::fence<dl::Scope::gpu>();
    __syncthreads();
    comm::signal_blocks(w, p.bank,
                        [&](int c) { return p.sig[c] + dl::ARRIVAL_WORD; });
  }
  // Block b waits only for the root's block b.
  if (threadIdx.x == 0)
    dl::signal_wait_until(p.sig[me] + dl::ARRIVAL_WORD + blockIdx.x, target,
                          tdt::WAIT_BROADCAST_ARRIVAL);
  __syncthreads();
}

// ``moved``: the bytes a rank's blocks copy, which sets their number, at
// most ``cap`` a rank and ``per_sm`` an SM (0: as many as fit); ``smem``:
// the dynamic shared memory a block.
int launch(void* fn, size_t smem, const void* x, void* const* out,
           const int* root, void* const* sig, int world, int base, int ranks,
           size_t bytes, size_t moved, int cap, int per_sm, u64 epoch,
           comm::Faults f, int* blocks, cudaStream_t s) {
  CommonArgs p{};
  p.x = static_cast<const char*>(x);
  p.root = root;
  uintptr_t align = reinterpret_cast<uintptr_t>(x) | bytes;
  for (int r = 0; r < world; ++r) {
    p.out.ptr[r] = static_cast<char*>(out[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(out[r]);
  }
  p.team = dl::Team{world, base};
  p.bytes = bytes;
  p.epoch = epoch;
  p.bulk = align % 16 == 0;
  p.faults = f;
  void* args[] = {&p};
  const int want = comm::blocks_for(moved);
  return comm::launch_cooperative(fn, args, ranks, want < cap ? want : cap,
                                  blocks, s, smem, &p.bank, per_sm);
}

bool bad_team(int world, int base, int ranks) {
  return world < 1 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
         base + ranks > world;
}

}  // namespace

// x (ranks, bytes): the launched ranks' data (ranks base .. base + ranks -
// 1 of a team of ``world``); ``out`` and ``sig``: host tables of ``world``
// device pointers, rank r's (bytes) output and its dl::SIGNAL_WORDS u64
// counters.  Every rank waits for every other, and copies its x to its
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
  return launch(reinterpret_cast<void*>(barrier_kernel), 0, x, out,
                nullptr, sig, world, base, ranks, bytes, bytes, 1 << 30,
                BARRIER_BLOCKS_PER_SM, epoch,
                comm::Faults{straggler, cycles, for_correctness}, blocks,
                static_cast<cudaStream_t>(stream));
}

// As `barrier_all_on_axis`, but every rank's out gets the x of the rank
// that ``root`` (a device int32) names; ``bytes`` >= 1; ``words`` counters
// a rank (at least BROADCAST_WORDS, `kernels/common_ops.py`).
extern "C" int broadcast(const void* x, void* const* out, const void* root,
                         void* const* sig, int words, int world, int base,
                         int ranks, unsigned long long bytes,
                         unsigned long long epoch, int straggler,
                         long long cycles, int for_correctness, int* blocks,
                         void* stream) {
  *blocks = 0;
  if (bad_team(world, base, ranks) || bytes < 1 || root == nullptr ||
      words < BROADCAST_WORDS)
    return (int)cudaErrorInvalidValue;
  return launch(reinterpret_cast<void*>(broadcast_kernel), comm::STAGE_SMEM,
                x, out, static_cast<const int*>(root), sig, world, base,
                ranks, bytes, world * bytes, MAX_BLOCKS, 0, epoch,
                comm::Faults{straggler, cycles, for_correctness}, blocks,
                static_cast<cudaStream_t>(stream));
}
