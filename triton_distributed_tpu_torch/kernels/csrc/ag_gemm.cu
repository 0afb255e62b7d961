// AllGather-GEMM: out_r = all_gather(a) @ b_r on every rank r of a team of
// W, with f32 accumulation, written in the activations' type.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py `ag_gemm`
//   -> pallas_call :329: `_ag_gemm_fused_kernel` (:164, the ring of
//   `_emit_ag_ring` :122) and `_ag_gemm_ll_kernel` (:175, the one-shot
//   push of allgather.py `emit_push_allgather` :150, then one chunked
//   matmul).  Layouts are the JAX wrapper's per rank: the shard a_r
//   (mp, k), the weight shard b_r (k, n), the gathered A (W, mp, k) and
//   out_r (W * mp, n), chunk c of out_r being rank c's rows.
//
// What bounds it on the H100: Qwen3-8B prefill at world 4 gathers 4 x 512
// rows of 4096 and multiplies them by b_r of (4096, 1536) (QKV) or (4096,
// 6144) (gate_up): 25.8 / 103 GFLOP a rank, the tensor cores.  A decode
// step gathers 4 rows and streams b_r: bytes.  On one card the W ranks
// share its 132 SMs and one HBM, so the gather's copies cost HBM bandwidth
// that NVLink would carry between cards.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`): blockIdx.y is the rank, and each rank's
// P persistent blocks stride over its GEMM tiles (`gemm_tile.cuh`, the
// K6/K8 body) and share its copies.  The cooperative launch guarantees that
// every block is resident, so a block that spins on a peer's signal never
// starves the peer; a grid that cannot be resident is refused, never run
// partly.
// - `fused` (the ring): the neighbour entry barrier; the own shard into the
//   own slot and the right neighbour's (a put and one arrival signal a
//   block); the own chunk's GEMM tiles, read from the shard itself; then
//   for s = 1 .. W-1 the chunk c = (r - s) mod W: wait until all P blocks
//   of the left neighbour have delivered it, forward it to the right
//   neighbour unless s = W-1, and compute its tiles.  A block forwards
//   before it computes, so the copy of step s overlaps the GEMM of the
//   blocks still at step s - 1 (`comm_body.cuh` `emit_ag_ring`, shared
//   with K11 and K13).
// - `ll`: the entry barrier, the push all-gather (every rank's shard into
//   every rank's slot), then one GEMM over the W * mp gathered rows, which
//   reads b_r once (the decode regime).
// Padded rows (the wrapper pads m to the row tile with zeros) are gathered
// and multiplied like any row and sliced off by the wrapper.

#include "comm_body.cuh"
#include "gemm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;

template <typename T>
struct AgArgs {
  const T* a;               // (R, mp, k): the shards of the launched ranks
  const T* b;               // (R, k, n): their weight shards
  T* out;                   // (R, W * mp, n)
  dl::Symm<char> gathered;  // rank r's (W, mp, k)
  dl::Symm<u64> sig;        // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int mp, n, k, vec;
  u64 epoch;                // the instance's sum of P before this call
};

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    ag_gemm_fused_kernel(AgArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int w = t.world, y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t chunk = (size_t)p.mp * p.k;
  const size_t out_chunk = (size_t)p.mp * p.n;
  const T* b = p.b + (size_t)y * p.k * p.n;
  T* out = p.out + y * w * out_chunk;
  tdt::comm::emit_ag_ring(
      t, p.a + y * chunk, p.gathered, chunk * sizeof(T), p.sig, target,
      "ag_gemm ring arrival", [&](int c, const char* held) {
        gemm::run_tiles<Tile>(sm, reinterpret_cast<const T*>(held), b,
                              out + c * out_chunk, p.mp, p.n, p.k, p.vec,
                              part, parts);
      });
}

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    ag_gemm_ll_kernel(AgArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), y = blockIdx.y;
  const u64 target = p.epoch + gridDim.x;
  const size_t chunk = (size_t)p.mp * p.k;
  tdt::comm::emit_push_allgather(t, p.a + y * chunk, p.gathered,
                                 chunk * sizeof(T), p.sig, target,
                                 /*barrier=*/true);
  gemm::run_tiles<Tile>(sm, reinterpret_cast<const T*>(p.gathered[me]),
                        p.b + (size_t)y * p.k * p.n,
                        p.out + (size_t)y * t.world * p.mp * p.n,
                        t.world * p.mp, p.n, p.k, p.vec, blockIdx.x,
                        gridDim.x);
}

// P blocks a rank: as many as the GEMM step has tiles, at most as many as
// can be resident together with every other rank's; then one cooperative
// launch.
template <class Tile>
int launch(AgArgs<typename Tile::In> p, int ranks, int ll, int* blocks,
           cudaStream_t s) {
  void* fn = ll ? reinterpret_cast<void*>(ag_gemm_ll_kernel<Tile>)
                : reinterpret_cast<void*>(ag_gemm_fused_kernel<Tile>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Tile::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = gemm::tiles<Tile>(ll ? p.team.world * p.mp : p.mp, p.n);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Tile::NT),
                                          args, 0, s);
}

template <typename T>
int dispatch(AgArgs<T> p, int ranks, int ll, int* blocks, cudaStream_t s);

template <>
int dispatch<bf16>(AgArgs<bf16> p, int ranks, int ll, int* blocks,
                   cudaStream_t s) {
  const int rows = ll ? p.team.world * p.mp : p.mp;
  if (rows <= 16) return launch<gemm::Bf16Tile16>(p, ranks, ll, blocks, s);
  if (rows <= 64) return launch<gemm::Bf16Tile64>(p, ranks, ll, blocks, s);
  return launch<gemm::Bf16Tile128>(p, ranks, ll, blocks, s);
}

template <>
int dispatch<float>(AgArgs<float> p, int ranks, int ll, int* blocks,
                    cudaStream_t s) {
  return launch<gemm::F32Tile>(p, ranks, ll, blocks, s);
}

template <typename T>
int run(const void* a, const void* b, void* out, void* const* gathered,
        void* const* sig, int world, int base, int ranks, int ll, int mp,
        int n, int k, u64 epoch, int* blocks, cudaStream_t s) {
  AgArgs<T> p{};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.out = static_cast<T*>(out);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  p.team = dl::Team{world, base};
  p.mp = mp;
  p.n = n;
  p.k = k;
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  p.epoch = epoch;
  return dispatch<T>(p, ranks, ll, blocks, s);
}

}  // namespace

// a (ranks, mp, k) and b (ranks, k, n): the launched ranks' shards (ranks
// base .. base + ranks - 1 of a team of ``world``); out (ranks, world * mp,
// n); ``gathered`` and ``sig``: host tables of ``world`` device pointers,
// rank r's gathered (world, mp, k) buffer and its dl::SIGNAL_WORDS u64
// counters; all contiguous, in ``dtype`` (tdt::DTYPE_*) but the counters.
// ``ll``: the one-shot method, else the ring.  ``epoch``: the instance's sum
// of blocks a rank over its earlier calls; the blocks a rank of this launch
// go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int ag_gemm(const void* a, const void* b, void* out,
                       void* const* gathered, void* const* sig, int world,
                       int base, int ranks, int ll, int dtype, int mp, int n,
                       int k, unsigned long long epoch, int* blocks,
                       void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || mp < 1 || n < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(a, b, out, gathered, sig, world, base, ranks, ll, mp, n,
                     k, epoch, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(a, b, out, gathered, sig, world, base, ranks, ll, mp,
                      n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
