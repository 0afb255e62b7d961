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
// Design.  One cooperative launch holds every rank's blocks (`dl.cuh`):
// blockIdx.y is the rank, and each rank's P persistent blocks share its
// GEMM tiles and its copies.  The cooperative launch guarantees that every
// block is resident, so a block that spins on a peer's signal never starves
// the peer; a grid that cannot be resident is refused, never run partly.
//
// bf16 operands on 16-byte rows (k and n multiples of 8, every pointer
// 16-byte aligned: every main-path call) run the Hopper tile of
// `wgmma_tile.cuh` (K6/K8's): TMA loads into a ring of k = 64 stages,
// consumer warpgroups on `wgmma` m64n256k16, one producer thread; one block
// an SM (about 200 KB of dynamic shared memory), so P = 132 / W blocks a
// rank (33 at world 4).  The producer warpgroup's other three warps are the
// block's communication crew (`comm_body.cuh` `Crew`), so the copies run
// beside the products and never wait on them.  Tensor maps: a's shards (R,
// m, k) as (k, m, R); rank r's gathered buffer (W, m, k) as (k, m, W) for
// the ring, as (k, W m, 1) for `ll`; b (R, k, n) as (n, k, R).  Rows are
// not padded: a box past m reads zeros and rows past m are not written, so
// a decode row a rank gathers 4 rows at world 4, not 64.
// - `fused` (the ring): the crew runs the neighbour entry barrier, puts
//   the own shard into the own slot and the right neighbour's, then for s =
//   1 .. W-2 waits for chunk (r - s) mod W and forwards its share
//   (`emit_ag_ring_forward`).  The tiles of the W chunks, in ring order, are
//   one flat list over the rank's P blocks (m fastest within a chunk), so
//   no block idles at a chunk boundary.  The own chunk's tiles read the
//   shard itself; before the first a load of another chunk the producer
//   waits on that chunk's arrival word and fences the generic proxy (the
//   peers' stores) against the async proxy (its TMA loads)
//   (`ring_wait_chunk`); the b tiles of the tile's first stages go out
//   before the wait, since the weights wait on nothing.
// - `ll`: the crew runs the entry barrier and the push (every rank's shard
//   into every rank's slot, `emit_push_allgather_send`); the producer waits
//   for all W arrivals before its first a load (its first stages of b are
//   in flight meanwhile); the GEMM runs over the W m gathered rows, reading
//   b once.  At decode (W m <= 64, the 64-row tile) the rank's n / 256
//   column tiles are too few for its P blocks (QKV: 6 for 33), so the host
//   may ask for the narrow tile, 64 x 64 on `wgmma` m64n64k16 with 12
//   stages (`allgather_gemm.ll_tile_n`: while its column tiles fit one wave
//   of the rank's blocks; QKV's 24 on 33), which puts 4x the blocks on the
//   weight stream.
// Every tile sums k in one order and the two widths give the same bits
// (`wgmma_tile.cuh`'s promise), so on this body a row's result depends on
// its own row only: not on the other rows, the tile or the method.
//
// f32 operands (CUDA cores, `F32Tile`) and bf16 off 16-byte rows (the
// `mma.sync` tile, loads by element; `gemm_tile.cuh`) keep the first
// kernels, which run the whole block's threads through `emit_ag_ring` or
// `emit_push_allgather` and compute between the steps; rows are padded to
// the row tile by the wrapper.  A failed tensor-map encode, attribute or
// launch returns its error code; no call falls back to another body.

#include <algorithm>

#include "comm_body.cuh"
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

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
      tdt::WAIT_AG_GEMM_RING, [&](int c, const char* held) {
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

// ---- the Hopper body: bf16 on 16-byte rows ---------------------------------

namespace wg = tdt::wgmma;
namespace comm = tdt::comm;
using WgTile64 = wg::Tile<1, 5>;
using WgTile128 = wg::Tile<2, 4>;
//: The narrow tile of `ll` at decode (W m <= 64 gathered rows).
using NarrowTile = wg::Tile<1, 12, 64>;

//: The communication crew: the producer warpgroup's warps 1-3 on named
//: barrier 1.
constexpr int CREW_THREADS = 96, CREW_BARRIER = 1;

struct WgArgs {
  CUtensorMap ta;                 // a (R, m, k) as (k, m, R)
  CUtensorMap tb;                 // b (R, k, n) as (n, k, R)
  CUtensorMap tg[dl::MAX_RANKS];  // rank r's gathered: (k, m, W) or (k, W m, 1)
  const bf16* a;
  bf16* out;                      // (R, W m, n)
  dl::Symm<char> gathered;        // rank r's (W, m, k)
  dl::Symm<u64> sig;              // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int m, n, k;
  u64 epoch;                      // the instance's sum of P before this call
};

__device__ __forceinline__ comm::Crew crew(int i) {
  return comm::Crew{i, CREW_THREADS, CREW_BARRIER};
}

// `fused`: tile t is tile t % tpc of step t / tpc's chunk (r - step) mod
// W, m fastest; the own chunk's from the shard, the others from the
// gathered buffer once arrived.
template <class Tile>
struct RingSched {
  const WgArgs* p;
  int me, y, mt, tpc, nk;
  u64 target;
  int held;  // the producer's last chunk waited for

  __device__ __forceinline__ int chunk(int t) const {
    return dl::peer_id(p->team, me - t / tpc);
  }
  __device__ __forceinline__ wg::At at(int t) const {
    const int c = chunk(t), i = t % tpc;
    const int row = i % mt * Tile::BM, col = i / mt * Tile::TN;
    if (c == me) return {&p->ta, row, y, col, y, nk};
    return {&p->tg[me], row, c, col, y, nk};
  }
  __device__ __forceinline__ bool pending(int t) const {
    return chunk(t) != held;
  }
  __device__ __forceinline__ void ready(int t) {
    held = chunk(t);
    comm::ring_wait_chunk(p->sig, me, held, target, tdt::WAIT_AG_GEMM_RING);
  }
  __device__ __forceinline__ void side(int i) {
    const size_t elems = (size_t)p->m * p->k;
    comm::emit_ag_ring_forward(p->team, p->a + y * elems, p->gathered,
                               elems * sizeof(bf16), p->sig, target,
                               tdt::WAIT_AG_GEMM_FORWARD, crew(i));
  }
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        const float (&acc)[Tile::ACC]) {
    const size_t group = (size_t)y * p->team.world + chunk(t);
    wg::store_tile(p->out + group * p->m * p->n, p->m, p->n, w.a_row, w.col,
                   wgi, acc);
  }
};

// `ll`: the M = W m gathered rows as one matrix; tile t is row tile t % mt,
// column tile t / mt.
template <class Tile>
struct LlSched {
  const WgArgs* p;
  int me, y, M, mt, nk;
  u64 target;
  bool held;  // the producer has waited for every chunk

  __device__ __forceinline__ wg::At at(int t) const {
    return {&p->tg[me], t % mt * Tile::BM, 0, t / mt * Tile::TN, y, nk};
  }
  __device__ __forceinline__ bool pending(int) const { return !held; }
  __device__ __forceinline__ void ready(int) {
    for (int c = 0; c < p->team.world; ++c)
      comm::ring_wait_chunk(p->sig, me, c, target, tdt::WAIT_AG_GEMM_PUSH);
    held = true;
  }
  __device__ __forceinline__ void side(int i) {
    const size_t elems = (size_t)p->m * p->k;
    comm::emit_push_allgather_send(p->team, p->a + y * elems, p->gathered,
                                   elems * sizeof(bf16), p->sig, target,
                                   crew(i));
  }
  __device__ __forceinline__ void store(int, const wg::At& w, int wgi,
                                        const float (&acc)[Tile::ACC]) {
    wg::store_tile(p->out + (size_t)y * M * p->n, M, p->n, w.a_row, w.col,
                   wgi, acc);
  }
};

// Compiled for 384 threads (168 registers a thread at entry, so the
// consumers' `setmaxnreg` rises from there, as K6/K8's) and launched with
// Tile::NT.
template <class Tile, bool LL>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    ag_gemm_wgmma_kernel(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int me = dl::rank(p.team), y = blockIdx.y;
  const u64 target = p.epoch + gridDim.x;
  const int nt = (p.n + Tile::TN - 1) / Tile::TN;
  const int nk = (p.k + wg::BK - 1) / wg::BK;
  if constexpr (LL) {
    const int M = p.team.world * p.m, mt = (M + Tile::BM - 1) / Tile::BM;
    const int ntiles = mt * nt;
    LlSched<Tile> sched{&p, me, y, M, mt, nk, target, false};
    Tile::run(smem, &p.tb, ntiles, sched);
  } else {
    const int mt = (p.m + Tile::BM - 1) / Tile::BM;
    const int ntiles = p.team.world * mt * nt;
    RingSched<Tile> sched{&p, me, y, mt, mt * nt, nk, target, me};
    Tile::run(smem, &p.tb, ntiles, sched);
  }
}

// Encode the maps, then one cooperative launch: P blocks a rank, as many as
// the call has tiles, at most as many as can be resident
// together with every other rank's (one an SM).
template <class Tile, bool LL>
int launch_wgmma(WgArgs& p, const void* a, const void* b,
                 void* const* gathered, int ranks, int* blocks,
                 cudaStream_t s) {
  const int w = p.team.world, m = p.m, n = p.n, k = p.k;
  int rc = wg::encode_3d(&p.ta, a, k, m, ranks, wg::BK, Tile::BM);
  if (rc == 0) rc = wg::encode_3d(&p.tb, b, n, k, ranks, wg::BOX_N, wg::BK);
  for (int r = 0; r < w && rc == 0; ++r)
    rc = LL ? wg::encode_3d(&p.tg[r], gathered[r], k, (uint64_t)w * m, 1,
                            wg::BK, Tile::BM)
            : wg::encode_3d(&p.tg[r], gathered[r], k, m, w, wg::BK,
                            Tile::BM);
  if (rc != 0) return rc;
  auto* fn = ag_gemm_wgmma_kernel<Tile, LL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Tile::NT,
                                                      Tile::SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int rows = LL ? w * m : m;
  const int tiles = (rows + Tile::BM - 1) / Tile::BM *
                    ((n + Tile::TN - 1) / Tile::TN);
  const int want = tiles * (LL ? 1 : w);
  const int P = std::min(want, fit);
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn),
                                          dim3(P, ranks), dim3(Tile::NT),
                                          args, Tile::SMEM_BYTES, s);
}

int run_wgmma(const void* a, const void* b, void* out, void* const* gathered,
              void* const* sig, int world, int base, int ranks, int ll, int m,
              int n, int k, u64 epoch, int narrow, int* blocks,
              cudaStream_t s) {
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r)
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  const int rows = ll ? world * m : m;
  if (k % 8 != 0 || n % 8 != 0 || align % 16 != 0 ||
      (narrow && (!ll || rows > wg::WG_ROWS)))
    return (int)cudaErrorInvalidValue;
  WgArgs p{};
  p.a = static_cast<const bf16*>(a);
  p.out = static_cast<bf16*>(out);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.m = m;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  if (narrow)
    return launch_wgmma<NarrowTile, true>(p, a, b, gathered, ranks, blocks,
                                          s);
  if (ll)
    return rows <= wg::WG_ROWS
               ? launch_wgmma<WgTile64, true>(p, a, b, gathered, ranks,
                                              blocks, s)
               : launch_wgmma<WgTile128, true>(p, a, b, gathered, ranks,
                                               blocks, s);
  return rows <= wg::WG_ROWS
             ? launch_wgmma<WgTile64, false>(p, a, b, gathered, ranks, blocks,
                                             s)
             : launch_wgmma<WgTile128, false>(p, a, b, gathered, ranks,
                                              blocks, s);
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
// go to ``*blocks``.  ``wgmma``: the Hopper body (bf16 on 16-byte rows, mp
// the unpadded rows a rank), else the first bodies (mp padded to their row
// tile); ``narrow``: `ll` at decode (world * mp <= 64) on the 64 x 64 tile.
// Returns a cudaError_t code.
extern "C" int ag_gemm(const void* a, const void* b, void* out,
                       void* const* gathered, void* const* sig, int world,
                       int base, int ranks, int ll, int dtype, int mp, int n,
                       int k, unsigned long long epoch, int wgmma, int narrow,
                       int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || mp < 1 || n < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma)
    return dtype == tdt::DTYPE_BF16
               ? run_wgmma(a, b, out, gathered, sig, world, base, ranks, ll,
                           mp, n, k, epoch, narrow, blocks, s)
               : (int)cudaErrorInvalidValue;
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(a, b, out, gathered, sig, world, base, ranks, ll, mp, n,
                     k, epoch, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(a, b, out, gathered, sig, world, base, ranks, ll, mp,
                      n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
