// GEMM-ReduceScatter: rank c of a team of W gets out_c = sum over ranks r
// of rows chunk c of (a_r @ b_r), each rank's partial rounded to the
// activations' type before the sum, the sum taken in f32 in rank order.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py
//   `gemm_rs` -> pallas_call :292: `_gemm_rs_fused_kernel` (:99) and
//   `_gemm_rs_ll_kernel` (:147, over reduce_scatter.py
//   `emit_scatter_reduce` :144).  Layouts are the JAX wrapper's per rank:
//   a_r (W * mc, k) as W row chunks, b_r (k, n), the receive buffer rbuf_r
//   (W, mc, n) whose slot w holds rank w's partial of chunk r, and out_r
//   (mc, n).  The JAX kernels' staging and receive buffers hold a's dtype,
//   so a partial is rounded to it before the f32 sum (`_emit_reduce_sum`
//   :94); this kernel rounds in its GEMM epilogue.
//
// What bounds it on the H100: Qwen3-8B prefill at world 4 multiplies 2048
// rows of 1024 (O projection) or 3072 (down) by b_r of (k_loc, 4096): 17.2
// / 51.5 GFLOP a rank, the tensor cores; a decode step's 4 rows stream b_r:
// bytes.  On one card the partials' stores and the sum's reads take HBM
// bandwidth that NVLink would carry between cards.
//
// One cooperative launch holds every rank's blocks (`dl.cuh`; see
// ag_gemm.cu): blockIdx.y is the rank, P persistent blocks a rank share its
// GEMM tiles and its sum.
//
// bf16 operands on 16-byte rows (k and n multiples of 8, every pointer
// 16-byte aligned: every main-path call) run the Hopper tile of
// `wgmma_tile.cuh` (K6/K8/K12's): TMA loads into a ring of k = 64 stages,
// consumer warpgroups on `wgmma`, one producer thread, one block an SM, so
// P = 132 / W blocks a rank (33 at world 4).  Rows are not padded: a's
// tensor map ends at a chunk's last row, so a box past it reads zeros, and
// rows past it are not stored.  The producer warpgroup's spare warps run
// the entry barrier (a `comm_body.cuh` crew on named barrier 1) and then
// open the consumers' remote stores (an mbarrier); the producer's loads
// never wait, since every operand is the rank's own.  The epilogue (the
// schedule's `store` hook) sends each partial tile, rounded to bf16,
// straight to its owner's receive slot, through a 2 KB slab of shared
// memory a warp (the fragments turned into 16-byte row pieces, so a row's
// 128 bytes go out in one piece a lane of 8 lanes).  The 128 accumulators
// stay live through the epilogue (the next tile's products read them), so
// the sums hold one 16-byte piece a lane at a time, and L2 prefetches
// (which take no registers) keep more loads in flight.
// - `fused` (prefill): the tiles of the W chunks are one flat list over
//   the rank's P blocks, chunk c = (r + 1 + s) mod W at step s (the JAX
//   order: remote chunks first, the own chunk last), m fastest; a chunk's
//   map is (k, mc, R W).  Tile partials go to slot r of rank c's rbuf.
//   After a block's last tile of a step its consumers meet on named barrier
//   2 and one thread adds one to the step's arrival word at rank c (every
//   block signals every step once a call; the steps before a block's first
//   tile are signalled by its crew right after the barrier).  After its
//   last tile a block waits for every rank's word of its own chunk, and the
//   rank's blocks share the chunk's sum.
// - `ll` (decode): one GEMM over the W mc rows (map (k, W mc, R)), so b_r
//   is read once; row i goes to slot r of rank i / mc's rbuf (no stage
//   buffer, no barrier among the rank's blocks, no scatter pass).  After
//   its last tile a block signals every rank once; the rank waits for W
//   arrivals, and its blocks share the sum.  At decode it keeps the 64 x
//   256 tile: K12's narrow 64 x 64 one was slower in two waves at
//   Qwen3-8B's 4096 columns and no faster, with the weights from HBM, at
//   Qwen3-30B-A3B's 2048 where it fits one wave (`PERF.md` §6).
// Every tile sums k in one order and both row tiles give an element the
// same bits (`wgmma_tile.cuh`'s promise), so a partial, and therefore a
// row's result, depends on its own row only: not on the other rows, the
// tile or the method.  The sum is the plain version's: partials rounded
// to bf16, added in f32 in rank order 0 .. W-1, cast once.
//
// f32 operands (CUDA cores, `F32Tile`) and bf16 off 16-byte rows (the
// `mma.sync` tile, loads by element; `gemm_tile.cuh`) keep the first
// kernels, on chunks the wrapper pads to the row tile with zeros (padded
// rows stay in their chunk's padded rows in every partial, so they are
// summed only into padded output rows, which the wrapper slices off):
// - `fused`: the entry barrier; for s = 0 .. W-1 the chunk c = (r + 1 + s)
//   mod W, its tiles stored by the GEMM epilogue straight into slot r of
//   rank c's rbuf, then one arrival signal a block to rank c; then the wait
//   for all W partials of the own chunk, and the reduce.
// - `ll`: the entry barrier; one GEMM over all W * mcp rows into the
//   rank's own staging buffer; the rank's blocks wait for each other; the
//   scatter of chunk c to slot r of rank c's rbuf; the wait and the reduce
//   (`emit_scatter_reduce`).
// A failed tensor-map encode, attribute or launch returns its error code;
// no call falls back to another body.

#include <algorithm>

#include "comm_body.cuh"
#include "gemm_tile.cuh"
#include "wgmma_epilogue.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;

template <typename T>
struct RsArgs {
  const T* a;           // (R, W * mcp, k): the launched ranks' rows
  const T* b;           // (R, k, n): their weight shards
  T* out;               // (R, mcp, n)
  T* stage;             // ll: (R, W * mcp, n), the partials before the scatter
  dl::Symm<char> rbuf;  // rank r's (W, mcp, n)
  dl::Symm<u64> sig;    // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int mcp, n, k, vec;
  u64 epoch;            // the instance's sum of P before this call
};

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    gemm_rs_fused_kernel(RsArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t a_chunk = (size_t)p.mcp * p.k, o_chunk = (size_t)p.mcp * p.n;
  const T* a = p.a + y * w * a_chunk;
  const T* b = p.b + (size_t)y * p.k * p.n;

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  for (int s = 0; s < w; ++s) {
    const int c = dl::peer_id(t, me + 1 + s);
    gemm::run_tiles<Tile>(sm, a + c * a_chunk, b,
                          reinterpret_cast<T*>(p.rbuf[c]) + me * o_chunk,
                          p.mcp, p.n, p.k, p.vec, part, parts);
    u64* word = p.sig[c] + dl::ARRIVAL_WORD + me;
    dl::signal_after_puts(&word, 1);
  }
  dl::wait(p.sig[me] + dl::ARRIVAL_WORD, w, 1, target,
           tdt::WAIT_GEMM_RS_PARTIAL);
  tdt::comm::reduce_sum(reinterpret_cast<const T*>(p.rbuf[me]),
                        p.out + y * o_chunk, w, o_chunk, part, parts);
}

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    gemm_rs_ll_kernel(RsArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int w = t.world, y = blockIdx.y;
  const u64 target = p.epoch + gridDim.x;
  const size_t o_chunk = (size_t)p.mcp * p.n;
  T* stage = p.stage + y * w * o_chunk;

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  gemm::run_tiles<Tile>(sm, p.a + (size_t)y * w * p.mcp * p.k,
                        p.b + (size_t)y * p.k * p.n, stage, w * p.mcp, p.n,
                        p.k, p.vec, blockIdx.x, gridDim.x);
  dl::barrier_rank(t, p.sig, target);
  tdt::comm::emit_scatter_reduce<T>(t, stage, p.out + y * o_chunk, p.rbuf,
                                    o_chunk, p.sig, target,
                                    /*barrier=*/false);
}

// P blocks a rank: as many as a GEMM step has tiles, at most as many as can
// be resident together with every other rank's; then one cooperative
// launch.
template <class Tile>
int launch(RsArgs<typename Tile::In> p, int ranks, int ll, int* blocks,
           cudaStream_t s) {
  void* fn = ll ? reinterpret_cast<void*>(gemm_rs_ll_kernel<Tile>)
                : reinterpret_cast<void*>(gemm_rs_fused_kernel<Tile>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Tile::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = gemm::tiles<Tile>(ll ? p.team.world * p.mcp : p.mcp, p.n);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Tile::NT),
                                          args, 0, s);
}

template <typename T>
int dispatch(RsArgs<T> p, int ranks, int ll, int* blocks, cudaStream_t s);

template <>
int dispatch<bf16>(RsArgs<bf16> p, int ranks, int ll, int* blocks,
                   cudaStream_t s) {
  const int rows = ll ? p.team.world * p.mcp : p.mcp;
  if (rows <= 16) return launch<gemm::Bf16Tile16>(p, ranks, ll, blocks, s);
  if (rows <= 64) return launch<gemm::Bf16Tile64>(p, ranks, ll, blocks, s);
  return launch<gemm::Bf16Tile128>(p, ranks, ll, blocks, s);
}

template <>
int dispatch<float>(RsArgs<float> p, int ranks, int ll, int* blocks,
                    cudaStream_t s) {
  return launch<gemm::F32Tile>(p, ranks, ll, blocks, s);
}

// ---- the Hopper body: bf16 on 16-byte rows ---------------------------------

namespace wg = tdt::wgmma;
namespace comm = tdt::comm;
using WgTile64 = wg::Tile<1, 5>;
using WgTile128 = wg::Tile<2, 4>;

using wg::consumers_sync;
using wg::piece_row;
using wg::reduce_partials;
using wg::SLAB_BYTES;
using wg::store_pieces;
using wg::wait_entered;

struct WgArgs {
  CUtensorMap ta;       // a (R, W mc, k): fused (k, mc, R W), ll (k, W mc, R)
  CUtensorMap tb;       // b (R, k, n) as (n, k, R)
  bf16* out;            // (R, mc, n)
  dl::Symm<char> rbuf;  // rank r's (W, mc, n): slot w rank w's partial
  dl::Symm<u64> sig;    // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int mc, n, k;
  u64 epoch;            // the instance's sum of P before this call
};

//: The slabs of a block's consumer warps, a warp's each, at the start of the
//: dynamic shared memory, the ring after them.
template <class Tile>
constexpr int EPI_BYTES = Tile::BM / 16 * SLAB_BYTES;


// `fused`: tile t is tile t % tpc of step s = t / tpc, whose chunk is (r +
// 1 + s) mod W, m fastest.
template <class Tile>
struct FusedSched {
  static constexpr int C = Tile::BM / wg::WG_ROWS;
  const WgArgs* p;
  uint64_t* entered;
  uint8_t* epi;  // the consumer warps' slabs
  int me, y, mt, tpc, nk;
  u64 target;
  int done;   // the steps signalled (from the first tile's step)
  bool open;  // a consumer has seen the entry barrier pass

  __device__ __forceinline__ int chunk(int s) const {
    return dl::peer_id(p->team, me + 1 + s);
  }
  __device__ __forceinline__ wg::At at(int t) const {
    const int c = chunk(t / tpc), i = t % tpc;
    return {&p->ta, i % mt * Tile::BM, y * p->team.world + c,
            i / mt * Tile::TN, y, nk};
  }
  __device__ __forceinline__ bool pending(int) const { return false; }
  __device__ __forceinline__ void ready(int) {}
  // The steps before the block's first tile's (it has none of their
  // tiles) are signalled by the crew once the barrier has passed, so that
  // a block whose first tile is in its own chunk never waits for its peers
  // before signalling them.
  __device__ __forceinline__ void side(int i) {
    wg::crew_enter(p->team, p->sig, entered, target, i);
    if (i < done) dl::notify(p->sig[chunk(i)] + dl::ARRIVAL_WORD + me);
  }
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        const float (&acc)[Tile::ACC]) {
    const int world = p->team.world, c = chunk(t / tpc);
    const int mc = p->mc, n = p->n, row0 = w.a_row + wgi * wg::WG_ROWS;
    const size_t slot = (size_t)mc * n;
    uint8_t* slab = epi + threadIdx.x / 32 * SLAB_BYTES;
    bf16* dst = reinterpret_cast<bf16*>(p->rbuf[c]) + me * slot;
    bf16* rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = row0 + piece_row(k);
      rows[k] = row < mc ? dst + (size_t)row * n : nullptr;
    }
    wait_entered(entered, open);
    store_pieces(slab, acc, rows, w.col, n);
    // The steps before the block's next tile's are done (those without a
    // tile of the block too): signal each once.
    const int after = (t + (int)gridDim.x) / tpc;
    const int next = after < world ? after : world;
    if (next > done) {
      __threadfence();
      consumers_sync<C>();
      const int i = threadIdx.x;
      if (i < next - done)
        dl::notify(p->sig[chunk(done + i)] + dl::ARRIVAL_WORD + me);
      done = next;
    }
    // After the block's last tile: once every block of every rank has
    // delivered its partial of the own chunk, the rank's blocks sum it.
    if (t + (int)gridDim.x >= world * tpc) {
      wg::consumers_wait<C>(p->sig[me] + dl::ARRIVAL_WORD, world, target,
                            tdt::WAIT_GEMM_RS_PARTIAL);
      reduce_partials<C>(reinterpret_cast<const bf16*>(p->rbuf[me]),
                         p->out + y * slot, world, (unsigned)slot,
                         blockIdx.x, gridDim.x);
    }
  }
};

// `ll`: the W mc rows as one matrix; tile t is row tile t % mt, column tile
// t / mt.
template <class Tile>
struct LlSched {
  static constexpr int C = Tile::BM / wg::WG_ROWS;
  const WgArgs* p;
  uint64_t* entered;
  uint8_t* epi;  // the consumer warps' slabs
  int me, y, M, mt, ntiles, nk;
  u64 target;
  bool open;  // a consumer has seen the entry barrier pass

  __device__ __forceinline__ wg::At at(int t) const {
    return {&p->ta, t % mt * Tile::BM, y, t / mt * Tile::TN, y, nk};
  }
  __device__ __forceinline__ bool pending(int) const { return false; }
  __device__ __forceinline__ void ready(int) {}
  __device__ __forceinline__ void side(int i) {
    wg::crew_enter(p->team, p->sig, entered, target, i);
  }
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        const float (&acc)[Tile::ACC]) {
    // Row i of the W mc rows is row i % mc of rank i / mc's chunk: it goes
    // to slot r of that rank's rbuf.
    const int mc = p->mc, n = p->n, row0 = w.a_row + wgi * wg::WG_ROWS;
    const size_t slot = (size_t)mc * n;
    uint8_t* slab = epi + threadIdx.x / 32 * SLAB_BYTES;
    bf16* rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = row0 + piece_row(k), owner = row / mc;
      rows[k] = row < M ? reinterpret_cast<bf16*>(p->rbuf[owner]) +
                              me * slot + (size_t)(row - owner * mc) * n
                        : nullptr;
    }
    wait_entered(entered, open);
    store_pieces(slab, acc, rows, w.col, n);
    if (t + (int)gridDim.x < ntiles) return;
    // The block's last tile: one arrival at every rank; once all W have
    // arrived here, the rank's blocks sum the chunk.
    const int world = p->team.world;
    __threadfence();
    consumers_sync<C>();
    if ((int)threadIdx.x < world)
      dl::notify(p->sig[threadIdx.x] + dl::ARRIVAL_WORD + me);
    wg::consumers_wait<C>(p->sig[me] + dl::ARRIVAL_WORD, world, target,
                          tdt::WAIT_GEMM_RS_PARTIAL);
    reduce_partials<C>(reinterpret_cast<const bf16*>(p->rbuf[me]),
                       p->out + y * slot, world, (unsigned)slot, blockIdx.x,
                       gridDim.x);
  }
};

// Compiled for 384 threads (168 registers a thread at entry, so the
// consumers' `setmaxnreg` rises from there, as K6/K8/K12's) and launched
// with Tile::NT.
template <class Tile, bool LL>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    gemm_rs_wgmma_kernel(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ uint64_t entered;
  uint8_t* epi = smem;  // the slabs, then the ring
  uint8_t* ring = smem + EPI_BYTES<Tile>;
  if (threadIdx.x == 0) tdt::mbar_init(&entered, 1);
  const int me = dl::rank(p.team), y = blockIdx.y, world = p.team.world;
  const u64 target = p.epoch + gridDim.x;
  const int nt = (p.n + Tile::TN - 1) / Tile::TN;
  const int nk = (p.k + wg::BK - 1) / wg::BK;
  if constexpr (LL) {
    const int M = world * p.mc, mt = (M + Tile::BM - 1) / Tile::BM;
    LlSched<Tile> sched{&p, &entered, epi,    me,     y,
                        M,  mt,       mt * nt, nk, target, false};
    Tile::run(ring, &p.tb, mt * nt, sched);
  } else {
    const int mt = (p.mc + Tile::BM - 1) / Tile::BM;
    const int tpc = mt * nt, ntiles = world * tpc;
    const int first = (int)blockIdx.x / tpc;  // < W: P <= ntiles
    FusedSched<Tile> sched{&p,     &entered, epi,   me,    y,    mt,
                           tpc,    nk,       target, first, false};
    Tile::run(ring, &p.tb, ntiles, sched);
  }
}

// Encode the maps, then one cooperative launch: P blocks a rank, as many as
// the call has tiles (so every block has one), at most as many as can be
// resident together with every other rank's (one an SM).
template <class Tile, bool LL>
int launch_wgmma(WgArgs& p, const void* a, const void* b, int ranks,
                 int* blocks, cudaStream_t s) {
  const int w = p.team.world, mc = p.mc, n = p.n, k = p.k;
  int rc = LL ? wg::encode_3d(&p.ta, a, k, (uint64_t)w * mc, ranks, wg::BK,
                              Tile::BM)
              : wg::encode_3d(&p.ta, a, k, mc, (uint64_t)ranks * w, wg::BK,
                              Tile::BM);
  if (rc == 0) rc = wg::encode_3d(&p.tb, b, n, k, ranks, wg::BOX_N, wg::BK);
  if (rc != 0) return rc;
  auto* fn = gemm_rs_wgmma_kernel<Tile, LL>;
  constexpr int SMEM = Tile::SMEM_BYTES + EPI_BYTES<Tile>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Tile::NT,
                                                      SMEM);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int rows = LL ? w * mc : mc;
  const int tiles = (rows + Tile::BM - 1) / Tile::BM *
                    ((n + Tile::TN - 1) / Tile::TN) * (LL ? 1 : w);
  const int P = std::min(tiles, fit);
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn),
                                          dim3(P, ranks), dim3(Tile::NT),
                                          args, SMEM, s);
}

int run_wgmma(const void* a, const void* b, void* out, void* const* rbuf,
              void* const* sig, int world, int base, int ranks, int ll,
              int mc, int n, int k, u64 epoch, int* blocks,
              cudaStream_t s) {
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out);
  for (int r = 0; r < world; ++r)
    align |= reinterpret_cast<uintptr_t>(rbuf[r]);
  const int rows = ll ? world * mc : mc;
  if (k % 8 != 0 || n % 8 != 0 || align % 16 != 0 ||
      (size_t)mc * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  WgArgs p{};
  p.out = static_cast<bf16*>(out);
  for (int r = 0; r < world; ++r) {
    p.rbuf.ptr[r] = static_cast<char*>(rbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.mc = mc;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  if (!ll)
    return rows <= wg::WG_ROWS
               ? launch_wgmma<WgTile64, false>(p, a, b, ranks, blocks, s)
               : launch_wgmma<WgTile128, false>(p, a, b, ranks, blocks, s);
  return rows <= wg::WG_ROWS
             ? launch_wgmma<WgTile64, true>(p, a, b, ranks, blocks, s)
             : launch_wgmma<WgTile128, true>(p, a, b, ranks, blocks, s);
}

template <typename T>
int run(const void* a, const void* b, void* out, void* stage,
        void* const* rbuf, void* const* sig, int world, int base, int ranks,
        int ll, int mcp, int n, int k, u64 epoch, int* blocks,
        cudaStream_t s) {
  RsArgs<T> p{};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.out = static_cast<T*>(out);
  p.stage = static_cast<T*>(stage);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r) {
    p.rbuf.ptr[r] = static_cast<char*>(rbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.mcp = mcp;
  p.n = n;
  p.k = k;
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  p.epoch = epoch;
  return dispatch<T>(p, ranks, ll, blocks, s);
}

}  // namespace

// a (ranks, world * mcp, k) and b (ranks, k, n): the launched ranks' rows
// and weight shards (ranks base .. base + ranks - 1 of a team of
// ``world``); out (ranks, mcp, n); ``stage`` (ranks, world * mcp, n), read
// and written by the first body's ``ll`` only; ``rbuf`` and ``sig``: host
// tables of ``world`` device pointers, rank r's (world, mcp, n) receive
// buffer and its dl::SIGNAL_WORDS u64 counters; all contiguous, in
// ``dtype`` (tdt::DTYPE_*) but the counters.  ``ll``: the one-shot method,
// else the fused one.  ``epoch``: the instance's sum of blocks a rank over
// its earlier calls; the blocks a rank of this launch go to ``*blocks``.
// ``wgmma``: the Hopper body (bf16 on 16-byte rows, mcp the unpadded rows
// of a chunk), else the first bodies (mcp padded to their row tile).
// Returns a cudaError_t code.
extern "C" int gemm_rs(const void* a, const void* b, void* out, void* stage,
                       void* const* rbuf, void* const* sig, int world,
                       int base, int ranks, int ll, int dtype, int mcp, int n,
                       int k, unsigned long long epoch, int wgmma,
                       int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || mcp < 1 || n < 1 || k < 1 ||
      (ll && !wgmma && stage == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wgmma)
    return dtype == tdt::DTYPE_BF16
               ? run_wgmma(a, b, out, rbuf, sig, world, base, ranks, ll, mcp,
                           n, k, epoch, blocks, s)
               : (int)cudaErrorInvalidValue;
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(a, b, out, stage, rbuf, sig, world, base, ranks, ll,
                     mcp, n, k, epoch, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(a, b, out, stage, rbuf, sig, world, base, ranks, ll,
                      mcp, n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
