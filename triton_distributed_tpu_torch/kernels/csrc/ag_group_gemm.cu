// AllGather + grouped GEMM, the MoE tensor-parallel prologue: every rank r
// of a team of W gets out_r[c, e] = buckets_c[e] @ b_r[e] for every
// chunk (source rank) c and expert e, f32 (int8: int32) accumulation.
//
// Replaces: triton_distributed_tpu/kernels/allgather_group_gemm.py
//   `ag_group_gemm` -> pallas_call :172 (`_ag_group_gemm_kernel`, K11) and
//   `ag_group_gemm_w8a8` -> pallas_call :297 (`_ag_group_gemm_w8a8_kernel`,
//   K11-int8), both over the ring `_emit_ag_ring_grouped` (:67) and the
//   in-kernel grouped GEMM `emit_grouped_matmul(_w8a8)` with `count_of`
//   (grouped_gemm.py :107, :308).  Layouts are the JAX wrapper's per rank:
//   the buckets (E, cap, k), the weight shard b_r (E, k, n), the gathered
//   buckets (W, E, cap, k) and out_r (W, E, cap, n); the int8 form also
//   takes every chunk's per-token scales (W, E, cap) (gathered outside the
//   kernel, as JAX gathers them in XLA; its lane-broadcast copy is a Mosaic
//   workaround that does not carry over) and sb_r (E, n).
//
// What bounds it on the H100: Qwen3-30B-A3B prefill at world 4 (4 x 512
// rows a rank, 128 experts of cap 64, k = 2048, n = 384 a rank): the bytes.
// Each rank must read the weight shards of the occupied experts once (201
// MB a rank at most), the occupied bucket rows of every chunk, and write
// the (W, E, cap, n) output (50 MB a rank); the products of the occupied
// rows (at most 51.5 GFLOP a rank) sit below the ridge.  On one card the
// ring's copies (3 x 33.5 MB a rank) are copies inside the same HBM.
//
// The Hopper body: bf16 operands on 16-byte rows (k and n multiples of 8,
// every pointer 16-byte aligned: every main-path call), and every int8 call
// (K11-int8: k a multiple of 16, cap of 32, any n) on the tile's int8 form.
// One cooperative
// launch holds every rank's blocks (`dl.cuh`; blockIdx.y is the rank), P =
// 132 / W persistent blocks a rank, one an SM (about 225 KB of dynamic
// shared memory), on the tile of `wgmma_tile.cuh` (K6/K8/K12/K14's).
// - Units, each weight tile loaded once: a rank's tile list is units of one
//   expert e and one column tile of 128, expert-major, then column tile.  A
//   unit's a rows are up to four 64-row boxes of e's buckets: box i (rows
//   64 i ..) of chunk c, for every (c, i) that holds a token (the count of
//   chunk c's bucket e above 64 i).  A stage loads the unit's b tile (64 k
//   x 128 columns) once and the live boxes, and the consumers multiply
//   every box by it, so each rank reads b_r[e]'s tile once for all the
//   chunks' rows, where the first body read it once a chunk.  An expert
//   with more than four live boxes (world 8, or cap above 64) takes
//   consecutive units of the same (e, column tile), which meet in L2.  A
//   unit with no live box is not in the list.  The wrapper builds the list
//   from the counts on the device (`allgather_group_gemm.unit_list`: torch
//   ops, no host sync): an int4 a unit {e, column tile, boxes 0-1, boxes
//   2-3}, each box (i << 3 | c) in 16 bits, and its length.
// - The shape: two consumer warpgroups, each with two boxes on
//   `wgmma` m64n128k16 (256 x 128 a unit, 128 f32 accumulators a thread,
//   as the 128 x 256 tile's).  n = 384 is three column tiles with no
//   waste, and a unit's four boxes are the four chunks' buckets at world 4
//   and cap 64.  A stage is 48 KB (four a boxes of 8 KB, two b boxes of 8
//   KB), four stages.  A unit with fewer live boxes loads and stores those
//   only (`At::boxes`; box j of warpgroup w is box j C + w); the consumers
//   multiply all four, since a product skipped on a runtime condition
//   makes ptxas serialize every `wgmma` (C7520; `torch_ag_group_gemm_ab.py
//   --variants skipdead`: 1% slower at layer 0's buckets on the H100).
// - The ring on the producer warpgroup's three spare warps (the crew,
//   K12's form): the neighbour entry barrier, then each chunk forwarded in
//   pieces of `epp` experts' buckets (`allgather_group_gemm.
//   RING_PIECE_EXPERTS`): this rank's piece into the right neighbour's
//   slot, then for s = 1 .. W-2 the piece of chunk (r - s) mod W once the
//   left neighbour's P blocks have delivered it, one arrival word a
//   (chunk, piece).  Units need every chunk, so whole chunks would hold
//   the first units until the ring's last hop (3 x 33.5 MB a rank at world
//   4); in pieces they wait for the first piece's hops only, and the
//   list's expert order follows the pieces'.  Crew warp w runs the hops w,
//   w + 3, ... of piece after piece, so one piece's hops overlap the
//   next's, where one chain of W - 1 hops a piece waited on its own
//   signals.  Of a piece a warp moves the buckets that hold a token (runs
//   of consecutive live experts), the only ones a unit reads; the own slot
//   stays empty, the own chunk's boxes reading the shard itself.  On one
//   card the copies are HBM traffic beside the weights': they are 1-D bulk
//   copies (`cp.async.bulk`, global -> shared -> global) through staging
//   buffers past the tile's ring, four a warp, where 96 threads of four
//   16-byte loads kept 6 KB in flight a block.  The TMA thread issues a
//   unit's first b stages, then waits on each of its chunks' arrival word
//   for the unit's piece (acquire, then `fence.proxy.async.global`) before
//   the unit's first a load.  The crew runs the whole ring whatever units
//   its block has, so no block's peers wait on its tiles.
// - Rows: the 3-D tensor maps read a box past cap as zeros, never the next
//   bucket: buckets (R, E, cap, k) as (k, cap, E R), each rank's gathered
//   buffer (W, E, cap, k) as (k, cap, E W), b (R, E, k, n) as (n, k, R E),
//   MN-major.  Rows are not padded.  A box's rows at or past the count are
//   computed (the padding of the bucket); the epilogue stores the live
//   boxes' rows below cap, 16 bytes a lane (`store_box`: a quad of lanes
//   trades its fragment pairs so that each lane holds 8 columns of a row),
//   and the crew, after the ring, writes zeros into every box with no
//   token (JAX grouped_gemm.py :160-168: a NaN there would survive the
//   zero-weighted combine), so the row tile of
//   `grouped_gemm.row_tile(.., "wgmma")` is 64 at every capacity.
// Every box sums k in one order on m64n128k16, so by the tile promise an
// element has K8's bits for the same bucket row and weights.
// - int8 (`Int8Ops`): the buckets are int8 rows of k bytes, so the ring
//   moves half the bytes; the weights are stored K-major, (R, E, n, k) read
//   as (k, n, R E) (`wgmma` has no transpose for 8-bit types; the layer
//   keeps them so once); the products are m64n128k32 into int32, and the
//   epilogue (`wg::dequant_box`) multiplies each by its row's token scale
//   (the gathered (W, E, cap), read outside the kernel as JAX gathers them
//   in XLA) and its column's scale (sb_r (E, n)), then stores bf16 on
//   16-byte rows as `store_box` does, f32 and other rows by fragment pairs
//   (`wg::store_frag`).  Exact, so equal to the plain version bit for bit.
//
// f32 operands (CUDA cores) and bf16 off 16-byte rows (`gemm_tile.cuh`'s
// `mma.sync` tile) keep the first body: the ring of K12
// (`comm_body.cuh` `emit_ag_ring`) run by the whole block, each chunk
// forwarded before it is computed; on each held chunk the P blocks of a
// rank stride over the chunk's occupied tiles only: per chunk, the
// exclusive prefix over experts of the row tiles that hold a token
// (`tile_start`, (W, E + 1)), and tile j of the chunk is (live row tile j %
// L, column tile j / L) of its expert, found by binary search.  Rows of the
// row tiles past an expert's count compute nothing and are written as
// zeros.  The tile is K8's (`gemm_tile.cuh`: 16, 64 or 128 rows by cap, f32
// on the CUDA cores).  A failed tensor-map encode, attribute or launch
// returns its error code; no call falls back to another body.

#include <algorithm>

#include "comm_body.cuh"
#include "tile_body.cuh"
#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;
namespace body = tdt::body;

template <class Body>
struct Args {
  const typename Body::In* a;  // (R, E, cap, k): the launched ranks' buckets
  const typename Body::In* b;  // (R, E, k, n): their weight shards
  const float* sa;             // int8: (W, E, cap), every chunk's scales
  const float* sb;             // int8: (R, E, n)
  const int* tile_start;       // (W, E + 1): live row tiles before expert e
  typename Body::Out* out;     // (R, W, E, cap, n)
  dl::Symm<char> gathered;     // rank r's (W, E, cap, k)
  dl::Symm<u64> sig;           // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int e, cap, n, k, vec;
  u64 epoch;                   // the instance's sum of P before this call
};

// Zeros into ``elems`` elements at ``o`` by a block's threads, 16 bytes a
// store where aligned.
template <typename TO>
__device__ __forceinline__ void zero_fill(TO* o, size_t elems) {
  constexpr size_t V = 16 / sizeof(TO);
  size_t done = 0;
  if (reinterpret_cast<uintptr_t>(o) % 16 == 0) {
    done = elems / V * V;
    uint4* v = reinterpret_cast<uint4*>(o);
    for (size_t i = threadIdx.x; i < done / V; i += blockDim.x)
      v[i] = make_uint4(0, 0, 0, 0);
  }
  for (size_t i = done + threadIdx.x; i < elems; i += blockDim.x)
    tdt::store1(o + i, 0.f);
}

template <class Body>
__global__ void __launch_bounds__(Body::NT, gemm::MIN_BLOCKS)
    ag_group_gemm_kernel(Args<Body> p) {
  using In = typename Body::In;
  using TO = typename Body::Out;
  __shared__ __align__(16) typename Body::Smem sm;
  const dl::Team& t = p.team;
  const int y = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t chunk = (size_t)p.e * p.cap * p.k;
  const size_t out_chunk = (size_t)p.e * p.cap * p.n;
  const In* b = p.b + (size_t)y * p.e * p.k * p.n;
  const float* sb = p.sb ? p.sb + (size_t)y * p.e * p.n : nullptr;
  TO* out = p.out + (size_t)y * t.world * out_chunk;
  const int ntn = (p.n + Body::BN - 1) / Body::BN;

  tdt::comm::emit_ag_ring(
      t, p.a + y * chunk, p.gathered, chunk * sizeof(In), p.sig, target,
      tdt::WAIT_AG_GROUP_GEMM_RING, [&](int c, const char* bytes) {
        const In* held = reinterpret_cast<const In*>(bytes);
        const int* first = p.tile_start + (size_t)c * (p.e + 1);
        TO* oc = out + c * out_chunk;
        // Rows past each expert's live row tiles: zeros.
        for (int ex = part; ex < p.e; ex += parts) {
          const int from = min(p.cap, (first[ex + 1] - first[ex]) * Body::BM);
          zero_fill(oc + ((size_t)ex * p.cap + from) * p.n,
                    (size_t)(p.cap - from) * p.n);
        }
        const int live = first[p.e];
        for (int j = part; j < live * ntn; j += parts) {
          const int q = j % live, nt = j / live;
          int lo = 0, hi = p.e;  // the expert ex with first[ex] <= q < first[ex + 1]
          while (hi - lo > 1) {
            const int mid = (lo + hi) / 2;
            if (first[mid] <= q) lo = mid; else hi = mid;
          }
          const size_t slot0 = ((size_t)c * p.e + lo) * p.cap;
          __syncthreads();
          Body::run(sm, held + (size_t)lo * p.cap * p.k,
                    b + (size_t)lo * p.k * p.n,
                    p.sa ? p.sa + slot0 : nullptr,
                    sb ? sb + (size_t)lo * p.n : nullptr,
                    oc + (size_t)lo * p.cap * p.n, p.cap, p.n, p.k,
                    (q - first[lo]) * Body::BM, nt * Body::BN, p.vec);
        }
      });
}

// P blocks a rank: as many as the dense tile grid of a chunk has tiles, at
// most as many as can be resident together with every other rank's; then
// one cooperative launch.
template <class Body>
int launch(Args<Body> p, int ranks, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(ag_group_gemm_kernel<Body>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Body::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = p.e * ((p.cap + Body::BM - 1) / Body::BM) *
                   ((p.n + Body::BN - 1) / Body::BN);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Body::NT),
                                          args, 0, s);
}

template <class Body>
int run(const void* a, const void* b, const void* sa, const void* sb,
        const void* tile_start, void* out, void* const* gathered,
        void* const* sig, int world, int e, int cap, int n, int k,
        u64 epoch, int* blocks, cudaStream_t s) {
  Args<Body> p{};
  p.a = static_cast<const typename Body::In*>(a);
  p.b = static_cast<const typename Body::In*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.tile_start = static_cast<const int*>(tile_start);
  p.out = static_cast<typename Body::Out*>(out);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  p.team = dl::Team{world, 0};
  p.e = e;
  p.cap = cap;
  p.n = n;
  p.k = k;
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  p.epoch = epoch;
  return launch<Body>(p, world, blocks, s);
}

int run_bf16(const void* a, const void* b, const void* tile_start, void* out,
             void* const* gathered, void* const* sig, int world, int e,
             int cap, int n, int k, u64 epoch, int* blocks, cudaStream_t s) {
  if (cap <= 16)
    return run<body::Float<gemm::Bf16Tile16, bf16>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  if (cap <= 64)
    return run<body::Float<gemm::Bf16Tile64, bf16>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  return run<body::Float<gemm::Bf16Tile128, bf16>>(
      a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e, cap,
      n, k, epoch, blocks, s);
}


// ---- the Hopper body: bf16 on 16-byte rows, and int8 ----------------------

namespace wg = tdt::wgmma;
namespace comm = tdt::comm;

//: Two consumer warpgroups of two 64-row boxes on m64n128k16 (bf16) or
//: m64n128k32 (int8), four stages; both forms have the same stage bytes.
template <class Ops>
using UnitTileOf = wg::Tile<2, 4, 128, 2, Ops>;
using UnitTile = UnitTileOf<wg::Bf16Ops>;
static_assert(UnitTileOf<wg::Int8Ops>::SMEM_BYTES == UnitTile::SMEM_BYTES,
              "one staging layout for both forms");
//: Boxes a unit, and the code of an empty slot.
constexpr int UNIT_BOXES = UnitTile::BM / wg::WG_ROWS;
constexpr unsigned NO_BOX = 0xFFFF;
//: The communication crew: the producer warpgroup's warps 1-3 on named
//: barrier 1.
constexpr int CREW_THREADS = 96, CREW_BARRIER = 1;

struct WgArgs {
  CUtensorMap ta;                 // buckets (R, E, cap, k) as (k, cap, E R)
  CUtensorMap tb;                 // b (R, E, k, n) as (n, k, R E); int8: its
                                  // K-major (R, E, n, k) as (k, n, R E)
  CUtensorMap tg[dl::MAX_RANKS];  // rank r's gathered as (k, cap, E W)
  const int4* units;   // {e, column tile, boxes 0-1, boxes 2-3} a unit
  const int* ntiles;   // the units in the list
  const int* counts;   // (W, E) tokens a bucket, or null (every row live)
  const char* a;       // (R, E, cap, k): the launched ranks' buckets
  void* out;           // (R, W, E, cap, n): bf16, or bf16 / f32 for int8
  const float* sa;     // int8: (W, E, cap), every chunk's per-token scales
  const float* sb;     // int8: (R, E, n)
  dl::Symm<char> gathered;  // rank r's (W, E, cap, k)
  dl::Symm<u64> sig;   // rank r's 2 + W pieces signal words
  dl::Team team;
  int e, cap, n, k;
  int es, out_es;      // bytes of a bucket element (2 or 1) and of an out one
  int vec;             // bf16 out on 16-byte rows: 16-byte stores
  int epp, pieces;     // experts a piece of the ring, pieces a chunk
  u64 epoch;           // the instance's sum of P before this call
};

// Box s (0 .. 3) of unit ``u``: (row box i) << 3 | chunk, or NO_BOX.
__device__ __forceinline__ unsigned unit_box(const int4& u, int s) {
  const unsigned w = (unsigned)(s < 2 ? u.z : u.w);
  return s & 1 ? w >> 16 : w & 0xFFFF;
}

//: The crew's staging, in the shared memory that the tile leaves of a
//: block's 227 KB: for each crew warp RING_BUFS buffers of RING_BUF bytes
//: (whole 128-byte lines) for its bulk copies, a barrier each.
constexpr int CREW_WARPS = CREW_THREADS / 32;
constexpr int MAX_SMEM = 232448, RING_BUFS = 4;
constexpr int RING_BUF =
    ((MAX_SMEM - UnitTile::SMEM_BYTES - 128) / (CREW_WARPS * RING_BUFS) - 8) /
    128 * 128;
constexpr int SMEM_BYTES = UnitTile::SMEM_BYTES + 128 +
                           CREW_WARPS * RING_BUFS * (RING_BUF + 8);
static_assert(RING_BUF >= 1024 && SMEM_BYTES <= MAX_SMEM, "staging");

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A crew warp's bulk copies, issued by its lane 0 through its staging
// buffers: the u-th piece of RING_BUF bytes it moves goes through buffer u
// % RING_BUFS, whose barrier then completes its phase u / RING_BUFS.
struct Stager {
  uint8_t* buf;
  uint64_t* bar;
  unsigned used;  // pieces moved so far

  __device__ __forceinline__ void load(const char* src, unsigned u,
                                       unsigned bytes) {
    const unsigned b = u % RING_BUFS;
    tdt::mbar_expect_tx(&bar[b], bytes);
    tdt::bulk_load(buf + b * RING_BUF, src, bytes, &bar[b]);
  }
  // Block ``part``'s share of ``bytes`` (16-byte multiples and alignment)
  // from ``src`` to ``dst``, whole 128-byte lines but the last: global ->
  // shared -> global a piece at a time, every buffer's load in flight
  // before the first store, and a buffer loaded again once the store
  // before last has read it.  The stores are still in flight on return
  // (`bulk_wait_all`).
  __device__ __forceinline__ void copy(char* dst, const char* src,
                                       size_t bytes, int part, int parts) {
    const unsigned units = (unsigned)(bytes / 16);
    const unsigned share = (units + 8 * parts - 1) / (8u * parts) * 8;
    const unsigned start = (unsigned)part * share;
    const unsigned lo = start < units ? start : units;
    const unsigned hi = units - lo < share ? units : lo + share;
    constexpr unsigned PER = RING_BUF / 16;
    const unsigned n = (hi - lo + PER - 1) / PER;
    auto at = [&](unsigned i) { return (size_t)(lo + i * PER) * 16; };
    auto len = [&](unsigned i) { return min(PER, hi - lo - i * PER) * 16; };
    tdt::bulk_wait_read<0>();  // the last call's stores have read theirs
    for (unsigned i = 0; i < n && i < RING_BUFS; ++i)
      load(src + at(i), used + i, len(i));
    for (unsigned i = 0; i < n; ++i) {
      const unsigned u = used + i;
      tdt::mbar_wait(&bar[u % RING_BUFS], (u / RING_BUFS) & 1);
      tdt::bulk_store(dst + at(i), buf + u % RING_BUFS * RING_BUF, len(i));
      tdt::bulk_commit();
      const unsigned next = i - 1 + RING_BUFS;  // piece i - 1's buffer
      if (i > 0 && next < n) {
        tdt::bulk_wait_read<1>();
        load(src + at(next), used + next, len(next));
      }
    }
    used += n;
  }
};

// The crew's ring: the neighbour entry barrier, then piece after piece
// (experts epp q .. of every chunk): this rank's piece into the right
// neighbour's slot me, and for s = 1 .. W-2 the piece of chunk (r - s) mod
// W once the left neighbour's P blocks have delivered it (word ARRIVAL_WORD
// + chunk pieces + q), forwarded to the right; one signal a block a word.
// Crew warp w runs the hops s = w, w + 3, ... of every piece in order, so
// the hops of successive pieces overlap (hop s of piece q waits only for
// hop s - 1 of q at the left neighbour, which comes earlier in its warp's
// order: no cycle).  Of a piece a warp moves the buckets that hold a
// token, the only ones a unit reads: its lanes read the counts of 32
// experts at once and find the runs of live buckets (a ballot), each run
// one copy that every block shares.  The copies are bulk copies through
// the warp's staging (`Stager`), issued by its lane 0; before a signal its
// stores are done and fenced against the generic proxy, and after a wait
// the acquire is fenced against the async proxy of its loads.  Then the
// block's share of the output boxes with no token: zeros, bulk stores of a
// zeroed buffer.
__device__ __forceinline__ void k11_crew(const WgArgs& p, uint8_t* stage,
                                         const comm::Crew& c) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t bucket = (size_t)p.cap * p.k * p.es;
  const size_t chunk = bucket * p.e;
  const int right = dl::peer_id(t, me + 1);
  const char* shard = p.a + y * chunk;
  const char* mine = p.gathered[me];
  char* theirs = p.gathered[right];
  const int w = c.tid / 32, lane = c.tid % 32;
  const bool lead = lane == 0;
  Stager st{stage + w * RING_BUFS * RING_BUF,
            reinterpret_cast<uint64_t*>(stage + CREW_WARPS * RING_BUFS *
                                                    RING_BUF) +
                w * RING_BUFS,
            0};
  if (lead) {
    for (int b = 0; b < RING_BUFS; ++b) tdt::mbar_init(&st.bar[b], 1);
    tdt::mbar_init_fence();
  }
  comm::crew_entry_barrier(t, p.sig, target, /*neighbors_only=*/true, c);
  for (int q = 0; q < p.pieces; ++q) {
    const int e0 = q * p.epp, e1 = min(p.e, e0 + p.epp);
    for (int s = w; s < t.world - 1; s += CREW_WARPS) {
      const int ch = dl::peer_id(t, me - s);
      if (s > 0) {
        if (lead) {
          dl::signal_wait_until(
              p.sig[me] + dl::ARRIVAL_WORD + ch * p.pieces + q, target,
              tdt::WAIT_AG_GROUP_GEMM_FORWARD);
          fence_proxy_async_global();
        }
        __syncwarp();
      }
      const char* from = s == 0 ? shard : mine + ch * chunk;
      for (int g = e0; g < e1; g += 32) {
        const int e = g + lane;
        unsigned live = __ballot_sync(
            0xFFFFFFFFu, e < e1 && (p.counts == nullptr ||
                                    __ldg(p.counts + ch * p.e + e) > 0));
        while (live != 0) {
          const int a = __ffs(live) - 1;
          const unsigned rest = ~(live >> a);
          const int n = rest == 0 ? 32 - a : __ffs(rest) - 1;
          live &= n == 32 ? 0u : ~(((1u << n) - 1) << a);
          const size_t off = (size_t)(g + a) * bucket;
          if (lead)
            st.copy(theirs + ch * chunk + off, from + off, n * bucket, part,
                    parts);
        }
      }
      if (lead) {
        tdt::bulk_wait_all();
        fence_proxy_async_global();
        dl::fence<dl::Scope::gpu>();
        dl::notify(p.sig[right] + dl::ARRIVAL_WORD + ch * p.pieces + q);
      }
      __syncwarp();
    }
  }
  c.sync();  // every warp's copies done: warp 0's staging is free
  if (p.counts == nullptr) return;
  // Zeros: the crew clears warp 0's buffer 0, then its lane 0 stores it
  // over the block's share of the boxes with no token.
  uint4* zeros = reinterpret_cast<uint4*>(stage);
  for (int x = c.tid; x < RING_BUF / 16; x += c.n)
    zeros[x] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  c.sync();
  if (c.tid != 0) return;
  const int rt = (p.cap + wg::WG_ROWS - 1) / wg::WG_ROWS;
  const int boxes = t.world * p.e * rt;
  char* out = static_cast<char*>(p.out) +
              (size_t)y * t.world * p.e * p.cap * p.n * p.out_es;
  for (int j = part; j < boxes; j += parts) {
    const int ce = j / rt, r0 = j % rt * wg::WG_ROWS;
    if (__ldg(p.counts + ce) > r0) continue;
    const unsigned bytes =
        (unsigned)(min(wg::WG_ROWS, p.cap - r0) * p.n * p.out_es);
    char* o = out + ((size_t)ce * p.cap + r0) * p.n * p.out_es;
    for (unsigned off = 0; off < bytes; off += RING_BUF)
      tdt::bulk_store(o + off, stage, min((unsigned)RING_BUF, bytes - off));
  }
  tdt::bulk_commit();
  tdt::bulk_wait_all();
}

// A box's accumulator values ``val(i)`` (one m64n128 fragment of consumer
// warpgroup lanes: the accumulators, or their int8 dequantization) as bf16
// rows [row0, row0 + 64) x columns [col0, col0 + 128) of the row-major (M,
// N) ``o``; rows past M and columns past N dropped (N a multiple of 8).  A
// row's 8-column group lies in the 4 lanes of a quad, a pair each: for
// each 4 groups the quad trades pairs (a 4 x 4 transpose by two `shfl_xor`
// steps, selects element by element), so each lane stores a whole group,
// 16 bytes, and 4 lanes 64 contiguous bytes a row.
template <class F>
__device__ __forceinline__ void store_box(bf16* o, int M, int N, int row0,
                                          int col0, const F& val) {
  const int warp = threadIdx.x % wg::WG / 32, lane = threadIdx.x % 32;
  const int q = lane % 4, r = row0 + warp * 16 + lane / 4;
  auto pack = [](float x, float y) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&h);
  };
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 16 * b + 2 * h;  // group 4 b + j: acc[i + 4 j], + 1
      unsigned v0 = pack(val(i), val(i + 1));
      unsigned v1 = pack(val(i + 4), val(i + 5));
      unsigned v2 = pack(val(i + 8), val(i + 9));
      unsigned v3 = pack(val(i + 12), val(i + 13));
      unsigned t0 = q & 1 ? v0 : v1, t1 = q & 1 ? v2 : v3;
      t0 = __shfl_xor_sync(0xFFFFFFFFu, t0, 1);
      t1 = __shfl_xor_sync(0xFFFFFFFFu, t1, 1);
      if (q & 1) {
        v0 = t0;
        v2 = t1;
      } else {
        v1 = t0;
        v3 = t1;
      }
      t0 = q & 2 ? v0 : v2;
      t1 = q & 2 ? v1 : v3;
      t0 = __shfl_xor_sync(0xFFFFFFFFu, t0, 2);
      t1 = __shfl_xor_sync(0xFFFFFFFFu, t1, 2);
      if (q & 2) {
        v0 = t0;
        v1 = t1;
      } else {
        v2 = t0;
        v3 = t1;
      }
      const int row = r + 8 * h, col = col0 + (4 * b + q) * 8;
      if (row < M && col < N)
        *reinterpret_cast<uint4*>(o + (size_t)row * N + col) =
            make_uint4(v0, v1, v2, v3);
    }
  }
}

// The unit list as the tile's schedule, for bf16 (`Bf16Ops`, out bf16) or
// int8 (`Int8Ops`, out bf16 or f32).  The producer thread runs at 40
// registers, so it keeps the last unit's entry and what it has waited for.
template <class Ops, typename TO>
struct UnitSched {
  using Tile = UnitTileOf<Ops>;
  const WgArgs* p;
  uint8_t* stage;  // the crew's staging
  int at_t;       // the last unit located
  int4 u;         // its entry
  int held_q;     // the piece whose arrivals ``held`` records
  unsigned held;  // chunks (a bit each) waited for in piece held_q

  __device__ __forceinline__ void locate(int t) {
    if (t == at_t) return;
    at_t = t;
    u = __ldg(p->units + t);
  }
  __device__ __forceinline__ int live() const {
    int nb = 0;
#pragma unroll
    for (int s = 0; s < UNIT_BOXES; ++s) nb += unit_box(u, s) != NO_BOX;
    return nb;
  }
  // The unit's chunks other than this rank's, a bit each.
  __device__ __forceinline__ unsigned need() const {
    unsigned m = 0;
#pragma unroll
    for (int s = 0; s < UNIT_BOXES; ++s) {
      const unsigned b = unit_box(u, s);
      if (b != NO_BOX && (int)(b & 7) != (int)blockIdx.y) m |= 1u << (b & 7);
    }
    return m;
  }
  __device__ __forceinline__ wg::At at(int t) {
    locate(t);
    return {&p->ta, 0, 0, u.y * Tile::TN, (int)blockIdx.y * p->e + u.x,
            (p->k + Tile::KS - 1) / Tile::KS, live()};
  }
  __device__ __forceinline__ bool pending(int t) {
    locate(t);
    const unsigned seen = u.x / p->epp == held_q ? held : 0u;
    return (need() & ~seen) != 0;
  }
  __device__ __forceinline__ void ready(int) {
    const int q = u.x / p->epp;
    if (q != held_q) {
      held_q = q;
      held = 0;
    }
    const unsigned m = need();
    for (unsigned w = m & ~held; w != 0; w &= w - 1)
      comm::wait_word_for_tma(p->sig[blockIdx.y] + dl::ARRIVAL_WORD +
                                  (__ffs(w) - 1) * p->pieces + q,
                              p->epoch + gridDim.x,
                              tdt::WAIT_AG_GROUP_GEMM_LOAD);
    held |= m;
  }
  // Stage kt's live boxes: the own chunk's from the shards' map, the
  // others' from this rank's gathered buffer; group c E + e in both.
  __device__ __forceinline__ void load_a(uint8_t* dst, uint64_t* bar,
                                         int kt) {
#pragma unroll
    for (int s = 0; s < UNIT_BOXES; ++s) {
      const unsigned b = unit_box(u, s);
      if (b == NO_BOX) break;
      const int c = b & 7;
      wg::tma_load_3d(dst + s * Tile::BOX_BYTES,
                      c == (int)blockIdx.y ? &p->ta : &p->tg[blockIdx.y], bar,
                      kt * Tile::KS, (int)(b >> 3) * wg::WG_ROWS,
                      c * p->e + u.x);
    }
  }
  __device__ __forceinline__ void side(int i) {
    k11_crew(*p, stage, comm::Crew{i, CREW_THREADS, CREW_BARRIER});
  }
  // Box ``b`` of the unit, accumulators ``acc``: rows below cap of chunk
  // c's bucket e in this rank's out; int8 dequantized with the chunk's
  // token scales and this rank's column scales of expert e.
  __device__ __forceinline__ void store_one(
      unsigned b, int col, typename Tile::Acc (&acc)[Tile::ACC / 2]) {
    const int c = b & 7, row0 = (int)(b >> 3) * wg::WG_ROWS;
    const size_t bucket = ((size_t)blockIdx.y * p->team.world + c) * p->e +
                          u.x;
    TO* o = static_cast<TO*>(p->out) + bucket * p->cap * p->n;
    if constexpr (std::is_same<typename Tile::Acc, float>::value) {
      store_box(o, p->cap, p->n, row0, col, [&](int i) { return acc[i]; });
    } else {
      wg::dequant_box(acc, p->sa + ((size_t)c * p->e + u.x) * p->cap,
                      p->cap, row0,
                      p->sb + ((size_t)blockIdx.y * p->e + u.x) * p->n, col,
                      p->n);
      const auto val = [&](int i) { return __int_as_float(acc[i]); };
      if constexpr (std::is_same<TO, bf16>::value) {
        if (p->vec) {
          store_box(o, p->cap, p->n, row0, col, val);
          return;
        }
      }
      wg::store_frag<Tile::ACC / 2>(o, p->cap, p->n, row0, col, val);
    }
  }
  // Warpgroup wgi's boxes wgi and 2 + wgi, where live.
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        typename Tile::Acc (&acc)[Tile::ACC]) {
    locate(t);
    using Half = typename Tile::Acc(&)[Tile::ACC / 2];
    const unsigned b0 = unit_box(u, wgi), b1 = unit_box(u, 2 + wgi);
    if (b0 != NO_BOX) store_one(b0, w.col, reinterpret_cast<Half>(acc[0]));
    if (b1 != NO_BOX)
      store_one(b1, w.col, reinterpret_cast<Half>(acc[Tile::ACC / 2]));
  }
};

// Compiled for 384 threads (168 registers a thread at entry, so the
// consumers' `setmaxnreg` rises from there, as K12's) and launched with
// UnitTile::NT.
template <class Ops, typename TO>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    ag_group_gemm_wgmma_kernel(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* stage = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + UnitTile::SMEM_BYTES + 127) &
      ~uintptr_t(127));
  UnitSched<Ops, TO> sched{&p, stage, -1, make_int4(0, 0, 0, 0), -1, 0u};
  UnitTileOf<Ops>::run(smem, &p.tb, __ldg(p.ntiles), sched);
}

// Encode the maps, then one cooperative launch: P blocks a rank, as many as
// the list can have units (``tmax``), at most as many as can be resident
// together with every other rank's (one an SM).
template <class Ops, typename TO>
int launch_wgmma(WgArgs& p, const void* b, void* const* gathered, int tmax,
                 int* blocks, cudaStream_t s) {
  const int w = p.team.world, es = p.es;
  constexpr int KS = Ops::K_STAGE;
  int rc = wg::encode_3d(&p.ta, p.a, p.k, p.cap, (uint64_t)p.e * w, KS,
                         wg::WG_ROWS, es);
  if (rc == 0)
    rc = Ops::B_K_MAJOR
             ? wg::encode_3d(&p.tb, b, p.k, p.n, (uint64_t)w * p.e, KS,
                             wg::BOX_N, es)
             : wg::encode_3d(&p.tb, b, p.n, p.k, (uint64_t)w * p.e, wg::BOX_N,
                             KS, es);
  for (int r = 0; r < w && rc == 0; ++r)
    rc = wg::encode_3d(&p.tg[r], gathered[r], p.k, p.cap, (uint64_t)p.e * w,
                       KS, wg::WG_ROWS, es);
  if (rc != 0) return rc;
  auto* fn = ag_group_gemm_wgmma_kernel<Ops, TO>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, UnitTile::NT,
                                                      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / w;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int P = std::min(std::max(tmax, 1), fit);
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn),
                                          dim3(P, w), dim3(UnitTile::NT),
                                          args, SMEM_BYTES, s);
}
}  // namespace

// a (world, E, cap, k) and b (world, E, k, n): every rank's buckets and
// weight shard, in ``dtype`` (tdt::DTYPE_*; out the same); tile_start
// (world, E + 1) int32; out (world, world, E, cap, n); ``gathered`` and
// ``sig``: host tables of ``world`` device pointers, rank r's gathered
// (world, E, cap, k) buffer and its dl::SIGNAL_WORDS u64 counters; all
// contiguous.  ``epoch``: the instance's sum of blocks a rank over its
// earlier calls; the blocks a rank of this launch go to ``*blocks``.
// Returns a cudaError_t code.
extern "C" int ag_group_gemm(const void* a, const void* b,
                             const void* tile_start, void* out,
                             void* const* gathered, void* const* sig,
                             int world, int dtype, int e, int cap, int n,
                             int k, unsigned long long epoch, int* blocks,
                             void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || n < 1 ||
      k < 1 || tile_start == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run_bf16(a, b, tile_start, out, gathered, sig, world, e, cap, n,
                    k, epoch, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<body::Float<gemm::F32Tile, float>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

// The Hopper body's arguments common to both forms, checked; 0 or a
// cudaError_t code.
int wg_args(WgArgs& p, const void* a, const void* b, const void* units,
            const void* ntiles, const void* counts, void* out,
            void* const* gathered, void* const* sig, int world, int e,
            int cap, int n, int k, int tmax, int epp,
            unsigned long long epoch) {
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || n < 1 ||
      k < 1 || tmax < 1 || epp < 1 || units == nullptr || ntiles == nullptr)
    return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(units) |
                    reinterpret_cast<uintptr_t>(out);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  if (align % 16 != 0) return (int)cudaErrorInvalidValue;
  p.units = static_cast<const int4*>(units);
  p.ntiles = static_cast<const int*>(ntiles);
  p.counts = static_cast<const int*>(counts);
  p.a = static_cast<const char*>(a);
  p.out = out;
  p.team = dl::Team{world, 0};
  p.e = e;
  p.cap = cap;
  p.n = n;
  p.k = k;
  p.epp = epp;
  p.pieces = (e + epp - 1) / epp;
  p.epoch = epoch;
  return 0;
}

}  // namespace

// The Hopper body (bf16 on 16-byte rows): a (world, E, cap, k) and b
// (world, E, k, n), every rank's buckets and weight shard; ``units``
// (tmax) int4 and ``ntiles`` (1) int32, the unit list and its length
// (`allgather_group_gemm.unit_list`); counts (world, E) int32 or null;
// out (world, world, E, cap, n); ``gathered`` and ``sig``: host tables of
// ``world`` device pointers, rank r's gathered (world, E, cap, k) buffer
// and its 2 + world pieces u64 counters, pieces = ceil(E / epp) (``epp``
// experts a piece of the ring); all contiguous and 16-byte aligned, k and
// n multiples of 8.  ``epoch``: the instance's sum of blocks a rank over
// its earlier calls; the blocks a rank of this launch go to ``*blocks``.
// Returns a cudaError_t code.
extern "C" int ag_group_gemm_wgmma(const void* a, const void* b,
                                   const void* units, const void* ntiles,
                                   const void* counts, void* out,
                                   void* const* gathered, void* const* sig,
                                   int world, int e, int cap, int n, int k,
                                   int tmax, int epp,
                                   unsigned long long epoch, int* blocks,
                                   void* stream) {
  *blocks = 0;
  WgArgs p{};
  const int rc = wg_args(p, a, b, units, ntiles, counts, out, gathered, sig,
                         world, e, cap, n, k, tmax, epp, epoch);
  if (rc != 0) return rc;
  if (k % 8 != 0 || n % 8 != 0) return (int)cudaErrorInvalidValue;
  p.es = p.out_es = 2;
  p.vec = 1;
  return launch_wgmma<wg::Bf16Ops, bf16>(p, b, gathered, tmax, blocks,
                                         static_cast<cudaStream_t>(stream));
}

// K11-int8 on the Hopper body: a (world, E, cap, k) int8 buckets; bt
// (world, E, n, k) int8, every rank's weight shard K-major (the transpose of
// the JAX layout's (E, k, n) a rank); sa (world, E, cap) f32, every chunk's
// per-token scales; sb (world, E, n) f32; out (world, world, E, cap, n) in
// ``out_dtype`` (bf16 or f32); the rest as `ag_group_gemm_wgmma`, with k a
// multiple of 16 and cap of 32 (any n).  Returns a cudaError_t code.
extern "C" int ag_group_gemm_w8a8(const void* a, const void* bt,
                                  const void* sa, const void* sb,
                                  const void* units, const void* ntiles,
                                  const void* counts, void* out,
                                  void* const* gathered, void* const* sig,
                                  int world, int e, int cap, int n, int k,
                                  int tmax, int epp, int out_dtype,
                                  unsigned long long epoch, int* blocks,
                                  void* stream) {
  *blocks = 0;
  WgArgs p{};
  const int rc = wg_args(p, a, bt, units, ntiles, counts, out, gathered, sig,
                         world, e, cap, n, k, tmax, epp, epoch);
  if (rc != 0) return rc;
  if (k % 16 != 0 || cap % 32 != 0 || sa == nullptr || sb == nullptr)
    return (int)cudaErrorInvalidValue;
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.es = 1;
  p.vec = n % 8 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == tdt::DTYPE_BF16) {
    p.out_es = 2;
    return launch_wgmma<wg::Int8Ops, bf16>(p, bt, gathered, tmax, blocks, s);
  }
  if (out_dtype == tdt::DTYPE_F32) {
    p.out_es = 4;
    return launch_wgmma<wg::Int8Ops, float>(p, bt, gathered, tmax, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
