// Grouped GEMM + top-k weighted combine + ReduceScatter, the MoE
// tensor-parallel epilogue: rank c of a team of W gets out_c = sum over
// ranks r of combine_c(buckets_r[c] @ down_r), the sum taken in f32 in rank
// order of the partials rounded to the activations' type.
//
// Replaces: triton_distributed_tpu/kernels/moe_reduce_rs.py
//   `moe_reduce_rs_fused` -> pallas_call :396 (`_moe_rs_fused_kernel`
//   :128, and the two-phase `_moe_rs_fused_kernel_2p` :199), with float or
//   int8 weights, over grouped_gemm.py `emit_packed_combine` (:391),
//   `emit_packed_matmul` (:514) and `emit_packed_combine_matmul` (:606).
//   Layouts are the JAX wrapper's per rank: the activated buckets of every
//   chunk (W, E, cap, k) (int8 with per-token scales (W, E, cap)), the
//   down-projection shard (E, k, n) (int8 with (E, n) scales), the packed
//   plan's tables `block_expert` / `block_slot` (W, T) and `n_blocks` (W,)
//   (moe_utils.plan_chunks), the receive buffer (W, mc, n) and out (mc, n).
//   The TPU kernel combines with a dense one-hot matmul of the per-block
//   weights `combine_blocks` (T, B, mc); here each token's kept pairs are a
//   table (W, mc, topk) of rows of the packed stage and their weights in the
//   activations' type, which the wrapper reads off the plan
//   (`moe_utils.combine_pairs`: routing metadata, as JAX builds
//   `combine_blocks` in XLA).  The TPU's choice between the single-phase
//   and the two-phase kernel is a VMEM ceiling that has no counterpart
//   here: one design serves both.
//
// What bounds it on the H100: Qwen3-30B-A3B prefill at world 4 (mc = 512,
// 128 experts of cap 64, blocks of 64 rows, k = 192 a rank, n = 2048): the
// bytes.  The weights, 128 x 192 x 2048 bf16 = 101 MB a rank (read once a
// call by the Hopper body, once for each chunk that uses them by the first
// body), the staged rows written and read back by the combine (at most
// topk rows a token: 4 x 512 x 8 x 2048 x 2 = 67 MB a rank, not the TPU's
// ~69 GFLOP one-hot product), beside the down GEMM over the occupied rows
// (at most 4 x 128 x 64 x 192 x 2048 x 2 = 25.8 GFLOP a rank).
//
// The Hopper body: bf16 activations and weights on 16-byte rows (k and n
// multiples of 8, every pointer 16-byte aligned: every MoE TP prefill call
// of the main path).  One cooperative launch holds every rank's blocks
// (`dl.cuh`; blockIdx.y is the rank), P = 132 / W persistent blocks a rank,
// one an SM, on K11's unit tile (`wgmma_tile.cuh` `Tile<2, 4, 128, 2>`: two
// consumer warpgroups of two 64-row boxes on `wgmma` m64n128k16, stages of
// 48 KB loaded by TMA).
// - Units, each weight tile loaded once a rank: a unit is one expert e and
//   one column tile of 128 times up to four live boxes, box (i, c) rows 64 i
//   .. of chunk c's bucket e for every (c, i) whose count is above 64 i
//   (`allgather_group_gemm.unit_list`, built on the device from the plan's
//   counts, K11's list).  A stage loads the unit's b tile once and its live
//   boxes, so each rank reads its down shard once a call (at world 4 and
//   cap 64 a unit's four boxes are the four chunks' buckets), where the
//   first body read it once a chunk.  An expert with more than four live
//   boxes takes consecutive units of the same (e, column tile), which meet
//   in L2.  Products of dead box slots are computed and not stored (a
//   product skipped on a runtime condition serializes every `wgmma`, C7520).
// - The maps: a (R, W, E, cap, k) as (k, cap, R W E), b (R, E, k, n) as (n,
//   k, R E), MN-major; a box past cap, k or n reads zeros.
// - The stage keeps the packed layout of the plan, one (T B, n) a chunk:
//   row ``row`` of box (i, c) of expert e goes to chunk c's row base[c, e] +
//   64 i + row (base: the expert's first packed block times B, the plan's
//   exclusive sum), for the rows below counts[c, e] only, the rows a kept
//   pair reads.  The `store` hook rounds each row to bf16 and stores it as
//   16-byte pieces through a 2 KB slab a warp (`wgmma_epilogue.cuh`, K14's).
// - After its last unit a block's consumers, in the last `store` (code after
//   the tile loop caps the consumers at 168 registers and spills): the
//   rank's blocks meet (the stage is whole); then for each chunk c, remote
//   chunks first, each token's kept pairs in ascending expert order, weight
//   times stage row in f32, rounded, into slot r of rank c's receive
//   buffer, one arrival signal a block; the wait; the rank-order sum; then
//   the consumer threads exit, so that no path leads back to the tile loop
//   and its 128 accumulators a thread are dead through the combine, which
//   keeps a piece's eight pairs' loads in flight (with the accumulators
//   live it spilled).  A block without a unit of the list takes an empty
//   one, so every block reaches that hook.  The crew (the producer
//   warpgroup's spare warps) runs the entry barrier, which opens the
//   consumers' remote stores.
// An element's products sum k in one order (the tile promise), and a row's
// combine and sum read its own pairs only, so back-to-back calls are
// bit-identical; the stage's values may differ from the `mma.sync` body's
// within bf16 rounding.
//
// f32, int8 weights and bf16 off 16-byte rows keep the first body.
//
// The first body (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`; blockIdx.y is the rank); P blocks a rank.
// The entry barrier; then for s = 0 .. W-1 the chunk c = (r + 1 + s) mod W
// (JAX :158: remote chunks first, the own chunk last):
// 1. the packed grouped GEMM: the blocks stride over (occupied block t <
//    n_blocks[c], column tile), rows block_slot[t] B .. of expert
//    block_expert[t], each tile rounded to the activations' type into the
//    rank's packed stage (T B, n) (JAX :466-470: the combine runs in the
//    activations' type); int8 accumulates in int32 and dequantizes with
//    the per-token and per-channel scales (float(acc) * sa) * sw.  The tile
//    is K8's (`gemm_tile.cuh`, 16/64/128 rows by B; f32 on the CUDA cores)
//    or the first int8 tile (`w8a8_body.cuh`).
// 2. the rank's blocks wait for each other (`dl::barrier_rank`): the
//    stage is whole.
// 3. the combine: each token's <= topk kept pairs, in ascending expert
//    order (the order in which the TPU's one-hot combine meets the blocks),
//    weight times stage row in f32, summed in f32, rounded to the
//    activations' type and stored straight into slot r of rank c's receive
//    buffer; one arrival signal a block to rank c.
// Chunks alternate between two stages, so a block that runs ahead into
// chunk s + 1 never overwrites rows a slower block still combines for
// chunk s, and one barrier a chunk is enough (a block reaches the GEMM of
// s + 2 only after every block has left the combine of s).  Last, the wait
// for the W partials of the own chunk and their f32 sum in rank order
// (`comm_body.cuh` `reduce_sum`, JAX `_emit_reduce_sum`).  The result does
// not depend on the number of blocks or their timing: back-to-back calls
// are bit-identical.

#include <algorithm>

#include "comm_body.cuh"
#include "tile_body.cuh"
#include "wgmma_epilogue.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;
namespace body = tdt::body;
namespace comm = tdt::comm;

template <class Body>
struct Args {
  using T = typename Body::Out;
  const typename Body::In* a;  // (R, W, E, cap, k): every chunk's buckets
  const typename Body::In* b;  // (R, E, k, n): the down shards
  const float* sa;             // int8: (R, W, E, cap)
  const float* sb;             // int8: (E, n)
  const int* bexp;             // (W, T)
  const int* bslot;            // (W, T)
  const int* nblk;             // (W,)
  const int* rows;             // (W, mc, topk): stage rows, -1 past the kept
  const T* weights;            // (W, mc, topk)
  T* stage;                    // (R, 2, T B, n)
  T* out;                      // (R, mc, n)
  dl::Symm<char> rbuf;         // rank r's (W, mc, n)
  dl::Symm<u64> sig;           // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int e, cap, k, n, mc, tmax, block, topk, vec;
  u64 epoch;                   // the instance's sum of P before this call
};

// Token i's combine over columns [col, col + cnt) (cnt 8 with vec8, else
// 1) into out_row.
template <typename T>
__device__ __forceinline__ void combine_cols(const T* stage, const int* rows,
                                             const T* w, int topk, int n,
                                             int col, bool vec8, T* out_row) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int kk = 0; kk < topk; ++kk) {
    const int r = rows[kk];
    if (r < 0) break;
    const float wv = tdt::comm::load1_cg(w + kk);
    const T* src = stage + (size_t)r * n + col;
    if (vec8) {
      float v[8];
      comm::load8_cg(src, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wv, v[j]));
    } else {
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wv, comm::load1_cg(src)));
    }
  }
  if (vec8)
    comm::store8(out_row + col, acc);
  else
    tdt::store1(out_row + col, acc[0]);
}

template <class Body>
__global__ void __launch_bounds__(Body::NT, gemm::MIN_BLOCKS)
    moe_reduce_rs_kernel(Args<Body> p) {
  using In = typename Body::In;
  using T = typename Body::Out;
  __shared__ __align__(16) typename Body::Smem sm;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t bucket = (size_t)p.e * p.cap;        // rows of one chunk
  const size_t stage_elems = (size_t)p.tmax * p.block * p.n;
  const size_t o_chunk = (size_t)p.mc * p.n;
  const In* b = p.b + (size_t)y * p.e * p.k * p.n;
  const int ntn = (p.n + Body::BN - 1) / Body::BN;
  const int mtb = (p.block + Body::BM - 1) / Body::BM;  // row tiles a block
  const bool vec8 = p.n % 8 == 0;
  const int ng = vec8 ? p.n / 8 : p.n;                  // column units a row

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  for (int s = 0; s < w; ++s) {
    const int c = dl::peer_id(t, me + 1 + s);
    const size_t chunk = (size_t)y * w + c;
    const In* a = p.a + chunk * bucket * p.k;
    const float* sa = p.sa ? p.sa + chunk * bucket : nullptr;
    T* stage = p.stage + ((size_t)y * 2 + (s & 1)) * stage_elems;
    const int* bexp = p.bexp + (size_t)c * p.tmax;
    const int* bslot = p.bslot + (size_t)c * p.tmax;
    // 1. the packed grouped GEMM over the chunk's occupied blocks.
    const int tiles = p.nblk[c] * mtb;
    for (int j = part; j < tiles * ntn; j += parts) {
      const int tb = j % tiles, nt = j / tiles;
      const int blk = tb / mtb, ex = bexp[blk];
      const size_t row0 = (size_t)ex * p.cap + (size_t)bslot[blk] * p.block;
      __syncthreads();
      Body::run(sm, a + row0 * p.k, b + (size_t)ex * p.k * p.n,
                sa ? sa + row0 : nullptr, p.sb ? p.sb + (size_t)ex * p.n : nullptr,
                stage + (size_t)blk * p.block * p.n, p.block, p.n, p.k,
                (tb % mtb) * Body::BM, nt * Body::BN, p.vec);
    }
    // 2. the stage is whole: the (s + 1)-th of this call's W barriers.
    dl::barrier_rank(t, p.sig, (u64)w * p.epoch + (u64)(s + 1) * gridDim.x);
    // 3. the combine, into slot me of rank c's receive buffer.
    T* dst = reinterpret_cast<T*>(p.rbuf[c]) + me * o_chunk;
    const int* rows = p.rows + (size_t)c * p.mc * p.topk;
    const T* wts = p.weights + (size_t)c * p.mc * p.topk;
    const size_t units = (size_t)p.mc * ng;
    for (size_t u = (size_t)part * blockDim.x + threadIdx.x; u < units;
         u += (size_t)parts * blockDim.x) {
      const size_t i = u / ng;
      const int col = (int)(u % ng) * (vec8 ? 8 : 1);
      combine_cols(stage, rows + i * p.topk, wts + i * p.topk, p.topk, p.n,
                   col, vec8, dst + i * p.n);
    }
    u64* word = p.sig[c] + dl::ARRIVAL_WORD + me;
    dl::signal_after_puts(&word, 1);
  }
  dl::wait(p.sig[me] + dl::ARRIVAL_WORD, w, 1, target,
           tdt::WAIT_MOE_REDUCE_RS_PARTIAL);
  comm::reduce_sum(reinterpret_cast<const T*>(p.rbuf[me]), p.out + y * o_chunk,
                   w, o_chunk, part, parts);
}

// P blocks a rank: as many as the dense block grid of a chunk has tiles, at
// most as many as can be resident together with every other rank's; then
// one cooperative launch.
template <class Body>
int launch(Args<Body> p, int ranks, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(moe_reduce_rs_kernel<Body>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Body::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = p.tmax * ((p.block + Body::BM - 1) / Body::BM) *
                   ((p.n + Body::BN - 1) / Body::BN);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Body::NT),
                                          args, 0, s);
}

struct Raw {
  const void *a, *b, *sa, *sb, *bexp, *bslot, *nblk, *rows, *weights;
  void *stage, *out;
  void* const* rbuf;
  void* const* sig;
  int world, e, cap, k, n, mc, tmax, block, topk;
  u64 epoch;
};

template <class Body>
int run(const Raw& r, int* blocks, cudaStream_t s) {
  using T = typename Body::Out;
  Args<Body> p{};
  p.a = static_cast<const typename Body::In*>(r.a);
  p.b = static_cast<const typename Body::In*>(r.b);
  p.sa = static_cast<const float*>(r.sa);
  p.sb = static_cast<const float*>(r.sb);
  p.bexp = static_cast<const int*>(r.bexp);
  p.bslot = static_cast<const int*>(r.bslot);
  p.nblk = static_cast<const int*>(r.nblk);
  p.rows = static_cast<const int*>(r.rows);
  p.weights = static_cast<const T*>(r.weights);
  p.stage = static_cast<T*>(r.stage);
  p.out = static_cast<T*>(r.out);
  uintptr_t align = reinterpret_cast<uintptr_t>(r.a) |
                    reinterpret_cast<uintptr_t>(r.b);
  for (int i = 0; i < r.world; ++i) {
    p.rbuf.ptr[i] = static_cast<char*>(r.rbuf[i]);
    p.sig.ptr[i] = static_cast<u64*>(r.sig[i]);
  }
  p.team = dl::Team{r.world, 0};
  p.e = r.e;
  p.cap = r.cap;
  p.k = r.k;
  p.n = r.n;
  p.mc = r.mc;
  p.tmax = r.tmax;
  p.block = r.block;
  p.topk = r.topk;
  p.vec = r.k % 8 == 0 && r.n % 8 == 0 && align % 16 == 0;
  p.epoch = r.epoch;
  return launch<Body>(p, r.world, blocks, s);
}

int run_bf16(const Raw& r, int* blocks, cudaStream_t s) {
  if (r.block <= 16) return run<body::Float<gemm::Bf16Tile16, bf16>>(r, blocks, s);
  if (r.block <= 64) return run<body::Float<gemm::Bf16Tile64, bf16>>(r, blocks, s);
  return run<body::Float<gemm::Bf16Tile128, bf16>>(r, blocks, s);
}

// ---- the Hopper body: bf16 on 16-byte rows ---------------------------------

namespace wg = tdt::wgmma;

//: K11's unit tile: two consumer warpgroups of two 64-row boxes on
//: m64n128k16, four stages.
using UnitTile = wg::Tile<2, 4, 128, 2>;
constexpr int CONSUMERS = UnitTile::BM / (UnitTile::BOXES * wg::WG_ROWS);
//: Boxes a unit, and the code of an empty slot.
constexpr int UNIT_BOXES = UnitTile::BM / wg::WG_ROWS;
constexpr unsigned NO_BOX = 0xFFFF;
//: The consumer warps' slabs at the start of the dynamic shared memory,
//: the ring after them.
constexpr int EPI_BYTES = CONSUMERS * wg::WG / 32 * wg::SLAB_BYTES;
constexpr int SMEM_BYTES = EPI_BYTES + UnitTile::SMEM_BYTES;

struct WgArgs {
  CUtensorMap ta;        // a (R, W, E, cap, k) as (k, cap, R W E)
  CUtensorMap tb;        // b (R, E, k, n) as (n, k, R E)
  const int4* units;     // {e, column tile, boxes 0-1, boxes 2-3} a unit
  const int* ntiles;     // the units in the list
  const int* counts;     // (W, E): tokens of chunk c's bucket e
  const int* base;       // (W, E): chunk c's stage row of bucket e's slot 0
  const int* rows;       // (W, mc, topk): stage rows, -1 past the kept
  const bf16* weights;   // (W, mc, topk)
  bf16* stage;           // (R, W, T B, n)
  bf16* out;             // (R, mc, n)
  dl::Symm<char> rbuf;   // rank r's (W, mc, n)
  dl::Symm<u64> sig;     // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int e, k, n, mc, trows, topk;
  u64 epoch;             // the instance's sum of P before this call
};

// Box s (0 .. 3) of unit ``u``: (row box i) << 3 | chunk, or NO_BOX.
__device__ __forceinline__ unsigned unit_box(const int4& u, int s) {
  const unsigned w = (unsigned)(s < 2 ? u.z : u.w);
  return s & 1 ? w >> 16 : w & 0xFFFF;
}

//: Pairs of a piece whose stage loads go out together: all eight of
//: Qwen3's top-8 (the consumers' accumulators are dead by then, see
//: `RsSched::store`, so the loads have the registers).
constexpr int COMBINE_PAIRS = 8;

// One 16-byte piece (8 columns) of a token's combine: its kept pairs
// ``rows`` (stage rows of ``stage``, -1 past the kept) in order, weight
// times row in f32, each product and sum rounded as the plain version's;
// COMBINE_PAIRS pairs' loads in flight at a time.  Stored to ``dst``.
__device__ __forceinline__ void combine_piece(const bf16* stage,
                                              const int* rows, const bf16* w,
                                              int topk, int n, int col,
                                              bf16* dst) {
  constexpr int J = COMBINE_PAIRS;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < topk; k0 += J) {
    int r[J];
    uint4 v[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      r[j] = k0 + j < topk ? __ldg(rows + k0 + j) : -1;
#pragma unroll
    for (int j = 0; j < J; ++j)
      v[j] = r[j] >= 0 ? __ldcg(reinterpret_cast<const uint4*>(
                             stage + (size_t)r[j] * n + col))
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (r[j] < 0) continue;
      const float wv = tdt::comm::load1_cg(w + k0 + j);
      float f[8];
      wg::unpack8(v[j], f);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        acc[x] = __fadd_rn(acc[x], __fmul_rn(wv, f[x]));
    }
  }
  tdt::comm::store8(dst, acc);
}

// The unit list as the tile's schedule; tiles past the list are empty
// units (no box), so that every block has one.
struct RsSched {
  static constexpr int C = CONSUMERS;
  const WgArgs* p;
  uint64_t* entered;
  uint8_t* epi;   // the consumer warps' slabs
  int ntiles;     // the list's units
  int total;      // the tiles the blocks walk: at least one a block
  int nk;
  u64 target;
  int at_t;       // the last unit located
  int4 u;         // its entry
  bool open;      // a consumer has seen the entry barrier pass

  __device__ __forceinline__ void locate(int t) {
    if (t == at_t) return;
    at_t = t;
    u = t < ntiles ? __ldg(p->units + t) : make_int4(0, 0, -1, -1);
  }
  __device__ __forceinline__ int live() const {
    int nb = 0;
#pragma unroll
    for (int s = 0; s < UNIT_BOXES; ++s) nb += unit_box(u, s) != NO_BOX;
    return nb;
  }
  __device__ __forceinline__ wg::At at(int t) {
    locate(t);
    return {&p->ta, 0, 0, u.y * UnitTile::TN, (int)blockIdx.y * p->e + u.x,
            nk, live()};
  }
  __device__ __forceinline__ bool pending(int) const { return false; }
  __device__ __forceinline__ void ready(int) {}
  // Stage kt's live boxes: chunk c's bucket e, group (y W + c) E + e.
  __device__ __forceinline__ void load_a(uint8_t* dst, uint64_t* bar,
                                         int kt) {
#pragma unroll
    for (int s = 0; s < UNIT_BOXES; ++s) {
      const unsigned b = unit_box(u, s);
      if (b == NO_BOX) break;
      wg::tma_load_3d(dst + s * UnitTile::BOX_BYTES, &p->ta, bar,
                      kt * wg::BK, (int)(b >> 3) * wg::WG_ROWS,
                      ((int)blockIdx.y * p->team.world + (int)(b & 7)) *
                              p->e + u.x);
    }
  }
  __device__ __forceinline__ void side(int i) {
    wg::crew_enter(p->team, p->sig, entered, target, i);
  }
  // Box ``b``'s counted rows, rounded to bf16, into its chunk's stage.
  __device__ __forceinline__ void store_box(unsigned b, int col,
                                            uint8_t* slab,
                                            const float (&acc)[UnitTile::ACC /
                                                               2]) {
    const int c = b & 7, r0 = (int)(b >> 3) * wg::WG_ROWS;
    const int ce = c * p->e + u.x;
    const int live = __ldg(p->counts + ce) - r0;
    bf16* dst = p->stage +
                ((size_t)((int)blockIdx.y * p->team.world + c) * p->trows +
                 __ldg(p->base + ce) + r0) * p->n;
    bf16* rows[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int row = wg::piece_row(k);
      rows[k] = row < live ? dst + (size_t)row * p->n : nullptr;
    }
    wg::store_pieces(slab, acc, rows, col, p->n);
  }
  // Warpgroup wgi's boxes wgi and 2 + wgi, where live; after the block's
  // last tile, the combine and the sum, and the consumer threads exit: the
  // tile loop that follows a `store` reads the accumulators, so without
  // the exit they stay live (128 registers a thread) through the combine.
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        const float (&acc)[UnitTile::ACC]) {
    locate(t);
    using Half = const float(&)[UnitTile::ACC / 2];
    uint8_t* slab = epi + threadIdx.x / 32 * wg::SLAB_BYTES;
    const unsigned b0 = unit_box(u, wgi), b1 = unit_box(u, 2 + wgi);
    if (b0 != NO_BOX)
      store_box(b0, w.col, slab, reinterpret_cast<Half>(acc[0]));
    if (b1 != NO_BOX)
      store_box(b1, w.col, slab,
                reinterpret_cast<Half>(acc[UnitTile::ACC / 2]));
    if (t + (int)gridDim.x >= total) {
      finish();
      asm volatile("exit;");
      __builtin_unreachable();
    }
  }
  // 1. the rank's blocks meet: the stage is whole (W adds a block on the
  //    rank's LOCAL_WORD, as the first body's W chunk barriers make);
  // 2. for each chunk c, remote chunks first, the block's share of its
  //    tokens' 16-byte pieces combined into slot r of rank c's receive
  //    buffer, then one arrival at rank c;
  // 3. the wait for every rank's partial of this rank's chunk;
  // 4. the rank's blocks sum it in rank order.
  __device__ __forceinline__ void finish() {
    const dl::Team& t = p->team;
    const int me = dl::rank(t), w = t.world, y = blockIdx.y;
    u64* local = p->sig[me] + dl::LOCAL_WORD;
    __threadfence();
    wg::consumers_sync<C>();
    if (threadIdx.x == 0) dl::notify(local, (u64)w);
    wg::consumers_wait<C>(local, 1, (u64)w * target, tdt::WAIT_BARRIER_RANK);
    wg::wait_entered(entered, open);
    constexpr unsigned NT = C * wg::WG;
    const unsigned ng = (unsigned)p->n / 8, units = (unsigned)p->mc * ng;
    const size_t slot = (size_t)p->mc * p->n;
    for (int s = 0; s < w; ++s) {
      const int c = dl::peer_id(t, me + 1 + s);
      const bf16* stage = p->stage + ((size_t)y * w + c) * p->trows * p->n;
      const size_t pairs = (size_t)c * p->mc * p->topk;
      bf16* dst = reinterpret_cast<bf16*>(p->rbuf[c]) + me * slot;
      for (unsigned q = blockIdx.x * NT + threadIdx.x; q < units;
           q += gridDim.x * NT) {
        const unsigned i = q / ng, col = q % ng * 8;
        combine_piece(stage, p->rows + pairs + (size_t)i * p->topk,
                      p->weights + pairs + (size_t)i * p->topk, p->topk,
                      p->n, (int)col, dst + (size_t)i * p->n + col);
      }
      __threadfence();
      wg::consumers_sync<C>();
      if (threadIdx.x == 0) dl::notify(p->sig[c] + dl::ARRIVAL_WORD + me);
    }
    wg::consumers_wait<C>(p->sig[me] + dl::ARRIVAL_WORD, w, target,
                          tdt::WAIT_MOE_REDUCE_RS_PARTIAL);
    wg::reduce_partials<C>(reinterpret_cast<const bf16*>(p->rbuf[me]),
                           p->out + y * slot, w, (unsigned)slot, blockIdx.x,
                           gridDim.x);
  }
};

// Compiled for 384 threads (168 registers a thread at entry, so the
// consumers' `setmaxnreg` rises from there, as K11's) and launched with
// UnitTile::NT.
__global__ void __launch_bounds__(3 * wg::WG, 1)
    moe_reduce_rs_wgmma_kernel(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  __shared__ uint64_t entered;
  if (threadIdx.x == 0) tdt::mbar_init(&entered, 1);
  const int nt = __ldg(p.ntiles);
  const int total = nt > (int)gridDim.x ? nt : (int)gridDim.x;
  RsSched sched{&p,    &entered, smem, nt, total, (p.k + wg::BK - 1) / wg::BK,
                p.epoch + gridDim.x, -1, make_int4(0, 0, 0, 0), false};
  UnitTile::run(smem + EPI_BYTES, &p.tb, total, sched);
}

// Encode the maps, then one cooperative launch: P blocks a rank, as many as
// the list can have units (``tmax``), at most as many as can be resident
// together with every other rank's (one an SM).
int launch_wgmma(WgArgs& p, const void* a, const void* b, int cap, int tmax,
                 int* blocks, cudaStream_t s) {
  const int w = p.team.world;
  int rc = wg::encode_3d(&p.ta, a, p.k, cap, (uint64_t)w * w * p.e, wg::BK,
                         wg::WG_ROWS);
  if (rc == 0)
    rc = wg::encode_3d(&p.tb, b, p.n, p.k, (uint64_t)w * p.e, wg::BOX_N,
                       wg::BK);
  if (rc != 0) return rc;
  auto* fn = moe_reduce_rs_wgmma_kernel;
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

// a (world, world, E, cap, k): rank r's buckets of every chunk, in
// ``dtype`` (tdt::DTYPE_*), or int8 when ``int8`` (then sa (world, world,
// E, cap) and sb (E, n) f32 scales); b (world, E, k, n) in ``dtype`` or
// int8; bexp, bslot (world, T) and nblk (world,) int32, the packed plan;
// rows (world, mc, topk) int32 and weights (world, mc, topk) in ``dtype``,
// each token's stage rows and combine weights; stage (world, 2, T block,
// n) and out (world, mc, n) in ``dtype``; ``rbuf`` and ``sig``: host tables
// of ``world`` device pointers, rank r's (world, mc, n) receive buffer and
// its dl::SIGNAL_WORDS u64 counters; all contiguous.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a rank
// of this launch go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int moe_reduce_rs(const void* a, const void* b, const void* sa,
                             const void* sb, const void* bexp,
                             const void* bslot, const void* nblk,
                             const void* rows, const void* weights,
                             void* stage, void* out, void* const* rbuf,
                             void* const* sig, int world, int int8, int dtype,
                             int e, int cap, int k, int n, int mc, int tmax,
                             int block, int topk, unsigned long long epoch,
                             int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || k < 1 ||
      n < 1 || mc < 1 || tmax < 1 || block < 1 || cap % block || topk < 1 ||
      (int8 && (sa == nullptr || sb == nullptr || k % 16)))
    return (int)cudaErrorInvalidValue;
  const Raw r{a, b, sa, sb, bexp, bslot, nblk, rows, weights, stage, out,
              rbuf, sig, world, e, cap, k, n, mc, tmax, block, topk, epoch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return int8 ? run<body::Int8<bf16>>(r, blocks, s) : run_bf16(r, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return int8 ? run<body::Int8<float>>(r, blocks, s)
                : run<body::Float<gemm::F32Tile, float>>(r, blocks, s);
  return (int)cudaErrorInvalidValue;
}


// The Hopper body (bf16 on 16-byte rows): a (world, world, E, cap, k) and b
// (world, E, k, n), every rank's buckets of every chunk and its down shard;
// ``units`` (tmax) int4 and ``ntiles`` (1) int32, the unit list and its
// length (`allgather_group_gemm.unit_list` of the plan's counts); counts
// and base (world, E) int32, the tokens of chunk c's bucket e and the
// chunk's stage row of its slot 0; rows (world, mc, topk) int32 and weights
// (world, mc, topk) bf16, each token's stage rows and combine weights;
// stage (world, world, trows, n) with trows = T block; out (world, mc, n);
// ``rbuf`` and ``sig``: host tables of ``world`` device pointers, rank r's
// (world, mc, n) receive buffer and its dl::SIGNAL_WORDS u64 counters; all
// contiguous and 16-byte aligned, k and n multiples of 8.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a rank
// of this launch go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int moe_reduce_rs_wgmma(const void* a, const void* b,
                                   const void* units, const void* ntiles,
                                   const void* counts, const void* base,
                                   const void* rows, const void* weights,
                                   void* stage, void* out, void* const* rbuf,
                                   void* const* sig, int world, int e,
                                   int cap, int k, int n, int mc, int trows,
                                   int topk, int tmax,
                                   unsigned long long epoch, int* blocks,
                                   void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || k < 1 ||
      n < 1 || mc < 1 || trows < 1 || topk < 1 || tmax < 1 ||
      units == nullptr || ntiles == nullptr || (size_t)mc * n >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(units) |
                    reinterpret_cast<uintptr_t>(stage) |
                    reinterpret_cast<uintptr_t>(out);
  WgArgs p{};
  for (int r = 0; r < world; ++r) {
    p.rbuf.ptr[r] = static_cast<char*>(rbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(rbuf[r]);
  }
  if (k % 8 != 0 || n % 8 != 0 || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  p.units = static_cast<const int4*>(units);
  p.ntiles = static_cast<const int*>(ntiles);
  p.counts = static_cast<const int*>(counts);
  p.base = static_cast<const int*>(base);
  p.rows = static_cast<const int*>(rows);
  p.weights = static_cast<const bf16*>(weights);
  p.stage = static_cast<bf16*>(stage);
  p.out = static_cast<bf16*>(out);
  p.team = dl::Team{world, 0};
  p.e = e;
  p.k = k;
  p.n = n;
  p.mc = mc;
  p.trows = trows;
  p.topk = topk;
  p.epoch = epoch;
  return launch_wgmma(p, a, b, cap, tmax, blocks,
                      static_cast<cudaStream_t>(stream));
}
