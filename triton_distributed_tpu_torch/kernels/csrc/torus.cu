// Collectives over a process grid of nd = 2 or 3 axes, every axis at once
// (K21): the all-gather (K21a), the reduce-scatter (K21b) and the
// all-gather GEMM (K21c) of a team of W ranks laid out as a grid (rank g
// row-major over the axes, `dl::Grid`).
//
// Replaces: triton_distributed_tpu/kernels/torus.py
//   K21a `all_gather_torus` -> pallas_call :359 (`_torus_ag_kernel` :298
//     over `_emit_torus_ag` :217);
//   K21b `reduce_scatter_torus` -> pallas_call :613 (`_torus_rs_kernel`
//     :472, `_ReduceLane` :383, adding with reduce_scatter.py
//     `emit_add_into` :120);
//   K21c `ag_gemm_torus` -> pallas_call :727 (`_ag_gemm_torus_kernel` :636).
// Layouts: a rank's m rows split into L = 2 * nd pieces, piece q the rows
// [q * ms, min((q + 1) * ms, m)) (the JAX wrappers' split; they pad the
// rows to L * ms, the kernels take the last pieces short or empty and need
// no copy): K21a's x_g (m, row) and gathered A (W, m, row), cell c holding
// rank c's rows; K21b's partials x_g (W, m, n), cell c the partial of rank
// c's chunk, and out_g (m, n); K21c's a_g (m, k), its gathered A (W, m, k)
// and out_g (W * m, n).
//
// The schedule (JAX `lane_schedules`): lane q = (sign s, rotation r), q < nd
// the + lanes, rides axis (r + p) mod nd in direction s at phase p.  Phase
// p of K21a is a ring all-gather along that axis of the lane's slab: the
// cells over the lane's first p axes at a ring position (own coordinate on
// the axes still to come), piece q of each.  K21b runs it backwards: stage
// t ring-reduces, along the axis of phase nd-1-t, the slabs that phase
// gathered, with running sums passed to the next rank of the ring (the
// JAX two-slot staging, each slot written again only after the receiver's
// ack) and one f32 add rounded to the element type a hop; the last stage
// leaves piece q of the rank's own chunk.  Every lane of every rank has
// its own P blocks (blockIdx.x = q * P + part), so a slow lane holds up no
// other: that replaces the TPU kernel's step interleaving of the lanes
// (`_run_lanes` :449).
//
// Signals (`dl.cuh`; every word its own counter, never shared by lanes):
// word 0 the entry barrier; K21a/K21c: arrival word (phase, lane, ring
// position), 1 + (p * L + q) * maxw + c, one add from each of the sender's
// P lane blocks a call; K21b: arrival and ack words (stage, lane, step),
// 1 + (t * L + q) * (maxw - 1) + s and the same past nd * L * (maxw - 1).
// A word receives P adds a call, so its wait is epoch + P, the epoch being
// the instance's sum of P over its earlier calls.
//
// Memory: a block copies its share of a piece (`put_nbi`) or adds its range
// of one (`add_into`, `block_range`).  It forwards only bytes a peer
// announced (its own piece it sends from its input), and K21b's blocks
// read back only their own range of the sums they wrote.  Waits are
// acquire loads; arrived data is read through L2.
//
// What bounds it on the H100: bytes (K21a, K21b: each rank reads its
// shard, receives W - 1 pieces a lane and writes its output), operations
// (K21c at prefill shapes: the product of the W * m gathered rows with the
// rank's B).  On one card every put is a copy inside one HBM: the lanes'
// use of 2 * nd links at once, the reason for the schedule on a torus,
// buys nothing here.
//
// Design (a first kernel that is right): one cooperative launch of every
// rank's L * P blocks (P at most what lets them all be resident), the
// grid's entry barrier (K21a, K21c: the ring neighbours along every axis;
// K21b: every rank of each axis, as the JAX kernel), then each lane's
// phases.  K21c forwards a slab before it multiplies the pieces that
// arrived at the step before (JAX `consume_piece` :658), its own pieces
// first, each piece's tiles on K12's tile (`gemm_tile.cuh`) striding over
// the lane's P blocks.

#include "comm_body.cuh"
#include "gemm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace comm = tdt::comm;
namespace gemm = tdt::gemm;

// Lane q of the 2 * nd: its rotation and direction.
struct Lane {
  int r, dir;
};

__device__ __forceinline__ Lane lane_of(int q, int nd) {
  return Lane{q % nd, q < nd ? 1 : -1};
}

__device__ __forceinline__ int lane_axis(const Lane& l, int phase, int nd) {
  return (l.r + phase) % nd;
}

// The axes of the lane's first ``phases`` phases, as a bit mask.
__device__ __forceinline__ int lane_mask(const Lane& l, int phases, int nd) {
  int m = 0;
  for (int j = 0; j < phases; ++j) m |= 1 << lane_axis(l, j, nd);
  return m;
}

__device__ __forceinline__ int wrap(int c, int w) { return ((c % w) + w) % w; }

// Cells over the axes of ``mask``.
__device__ __forceinline__ int mask_cells(const dl::Grid& g, int mask) {
  int n = 1;
  for (int a = 0; a < g.nd; ++a)
    if (mask >> a & 1) n *= g.size[a];
  return n;
}

// The rank whose coordinates are ``base``'s, but ``c`` along ``axis`` and,
// along the axes of ``mask``, the e-th combination (the highest axis
// fastest).
__device__ __forceinline__ int cell_rank(const dl::Grid& g, int base,
                                         int axis, int c, int mask, int e) {
  int r = base + (c - dl::grid_coord(g, base, axis)) * g.stride[axis];
  for (int a = g.nd - 1; a >= 0; --a) {
    if (!(mask >> a & 1)) continue;
    const int ca = e % g.size[a];
    e /= g.size[a];
    r += (ca - dl::grid_coord(g, base, a)) * g.stride[a];
  }
  return r;
}

struct GridArgs {
  dl::Symm<u64> sig;  // rank r's signal words
  dl::Team team;
  dl::Grid grid;
  int lanes;          // L = 2 * nd
  int maxw;           // the largest axis
  u64 epoch;          // the instance's sum of P over its earlier calls
  comm::Faults faults;
};

__device__ __forceinline__ int ag_word(const GridArgs& p, int phase, int q,
                                       int c) {
  return 1 + (phase * p.lanes + q) * p.maxw + c;
}

// ---------------------------------------------------------------------------
// K21a / K21c: the all-gather schedule, with hooks for the GEMM
// ---------------------------------------------------------------------------

// Rows of piece q of m rows in pieces of ms.
__device__ __forceinline__ int piece_rows(int m, int ms, int q) {
  const int r = m - q * ms;
  return r < 0 ? 0 : (r < ms ? r : ms);
}

// One lane's all-gather: x (m, row bytes) this rank's shard, ``out`` every
// rank's gathered (W, m, row).  ``local(q)`` runs once the first slab is on
// its way; ``landed(ph, c)`` once the lane's phase-ph slab at ring
// position c has arrived and the next slab is on its way (at the end for
// the last).  The P blocks of lane q of rank me share each copy.
template <class Local, class Landed>
__device__ __forceinline__ void emit_torus_ag(const GridArgs& p,
                                              const char* x,
                                              dl::Symm<char> out, int m,
                                              int ms, size_t row,
                                              Local&& local,
                                              Landed&& landed) {
  const dl::Team& t = p.team;
  const dl::Grid& g = p.grid;
  const int me = dl::rank(t), nd = g.nd, L = p.lanes;
  const int P = gridDim.x / L, q = blockIdx.x / P, part = blockIdx.x % P;
  const u64 target = p.epoch + P;
  char* mine = out[me];
  const Lane l = lane_of(q, nd);
  const size_t shard = (size_t)m * row, start = (size_t)q * ms * row;
  const size_t piece = (size_t)piece_rows(m, ms, q) * row;

  comm::inject_faults(t, p.faults);
  dl::grid_barrier(t, g, p.sig, 0, (u64)L * target, /*neighbors_only=*/true);
  dl::put_nbi(mine + me * shard + start, x + start, piece, part, P);
  bool first = true;
  int pend_phase = -1, pend_c = 0;
  for (int ph = 0; ph < nd; ++ph) {
    const int a = lane_axis(l, ph, nd), w = g.size[a], d = l.dir;
    const int pos = dl::grid_coord(g, me, a), mask = lane_mask(l, ph, nd);
    const int cells = mask_cells(g, mask);
    const int nbr = dl::grid_neighbor(g, me, a, d);
    for (int s = 0; s < w - 1; ++s) {
      const int src = wrap(pos - s * d, w);
      for (int e = 0; e < cells; ++e) {
        const int cell = cell_rank(g, me, a, src, mask, e);
        const size_t off = cell * shard + start;
        dl::put_nbi(out[nbr] + off, cell == me ? x + start : mine + off,
                    piece, part, P);
      }
      u64* word = p.sig[nbr] + ag_word(p, ph, q, src);
      dl::signal_after_puts(&word, 1);
      if (first) {
        local(q);
        first = false;
      } else if (pend_phase >= 0) {
        landed(pend_phase, pend_c);
      }
      const int expect = wrap(pos - (s + 1) * d, w);
      dl::wait(p.sig[me] + ag_word(p, ph, q, expect), 1, 0, target,
               tdt::WAIT_TORUS_ALL_GATHER);
      pend_phase = ph;
      pend_c = expect;
    }
  }
  if (pend_phase >= 0) landed(pend_phase, pend_c);
}

struct AgArgs {
  GridArgs grid;
  const char* x;       // (R, m, row): every launched rank's shard
  dl::Symm<char> out;  // rank r's gathered (W, m, row)
  int m, ms;           // rows a shard, rows a piece
  size_t row;          // bytes a row
};

__global__ void __launch_bounds__(comm::COMM_THREADS)
    torus_ag_kernel(AgArgs p) {
  emit_torus_ag(
      p.grid, p.x + blockIdx.y * (size_t)p.m * p.row, p.out, p.m, p.ms,
      p.row, [](int) {}, [](int, int) {});
}

template <typename T>
struct AgGemmArgs {
  GridArgs grid;
  const T* a;               // (R, m, k)
  const T* b;               // (R, k, n)
  T* out;                   // (R, W * m, n)
  dl::Symm<char> gathered;  // rank r's (W, m, k)
  int m, ms, n, k, vec;
};

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    torus_ag_gemm_kernel(AgGemmArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Grid& g = p.grid.grid;
  const int me = dl::rank(p.grid.team), nd = g.nd, L = p.grid.lanes;
  const int P = gridDim.x / L, part = blockIdx.x % P, q = blockIdx.x / P;
  const int world = g.stride[0] * g.size[0];
  const T* a = p.a + (size_t)blockIdx.y * p.m * p.k;
  const T* b = p.b + (size_t)blockIdx.y * p.k * p.n;
  T* out = p.out + (size_t)blockIdx.y * world * p.m * p.n;
  const T* mine = reinterpret_cast<const T*>(p.gathered[me]);
  const int rows = piece_rows(p.m, p.ms, q);
  const Lane l = lane_of(q, nd);
  // Piece q of cell c: rows c * m + q * ms .. of the gathered A and out.
  auto first = [&](int cell) {
    return (size_t)cell * p.m + (size_t)q * p.ms;
  };
  auto mm = [&](const T* piece, int cell) {
    gemm::run_tiles<Tile>(sm, piece, b, out + first(cell) * p.n, rows, p.n,
                          p.k, p.vec, part, P);
  };
  emit_torus_ag(
      p.grid, reinterpret_cast<const char*>(a), p.gathered, p.m, p.ms,
      (size_t)p.k * sizeof(T),
      [&](int) { mm(a + (size_t)q * p.ms * p.k, me); },
      [&](int ph, int c) {
        const int axis = lane_axis(l, ph, nd), mask = lane_mask(l, ph, nd);
        const int cells = mask_cells(g, mask);
        for (int e = 0; e < cells; ++e) {
          const int cell = cell_rank(g, me, axis, c, mask, e);
          mm(mine + first(cell) * p.k, cell);
        }
      });
}

// ---------------------------------------------------------------------------
// K21b: the reduce-scatter
// ---------------------------------------------------------------------------

template <typename T>
struct RsArgs {
  GridArgs grid;
  const T* x;              // (R, W, m, n): the launched ranks' partials
  T* out;                  // (R, m, n)
  dl::Symm<char> staging;  // rank r's staging slots (`slots_before`)
  T* local;                // (R, local_pieces, ms, n): sums, stage results
  int m, ms;               // rows a chunk, rows a piece
  size_t n;                // elements a row
  size_t local_pieces;
};

// Pieces of a slab slot at stage t: maxw^(nd-1-t) (the JAX kernel's slab
// shape, `reduce_scatter_torus` :606).
__device__ __forceinline__ int slab_pieces(int maxw, int nd, int t) {
  int n = 1;
  for (int i = 0; i < nd - 1 - t; ++i) n *= maxw;
  return n;
}

// Pieces before stage t's slots: each earlier stage has two slots a lane
// (``per_lane`` 2) of staging or running sums, or one (1) of stage results.
__device__ __forceinline__ int slots_before(int maxw, int nd, int lanes,
                                            int t, int per_lane) {
  int n = 0;
  for (int u = 0; u < t; ++u) n += lanes * per_lane * slab_pieces(maxw, nd, u);
  return n;
}

// The index, in a slab over the axes of ``outer`` (highest axis fastest),
// of the cell at ``c`` along ``axis`` and the e-th combination of the axes
// of ``inner`` (``outer`` = ``inner`` + ``axis``).
__device__ __forceinline__ int slab_index(const dl::Grid& g, int outer,
                                          int axis, int c, int inner, int e) {
  int coord[3] = {0, 0, 0};
  for (int a = g.nd - 1; a >= 0; --a) {
    if (!(inner >> a & 1)) continue;
    coord[a] = e % g.size[a];
    e /= g.size[a];
  }
  coord[axis] = c;
  int idx = 0;
  for (int a = 0; a < g.nd; ++a)
    if (outer >> a & 1) idx = idx * g.size[a] + coord[a];
  return idx;
}

__device__ __forceinline__ int rs_word(const GridArgs& p, int ack, int t,
                                       int q, int s) {
  return 1 + ((ack * p.grid.nd + t) * p.lanes + q) * (p.maxw - 1) + s;
}

template <typename T>
__global__ void __launch_bounds__(comm::COMM_THREADS)
    torus_rs_kernel(RsArgs<T> p) {
  const GridArgs& gp = p.grid;
  const dl::Team& tm = gp.team;
  const dl::Grid& g = gp.grid;
  const int me = dl::rank(tm), nd = g.nd, L = gp.lanes, maxw = gp.maxw;
  const int world = g.size[0] * g.stride[0];
  const int P = gridDim.x / L, q = blockIdx.x / P, part = blockIdx.x % P;
  const u64 target = gp.epoch + P;
  // A slot holds a whole piece of ms rows (S elements); the lane's pieces
  // have E elements (fewer, or none, for the last pieces).
  const size_t S = (size_t)p.ms * p.n;
  const size_t E = (size_t)piece_rows(p.m, p.ms, q) * p.n;
  const size_t first = (size_t)q * p.ms * p.n;
  const T* x = p.x + (size_t)blockIdx.y * world * p.m * p.n;
  T* out = p.out + (size_t)blockIdx.y * p.m * p.n;
  T* local = p.local + (size_t)blockIdx.y * p.local_pieces * S;
  const int staged = slots_before(maxw, nd, L, nd, 2);
  const comm::Range rg = comm::block_range(E, part, P);
  const Lane l = lane_of(q, nd);

  comm::inject_faults(tm, gp.faults);
  dl::grid_barrier(tm, g, gp.sig, 0, (u64)L * target,
                   /*neighbors_only=*/false);
  for (int t = 0; t < nd; ++t) {
    const int a = lane_axis(l, nd - 1 - t, nd), d = l.dir, w = g.size[a];
    const int pos = dl::grid_coord(g, me, a);
    const int after = lane_mask(l, nd - 1 - t, nd), before = after | 1 << a;
    const int cells = mask_cells(g, after);
    const int cap = slab_pieces(maxw, nd, t);
    const size_t slots = (size_t)(slots_before(maxw, nd, L, t, 2) +
                                  q * 2 * cap) * S;
    T* stage_me = reinterpret_cast<T*>(p.staging[me]) + slots;
    T* stage_fwd = reinterpret_cast<T*>(
                       p.staging[dl::grid_neighbor(g, me, a, d)]) + slots;
    T* sums = local + slots;
    const T* prev = local + (size_t)(staged +
                                     (t ? slots_before(maxw, nd, L, t - 1, 1)
                                          + q * slab_pieces(maxw, nd, t - 1)
                                        : 0)) * S;
    T* result = t == nd - 1
                    ? out + first
                    : local + (size_t)(staged +
                                       slots_before(maxw, nd, L, t, 1) +
                                       q * cap) * S;
    // The lane's partial of cell e of the slab at ring position c: the
    // input at stage 0, the last stage's result after.
    auto take = [&](int c, int e) -> const T* {
      if (t == 0)
        return x + (size_t)cell_rank(g, me, a, c, after, e) * p.m * p.n +
               first;
      return prev + (size_t)slab_index(g, before, a, c, after, e) * S;
    };
    u64* const mine = gp.sig[me];
    for (int s = 0; s < w - 1; ++s) {
      const int slot = s & 1;
      // The slot is written again only after the receiver has added what
      // it held two steps ago.
      if (s >= 2)
        dl::wait(mine + rs_word(gp, 1, t, q, s - 2), 1, 0, target,
                 tdt::WAIT_TORUS_RS_ACK);
      const int send = wrap(pos - (1 + s) * d, w);
      for (int e = 0; e < cells; ++e)
        comm::put_range(stage_fwd + (size_t)(slot * cap + e) * S,
                        s == 0 ? take(send, e)
                               : sums + (size_t)(slot * cap + e) * S,
                        rg);
      u64* word = gp.sig[dl::grid_neighbor(g, me, a, d)] +
                  rs_word(gp, 0, t, q, s);
      dl::signal_after_puts(&word, 1);
      dl::wait(mine + rs_word(gp, 0, t, q, s), 1, 0, target,
               tdt::WAIT_TORUS_RS_ARRIVAL);
      const int recv = wrap(pos - (2 + s) * d, w);
      for (int e = 0; e < cells; ++e)
        comm::add_into(s < w - 2 ? sums + (size_t)((1 - slot) * cap + e) * S
                                 : result + (size_t)e * S,
                       stage_me + (size_t)(slot * cap + e) * S,
                       take(recv, e), rg);
      // The slot is free again, and this block's sums are stored before
      // the next step forwards them.
      u64* ack = gp.sig[dl::grid_neighbor(g, me, a, -d)] +
                 rs_word(gp, 1, t, q, s);
      dl::signal_after_puts(&ack, 1);
    }
    for (int s = w - 3 < 0 ? 0 : w - 3; s < w - 1; ++s)
      dl::wait(mine + rs_word(gp, 1, t, q, s), 1, 0, target,
               tdt::WAIT_TORUS_RS_ACK_DRAIN);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// The grid of ``sizes`` (nd of them, each at least 2, at most MAX_RANKS
// ranks); false if it is not one the kernels take.
bool make_grid(int nd, const int* sizes, GridArgs* p, int* world) {
  if (nd < 2 || nd > 3) return false;
  int w = 1;
  for (int a = 0; a < nd; ++a) {
    if (sizes[a] < 2) return false;
    w *= sizes[a];
  }
  if (w > dl::MAX_RANKS) return false;
  p->grid.nd = nd;
  p->maxw = 0;
  for (int a = nd - 1, stride = 1; a >= 0; stride *= sizes[a--]) {
    p->grid.size[a] = sizes[a];
    p->grid.stride[a] = stride;
    if (sizes[a] > p->maxw) p->maxw = sizes[a];
  }
  p->lanes = 2 * nd;
  p->team = dl::Team{w, 0};
  *world = w;
  return true;
}

// One cooperative launch of ``fn`` with P blocks a lane for every lane of
// every rank (gridDim = (L * P, W)): P is ``want`` (at least 1), at most
// as many as can be resident with all the others.  P goes to ``*blocks``.
int launch_lanes(void* fn, void** args, int threads, const GridArgs& p,
                 int want, int* blocks, cudaStream_t s) {
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / (p.team.world * p.lanes);
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int P = want < 1 ? 1 : (want < fit ? want : fit);
  *blocks = P;
  return (int)cudaLaunchCooperativeKernel(
      fn, dim3(p.lanes * P, p.team.world), dim3(threads), args, 0, s);
}

// Cells of the largest slab a lane moves (its last phase's: every axis but
// one, the smallest).
int largest_slab(const GridArgs& p) {
  int smallest = p.grid.size[0];
  for (int a = 1; a < p.grid.nd; ++a)
    if (p.grid.size[a] < smallest) smallest = p.grid.size[a];
  return p.team.world / smallest;
}

template <class Tile>
int launch_ag_gemm(AgGemmArgs<typename Tile::In> p, int* blocks,
                   cudaStream_t s) {
  void* args[] = {&p};
  return launch_lanes(reinterpret_cast<void*>(torus_ag_gemm_kernel<Tile>),
                      args, Tile::NT, p.grid, gemm::tiles<Tile>(p.ms, p.n),
                      blocks, s);
}

template <typename T>
int run_ag_gemm(AgGemmArgs<T> p, int* blocks, cudaStream_t s);

template <>
int run_ag_gemm<bf16>(AgGemmArgs<bf16> p, int* blocks, cudaStream_t s) {
  if (p.ms <= 16) return launch_ag_gemm<gemm::Bf16Tile16>(p, blocks, s);
  if (p.ms <= 64) return launch_ag_gemm<gemm::Bf16Tile64>(p, blocks, s);
  return launch_ag_gemm<gemm::Bf16Tile128>(p, blocks, s);
}

template <>
int run_ag_gemm<float>(AgGemmArgs<float> p, int* blocks, cudaStream_t s) {
  return launch_ag_gemm<gemm::F32Tile>(p, blocks, s);
}

template <typename T>
int ag_gemm(const void* a, const void* b, void* out, void* const* gathered,
            GridArgs gp, int m, int ms, int n, int k, int* blocks,
            cudaStream_t s) {
  AgGemmArgs<T> p{};
  p.grid = gp;
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.out = static_cast<T*>(out);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < gp.team.world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  p.m = m;
  p.ms = ms;
  p.n = n;
  p.k = k;
  // Row starts are multiples of k (and n) elements, so 16-byte rows keep
  // every piece aligned.
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  return run_ag_gemm<T>(p, blocks, s);
}

template <typename T>
int reduce_scatter(const void* x, void* out, void* const* staging,
                   void* local, GridArgs gp, int m, int ms, size_t n,
                   int* blocks, cudaStream_t s) {
  RsArgs<T> p{};
  p.grid = gp;
  p.x = static_cast<const T*>(x);
  p.out = static_cast<T*>(out);
  p.local = static_cast<T*>(local);
  p.m = m;
  p.ms = ms;
  p.n = n;
  int staged = 0, mids = 0;
  for (int t = 0; t < gp.grid.nd; ++t) {
    int cap = 1;
    for (int i = 0; i < gp.grid.nd - 1 - t; ++i) cap *= gp.maxw;
    staged += gp.lanes * 2 * cap;
    if (t < gp.grid.nd - 1) mids += gp.lanes * cap;
  }
  p.local_pieces = staged + mids;
  for (int r = 0; r < gp.team.world; ++r)
    p.staging.ptr[r] = static_cast<char*>(staging[r]);
  void* args[] = {&p};
  return launch_lanes(
      reinterpret_cast<void*>(torus_rs_kernel<T>), args, comm::COMM_THREADS,
      gp, comm::blocks_for(largest_slab(gp) * ms * n * sizeof(T)), blocks,
      s);
}

}  // namespace

// The three entry points share their trailing arguments: ``sig``, a host
// table of W device pointers, rank r's ``words`` u64 signal words (at least
// what the kernel's layout needs); ``nd`` and ``sizes`` the grid (2 or 3
// axes, each of at least 2 ranks, W = their product <= 8 ranks, all of
// them in this launch); ``m`` rows a rank's shard (K21a, K21c) or chunk
// (K21b), split into 2 * nd pieces of ``ms`` rows (the last ones short or
// empty); ``epoch`` the instance's sum of blocks a lane over its earlier
// calls, this launch's going to ``*blocks``; ``straggler`` (-1: none)
// spins ``cycles`` first, ``for_correctness`` staggers every rank.  Each
// returns a cudaError_t code.

// K21a: x (W, m, row bytes) every rank's shard; ``out`` a table of rank
// r's gathered (W, m, row).
extern "C" int torus_all_gather(const void* x, void* const* out,
                                void* const* sig, int nd, const int* sizes,
                                int words, int m, int ms,
                                unsigned long long row,
                                unsigned long long epoch, int straggler,
                                long long cycles, int for_correctness,
                                int* blocks, void* stream) {
  *blocks = 0;
  AgArgs p{};
  int world = 0;
  if (!make_grid(nd, sizes, &p.grid, &world) || m < 1 || ms < 1 ||
      row < 1 || words < 1 + nd * p.grid.lanes * p.grid.maxw)
    return (int)cudaErrorInvalidValue;
  p.x = static_cast<const char*>(x);
  for (int r = 0; r < world; ++r) {
    p.out.ptr[r] = static_cast<char*>(out[r]);
    p.grid.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.m = m;
  p.ms = ms;
  p.row = row;
  p.grid.epoch = epoch;
  p.grid.faults = comm::Faults{straggler, cycles, for_correctness};
  void* args[] = {&p};
  return launch_lanes(reinterpret_cast<void*>(torus_ag_kernel), args,
                      comm::COMM_THREADS, p.grid,
                      comm::blocks_for(largest_slab(p.grid) * ms * row),
                      blocks, static_cast<cudaStream_t>(stream));
}

// K21b: x (W, W, m, n) every rank's partials, cell c for rank c; out (W, m,
// n); ``staging`` a table of rank r's staging slots and ``local`` (W, local
// pieces, ms, n) the ranks' running sums and stage results (the wrapper's
// `_rs_cells`); ``dtype`` tdt::DTYPE_*.
extern "C" int torus_reduce_scatter(const void* x, void* out,
                                    void* const* staging, void* local,
                                    void* const* sig, int nd,
                                    const int* sizes, int words, int dtype,
                                    int m, int ms, unsigned long long n,
                                    unsigned long long epoch, int straggler,
                                    long long cycles, int for_correctness,
                                    int* blocks, void* stream) {
  *blocks = 0;
  GridArgs gp{};
  int world = 0;
  if (!make_grid(nd, sizes, &gp, &world) || m < 1 || ms < 1 || n < 1 ||
      words < 1 + 2 * nd * gp.lanes * (gp.maxw - 1))
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < world; ++r) gp.sig.ptr[r] = static_cast<u64*>(sig[r]);
  gp.epoch = epoch;
  gp.faults = comm::Faults{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return reduce_scatter<bf16>(x, out, staging, local, gp, m, ms, n, blocks,
                                s);
  if (dtype == tdt::DTYPE_F32)
    return reduce_scatter<float>(x, out, staging, local, gp, m, ms, n,
                                 blocks, s);
  return (int)cudaErrorInvalidValue;
}

// K21c: a (W, m, k) every rank's shard of A, b (W, k, n) every rank's B,
// out (W, W * m, n); ``gathered`` a table of rank r's gathered A (W, m, k);
// ``dtype`` tdt::DTYPE_* of all of them.
extern "C" int torus_ag_gemm(const void* a, const void* b, void* out,
                             void* const* gathered, void* const* sig, int nd,
                             const int* sizes, int words, int dtype, int m,
                             int ms, int n, int k, unsigned long long epoch,
                             int straggler, long long cycles,
                             int for_correctness, int* blocks, void* stream) {
  *blocks = 0;
  GridArgs gp{};
  int world = 0;
  if (!make_grid(nd, sizes, &gp, &world) || m < 1 || ms < 1 || n < 1 ||
      k < 1 || words < 1 + nd * gp.lanes * gp.maxw)
    return (int)cudaErrorInvalidValue;
  for (int r = 0; r < world; ++r) gp.sig.ptr[r] = static_cast<u64*>(sig[r]);
  gp.epoch = epoch;
  gp.faults = comm::Faults{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return ag_gemm<bf16>(a, b, out, gathered, gp, m, ms, n, k, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return ag_gemm<float>(a, b, out, gathered, gp, m, ms, n, k, blocks, s);
  return (int)cudaErrorInvalidValue;
}
