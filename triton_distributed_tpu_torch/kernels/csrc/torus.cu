// Collectives over a process grid of nd = 2 or 3 axes, every axis at once
// (K21): the all-gather (K21a) and the all-gather GEMM (K21c) of a team of
// W ranks laid out as a grid (rank g row-major over the axes, `dl::Grid`).
// The reduce-scatter (K21b) is K16's scatter-then-sum body with the torus
// order of the sum (`reduce_scatter.cu`, `kernels/torus.py` `rs_order`).
//
// Replaces: triton_distributed_tpu/kernels/torus.py
//   K21a `all_gather_torus` -> pallas_call :359 (`_torus_ag_kernel` :298
//     over `_emit_torus_ag` :217);
//   K21c `ag_gemm_torus` -> pallas_call :727 (`_ag_gemm_torus_kernel` :636).
// Layouts: a rank's m rows split into L = 2 * nd pieces, piece q the rows
// [q * ms, min((q + 1) * ms, m)) (the JAX wrappers' split; they pad the
// rows to L * ms, the kernels take the last pieces short or empty and need
// no copy): K21a's x_g (m, row) and gathered A (W, m, row), cell c holding
// rank c's rows; K21c's a_g (m, k), its gathered A (W, m, k) and out_g
// (W * m, n).
//
// The schedule (JAX `lane_schedules`): lane q = (sign s, rotation r), q < nd
// the + lanes, rides axis (r + p) mod nd in direction s at phase p.  Phase
// p of K21a is a ring all-gather along that axis of the lane's slab: the
// cells over the lane's first p axes at a ring position (own coordinate on
// the axes still to come), piece q of each.  Every lane of every rank has
// its own P blocks (blockIdx.x = q * P + part), so a slow lane holds up no
// other: that replaces the TPU kernel's step interleaving of the lanes
// (`_run_lanes` :449).
//
// Signals (`dl.cuh`; every word its own counter, never shared by lanes):
// word 0 the entry barrier; K21a/K21c: arrival word (phase, lane, ring
// position), 1 + (p * L + q) * maxw + c, one add from each of the sender's
// P lane blocks a call.  A word receives P adds a call, so its wait is epoch + P, the epoch being
// the instance's sum of P over its earlier calls.
//
// Memory: a block copies its share of a piece (`put_nbi`).  It forwards
// only bytes a peer announced (its own piece it sends from its input).
// Waits are acquire loads; arrived data is read through L2.
//
// What bounds it on the H100: bytes (K21a: each rank reads its shard,
// receives W - 1 pieces a lane and writes its output), operations
// (K21c at prefill shapes: the product of the W * m gathered rows with the
// rank's B).  On one card every put is a copy inside one HBM: the lanes'
// use of 2 * nd links at once, the reason for the schedule on a torus,
// buys nothing here.
//
// Design (a first kernel that is right): one cooperative launch of every
// rank's L * P blocks (P at most what lets them all be resident), the
// grid's entry barrier (the ring neighbours along every axis), then each
// lane's phases.  K21c's first body (f32, and bf16 off 16-byte rows) forwards a
// slab before it multiplies the pieces that arrived at the step before (JAX
// `consume_piece` :658), its own pieces first, each piece's tiles on K12's
// tile (`gemm_tile.cuh`) striding over the lane's P blocks.
//
// K21c's Hopper body (bf16 on 16-byte rows: k and n multiples of 8, every
// pointer 16-byte aligned; every main-path call) runs the `wgmma` + TMA
// tile of `wgmma_tile.cuh`, as K12's ring does: one cooperative launch of P
// = min(tiles, 132 / W) blocks a rank (at least L), one an SM, gridDim (P,
// W).
// - The lanes' copies run on the producer warpgroup's three spare warps
//   (`comm::Crew`, named barrier 1, the producer's 40 registers): block j's
//   crew serves lane j mod L as share j div L of the lane's C = P div L
//   crews; the last P mod L blocks' crews copy nothing.  A crew runs the
//   grid's neighbour entry barrier, its share of the own piece into the
//   own slot, then each phase and step of its lane: the slab's puts, the
//   signal, the wait on the next arrival (`emit_torus_ag_crew`, all with
//   the crew's inlined 16-byte copies: `dl::put_nbi` is a call, and a call
//   in a `wgmma` kernel makes ptxas serialize the products).  The crews
//   never wait on the products, and a slow lane holds up no other.  An
//   arrival word receives C adds a call: the epoch counts C.
// - Every block computes.  The W L pieces a rank multiplies (cell c, lane
//   q: rows [q ms, q ms + rows) of the cell's m) are one flat tile list over
//   the rank's P blocks, in the order the JAX kernel multiplies them: its
//   own L pieces first, then each round's landed slabs (a round: one step
//   of one phase, every lane); empty pieces have no tile.  A round's pieces
//   are one run: their rows cut into segments of 32 (SEG), the run's
//   segments packed in order BM / 32 a row tile, column tiles outer, row
//   tiles inner.  So the blocks at work share a few column tiles of b and
//   read them from L2, and a piece of 96 rows (nd = 3 at m = 512) fills
//   three quarters of a 128-row tile, not all of one.  (Row tiles of one
//   piece fastest, then its column tiles, read every b tile from HBM once
//   a piece: on an H100 80GB HBM3 at 700 W, K21c took 1.08 ms on (2, 2) and
//   7.88 on (2, 2, 2) at Qwen3-8B's gate_up a rank, K12 0.63 and 2.56;
//   runs of whole 128-row pieces, 0.64 and 3.92.)  The
//   host builds the list (`kernels/torus.py` `ag_gemm_pieces`): a piece's
//   lane and run, and each rank's cell and arrival word a piece.  The TMA
//   thread loads a stage's a rows as one box of 32 rows a segment
//   (`load_a`), the own cell's through the map of a (R, m, k) as (k, m,
//   R), the others' through the rank's gathered buffer (W, m, k) as (k, m,
//   W), after it has waited on each arrival word of the tile's segments
//   and fenced the generic proxy against the async one
//   (`comm::wait_word_for_tma`; one word covers a whole slab, and a word
//   once waited on is not waited on again).  b's first stages go out
//   before the waits.
// - A piece's rows are not padded.  Where a piece's rows are not a
//   multiple of 32, its last segment's box reads rows past the piece: the
//   next lane's rows of the same cell, which that lane's crews may still
//   be writing, or zeros past m.  The epilogue stores only the piece's
//   rows, and by the tile promise a row's bits depend on that row alone,
//   so whatever those extra rows hold changes nothing that is kept.
// - Its outputs equal K12's Hopper body's bit for bit on the same operands
//   (the same tile, the same k order a row).
// A failed tensor-map encode, attribute or launch returns its error code;
// no call falls back to the first body.

#include <algorithm>

#include "comm_body.cuh"
#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

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
__host__ __device__ __forceinline__ int piece_rows(int m, int ms, int q) {
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
// K21c on the Hopper tile
// ---------------------------------------------------------------------------

// The all-gather of lane ``q`` on one crew, share ``part`` of the lane's
// ``parts`` crews of this rank: `emit_torus_ag` without its hooks.  The
// products wait on the same arrival words themselves.
__device__ __forceinline__ void emit_torus_ag_crew(
    const GridArgs& p, const char* x, const dl::Symm<char>& out, int m, int ms,
    size_t row, int q, int part, int parts, u64 target,
    const comm::Crew& crew) {
  const dl::Team& t = p.team;
  const dl::Grid& g = p.grid;
  const int me = dl::rank(t), nd = g.nd;
  char* mine = out[me];
  const Lane l = lane_of(q, nd);
  const size_t shard = (size_t)m * row, start = (size_t)q * ms * row;
  const size_t piece = (size_t)piece_rows(m, ms, q) * row;

  comm::inject_faults(t, p.faults);
  comm::crew_grid_barrier(t, g, p.sig, 0, (u64)p.lanes * target,
                          /*neighbors_only=*/true, crew);
  comm::crew_copy(mine + me * shard + start, x + start, piece, part, parts,
                  crew);
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
        comm::crew_copy(out[nbr] + off, cell == me ? x + start : mine + off,
                        piece, part, parts, crew);
      }
      u64* word = p.sig[nbr] + ag_word(p, ph, q, src);
      comm::crew_signal(&word, 1, crew);
      const int expect = wrap(pos - (s + 1) * d, w);
      comm::crew_wait(p.sig[me] + ag_word(p, ph, q, expect), 1, 0, target,
                      tdt::WAIT_TORUS_ALL_GATHER, crew);
    }
  }
}

namespace wg = tdt::wgmma;
using WgTile64 = wg::Tile<1, 5>;
using WgTile128 = wg::Tile<2, 4>;

//: The communication crew: the producer warpgroup's warps 1-3 on named
//: barrier 1.
constexpr int CREW_THREADS = 96, CREW_BARRIER = 1;
//: Most pieces a rank multiplies: W L, 8 ranks by 6 lanes.
constexpr int MAX_PIECES = dl::MAX_RANKS * 6;
//: Most runs: the own pieces, then one a step of a phase (at most 1 +
//: nd (maxw - 1) over the grids of at most 8 ranks: (2, 4) and (4, 2)).
constexpr int MAX_RUNS = 8;
//: Rows of a segment: the a rows of a tile are BM / SEG boxes of SEG rows,
//: each of any piece of the tile's run.
constexpr int SEG = 32;

// The flat tile list (`kernels/torus.py` `ag_gemm_pieces`): piece i of
// every rank is of lane ``lane[i]`` and has segments first[i] .. first[i +
// 1] - 1 (counted over the list); run r holds pieces run[r] .. run[r + 1]
// - 1 and row tiles tiles[r] .. tiles[r + 1] - 1, its segments in order,
// BM / SEG a row tile; rank r's piece i is of cell ``cell[r][i]`` and waits
// on its arrival word ``word[r][i]`` (0: an own piece, no wait).
struct Pieces {
  int count, runs;
  int first[MAX_PIECES + 1];
  int run[MAX_RUNS + 1];
  int tiles[MAX_RUNS + 1];
  unsigned char lane[MAX_PIECES];
  unsigned char cell[dl::MAX_RANKS][MAX_PIECES];
  unsigned char word[dl::MAX_RANKS][MAX_PIECES];
};

struct WgArgs {
  CUtensorMap ta;                 // a (R, m, k) as (k, m, R)
  CUtensorMap tb;                 // b (R, k, n) as (n, k, R)
  CUtensorMap tg[dl::MAX_RANKS];  // rank r's gathered (W, m, k) as (k, m, W)
  GridArgs grid;
  const bf16* a;
  bf16* out;                      // (R, W m, n)
  dl::Symm<char> gathered;        // rank r's (W, m, k)
  int m, ms, n, k;
  Pieces pieces;
};

// The producer thread runs at 40 registers, so the schedule keeps little:
// what it can read from the arguments or blockIdx it reads again.
template <class Tile>
struct TorusSched {
  //: Segments a tile: its BM rows as boxes of SEG rows.
  static constexpr int SPT = Tile::BM / SEG;
  const WgArgs* p;
  u64 held;  // the arrival words the producer has waited on, a bit each
  // The last tile located: its column, its live segments (a bit each), each
  // segment's first row in its cell (the piece's q ms plus the segment's
  // offset) << 3 | the cell (a segment past the run's last repeats the
  // tile's first; its rows are not stored), and its arrival words.
  int at_t, at_col, live;
  int seg[SPT];
  u64 need;

  __device__ __forceinline__ int me() const { return blockIdx.y; }
  __device__ __forceinline__ int nt() const {
    return (p->n + Tile::TN - 1) / Tile::TN;
  }
  __device__ __forceinline__ u64 target() const {
    return p->grid.epoch + gridDim.x / p->grid.lanes;
  }

  __device__ __forceinline__ void locate(int t) {
    if (t == at_t) return;
    const Pieces& ps = p->pieces;
    const int nt = this->nt();
    int r = 0;
    while (r + 1 < ps.runs && ps.tiles[r + 1] * nt <= t) ++r;
    const int rows = ps.tiles[r + 1] - ps.tiles[r];
    const int j = t - ps.tiles[r] * nt, end = ps.first[ps.run[r + 1]];
    const int s0 = ps.first[ps.run[r]] + j % rows * SPT;
    int i = ps.run[r];
    at_t = t;
    at_col = j / rows * Tile::TN;
    live = 0;
    need = 0;
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int s = s0 + k;
      if (s < end) {
        while (ps.first[i + 1] <= s) ++i;
        const int w = ps.word[me()][i];
        seg[k] = (ps.lane[i] * p->ms + (s - ps.first[i]) * SEG) << 3 |
                 ps.cell[me()][i];
        if (w != 0) need |= 1ull << w;
        live |= 1 << k;
      } else {
        seg[k] = seg[0];
      }
    }
  }
  __device__ __forceinline__ wg::At at(int t) {
    locate(t);
    return {&p->ta, seg[0] >> 3, seg[0] & 7, at_col, me(),
            (p->k + wg::BK - 1) / wg::BK};
  }
  __device__ __forceinline__ bool pending(int t) {
    locate(t);
    return (need & ~held) != 0;
  }
  __device__ __forceinline__ void ready(int) {
    for (u64 w = need & ~held; w != 0; w &= w - 1)
      comm::wait_word_for_tma(p->grid.sig[me()] + __ffsll((long long)w) - 1,
                              target(), tdt::WAIT_TORUS_AG_GEMM_LOAD);
    held |= need;
  }
  // Stage kt's a rows: a box of SEG rows a segment, the own cell's from
  // the shard, the others' from the gathered buffer.
  __device__ __forceinline__ void load_a(uint8_t* dst, uint64_t* bar,
                                         int kt) {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int cell = seg[k] & 7;
      wg::tma_load_3d(dst + k * SEG * wg::ROW_BYTES,
                      cell == me() ? &p->ta : &p->tg[me()],
                      bar, kt * wg::BK, seg[k] >> 3, cell);
    }
  }
  __device__ __forceinline__ void side(int i) {
    const int L = p->grid.lanes, crews = gridDim.x / L;
    const int share = blockIdx.x / L;
    if (share >= crews) return;
    emit_torus_ag_crew(
        p->grid,
        reinterpret_cast<const char*>(p->a + (size_t)me() * p->m * p->k),
        p->gathered, p->m, p->ms, (size_t)p->k * sizeof(bf16),
        blockIdx.x % L, share, crews, target(),
        comm::Crew{i, CREW_THREADS, CREW_BARRIER});
  }
  // A thread's two rows (r and r + 8 of a 16-row warp slice) lie in one
  // segment: rows c m + q ms + .. of this rank's out, clipped to the
  // piece's rows; a segment past the run's end stores nothing.
  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        const float (&acc)[Tile::ACC]) {
    locate(t);
    const int warp = threadIdx.x % wg::WG / 32;
    const int r = wgi * wg::WG_ROWS + warp * 16, k = r / SEG;
    int sg = 0;
#pragma unroll
    for (int s = 0; s < SPT; ++s)
      if (s == k) sg = seg[s];
    if (!(live >> k & 1)) return;
    const int row = sg >> 3, q = row / p->ms, first = q * p->ms;
    const int world = p->grid.team.world;
    bf16* o = p->out + ((size_t)me() * world * p->m +
                        (size_t)(sg & 7) * p->m + first) * p->n;
    // store_tile's rows of this thread: r0 + r + lane / 4 (and + 8).
    wg::store_tile(o, piece_rows(p->m, p->ms, q), p->n,
                   row - first + r % SEG - r, w.col, wgi, acc);
  }
};

// Compiled for 384 threads (168 registers a thread at entry, as K12's) and
// launched with Tile::NT.
template <class Tile>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    torus_ag_gemm_wgmma_kernel(const __grid_constant__ WgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  TorusSched<Tile> sched{&p, 0, -1};
  Tile::run(smem, &p.tb, p.pieces.tiles[p.pieces.runs] * sched.nt(), sched);
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

// The Hopper body: encode the maps, count each piece's row tiles, then one
// cooperative launch of P blocks a rank, P the call's tiles, at least L
// (every lane has a crew), at most what can be resident (one an SM).  The
// crews a lane, P / L, go to ``*blocks``.
template <class Tile>
int launch_ag_gemm_wgmma(WgArgs& p, const void* a, const void* b,
                         void* const* gathered, int* blocks,
                         cudaStream_t s) {
  const int w = p.grid.team.world, m = p.m, n = p.n, k = p.k;
  const int L = p.grid.lanes;
  int rc = wg::encode_3d(&p.ta, a, k, m, w, wg::BK, SEG);
  if (rc == 0) rc = wg::encode_3d(&p.tb, b, n, k, w, wg::BOX_N, wg::BK);
  for (int r = 0; r < w && rc == 0; ++r)
    rc = wg::encode_3d(&p.tg[r], gathered[r], k, m, w, wg::BK, SEG);
  if (rc != 0) return rc;
  Pieces& ps = p.pieces;
  constexpr int spt = Tile::BM / SEG;
  ps.first[0] = 0;
  for (int i = 0; i < ps.count; ++i)
    ps.first[i + 1] =
        ps.first[i] + (piece_rows(m, p.ms, ps.lane[i]) + SEG - 1) / SEG;
  ps.tiles[0] = 0;
  for (int r = 0; r < ps.runs; ++r)
    ps.tiles[r + 1] = ps.tiles[r] + (ps.first[ps.run[r + 1]] -
                                     ps.first[ps.run[r]] + spt - 1) / spt;
  auto* fn = torus_ag_gemm_wgmma_kernel<Tile>;
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
  const int fit = occ * sms / w;
  if (fit < L) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = ps.tiles[ps.runs] * ((n + Tile::TN - 1) / Tile::TN);
  const int P = std::min(std::max(tiles, L), fit);
  *blocks = P / L;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<void*>(fn),
                                          dim3(P, w), dim3(Tile::NT), args,
                                          Tile::SMEM_BYTES, s);
}

}  // namespace

// The entry points share their trailing arguments: ``sig``, a host table
// of W device pointers, rank r's ``words`` u64 signal words (at least what
// the kernel's layout needs); ``nd`` and ``sizes`` the grid (2 or 3 axes,
// each of at least 2 ranks, W = their product <= 8 ranks, all of them in
// this launch); ``m`` rows a rank's shard, split into 2 * nd pieces of ``ms`` rows (the last ones short or
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

// K21c's Hopper body: a, b, out, gathered, sig and the grid as
// `torus_ag_gemm`, all bf16, k and n multiples of 8, every pointer 16-byte
// aligned; ``pieces`` pieces a rank (at most W L), ``lanes`` (pieces) their
// lanes, ``cells`` and ``waits`` (W, pieces) each rank's cells and arrival
// words, ``runs`` runs of pieces, run r from piece ``run_first[r]`` on
// (`kernels/torus.py` `ag_gemm_pieces`); ``epoch`` the instance's sum of
// crews a lane over its earlier calls, this launch's going to ``*blocks``.
// Returns a cudaError_t code.
extern "C" int torus_ag_gemm_wgmma(const void* a, const void* b, void* out,
                                   void* const* gathered, void* const* sig,
                                   int nd, const int* sizes, int words, int m,
                                   int ms, int n, int k, int pieces,
                                   const int* lanes, const int* cells,
                                   const int* waits, int runs,
                                   const int* run_first,
                                   unsigned long long epoch,
                                   int straggler, long long cycles,
                                   int for_correctness, int* blocks,
                                   void* stream) {
  *blocks = 0;
  WgArgs p{};
  int world = 0;
  if (!make_grid(nd, sizes, &p.grid, &world) || m < 1 || ms < 1 || n < 1 ||
      k < 1 || k % 8 != 0 || n % 8 != 0 ||
      words < 1 + nd * p.grid.lanes * p.grid.maxw || pieces < 1 ||
      pieces > world * p.grid.lanes || runs < 1 || runs > MAX_RUNS)
    return (int)cudaErrorInvalidValue;
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(out);
  for (int r = 0; r < world; ++r) {
    p.grid.sig.ptr[r] = static_cast<u64*>(sig[r]);
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  if (align % 16 != 0) return (int)cudaErrorInvalidValue;
  Pieces& ps = p.pieces;
  ps.count = pieces;
  ps.runs = runs;
  for (int r = 0; r < runs; ++r) {
    if (run_first[r] < 0 || run_first[r] >= pieces ||
        (r > 0 && run_first[r] <= run_first[r - 1]))
      return (int)cudaErrorInvalidValue;
    ps.run[r] = run_first[r];
  }
  if (ps.run[0] != 0) return (int)cudaErrorInvalidValue;
  ps.run[runs] = pieces;
  for (int i = 0; i < pieces; ++i) {
    if (lanes[i] < 0 || lanes[i] >= p.grid.lanes ||
        piece_rows(m, ms, lanes[i]) < 1)
      return (int)cudaErrorInvalidValue;
    ps.lane[i] = (unsigned char)lanes[i];
    for (int r = 0; r < world; ++r) {
      const int c = cells[r * pieces + i], wd = waits[r * pieces + i];
      if (c < 0 || c >= world || wd < 0 || wd >= words || wd >= 64 ||
          (wd == 0) != (c == r))
        return (int)cudaErrorInvalidValue;
      ps.cell[r][i] = (unsigned char)c;
      ps.word[r][i] = (unsigned char)wd;
    }
  }
  p.a = static_cast<const bf16*>(a);
  p.out = static_cast<bf16*>(out);
  p.m = m;
  p.ms = ms;
  p.n = n;
  p.k = k;
  p.grid.epoch = epoch;
  p.grid.faults = comm::Faults{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return ms <= wg::WG_ROWS
             ? launch_ag_gemm_wgmma<WgTile64>(p, a, b, gathered, blocks, s)
             : launch_ag_gemm_wgmma<WgTile128>(p, a, b, gathered, blocks, s);
}
