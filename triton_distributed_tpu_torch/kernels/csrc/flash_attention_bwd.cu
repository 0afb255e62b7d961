// Causal / non-causal GQA flash attention, backward (training): K4 computes
// dq, K5 computes dk and dv.
//
// Replaces: triton_distributed_tpu/kernels/flash_attention.py
//   `_flash_backward` -> `_flash_bwd_dq_kernel` (pallas_call :948) and
//   `_flash_bwd_dkv_kernel` (pallas_call :987).
//
// Contract (the JAX package's): with p = exp(s - lse) on the scores
// s = scale * q k^T, delta = rowsum(do * out) - dlse (XLA code in the JAX
// package; here K4 computes it and writes it for K5, which runs after K4 on
// the same stream), ds = p * (do v^T - delta):
//   dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T do,
// dk and dv summed over each GQA group.  Rows whose lse is at the fully
// masked sentinel (lse <= NEG_INF * ln2 / 2, possible only with a negative
// kv_offset) contribute nothing: their p and ds are SELECTED to zero, so a
// NaN `out` (and delta) on such a row never reaches a product.  Key columns
// past the causal limit get p = 0.  Query rows past Sq and key rows past Sk
// are read as zeros (the tensor maps' out-of-bounds fill); a row past Sq is
// also marked dead, so its p and ds are zero, and a zero key row adds exact
// zeros to dq.  Operand precision follows the TPU kernels: p is rounded to
// bf16 for dv = p^T do, ds to bf16 for dq and dk; s and dp are sums in f32
// of exact products of bf16 values.
//
// What bounds it on the H100: at the Qwen3-8B training shape (q/do/out/dq
// 4x32x512x128, k/v 4x8x512x128 bf16, causal) K4 moves ~76 MB (22.8 us at
// 3.35 TB/s) against 12.9 GFLOP of products (13 us at 989 TFLOP/s), so its
// bound is bytes; K5 does 17.2 GFLOP (17.4 us) against ~51 MB, so its bound
// is operations.  At 1x32x2048x128 both are bound by operations (51.5 and
// 68.7 GFLOP).  Every bf16 product therefore runs on Hopper's tensor cores
// through `wgmma`, fed by TMA, and each block reads its streamed tiles from
// device memory once.
//
// Design, bf16 (every main-path call; D 64 or 128): two warp-specialised
// bodies of 384 threads in the shape of the forward's (`flash_body.cuh`
// `Hopper<D>`): warpgroup 2 produces (its first thread issues the TMA loads
// through 3-D tensor maps (D, S, planes) with 128-byte swizzle, so a box
// past a head's S reads zeros, never the next head's rows; its other warps
// load the rows' statistics), warpgroups 0 and 1 consume (`setmaxnreg`
// moves the producer's registers to them).  Blocks are persistent, one an
// SM at most, and take their items heaviest first in a snake over the grid
// (`item_of`; kernels/flash_attention.py `bwd_items` writes the same order
// in Python, and tests/test_torch_flash_bwd_schedule.py holds it).
// - K4 (`Dq`): an item is one (batch, query head, 128 query rows); each
//   consumer warpgroup owns 64 rows.  Q and dO of the item are loaded once
//   into one of two buffers (the next item's load overlaps this one), K and
//   V stream in stages of 64 keys through a ring of full / empty mbarriers,
//   up to the causal limit of the item's last row.  Per stage a consumer
//   computes S = Q K^T and dP = dO V^T (`wgmma` m64n64k16, both operands
//   from shared memory, K-major), forms P and dS on the accumulator
//   fragment, and adds dQ += dS K (`wgmma` m64nDk16, dS as the register A
//   operand, K MN-major with the transpose bit); dS K of a stage is issued
//   together with the next stage's S and dP, and the stage goes back to the
//   producer once dS K has retired.  The producer's three spare warps form
//   delta = rowsum(dO * out) - dlse of an item's rows from device memory
//   while the consumers work on the item before (a buffer of row
//   statistics beside each Q buffer, its own mbarrier, waited for only
//   after the item's first products), write it for K5, and hand the
//   consumers lse * log2(e) and delta, a row past Sq or at the sentinel
//   marked dead.  dq * scale leaves through the warpgroup's rows of the Q
//   buffer as 16-byte stores.  The TPU kernel carried dq across sequential
//   grid steps in VMEM scratch; the loop over stages inside the block
//   replaces that grid dimension.
// - K5 (`Dkv`): an item is one (batch, KV head, 64 keys), whose K and V are
//   loaded once; Q and dO of each query head of the group and each visible
//   query tile of 64 rows stream through a ring of 4 stages, the tile's
//   lse * log2(e) and delta (64 floats each) written beside them by a spare
//   producer warp.  The two consumer warpgroups take the item's stages in
//   turn, each with dk and dv accumulators for all 64 keys in registers
//   across the item.  Per stage a warpgroup computes S^T = K Q^T and
//   dP^T = V dO^T (m64n64k16, both K-major), forms P^T and dS^T in
//   registers, and adds dV += P^T dO and dK += dS^T Q (m64nDk16, the A
//   operand from registers, dO and Q MN-major).  At the item's end
//   warpgroup 1's partial sums go through the K/V tiles (f32) to warpgroup
//   0, which adds them to its own in that order and stages dk * scale and
//   dv as bf16 for 16-byte stores.  The group is summed inside the item, in
//   head order: no float atomics, and two runs give the same bits.  That is
//   why dq has a kernel of its own and S and dP are computed in both
//   kernels: one kernel with dq added atomically across key tiles
//   (FlashAttention-3's backward) would save that work but not the bits.
//   With 128-key items (a warpgroup owning 64 keys, both reading every
//   stage) a Q/dO stage would serve twice the keys, but under the causal
//   mask the first key tile's item would carry 1.9x the mean work at 1 x
//   2048 (`bwd_balance`); 64-key items taken in turn keep the busiest
//   block within 4% of the mean at the training shapes, for twice the
//   Q/dO reads from L2.
// - Forms that were measured and lost or tied (the consumer warpgroups
//   taking turns at the tensor cores, dS K split by box or from shared
//   memory, other ring depths) are edits of this file that
//   scripts/torch_flash_bwd_ab.py --variants makes.
// - Waits spin at most ~10 s and then trap (`mbar_wait`); no path of these
//   kernels calls a function (ptxas would serialise the `wgmma`s, info
//   C7510).
//
// f32 kernels (inputs the main path never gives them; tests and the f32
// model-gradient check do) compute the same on the CUDA cores: 256 threads,
// each owning a 4x4 (K5: 4x2) piece of the score tile and 4 rows of the
// output, from transposed shared-memory tiles.

#include "flash_body.cuh"

namespace {

using tdt::LN2;
using tdt::LOG2E;
using tdt::NEG_INF;
using tdt::pack_bf16;
using bf16 = __nv_bfloat16;
namespace wg = tdt::wgmma;
namespace fb = tdt::flash;

constexpr int BQ = 64;  // f32: query rows per tile
constexpr int BK = 64;  // f32: keys per tile
// lse at or below this marks a fully masked row (the JAX kernels' test).
constexpr float LSE_DEAD = NEG_INF * (LN2 / 2);

__device__ __forceinline__ bool visible(int key, int row, int Sk, int causal,
                                        int kv_offset) {
  return key < Sk && (!causal || key <= row + kv_offset);
}

// delta = rowsum(do * out) - dlse for rows [q0, q0 + 64) of one head, NT /
// 64 threads a row (consecutive lanes): written to `delta` and to `ds`
// (shared, 64 floats).  dlse may be null.  Ends in a block barrier.
template <int D, int NT, typename T>
__device__ __forceinline__ void row_delta(const T* dout, const T* out,
                                          const float* dlse, float* delta,
                                          float* ds, int q0, int Sq,
                                          int tid) {
  constexpr int PER = NT / 64;  // threads a row
  constexpr int W = D / PER;    // elements a thread
  const int r = tid / PER, part = tid % PER;
  const int row = q0 + r;
  float acc = 0.f;
  if (row < Sq) {
    const T* dp = dout + (size_t)row * D + part * W;
    const T* op = out + (size_t)row * D + part * W;
#pragma unroll
    for (int c = 0; c < W; c += 8) {
      float a[8], b[8];
      tdt::load8(dp + c, a);
      tdt::load8(op + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
    }
  }
#pragma unroll
  for (int off = 1; off < PER; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    const float d = row < Sq ? acc - (dlse ? dlse[row] : 0.f) : 0.f;
    if (row < Sq) delta[row] = d;
    ds[r] = d;
  }
  __syncthreads();
}

// ---- bf16: the Hopper bodies (`wgmma` + TMA, warp-specialised) ------------

constexpr int HNT = 3 * wg::WG;  // consumer warpgroups 0, 1; the producer 2
constexpr int ROW = wg::ROW_BYTES;    // a swizzled row: 64 bf16
constexpr int ATOM = wg::ATOM_BYTES;  // 8 swizzled rows
constexpr int MAX_SMEM = 232448;      // dynamic shared memory of a block
//: A row statistic that marks a dead row (past Sq, or lse at the sentinel):
//: its p and ds are selected to zero.
constexpr float DEAD = 1e30f;
//: Named barriers 2 and 3: a consumer warpgroup's epilogue.
constexpr int OUT_BARRIER = 2;

// d (64 x 64 f32) = a (64 x 16, K-major) @ b (16 x 64, K-major) + (d if
// accumulate): S = Q K^T and its transposes, both operands rows of 128
// swizzled bytes along D.
__device__ __forceinline__ void mma_ss_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a (64 x 16k x 16: four k16 steps of 64 x 16 bf16, each four registers
// a thread in the m16n8k16 A layout) @ b (64 x D, MN-major: D / 64 boxes of
// ``box`` bytes, 64 rows of 128 swizzled bytes each), issued, not waited.
template <int D>
__device__ __forceinline__ void mma_rs_k64(float (&d)[D / 2],
                                           const unsigned (&a)[4][4],
                                           const uint8_t* b, int box) {
#pragma unroll
  for (int t = 0; t < 4; ++t)
    fb::mma_pv<D>(d, a[t], wg::desc(b + t * 16 * ROW, box, ATOM));
}

// S (64 x 64) = a (64 x D) @ b (64 x D)^T, both K-major tiles of D / 64
// boxes of ``abox`` / ``bbox`` bytes, issued, not waited.
template <int D>
__device__ __forceinline__ void mma_ss_kd(float (&d)[32], const uint8_t* a,
                                          int abox, const uint8_t* b,
                                          int bbox) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    mma_ss_m64n64k16(d, wg::desc(a + kk / 4 * abox + kk % 4 * 32, 16, ATOM),
                     wg::desc(b + kk / 4 * bbox + kk % 4 * 32, 16, ATOM),
                     kk > 0);
}

// The accumulators of two 8-column tiles of an m64n64 fragment, rounded to
// bf16: the A operand of a k16 step (keys or query rows 16 t .. 16 t + 15).
__device__ __forceinline__ void pack_a(unsigned (&a)[4][4],
                                       const float (&x)[32]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    a[t][0] = pack_bf16(x[8 * t], x[8 * t + 1]);
    a[t][1] = pack_bf16(x[8 * t + 2], x[8 * t + 3]);
    a[t][2] = pack_bf16(x[8 * t + 4], x[8 * t + 5]);
    a[t][3] = pack_bf16(x[8 * t + 6], x[8 * t + 7]);
  }
}

// Accumulator rows of an m64nD fragment (row lr0 + 8 h of the tile for
// this thread, h = 0, 1) times ``mul`` as bf16 into a tile of swizzled
// rows (D / 64 boxes of ``box`` bytes at ``tile``).
template <int D>
__device__ __forceinline__ void stage_acc(uint8_t* tile, int box,
                                          const float (&acc)[D / 2],
                                          float mul, int lr0) {
  const int tg = threadIdx.x % 4;
  // 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8).
#pragma unroll
  for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = lr0 + h * 8;
      *reinterpret_cast<unsigned*>(tile + n8 / 8 * box + lr * ROW +
                                   ((n8 % 8 ^ lr % 8) << 4) + tg * 4) =
          pack_bf16(acc[4 * n8 + 2 * h] * mul, acc[4 * n8 + 2 * h + 1] * mul);
    }
}

// Rows [lr_lo, lr_lo + rows) of a staged tile into rows r0 + lr < n of the
// (n, D) matrix ``dst``, 16 bytes a thread, by threads ``i`` of ``nthr``.
template <int D>
__device__ __forceinline__ void store_staged(const uint8_t* tile, int box,
                                             bf16* dst, int r0, int n,
                                             int lr_lo, int rows, int i,
                                             int nthr) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  for (int c = i; c < rows * CH; c += nthr) {
    const int lr = lr_lo + c / CH, n8 = c % CH;
    if (r0 + lr < n)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + lr) * D + n8 * 8) =
          *reinterpret_cast<const uint4*>(tile + n8 / 8 * box + lr * ROW +
                                          ((n8 % 8 ^ lr % 8) << 4));
  }
}

// The block's item in round r of a snake over the grid: rounds run forwards
// and backwards in turn, so with the items heaviest first every block's sum
// of work is about even (`Hopper::item_of`).
__device__ __forceinline__ int item_of(int r) {
  const int p = gridDim.x, b = blockIdx.x;
  return r * p + (r & 1 ? p - 1 - b : b);
}

__device__ __forceinline__ void advance(int& s, unsigned& phase, int n) {
  if (++s == n) {
    s = 0;
    phase ^= 1;
  }
}

// ---- K4: dq ------------------------------------------------------------------

struct DqArgs {
  CUtensorMap tq;   // q (B, H, Sq, D) as (D, Sq, B H), box (64, 128)
  CUtensorMap tdo;  // do, the same
  CUtensorMap tk;   // k (B, Hkv, Sk, D) as (D, Sk, B Hkv), box (64, 64)
  CUtensorMap tv;
  const bf16* dout;  // (B, H, Sq, D)
  const bf16* out;
  const float* lse;   // (B, H, Sq)
  const float* dlse;  // or null
  float* delta;       // written
  bf16* dq;
  int bh, H, group, Hkv, nqt, sq, sk, causal, off;
  float qscale, scale;
};

template <int D>
struct Dq {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int BOXES = D / 64;
  static constexpr int QROWS = 128;  // query rows of an item: 64 a warpgroup
  static constexpr int KROWS = 64;   // keys of a K/V stage
  static constexpr int QBUFS = 2;
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int QBOX = QROWS * ROW, KBOX = KROWS * ROW;
  static constexpr int Q_BYTES = BOXES * QBOX;  // Q (or dO) of an item
  static constexpr int BUF_BYTES = 2 * Q_BYTES;  // Q, then dO
  static constexpr int KV_BYTES = BOXES * KBOX;  // K (or V) of a stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int TILES = QBUFS * BUF_BYTES + STAGES * STAGE_BYTES;
  static constexpr int STATS = QBUFS * 2 * QROWS;  // floats
  static constexpr int USED = TILES + STATS * 4 + (3 * QBUFS + 2 * STAGES) * 8;
  //: Slack to align the tiles to the swizzle atom, where it fits; else the
  //: dynamic shared memory must start aligned (`carve` checks).
  static constexpr int SLACK = USED + ATOM <= MAX_SMEM ? ATOM : 0;
  static constexpr int SMEM_BYTES = USED + SLACK;
  static_assert(SMEM_BYTES <= MAX_SMEM, "shared memory");
  //: The spare warps hold eight 16-byte loads in flight each; the
  //: consumers need ~150 registers.
  static constexpr int PRODUCER_REGS = 72, CONSUMER_REGS = 216;
  static_assert(PRODUCER_REGS * wg::WG + 2 * CONSUMER_REGS * wg::WG <= 65536,
                "registers");

  struct Smem {
    uint8_t* q;     // buffer b at q + b BUF_BYTES: Q, then dO
    uint8_t* ring;  // stage s at ring + s STAGE_BYTES: K, then V
    float* stats;   // buffer b: lse * log2(e) [QROWS], then delta [QROWS]
    uint64_t* q_full;  // [QBUFS]
    uint64_t* q_empty;
    uint64_t* stats_full;
    uint64_t* full;  // [STAGES]
    uint64_t* empty;
  };

  static __device__ __forceinline__ Smem carve(uint8_t* raw) {
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + ATOM - 1) & ~uintptr_t(ATOM - 1));
    if (SLACK == 0 && base != raw) __trap();
    float* stats = reinterpret_cast<float*>(base + TILES);
    uint64_t* bars = reinterpret_cast<uint64_t*>(stats + STATS);
    uint8_t* ring = base + QBUFS * BUF_BYTES;
    return {base,
            ring,
            stats,
            bars,
            bars + QBUFS,
            bars + 2 * QBUFS,
            bars + 3 * QBUFS,
            bars + 3 * QBUFS + STAGES};
  }

  // Item it: query tile nqt - 1 - it / (B H) (the heaviest causal tiles
  // first) of (batch, head) it % (B H); its K/V stages up to the tile's
  // last row's causal limit.
  struct Item {
    int plane, kv_plane, q0, n_kt;
  };
  static __device__ __forceinline__ Item item(const DqArgs& p, int it) {
    const int bh = it % p.bh;
    const int q0 = (p.nqt - 1 - it / p.bh) * QROWS;
    const int b = bh / p.H, hk = bh % p.H / p.group;
    return {bh, b * p.Hkv + hk, q0,
            tdt::kv_tiles<QROWS, KROWS>(q0, p.sq, p.sk, p.causal, p.off)};
  }

  // ---- the producer thread: an item's Q and dO, then its K/V stages
  static __device__ __forceinline__ void produce(const Smem& sm,
                                                 const DqArgs& p, int items) {
    int s = 0, qb = 0;
    unsigned phase = 0, q_phase = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      tdt::mbar_wait(&sm.q_empty[qb], q_phase ^ 1);
      tdt::mbar_expect_tx(&sm.q_full[qb], BUF_BYTES);
      uint8_t* qd = sm.q + qb * BUF_BYTES;
#pragma unroll
      for (int j = 0; j < BOXES; ++j) {
        wg::tma_load_3d(qd + j * QBOX, &p.tq, &sm.q_full[qb], 64 * j, t.q0,
                        t.plane);
        wg::tma_load_3d(qd + Q_BYTES + j * QBOX, &p.tdo, &sm.q_full[qb],
                        64 * j, t.q0, t.plane);
      }
      advance(qb, q_phase, QBUFS);
      for (int kt = 0; kt < t.n_kt; ++kt) {
        tdt::mbar_wait(&sm.empty[s], phase ^ 1);
        tdt::mbar_expect_tx(&sm.full[s], STAGE_BYTES);
        uint8_t* st = sm.ring + s * STAGE_BYTES;
#pragma unroll
        for (int j = 0; j < BOXES; ++j) {
          wg::tma_load_3d(st + j * KBOX, &p.tk, &sm.full[s], 64 * j,
                          kt * KROWS, t.kv_plane);
          wg::tma_load_3d(st + KV_BYTES + j * KBOX, &p.tv, &sm.full[s],
                          64 * j, kt * KROWS, t.kv_plane);
        }
        advance(s, phase, STAGES);
      }
    }
  }

  // ---- the spare warps (96 threads, ``i`` their index): each item's
  // delta, written to device memory, and its rows' statistics.  A warp
  // takes 32 / (D / 8) rows at once, a row's 16-byte chunks on consecutive
  // lanes; dO and out are read from device memory, so the work does not
  // wait for the item's TMA loads.
  static __device__ __forceinline__ void row_stats(const Smem& sm,
                                                   const DqArgs& p,
                                                   int items, int i) {
    constexpr int CH = D / 8;       // 16-byte chunks a row
    constexpr int RPW = 32 / CH;    // rows a warp takes at once
    constexpr int STEP = 3 * RPW;   // rows the three warps take at once
    constexpr int PASSES = (QROWS + STEP - 1) / STEP;
    constexpr int U = 4;            // passes with their loads in flight
    const int warp = i / 32, lane = i % 32;
    const int sub = lane / CH, ch = lane % CH;
    int qb = 0;
    unsigned q_phase = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      const size_t base = (size_t)t.plane * p.sq;
      tdt::mbar_wait(&sm.q_empty[qb], q_phase ^ 1);
      float* st = sm.stats + qb * 2 * QROWS;
#pragma unroll 1
      for (int p0 = 0; p0 < PASSES; p0 += U) {
        uint4 a[U], o[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int lr = (p0 + u) * STEP + warp * RPW + sub;
          const bool ok = lr < QROWS && t.q0 + lr < p.sq;
          const size_t at = (base + (ok ? t.q0 + lr : 0)) * D + ch * 8;
          a[u] = ok ? *reinterpret_cast<const uint4*>(p.dout + at)
                    : make_uint4(0, 0, 0, 0);
          o[u] = ok ? *reinterpret_cast<const uint4*>(p.out + at)
                    : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a[u]);
          const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&o[u]);
          float acc = 0.f;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x[e]);
            const float2 yf = __bfloat1622float2(y[e]);
            acc = fmaf(xf.x, yf.x, acc);
            acc = fmaf(xf.y, yf.y, acc);
          }
#pragma unroll
          for (int m = 1; m < CH; m <<= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, m);
          const int lr = (p0 + u) * STEP + warp * RPW + sub;
          const int row = t.q0 + lr;
          if (ch == 0 && lr < QROWS) {
            float l2 = DEAD, dl = 0.f;
            if (row < p.sq) {
              const float l = p.lse[base + row];
              const float d = acc - (p.dlse ? p.dlse[base + row] : 0.f);
              p.delta[base + row] = d;
              if (l > LSE_DEAD) {
                l2 = l * LOG2E;
                dl = d;
              }
            }
            st[lr] = l2;
            st[QROWS + lr] = dl;
          }
        }
      }
      tdt::mbar_arrive(&sm.stats_full[qb]);
      advance(qb, q_phase, QBUFS);
    }
  }

  // The statistics of a consumer thread's rows lr, lr + 8 of the item in
  // Q buffer b, once the spare warps have written them.  A dead row's p
  // and ds are selected to zero.
  struct Rows {
    float lse2[2], delta[2];
    bool live[2];
  };
  static __device__ __forceinline__ Rows rows_of(const Smem& sm, int b,
                                                 unsigned phase, int lr) {
    tdt::mbar_wait(&sm.stats_full[b], phase);
    const float* st = sm.stats + b * 2 * QROWS;
    Rows rs;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rs.lse2[h] = st[lr + 8 * h];
      rs.delta[h] = st[QROWS + lr + 8 * h];
      rs.live[h] = rs.lse2[h] != DEAD;
    }
    return rs;
  }

  // ---- a consumer warpgroup: rows [64 w, 64 w + 64) of each item
  static __device__ __forceinline__ void consume(const Smem& sm,
                                                 const DqArgs& p, int items) {
    constexpr int NO = D / 2;  // dq accumulators a thread
    const int w = threadIdx.x / wg::WG, tid = threadIdx.x % wg::WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    int s = 0, qb = 0;
    unsigned phase = 0, q_phase = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      const int cur = qb;
      const unsigned stats_phase = q_phase;
      tdt::mbar_wait(&sm.q_full[cur], q_phase);
      advance(qb, q_phase, QBUFS);
      // This thread's rows: q0w + warp 16 + g, + 8.
      const int q0w = t.q0 + w * wg::WG_ROWS;
      const int row0 = q0w + warp * 16 + g;
      float dq[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) dq[i] = 0.f;
      const uint8_t* qs = sm.q + cur * BUF_BYTES + w * wg::WG_ROWS * ROW;
      const uint8_t* dos = qs + Q_BYTES;
      float sc[32] = {}, dp[32] = {};
      unsigned da[4][4];
      if (t.n_kt > 0) {
        tdt::mbar_wait(&sm.full[s], phase);
        const uint8_t* ks = sm.ring + s * STAGE_BYTES;
        wg::fence_acc(sc);
        wg::fence_acc(dp);
        wg::mma_fence();
        mma_ss_kd<D>(sc, qs, QBOX, ks, KBOX);
        mma_ss_kd<D>(dp, dos, QBOX, ks + KV_BYTES, KBOX);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_acc(sc);
        wg::fence_acc(dp);
      }
      // The rows' statistics, once the spare warps have them: after the
      // first stage's products, which do not need them.
      const Rows rs =
          rows_of(sm, cur, stats_phase, w * wg::WG_ROWS + warp * 16 + g);
      for (int kt = 0; kt < t.n_kt; ++kt) {
        const int k0 = kt * KROWS;
        const int cur_s = s;
        advance(s, phase, STAGES);
        // P and dS on the fragment: row row0 + 8 (e >> 1), key k0 + 8 j +
        // 2 tg + (e & 1).  The causal mask only where the stage crosses
        // the limit of the warpgroup's first row.
        const bool edge = p.causal && k0 + KROWS - 1 > q0w + p.off;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            const int key = k0 + 8 * j + 2 * tg + (e & 1);
            const bool ok =
                rs.live[h] && (!edge || key <= row0 + 8 * h + p.off);
            const float pv = ok ? exp2f(fminf(sc[4 * j + e] * p.qscale -
                                              rs.lse2[h], 0.f))
                                : 0.f;
            dp[4 * j + e] =
                rs.live[h] ? pv * (dp[4 * j + e] - rs.delta[h]) : 0.f;
          }
        pack_a(da, dp);
        // dQ += dS K (K MN-major: the next 64-column box is the leading
        // offset, 8 key rows the stride), then the next stage's S and dP.
        const uint8_t* ks = sm.ring + cur_s * STAGE_BYTES;
        wg::fence_acc(dq);
        wg::fence_acc(sc);
        wg::fence_acc(dp);
        wg::mma_fence();
        mma_rs_k64<D>(dq, da, ks, KBOX);
        wg::mma_commit();
        if (kt + 1 < t.n_kt) {
          tdt::mbar_wait(&sm.full[s], phase);
          const uint8_t* kn = sm.ring + s * STAGE_BYTES;
          mma_ss_kd<D>(sc, qs, QBOX, kn, KBOX);
          mma_ss_kd<D>(dp, dos, QBOX, kn + KV_BYTES, KBOX);
        }
        wg::mma_commit();  // the next stage's S and dP, or an empty group
        // dS K has retired: the stage goes back to the producer while the
        // next stage's products run.
        wg::mma_wait<1>();
        wg::fence_acc(dq);
        fb::keep(da);
        tdt::mbar_arrive(&sm.empty[cur_s]);
        wg::mma_wait<0>();
        wg::fence_acc(sc);
        wg::fence_acc(dp);
      }
      // dq * scale through the warpgroup's rows of the Q buffer (its last
      // product that read them has retired), then the buffer goes back.
      uint8_t* qw = sm.q + cur * BUF_BYTES;
      stage_acc<D>(qw, QBOX, dq, p.scale,
                   w * wg::WG_ROWS + warp * 16 + g);
      fb::named_sync(OUT_BARRIER + w, wg::WG);
      store_staged<D>(qw, QBOX, p.dq + (size_t)t.plane * p.sq * D, t.q0,
                      p.sq, w * wg::WG_ROWS, wg::WG_ROWS, tid, wg::WG);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tdt::mbar_arrive(&sm.q_empty[cur]);
    }
  }

  static __device__ __forceinline__ void run(uint8_t* raw, const DqArgs& p) {
    const Smem sm = carve(raw);
    if (threadIdx.x == 0) {
      for (int b = 0; b < QBUFS; ++b) {
        tdt::mbar_init(&sm.q_full[b], 1);
        tdt::mbar_init(&sm.q_empty[b], 2 * wg::WG);
        tdt::mbar_init(&sm.stats_full[b], 3 * 32);
      }
      for (int s = 0; s < STAGES; ++s) {
        tdt::mbar_init(&sm.full[s], 1);
        tdt::mbar_init(&sm.empty[s], 2 * wg::WG);
      }
      tdt::mbar_init_fence();
    }
    __syncthreads();
    const int w = threadIdx.x / wg::WG;
    const int items = p.nqt * p.bh;
    if (w == 2) {
      wg::regs_dec<PRODUCER_REGS>();
      if (threadIdx.x == 2 * wg::WG)
        produce(sm, p, items);
      else if (threadIdx.x >= 2 * wg::WG + 32)
        row_stats(sm, p, items, threadIdx.x - (2 * wg::WG + 32));
    } else {
      wg::regs_inc<CONSUMER_REGS>();
      consume(sm, p, items);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(HNT, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ DqArgs p) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  Dq<D>::run(wg_smem, p);
}

// ---- K5: dk, dv --------------------------------------------------------------

struct DkvArgs {
  CUtensorMap tq;   // q (B, H, Sq, D) as (D, Sq, B H), box (64, 64)
  CUtensorMap tdo;  // do, the same
  CUtensorMap tk;   // k (B, Hkv, Sk, D) as (D, Sk, B Hkv), box (64, 64)
  CUtensorMap tv;
  const float* lse;    // (B, H, Sq)
  const float* delta;  // K4's
  bf16* dk;            // (B, Hkv, Sk, D)
  bf16* dv;
  int bhk, group, nkt, nq, sq, sk, causal, off;
  float qscale, scale;
};

template <int D>
struct Dkv {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int BOXES = D / 64;
  static constexpr int KROWS = 64;  // keys of an item
  static constexpr int QROWS = 64;  // query rows of a stage
  static constexpr int STAGES = 4;
  static constexpr int BOX = 64 * ROW;  // a box of 64 rows: K, V, Q or dO
  static constexpr int KV_BYTES = BOXES * BOX;  // K (or V) of an item
  static constexpr int Q_BYTES = BOXES * BOX;   // Q (or dO) of a stage
  static constexpr int STAGE_BYTES = 2 * Q_BYTES;  // Q, then dO
  static constexpr int TILES = 2 * KV_BYTES + STAGES * STAGE_BYTES;
  static constexpr int STATS = STAGES * 2 * QROWS;  // floats
  static constexpr int SMEM_BYTES =
      TILES + STATS * 4 + (2 + 2 * STAGES) * 8 + ATOM;
  static constexpr int NO = D / 2;  // dk (and dv) accumulators a thread
  //: Named barriers: 2, both consumer warpgroups (the sum of their
  //: partials); 3, warpgroup 0 alone.
  static constexpr int BOTH = 2, FIRST = 3;
  static_assert(NO * wg::WG * 4 == 2 * KV_BYTES,
                "a warpgroup's f32 partial of dk or dv fills the K/V tiles");

  struct Smem {
    uint8_t* k;     // K of the item, then V at k + KV_BYTES
    uint8_t* ring;  // stage s at ring + s STAGE_BYTES: Q, then dO
    float* stats;   // stage s: lse * log2(e) [QROWS], then delta [QROWS]
    uint64_t* kv_full;
    uint64_t* kv_empty;
    uint64_t* full;  // [STAGES]
    uint64_t* empty;
  };

  static __device__ __forceinline__ Smem carve(uint8_t* raw) {
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + ATOM - 1) & ~uintptr_t(ATOM - 1));
    float* stats = reinterpret_cast<float*>(base + TILES);
    uint64_t* bars = reinterpret_cast<uint64_t*>(stats + STATS);
    return {base, base + 2 * KV_BYTES, stats, bars, bars + 1, bars + 2,
            bars + 2 + STAGES};
  }

  // Item it: key tile it / (B Hkv) (under a causal mask the first key
  // tiles see the most query rows: the heaviest first) of (batch, KV head)
  // it % (B Hkv).  Its stages, in order: the visible query tiles [qt0,
  // qt0 + n_q) of each query head of the group, group n_q in all; stage i
  // goes to consumer warpgroup i % 2.
  struct Item {
    int kv_plane, q_plane0, k0, qt0, n_q, n;
  };
  static __device__ __forceinline__ Item item(const DkvArgs& p, int it) {
    const int bhk = it % p.bhk;
    const int k0 = it / p.bhk * KROWS;
    int qt0 = 0, n_q = p.nq;
    if (p.causal) {
      const int first = k0 - p.off;  // the first query row that sees k0
      qt0 = first > 0 ? first / QROWS : 0;
      n_q = first > p.sq - 1 ? 0 : p.nq - qt0;
    }
    return {bhk, bhk * p.group, k0, qt0, n_q, p.group * n_q};
  }

  // ---- the producer thread: an item's first Q / dO stages (the ring's
  // free slots, while the consumers finish the item before), its K and V
  // (once they have), then the rest of its stages.
  static __device__ __forceinline__ void load_stage(const Smem& sm,
                                                    const DkvArgs& p,
                                                    const Item& t, int i,
                                                    int& s,
                                                    unsigned& phase) {
    const int plane = t.q_plane0 + i / t.n_q;
    const int q0 = (t.qt0 + i % t.n_q) * QROWS;
    tdt::mbar_wait(&sm.empty[s], phase ^ 1);
    tdt::mbar_expect_tx(&sm.full[s], STAGE_BYTES);
    uint8_t* st = sm.ring + s * STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < BOXES; ++j) {
      wg::tma_load_3d(st + j * BOX, &p.tq, &sm.full[s], 64 * j, q0, plane);
      wg::tma_load_3d(st + Q_BYTES + j * BOX, &p.tdo, &sm.full[s], 64 * j,
                      q0, plane);
    }
    advance(s, phase, STAGES);
  }

  static __device__ __forceinline__ void produce(const Smem& sm,
                                                 const DkvArgs& p,
                                                 int items) {
    int s = 0;
    unsigned phase = 0, kv_phase = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      if (t.n == 0) continue;  // nothing visible: dk = dv = 0
      const int pre = t.n < STAGES ? t.n : STAGES;
      for (int i = 0; i < pre; ++i) load_stage(sm, p, t, i, s, phase);
      tdt::mbar_wait(sm.kv_empty, kv_phase ^ 1);
      tdt::mbar_expect_tx(sm.kv_full, 2 * KV_BYTES);
#pragma unroll
      for (int j = 0; j < BOXES; ++j) {
        wg::tma_load_3d(sm.k + j * BOX, &p.tk, sm.kv_full, 64 * j, t.k0,
                        t.kv_plane);
        wg::tma_load_3d(sm.k + KV_BYTES + j * BOX, &p.tv, sm.kv_full,
                        64 * j, t.k0, t.kv_plane);
      }
      kv_phase ^= 1;
      for (int i = pre; i < t.n; ++i) load_stage(sm, p, t, i, s, phase);
    }
  }

  // ---- a spare warp: each stage's lse * log2(e) and delta, two rows a
  // lane, a dead row (past Sq, or lse at the sentinel) marked; then its
  // arrival on the stage's full barrier.
  static __device__ __forceinline__ void row_stats(const Smem& sm,
                                                   const DkvArgs& p,
                                                   int items, int lane) {
    int s = 0;
    unsigned phase = 0;
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      for (int gi = 0; gi < p.group && t.n > 0; ++gi) {
        const size_t base = (size_t)(t.q_plane0 + gi) * p.sq;
        for (int qt = t.qt0; qt < t.qt0 + t.n_q; ++qt) {
          tdt::mbar_wait(&sm.empty[s], phase ^ 1);
          float* st = sm.stats + s * 2 * QROWS;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = lane + 32 * h;
            const int row = qt * QROWS + lr;
            float l2 = DEAD, dl = 0.f;
            if (row < p.sq) {
              const float l = p.lse[base + row];
              if (l > LSE_DEAD) {
                l2 = l * LOG2E;
                dl = p.delta[base + row];
              }
            }
            st[lr] = l2;
            st[QROWS + lr] = dl;
          }
          tdt::mbar_arrive(&sm.full[s]);
          advance(s, phase, STAGES);
        }
      }
    }
  }

  // ---- a consumer warpgroup: every other stage of each item, then the
  // two warpgroups' partial dk and dv summed in warpgroup order.
  static __device__ __forceinline__ void consume(const Smem& sm,
                                                 const DkvArgs& p,
                                                 int items) {
    const int w = threadIdx.x / wg::WG, tid = threadIdx.x % wg::WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const int lr0 = warp * 16 + g;  // this thread's keys of the item: +0, +8
    unsigned c = 0;  // stages of the ring before the item's first
    unsigned kv_phase = 0;
    float sc[32] = {}, dp[32] = {};
    for (int r = 0; r * (int)gridDim.x < items; ++r) {
      const int it = item_of(r);
      if (it >= items) continue;
      const Item t = item(p, it);
      const size_t out0 = (size_t)t.kv_plane * p.sk * D;
      if (t.n == 0) {
        // No query row sees these keys: zeros, straight to device memory
        // (the K/V tiles may already hold the next item's), half the keys
        // a warpgroup.
        constexpr int CH = D / 8;
        for (int i = tid; i < 32 * CH; i += wg::WG) {
          const int key = t.k0 + 32 * w + i / CH;
          if (key < p.sk) {
            const size_t at = out0 + (size_t)key * D + i % CH * 8;
            *reinterpret_cast<uint4*>(p.dk + at) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(p.dv + at) = make_uint4(0, 0, 0, 0);
          }
        }
        continue;
      }
      tdt::mbar_wait(sm.kv_full, kv_phase);
      kv_phase ^= 1;
      const int key0 = t.k0 + lr0;
      float dk[NO], dv[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) dk[i] = dv[i] = 0.f;
      for (int i = w; i < t.n; i += 2) {
        const unsigned at = c + i;
        const int s = at % STAGES;
        const unsigned phase = at / STAGES & 1;
        const int q0 = (t.qt0 + i % t.n_q) * QROWS;
        tdt::mbar_wait(&sm.full[s], phase);
        const uint8_t* qs = sm.ring + s * STAGE_BYTES;
        const uint8_t* dos = qs + Q_BYTES;
        const float* st = sm.stats + s * 2 * QROWS;
        wg::fence_acc(sc);
        wg::fence_acc(dp);
        wg::mma_fence();
        mma_ss_kd<D>(sc, sm.k, BOX, qs, BOX);
        mma_ss_kd<D>(dp, sm.k + KV_BYTES, BOX, dos, BOX);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_acc(sc);
        wg::fence_acc(dp);
        // P^T and dS^T on the fragment: key key0 + 8 (e >> 1), query row
        // q0 + 8 j + 2 tg + (e & 1).  The causal mask only where the
        // item's last key is past the limit of the tile's first row.
        const bool edge = p.causal && t.k0 + KROWS - 1 > q0 + p.off;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(st + 8 * j + 2 * tg);
          const float2 dl =
              *reinterpret_cast<const float2*>(st + QROWS + 8 * j + 2 * tg);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float l = e & 1 ? l2.y : l2.x;
            const float dd = e & 1 ? dl.y : dl.x;
            const bool live = l != DEAD;
            const int row = q0 + 8 * j + 2 * tg + (e & 1);
            const bool ok =
                live && (!edge || key0 + 8 * (e >> 1) <= row + p.off);
            const float pv =
                ok ? exp2f(fminf(sc[4 * j + e] * p.qscale - l, 0.f)) : 0.f;
            dp[4 * j + e] = live ? pv * (dp[4 * j + e] - dd) : 0.f;
            sc[4 * j + e] = pv;
          }
        }
        unsigned pa[4][4], da[4][4];
        pack_a(pa, sc);
        pack_a(da, dp);
        // dV += P^T dO, dK += dS^T Q (dO and Q MN-major).
        wg::fence_acc(dk);
        wg::fence_acc(dv);
        wg::mma_fence();
        mma_rs_k64<D>(dv, pa, dos, BOX);
        mma_rs_k64<D>(dk, da, qs, BOX);
        wg::mma_commit();
        wg::mma_wait<0>();
        wg::fence_acc(dk);
        wg::fence_acc(dv);
        fb::keep(pa);
        fb::keep(da);
        tdt::mbar_arrive(&sm.empty[s]);
      }
      c += t.n;
      // dk = dk0 + dk1 and dv = dv0 + dv1 (warpgroup order) through the K/V
      // tiles, free once both warpgroups' products have retired, as f32
      // scratch (a thread's accumulators at i WG + tid: the same thread of
      // the other warpgroup holds the same elements); then warpgroup 0
      // stages dk * scale and dv there as bf16 and both store them.
      float* scratch = reinterpret_cast<float*>(sm.k);
      fb::named_sync(BOTH, 2 * wg::WG);
      if (w == 1) {
#pragma unroll
        for (int i = 0; i < NO; ++i) scratch[i * wg::WG + tid] = dk[i];
      }
      fb::named_sync(BOTH, 2 * wg::WG);
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < NO; ++i) dk[i] += scratch[i * wg::WG + tid];
      }
      fb::named_sync(BOTH, 2 * wg::WG);
      if (w == 1) {
#pragma unroll
        for (int i = 0; i < NO; ++i) scratch[i * wg::WG + tid] = dv[i];
      }
      fb::named_sync(BOTH, 2 * wg::WG);
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < NO; ++i) dv[i] += scratch[i * wg::WG + tid];
        fb::named_sync(FIRST, wg::WG);
        stage_acc<D>(sm.k, BOX, dk, p.scale, lr0);
        stage_acc<D>(sm.k + KV_BYTES, BOX, dv, 1.f, lr0);
      }
      fb::named_sync(BOTH, 2 * wg::WG);
      store_staged<D>(sm.k, BOX, p.dk + out0, t.k0, p.sk, 0, KROWS,
                      threadIdx.x, 2 * wg::WG);
      store_staged<D>(sm.k + KV_BYTES, BOX, p.dv + out0, t.k0, p.sk, 0,
                      KROWS, threadIdx.x, 2 * wg::WG);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      tdt::mbar_arrive(sm.kv_empty);
    }
  }

  static __device__ __forceinline__ void run(uint8_t* raw, const DkvArgs& p) {
    const Smem sm = carve(raw);
    if (threadIdx.x == 0) {
      tdt::mbar_init(sm.kv_full, 1);
      tdt::mbar_init(sm.kv_empty, 2 * wg::WG);
      for (int s = 0; s < STAGES; ++s) {
        tdt::mbar_init(&sm.full[s], 1 + 32);  // the TMA thread, the stats warp
        tdt::mbar_init(&sm.empty[s], wg::WG);  // the stage's warpgroup
      }
      tdt::mbar_init_fence();
    }
    __syncthreads();
    const int w = threadIdx.x / wg::WG;
    const int items = p.nkt * p.bhk;
    if (w == 2) {
      wg::regs_dec<wg::PRODUCER_REGS>();
      if (threadIdx.x == 2 * wg::WG)
        produce(sm, p, items);
      else if (threadIdx.x / 32 == 2 * wg::WG / 32 + 1)
        row_stats(sm, p, items, threadIdx.x % 32);
    } else {
      wg::regs_inc<wg::CONSUMER_REGS>();
      consume(sm, p, items);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(HNT, 1)
    bwd_dkv_wgmma_kernel(const __grid_constant__ DkvArgs p) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  Dkv<D>::run(wg_smem, p);
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block
constexpr int BQ5 = 32;      // K5 f32: query rows per tile

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // QsT, dOsT, KsT, VsT [D][64]; Ks [64][D]; dSs [64][64]; delta [64]
  return sizeof(float) * (size_t)(5 * D * 64 + BK * BQ + BQ);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  // KsT, VsT [D][64]; QsT, dOsT [D][32]; Qs, dOs [32][D]; Ps, dSs [32][64];
  // Ls, Ds [32]
  return sizeof(float) *
         (size_t)(2 * D * BK + 4 * D * BQ5 + 2 * BQ5 * BK + 2 * BQ5);
}

// Rows [r0, r0 + n_rows_tile) of a (n, D) f32 matrix into shared memory,
// transposed (dstT[d * ld + r]) and/or row-major (dst[r * D + d]); rows at
// or past n are zeros.
template <int D>
__device__ __forceinline__ void stage_f32(const float* src, int r0, int n,
                                          int rows, float* dstT, int ld,
                                          float* dst, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows * CH; c += F32_NT) {
    const int r = c % rows, dc = c / rows;  // consecutive threads, rows
    float f[8];
    if (r0 + r < n) {
      tdt::load8(src + (size_t)(r0 + r) * D + dc * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    if (dstT) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(dc * 8 + i) * ld + r] = f[i];
    }
    if (dst) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[r * D + dc * 8 + i] = f[i];
    }
  }
}

// K4 f32.  Thread (ty, tx) owns query rows 4*ty..4*ty+3, keys 4*tx..4*tx+3
// of the score tile and dq columns {64*gc + 4*tx + c}.
template <int D>
__global__ void __launch_bounds__(F32_NT) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dlse, float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale, float scale) {
  constexpr int NG = D / 64;
  extern __shared__ float smem_f[];
  float* QsT = smem_f;          // [D][BQ]
  float* dOsT = QsT + D * BQ;   // [D][BQ]
  float* KsT = dOsT + D * BQ;   // [D][BK]
  float* VsT = KsT + D * BK;    // [D][BK]
  float* Ks = VsT + D * BK;     // [BK][D]
  float* dSs = Ks + BK * D;     // [BK][BQ]
  float* Dsm = dSs + BK * BQ;   // [BQ], the tile's delta

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)(b * H + h) * Sq;
  const float* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * Sk * D;

  stage_f32<D>(q + qoff * D, q0, Sq, BQ, QsT, BQ, nullptr, tid);
  stage_f32<D>(dout + qoff * D, q0, Sq, BQ, dOsT, BQ, nullptr, tid);
  row_delta<D, F32_NT>(dout + qoff * D, out + qoff * D,
                       dlse ? dlse + qoff : nullptr, delta + qoff, Dsm, q0,
                       Sq, tid);

  float lse2[4], dlt[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l = row < Sq ? lse[qoff + row] : NEG_INF;
    live[i] = l > LSE_DEAD;
    lse2[i] = live[i] ? l * LOG2E : 0.f;
    dlt[i] = live[i] ? Dsm[ty * 4 + i] : 0.f;
  }
  float acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;

  const int n_kt = tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage_f32<D>(kp, k0, Sk, BK, KsT, BK, Ks, tid);
    stage_f32<D>(vp, k0, Sk, BK, VsT, BK, nullptr, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&QsT[d * BQ + ty * 4]);
      const float4 o = *reinterpret_cast<const float4*>(&dOsT[d * BQ + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&KsT[d * BK + tx * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&VsT[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ov[4] = {o.x, o.y, o.z, o.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vf[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live[i] && visible(k0 + tx * 4 + j, q0 + ty * 4 + i,
                                           Sk, causal, kv_offset);
        const float p =
            ok ? exp2f(fminf(s[i][j] * qscale - lse2[i], 0.f)) : 0.f;
        dp[i][j] = live[i] ? p * (dp[i][j] - dlt[i]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSs[(tx * 4 + j) * BQ + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(&dSs[j * BQ + ty * 4]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int gc = 0; gc < NG; ++gc) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[j * D + gc * 64 + tx * 4]);
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][gc * 4 + c] = fmaf(wv[i], kv[c], acc[i][gc * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      float* op = dq + (qoff + row) * D;
#pragma unroll
      for (int gc = 0; gc < NG; ++gc)
        *reinterpret_cast<float4*>(&op[gc * 64 + tx * 4]) = make_float4(
            acc[i][gc * 4] * scale, acc[i][gc * 4 + 1] * scale,
            acc[i][gc * 4 + 2] * scale, acc[i][gc * 4 + 3] * scale);
    }
  }
}

// K5 f32.  Thread (ty, tx) owns keys 4*ty..4*ty+3, query rows 2*tx, 2*tx+1
// of the (64 keys x 32 rows) score tile, and dk / dv columns
// {64*gc + 4*tx + c} of its keys.
template <int D>
__global__ void __launch_bounds__(F32_NT) bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq,
    int Sk, int causal, int kv_offset, float qscale, float scale) {
  constexpr int NG = D / 64;
  extern __shared__ float smem_f[];
  float* KsT = smem_f;           // [D][BK]
  float* VsT = KsT + D * BK;     // [D][BK]
  float* QsT = VsT + D * BK;     // [D][BQ5]
  float* dOsT = QsT + D * BQ5;   // [D][BQ5]
  float* Qs = dOsT + D * BQ5;    // [BQ5][D]
  float* dOs = Qs + BQ5 * D;     // [BQ5][D]
  float* Ps = dOs + BQ5 * D;     // [BQ5][BK]
  float* dSs = Ps + BQ5 * BK;    // [BQ5][BK]
  float* Ls = dSs + BQ5 * BK;    // [BQ5]
  float* Ds = Ls + BQ5;          // [BQ5]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t kvoff = (size_t)(b * Hkv + hk) * Sk;

  stage_f32<D>(k + kvoff * D, k0, Sk, BK, KsT, BK, nullptr, tid);
  stage_f32<D>(v + kvoff * D, k0, Sk, BK, VsT, BK, nullptr, tid);

  float dka[4][4 * NG], dva[4][4 * NG];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) dka[j][c] = dva[j][c] = 0.f;

  const int nq = (Sq + BQ5 - 1) / BQ5;
  const int qt0 = causal ? max(k0 - kv_offset, 0) / BQ5 : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (size_t)(b * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ5;
      __syncthreads();
      stage_f32<D>(q + qoff * D, q0, Sq, BQ5, QsT, BQ5, Qs, tid);
      stage_f32<D>(dout + qoff * D, q0, Sq, BQ5, dOsT, BQ5, dOs, tid);
      if (tid < BQ5) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[qoff + row] : NEG_INF;
        const bool live = l > LSE_DEAD;
        Ls[tid] = live ? l * LOG2E : NEG_INF;
        Ds[tid] = live ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&KsT[d * BK + ty * 4]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&VsT[d * BK + ty * 4]);
        const float2 a = *reinterpret_cast<const float2*>(&QsT[d * BQ5 + tx * 2]);
        const float2 o =
            *reinterpret_cast<const float2*>(&dOsT[d * BQ5 + tx * 2]);
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
        const float av[2] = {a.x, a.y};
        const float ov[2] = {o.x, o.y};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[j][i] = fmaf(kv[j], av[i], s[j][i]);
            dp[j][i] = fmaf(vf[j], ov[i], dp[j][i]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = tx * 2 + i;
          const bool live = Ls[c] > NEG_INF;
          const bool ok = live && q0 + c < Sq &&
                          visible(k0 + ty * 4 + j, q0 + c, Sk, causal,
                                  kv_offset);
          const float p = ok ? exp2f(fminf(s[j][i] * qscale - Ls[c], 0.f))
                             : 0.f;
          s[j][i] = p;
          dp[j][i] = live ? p * (dp[j][i] - Ds[c]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float4*>(&Ps[(tx * 2 + i) * BK + ty * 4]) =
            make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
        *reinterpret_cast<float4*>(&dSs[(tx * 2 + i) * BK + ty * 4]) =
            make_float4(dp[0][i], dp[1][i], dp[2][i], dp[3][i]);
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < BQ5; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[i * BK + ty * 4]);
        const float4 s4 =
            *reinterpret_cast<const float4*>(&dSs[i * BK + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int gc = 0; gc < NG; ++gc) {
          const float4 o4 =
              *reinterpret_cast<const float4*>(&dOs[i * D + gc * 64 + tx * 4]);
          const float4 q4 =
              *reinterpret_cast<const float4*>(&Qs[i * D + gc * 64 + tx * 4]);
          const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dva[j][gc * 4 + c] = fmaf(pv[j], ov[c], dva[j][gc * 4 + c]);
              dka[j][gc * 4 + c] = fmaf(sv[j], qv[c], dka[j][gc * 4 + c]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key < Sk) {
      float* kop = dk + (kvoff + key) * D;
      float* vop = dv + (kvoff + key) * D;
#pragma unroll
      for (int gc = 0; gc < NG; ++gc) {
        *reinterpret_cast<float4*>(&kop[gc * 64 + tx * 4]) = make_float4(
            dka[j][gc * 4] * scale, dka[j][gc * 4 + 1] * scale,
            dka[j][gc * 4 + 2] * scale, dka[j][gc * 4 + 3] * scale);
        *reinterpret_cast<float4*>(&vop[gc * 64 + tx * 4]) =
            make_float4(dva[j][gc * 4], dva[j][gc * 4 + 1],
                        dva[j][gc * 4 + 2], dva[j][gc * 4 + 3]);
      }
    }
  }
}

// Raises a kernel's dynamic shared-memory limit once per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

struct Args {
  const void *q, *k, *v, *dout, *lse;
  int B, H, Hkv, Sq, Sk, causal, kv_offset;
  float scale;
};

// Launches of the bf16 bodies (`Dq`, `Dkv`) in this process, which
// `flash_attention_bwd_hopper_launches` reports.
int hopper_launches = 0;

// The SMs of the current device: one persistent block each at most.
int sm_count(int& sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)e;
}

// The four tensor maps of a bf16 body: q and do (D, Sq, B H) with boxes of
// ``qrows`` rows, k and v (D, Sk, B Hkv) with boxes of ``krows``.  A zero
// length is encoded as 1: no item loads from such a map.
template <int D>
int encode_maps(const Args& a, const void* dout, CUtensorMap* tq,
                CUtensorMap* tdo, CUtensorMap* tk, CUtensorMap* tv,
                int qrows, int krows) {
  const uint64_t sq = a.Sq > 0 ? a.Sq : 1, sk = a.Sk > 0 ? a.Sk : 1;
  const uint64_t bh = (uint64_t)a.B * a.H, bhk = (uint64_t)a.B * a.Hkv;
  int rc = wg::encode_3d(tq, a.q, D, sq, bh, 64, qrows);
  if (rc == 0) rc = wg::encode_3d(tdo, dout, D, sq, bh, 64, qrows);
  if (rc == 0) rc = wg::encode_3d(tk, a.k, D, sk, bhk, 64, krows);
  if (rc == 0) rc = wg::encode_3d(tv, a.v, D, sk, bhk, 64, krows);
  return rc;
}

template <int D>
int launch_dq(const Args& a, const void* out, const void* dlse, void* delta,
              void* dq, int dtype, cudaStream_t s) {
  const float qscale = a.scale * LOG2E;
  if (dtype == tdt::DTYPE_BF16) {
    using Body = Dq<D>;
    DqArgs p{};
    int rc = encode_maps<D>(a, a.dout, &p.tq, &p.tdo, &p.tk, &p.tv,
                            Body::QROWS, Body::KROWS);
    if (rc != 0) return rc;
    p.dout = static_cast<const bf16*>(a.dout);
    p.out = static_cast<const bf16*>(out);
    p.lse = static_cast<const float*>(a.lse);
    p.dlse = static_cast<const float*>(dlse);
    p.delta = static_cast<float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    p.bh = a.B * a.H;
    p.H = a.H;
    p.group = a.H / a.Hkv;
    p.Hkv = a.Hkv;
    p.nqt = (a.Sq + Body::QROWS - 1) / Body::QROWS;
    p.sq = a.Sq;
    p.sk = a.Sk;
    p.causal = a.causal;
    p.off = a.kv_offset;
    p.qscale = qscale;
    p.scale = a.scale;
    static bool ready = false;
    cudaError_t e =
        allow_smem(bwd_dq_wgmma_kernel<D>, Body::SMEM_BYTES, ready);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    if ((rc = sm_count(sms)) != 0) return rc;
    const int items = p.nqt * p.bh;
    bwd_dq_wgmma_kernel<D><<<items < sms ? items : sms, HNT,
                             Body::SMEM_BYTES, s>>>(p);
    ++hopper_launches;
  } else {
    static bool ready = false;
    constexpr size_t smem = dq_f32_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dq_f32_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    bwd_dq_f32_kernel<D><<<grid, F32_NT, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(out), static_cast<const float*>(a.lse),
        static_cast<const float*>(dlse), static_cast<float*>(delta),
        static_cast<float*>(dq), a.H, a.Hkv, a.Sq, a.Sk, a.causal,
        a.kv_offset, qscale, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, const void* delta, void* dk, void* dv,
               int dtype, cudaStream_t s) {
  const float qscale = a.scale * LOG2E;
  if (dtype == tdt::DTYPE_BF16) {
    using Body = Dkv<D>;
    DkvArgs p{};
    int rc = encode_maps<D>(a, a.dout, &p.tq, &p.tdo, &p.tk, &p.tv,
                            Body::QROWS, Body::KROWS);
    if (rc != 0) return rc;
    p.lse = static_cast<const float*>(a.lse);
    p.delta = static_cast<const float*>(delta);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.bhk = a.B * a.Hkv;
    p.group = a.H / a.Hkv;
    p.nkt = (a.Sk + Body::KROWS - 1) / Body::KROWS;
    p.nq = (a.Sq + Body::QROWS - 1) / Body::QROWS;
    p.sq = a.Sq;
    p.sk = a.Sk;
    p.causal = a.causal;
    p.off = a.kv_offset;
    p.qscale = qscale;
    p.scale = a.scale;
    static bool ready = false;
    cudaError_t e =
        allow_smem(bwd_dkv_wgmma_kernel<D>, Body::SMEM_BYTES, ready);
    if (e != cudaSuccess) return (int)e;
    int sms = 0;
    if ((rc = sm_count(sms)) != 0) return rc;
    const int items = p.nkt * p.bhk;
    bwd_dkv_wgmma_kernel<D><<<items < sms ? items : sms, HNT,
                              Body::SMEM_BYTES, s>>>(p);
    ++hopper_launches;
  } else {
    static bool ready = false;
    constexpr size_t smem = dkv_f32_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dkv_f32_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sk + BK - 1) / BK, a.Hkv, a.B);
    bwd_dkv_f32_kernel<D><<<grid, F32_NT, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Hkv, a.Sq,
        a.Sk, a.causal, a.kv_offset, qscale, a.scale);
  }
  return (int)cudaGetLastError();
}

bool supported(int dtype, int D) {
  return (dtype == tdt::DTYPE_BF16 || dtype == tdt::DTYPE_F32) &&
         (D == 64 || D == 128);
}

}  // namespace

// K4.  q/dout/out/dq (B,H,Sq,D), k/v (B,Hkv,Sk,D) contiguous, one dtype;
// lse, dlse (may be null) and delta (written: rowsum(dout * out) - dlse)
// (B,H,Sq) f32.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* out, const void* lse,
                                      const void* dlse, void* delta, void* dq,
                                      int dtype, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, int causal,
                                      int kv_offset, float scale,
                                      void* stream) {
  if (!supported(dtype, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a{q, k, v, dout, lse, B, H, Hkv, Sq, Sk, causal, kv_offset,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dq<128>(a, out, dlse, delta, dq, dtype, s)
                  : launch_dq<64>(a, out, dlse, delta, dq, dtype, s);
}

// K5.  The same q, k, v, dout, lse and K4's delta; dk, dv (B,Hkv,Sk,D) in
// the inputs' dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B,
                                       int H, int Hkv, int Sq, int Sk, int D,
                                       int causal, int kv_offset, float scale,
                                       void* stream) {
  if (!supported(dtype, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  const Args a{q, k, v, dout, lse, B, H, Hkv, Sq, Sk, causal, kv_offset,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dkv<128>(a, delta, dk, dv, dtype, s)
                  : launch_dkv<64>(a, delta, dk, dv, dtype, s);
}

// How many times K4 and K5 have launched their bf16 bodies (`Dq`, `Dkv`)
// in this process: the wrapper counts `wgmma_launches` from it, so that the
// rule choosing a body lives here alone.
extern "C" int flash_attention_bwd_hopper_launches() {
  return hopper_launches;
}
