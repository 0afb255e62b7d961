// The flash-attention bodies shared by K1 (`flash_attention.cu`) and K20
// (`sp_ag_attention.cu`): a block owns a tile of query rows of one (batch,
// head) and walks K/V tiles with the online softmax state (m, l, O) in
// registers.  Each body is three steps: `begin` stages the query tile and
// clears the state, `attend` folds the K/V tiles of one key range into it
// (again on further ranges: the state carries over, so K20 folds one ring
// chunk after another into it), and `finish` normalises and stores out and
// lse.
//
// Replaces the online-softmax block of triton_distributed_tpu/kernels/
// flash_attention.py `_flash_kernel` (:150-230) and its in-kernel form
// sp_ag_attention.py `_emit_flash_chunk` (:181).  The math, for both:
// - scores are scaled by scale*log2(e) into the exp2 domain as the TPU
//   kernel does (:170-179); m is in log2 units and l a natural-domain sum,
//   so lse = m*ln2 + log(l) (natural log at the API);
// - causal: query row i sees keys <= i + kv_offset; an `attend` call visits
//   only the K/V tiles up to the tile's last row's limit (`kv_tiles`), so
//   tiles above the diagonal are never read;
// - keys past Sk and query rows past Sq are loaded as zeros; scores past Sk
//   are masked (NEG_INF, finite as on the TPU), only on the tiles that
//   cross Sk or the causal limit; rows past Sq are not stored;
// - a row that saw no key ends with lse ~ -inf and an unspecified out.  A
//   fully masked tile row adds exp2(0) weights while m is still NEG_INF;
//   the first real key resets them (alpha = exp2(NEG_INF - m) = 0), so a
//   row that sees any key in any range is exact.  A tile past a row's
//   causal limit adds exact zeros to it, so a row's bits depend on its own
//   q, K, V and offsets only, not on the other rows, heads or batches.
//
// bf16 body (`Hopper<D>`, FlashAttention-3's shape on this card): 384
// threads, persistent over tiles of WBQ = 128 query rows.  Warpgroup 2
// produces: one thread issues the TMA loads (a tile's Q once, into one of
// two Q buffers, then K and V stages of WBK = 128 keys into a ring of
// WSTAGES with 128-byte swizzle; a "full" mbarrier each for K and V and an
// "empty" one a stage and a Q buffer), its other three warps are the
// caller's side work (K20's ring crew); `setmaxnreg` gives its registers
// to the consumers (40 and 232).  Consumer warpgroups 0 and 1 own 64 rows
// each: S = Q K^T by `wgmma` m64n128k16 from shared memory (both K-major),
// the softmax on the accumulator fragment, P rounded to bf16 and fed back
// as the register A operand of O += P V (`wgmma` m64nDk16, V MN-major with
// the transpose bit).  The schedule, after FlashAttention-3: a stage's
// P V is issued back to back with the next stage's Q K^T, and the two
// warpgroups take turns at the tensor cores (named barriers 4 and 5), so
// one's softmax runs under the other's products.  (Running the next
// stage's softmax under this stage's P V in one warpgroup, FA3's other
// overlap, took K1 over 32,768 tokens from 18.9 to 31.2 ms on an H100 and
// was dropped.)
// The epilogue stages out through the warpgroup's rows of its Q buffer for
// 16-byte stores.  Maps are 3-D (D,
// S, planes), so a box past a head's S reads zeros, never the next head's
// rows, and no length needs padding.  The kernels hold no function call
// (ptxas would serialize their `wgmma`s, info C7510): the division is
// div.approx, the waits' timeout path stores and traps.
//
// f32 body: 256 threads, tiles of BQ = 64 rows and BK = 64 keys; thread
// (ty, tx) owns query rows 4*ty..4*ty+3, score columns 4*tx..4*tx+3 and
// output columns {64*g + 4*tx + c}, all products as f32 FMAs from
// transposed shared-memory tiles.
#pragma once

#include "common.cuh"
#include "mbarrier.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // f32: query rows per tile
constexpr int BK = 64;  // f32: keys per K/V tile

// The natural-log lse of a row, m * ln2 + log(l), rounded after the
// product and after the sum: spelled out with intrinsics, which the
// compiler never contracts into an FMA, so every kernel that inlines the
// bodies rounds it alike.
__device__ __forceinline__ float lse_of(float m, float l) {
  return __fadd_rn(__fmul_rn(m, LN2), logf(l));
}

// ---- bf16: the Hopper body (`wgmma` + TMA, warp-specialised) -------------

namespace wg = tdt::wgmma;

constexpr int WBQ = 128;         // query rows of a tile: 64 a warpgroup
constexpr int WBK = 128;         // keys of a K/V stage
constexpr int WSTAGES = 2;       // K/V stages of the ring
constexpr int WNT = 3 * wg::WG;  // consumer warpgroups 0, 1; the producer 2
constexpr int BOX_BYTES = 128 * wg::ROW_BYTES;  // a box: 128 rows of 64 bf16
//: Named barriers 2 and 3: a consumer warpgroup's epilogue (1 is a crew's);
//: 4 and 5: the consumer warpgroups' turns at the tensor cores.
constexpr int OUT_BARRIER = 2, SCHED_BARRIER = 4;
//: Q buffers: with two, a persistent block loads the next tile's Q while
//: its consumers finish this one.
constexpr int QBUFS = 2;

// d (64 x 128 f32) = a (64 x 16, K-major) @ b (16 x 128, K-major: the
// key-major K tile, no transpose) + (d if accumulate).
__device__ __forceinline__ void mma_ss_m64n128k16(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32) = a (64 x 16 bf16, four registers a thread: the
// m16n8k16 A fragment of the thread's warp) @ b (16 x 128, MN-major: V, the
// transpose bit set) + (d if accumulate).
__device__ __forceinline__ void mma_rs_m64n128k16(float (&d)[64],
                                                const unsigned (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d (64 x 64 f32) = a (64 x 16 bf16, four registers a thread: the
// m16n8k16 A fragment of the thread's warp) @ b (16 x 64, MN-major: V, the
// transpose bit set) + (d if accumulate).
__device__ __forceinline__ void mma_rs_m64n64k16(float (&d)[32],
                                                const unsigned (&a)[4],
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// Where a query tile lies: its plane in the q map (and in out, lse), its
// (batch, head) index in the caller's rank, and its first row.
struct QTile {
  int plane, bh, q0;
};

// A key range a tile folds in: its K and V maps and their plane, its
// ``n_kt`` stages of WBK keys (`kv_tiles`), Sk, the causal shift (query row
// i sees keys <= i + off when causal), and the ring chunk the producer must
// wait for before its first load (-1: none).
struct Keys {
  const CUtensorMap* tk;
  const CUtensorMap* tv;
  int plane, n_kt, sk, causal, off, chunk;
};

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Keeps registers that an asynchronous product reads live until its wait.
template <int N>
__device__ __forceinline__ void keep(const unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" ::"r"(a[i][0]), "r"(a[i][1]), "r"(a[i][2]), "r"(a[i][3])
                 : "memory");
}

template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const unsigned (&a)[4], uint64_t db);
template <>
__device__ __forceinline__ void mma_pv<128>(float (&o)[64],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  mma_rs_m64n128k16(o, a, db, 1);
}
template <>
__device__ __forceinline__ void mma_pv<64>(float (&o)[32],
                                           const unsigned (&a)[4],
                                           uint64_t db) {
  mma_rs_m64n64k16(o, a, db, 1);
}

// The body for head dim D (64 or 128), one block of WNT threads:
// - shared memory (1024-aligned): QBUFS Q tiles (D / 64 boxes of 128 rows
//   x 128 bytes, 128-byte swizzle), then WSTAGES stages of a K tile and a
//   V tile (the same boxes, WBK keys), then the barriers: q_full[b],
//   q_empty[b], k_full[s], v_full[s], empty[s];
// - the producer thread (warpgroup 2, thread 0) loads a tile's Q once,
//   then its K/V stages in order, running ahead by the free stages and Q
//   buffers;
// - consumer warpgroup w owns rows [64 w, 64 w + 64) of each tile:
//   `begin`, `attend` per key range, `finish`.
template <int D>
struct Hopper {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int BOXES = D / 64;
  static constexpr int Q_BYTES = BOXES * BOX_BYTES;
  static constexpr int KV_BYTES = BOXES * BOX_BYTES;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K, then V
  static constexpr int BARS = QBUFS * Q_BYTES + WSTAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES =
      BARS + (2 * QBUFS + 3 * WSTAGES) * 8 + wg::ATOM_BYTES;
  static constexpr int NO = D / 2;    // O accumulators a thread (m64nD)
  static constexpr int NS = WBK / 2;  // score accumulators (m64n128)
  static constexpr int KSTEPS = WBK / 16;  // k16 steps of P V

  struct Smem {
    uint8_t* q;  // buffer b at q + b Q_BYTES
    uint8_t* ring;
    uint64_t* q_full;  // [QBUFS]
    uint64_t* q_empty;
    uint64_t* k_full;
    uint64_t* v_full;
    uint64_t* empty;
  };

  // A consumer thread's state: its two rows' (m, l) and O, and its place
  // in the ring.
  struct State {
    float o[NO];
    float m[2], l[2];
    int s, qb, qcur;  // the next stage, the next Q buffer, this tile's
    unsigned phase, q_phase;
  };

  // The producer's place in the ring.
  struct Feed {
    int s, qb;
    unsigned phase, q_phase;
  };

  static __device__ __forceinline__ Smem carve(uint8_t* raw) {
    uint8_t* base = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + wg::ATOM_BYTES - 1) &
        ~uintptr_t(wg::ATOM_BYTES - 1));
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + BARS);
    uint64_t* kv = bars + 2 * QBUFS;
    return {base, base + QBUFS * Q_BYTES, bars, bars + QBUFS, kv,
            kv + WSTAGES, kv + 2 * WSTAGES};
  }

  // ---- the producer thread

  static __device__ __forceinline__ void load_q(const Smem& sm,
                                                const CUtensorMap* tq,
                                                const QTile& t, Feed& f) {
    mbar_wait(&sm.q_empty[f.qb], f.q_phase ^ 1);
    mbar_expect_tx(&sm.q_full[f.qb], Q_BYTES);
#pragma unroll
    for (int j = 0; j < BOXES; ++j)
      wg::tma_load_3d(sm.q + f.qb * Q_BYTES + j * BOX_BYTES, tq,
                      &sm.q_full[f.qb], 64 * j, t.q0, t.plane);
    if (++f.qb == QBUFS) {
      f.qb = 0;
      f.q_phase ^= 1;
    }
  }

  static __device__ __forceinline__ void load_keys(const Smem& sm,
                                                   const Keys& k, Feed& f) {
    for (int kt = 0; kt < k.n_kt; ++kt) {
      mbar_wait(&sm.empty[f.s], f.phase ^ 1);
      uint8_t* st = sm.ring + f.s * STAGE_BYTES;
      mbar_expect_tx(&sm.k_full[f.s], KV_BYTES);
#pragma unroll
      for (int j = 0; j < BOXES; ++j)
        wg::tma_load_3d(st + j * BOX_BYTES, k.tk, &sm.k_full[f.s], 64 * j,
                        kt * WBK, k.plane);
      mbar_expect_tx(&sm.v_full[f.s], KV_BYTES);
#pragma unroll
      for (int j = 0; j < BOXES; ++j)
        wg::tma_load_3d(st + KV_BYTES + j * BOX_BYTES, k.tv,
                        &sm.v_full[f.s], 64 * j, kt * WBK, k.plane);
      if (++f.s == WSTAGES) {
        f.s = 0;
        f.phase ^= 1;
      }
    }
  }

  // ---- a consumer warpgroup

  // Wait for the tile's Q and clear the state.
  static __device__ __forceinline__ void begin(const Smem& sm, State& st) {
    mbar_wait(&sm.q_full[st.qb], st.q_phase);
    st.qcur = st.qb;
    if (++st.qb == QBUFS) {
      st.qb = 0;
      st.q_phase ^= 1;
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) st.o[i] = 0.f;
    st.m[0] = st.m[1] = NEG_INF;
    st.l[0] = st.l[1] = 0.f;
  }

  // The scheduler of the two consumer warpgroups' products (FA3's ping-pong):
  // warpgroup w issues its products only after the other one has issued
  // its last batch, so one warpgroup's softmax runs under the other's
  // products.  Both fold the same stages, so their batches pair up.
  static __device__ __forceinline__ void turn_wait(int w) {
    named_sync(SCHED_BARRIER + w, 2 * wg::WG);
  }
  static __device__ __forceinline__ void turn_pass(int w) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(SCHED_BARRIER + 1 - w),
                 "r"(2 * wg::WG)
                 : "memory");
  }

  // S = Q K^T for the stage at ``st`` (64 rows x 128 keys, both K-major in
  // shared memory), issued and committed; the caller waits.
  static __device__ __forceinline__ void issue_s(const Smem& sm, int qcur,
                                                 int st, unsigned phase,
                                                 float (&sc)[NS]) {
    const int w = threadIdx.x / wg::WG;
    const uint8_t* qs =
        sm.q + qcur * Q_BYTES + w * wg::WG_ROWS * wg::ROW_BYTES;
    const uint8_t* ks = sm.ring + st * STAGE_BYTES;
    mbar_wait(&sm.k_full[st], phase);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      mma_ss_m64n128k16(
          sc,
          wg::desc(qs + kk / 4 * BOX_BYTES + kk % 4 * 32, 16, wg::ATOM_BYTES),
          wg::desc(ks + kk / 4 * BOX_BYTES + kk % 4 * 32, 16, wg::ATOM_BYTES),
          kk > 0);
    wg::mma_commit();
  }

  // Fold the k.n_kt stages of the key range into the state of the
  // warpgroup's rows, whose first is ``q0w``.  ``qscale`` is scale *
  // log2(e).  Stage j's P V product is issued together with stage j + 1's
  // Q K^T, so the two run back to back; a stage goes back
  // to the producer once its P V product has retired.
  static __device__ __forceinline__ void attend(const Smem& sm, const Keys& k,
                                                int q0w, float qscale,
                                                State& st) {
    const int w = threadIdx.x / wg::WG, tid = threadIdx.x % wg::WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;  // fragment row / column pair
    const int row0 = q0w + warp * 16 + g;   // this thread's rows: +0, +8
    float sc[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    turn_wait(w);
    wg::fence_acc(sc);
    wg::mma_fence();
    issue_s(sm, st.qcur, st.s, st.phase, sc);
    turn_pass(w);
    wg::mma_wait<0>();
    wg::fence_acc(sc);
    for (int kt = 0; kt < k.n_kt; ++kt) {
      const int k0 = kt * WBK;
      const int cur = st.s;
      const unsigned cur_phase = st.phase;
      if (++st.s == WSTAGES) {
        st.s = 0;
        st.phase ^= 1;
      }

      // Scale into log2 units; mask only where the stage crosses Sk or the
      // causal limit of the warpgroup's first row.
      const bool edge =
          k0 + WBK > k.sk || (k.causal && k0 + WBK - 1 > q0w + k.off);
#pragma unroll
      for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * qscale;
          if (edge) {
            const int key = k0 + j * 8 + tg * 2 + (e & 1);
            const int row = row0 + (e >> 1) * 8;
            if (key >= k.sk || (k.causal && key > row + k.off)) x = NEG_INF;
          }
          sc[4 * j + e] = x;
        }

      // Online softmax.  A row's 128 scores are spread over the 4 lanes of
      // a quad; the max is reduced across them, the sum stays a per-lane
      // partial until `finish`.
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < WBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(st.m[r], mx);
        const float alpha = exp2f(st.m[r] - m_new);
        st.m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < WBK / 8; ++j)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            sc[4 * j + e] = exp2f(sc[4 * j + e] - m_new);
            rs += sc[4 * j + e];
          }
        st.l[r] = st.l[r] * alpha + rs;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          st.o[4 * n + 2 * r] *= alpha;
          st.o[4 * n + 2 * r + 1] *= alpha;
        }
      }

      // P in bf16 as the A operand from registers: the accumulators of two
      // 8-key column tiles are the m16n8k16 A fragment of a 16-key step.
      unsigned pa[KSTEPS][4];
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        pa[t][0] = pack_bf16(sc[8 * t], sc[8 * t + 1]);
        pa[t][1] = pack_bf16(sc[8 * t + 2], sc[8 * t + 3]);
        pa[t][2] = pack_bf16(sc[8 * t + 4], sc[8 * t + 5]);
        pa[t][3] = pack_bf16(sc[8 * t + 6], sc[8 * t + 7]);
      }

      // O += P V: V (keys, D) is MN-major; the next 64-column box is the
      // leading offset, 8 key rows the stride offset.  Then the next
      // stage's Q K^T into the score registers P no longer needs.
      const uint8_t* vs = sm.ring + cur * STAGE_BYTES + KV_BYTES;
      turn_wait(w);
      mbar_wait(&sm.v_full[cur], cur_phase);
      wg::fence_acc(st.o);
      wg::fence_acc(sc);
      wg::mma_fence();
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t)
        mma_pv<D>(st.o, pa[t],
                  wg::desc(vs + t * 16 * wg::ROW_BYTES, BOX_BYTES,
                           wg::ATOM_BYTES));
      wg::mma_commit();
      if (kt + 1 < k.n_kt)
        issue_s(sm, st.qcur, st.s, st.phase, sc);
      turn_pass(w);
      wg::mma_wait<0>();
      wg::fence_acc(st.o);
      wg::fence_acc(sc);
      keep(pa);
      mbar_arrive(&sm.empty[cur]);
    }
  }

  // Normalise, stage the warpgroup's rows of out in its rows of the Q
  // buffer (its last product that read them has retired), store rows
  // [q0, q0 + WBQ) below Sq of ``out`` (Sq rows of D) and of the
  // natural-log ``lse``, 16 bytes a thread, then give the Q buffer back.
  static __device__ __forceinline__ void finish(const Smem& sm, bf16* out,
                                                float* lse, int q0, int sq,
                                                State& st) {
    const int w = threadIdx.x / wg::WG, tid = threadIdx.x % wg::WG;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tg = lane % 4;
    const int lr0 = w * wg::WG_ROWS + warp * 16 + g;  // local rows +0, +8
    uint8_t* qs = sm.q + st.qcur * Q_BYTES;
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
      st.l[r] = fmaxf(st.l[r], 1e-30f);
      inv[r] = __fdividef(1.f, st.l[r]);  // div.approx: no call
      const int row = q0 + lr0 + r * 8;
      if (tg == 0 && row < sq) lse[row] = lse_of(st.m[r], st.l[r]);
    }
    // 128-byte swizzle: 16-byte chunk c of row r lies at chunk c ^ (r % 8).
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int lr = lr0 + r * 8;
        *reinterpret_cast<unsigned*>(qs + n / 8 * BOX_BYTES +
                                     lr * wg::ROW_BYTES +
                                     ((n % 8 ^ lr % 8) << 4) + tg * 4) =
            pack_bf16(st.o[4 * n + 2 * r] * inv[r],
                      st.o[4 * n + 2 * r + 1] * inv[r]);
      }
    named_sync(OUT_BARRIER + w, wg::WG);
    constexpr int CH = D / 8;  // 16-byte chunks a row
    for (int c = tid; c < wg::WG_ROWS * CH; c += wg::WG) {
      const int lr = w * wg::WG_ROWS + c / CH, n = c % CH;
      const int row = q0 + lr;
      if (row < sq)
        *reinterpret_cast<uint4*>(out + (size_t)row * D + n * 8) =
            *reinterpret_cast<const uint4*>(qs + n / 8 * BOX_BYTES +
                                            lr * wg::ROW_BYTES +
                                            ((n % 8 ^ lr % 8) << 4));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_arrive(&sm.q_empty[st.qcur]);
  }

  // The block's item in round r of a snake over the grid: rounds run
  // forwards and backwards in turn, so with the items heaviest first every
  // block's sum of work is about even.
  static __device__ __forceinline__ int item_of(int r) {
    const int p = gridDim.x, b = blockIdx.x;
    return r * p + (r & 1 ? p - 1 - b : b);
  }

  // The block: item `item_of(r)` of ``sched.items()`` for r = 0, 1, ...
  // The schedule gives:
  // - ``tq()``: the q map, (D, Sq, planes) with box (64, WBQ, 1);
  // - ``tile(it)``: item it's QTile; ``ranges()``: key ranges an item;
  //   ``keys(tile, r)``: range r's Keys (the same for producer and
  //   consumers); the ranges are folded in order;
  // - ``ready(c)``: the producer thread, before the first load of a range
  //   whose ``chunk`` is c >= 0;
  // - ``side(i)``: thread i of the producer warpgroup's other 96, once;
  // - ``out(tile)``, ``lse(tile)``: the tile's plane of out (Sq rows of D)
  //   and of lse; ``sq()``, ``qscale()``.
  template <class Sched>
  static __device__ __forceinline__ void run(uint8_t* raw, Sched& sched) {
    const Smem sm = carve(raw);
    if (threadIdx.x == 0) {
      for (int b = 0; b < QBUFS; ++b) {
        mbar_init(&sm.q_full[b], 1);
        mbar_init(&sm.q_empty[b], 2 * wg::WG);
      }
      for (int s = 0; s < WSTAGES; ++s) {
        mbar_init(&sm.k_full[s], 1);
        mbar_init(&sm.v_full[s], 1);
        mbar_init(&sm.empty[s], 2 * wg::WG);
      }
      mbar_init_fence();
    }
    __syncthreads();
    const int w = threadIdx.x / wg::WG;
    const int items = sched.items();
    if (w == 2) {
      wg::regs_dec<wg::PRODUCER_REGS>();
      if (threadIdx.x == 2 * wg::WG) {
        Feed f{0, 0, 0, 0};
        for (int r = 0; r * (int)gridDim.x < items; ++r) {
          const int it = item_of(r);
          if (it >= items) continue;
          const QTile t = sched.tile(it);
          load_q(sm, sched.tq(), t, f);
          for (int r = 0; r < sched.ranges(); ++r) {
            const Keys k = sched.keys(t, r);
            if (k.n_kt == 0) continue;  // the tile's causal future
            if (k.chunk >= 0) sched.ready(k.chunk);
            load_keys(sm, k, f);
          }
        }
      } else if (threadIdx.x >= 2 * wg::WG + 32) {
        sched.side(threadIdx.x - (2 * wg::WG + 32));
      }
    } else {
      wg::regs_inc<wg::CONSUMER_REGS>();
      if (w == 1)
        asm volatile("bar.arrive %0, %1;\n" ::"r"(SCHED_BARRIER),
                     "r"(2 * wg::WG)
                     : "memory");  // warpgroup 0 takes the first turn
      State st;
      st.s = st.qb = st.qcur = 0;
      st.phase = st.q_phase = 0;
      for (int r = 0; r * (int)gridDim.x < items; ++r) {
        const int it = item_of(r);
        if (it >= items) continue;
        const QTile t = sched.tile(it);
        begin(sm, st);
        for (int r = 0; r < sched.ranges(); ++r) {
          const Keys k = sched.keys(t, r);
          if (k.n_kt == 0) continue;
          attend(sm, k, t.q0 + w * wg::WG_ROWS, sched.qscale(), st);
        }
        finish(sm, sched.out(t), sched.lse(t), t.q0, sched.sq(), st);
      }
    }
  }
};

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs [D][BQ] + Ks [D][BK] + Vs [BK][D] + Ps [BK][BQ], all f32
  return sizeof(float) * (size_t)(D * BQ + D * BK + BK * D + BK * BQ);
}

// Eight floats read through L2 (ld.global.cg; 16-byte aligned).
__device__ __forceinline__ void load8_l2(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <int D>
struct F32State {
  static constexpr int NG = D / 64;  // 64-wide output column groups
  float m[4], l[4], acc[4][4 * NG];
};

// Stage Q transposed and pre-scaled into the exp2 domain (``qscale`` =
// scale * log2(e)), and clear the state.  Qs must be free.
template <int D>
__device__ __forceinline__ void f32_begin(float* smem, const float* qp,
                                          int q0, int Sq, float qscale,
                                          F32State<D>& st) {
  constexpr int CH = D / 8;  // 8-element chunks per row
  float* Qs = smem;          // [D][BQ]
  const int tid = threadIdx.x;
  for (int c = tid; c < BQ * CH; c += F32_NT) {
    const int r = c % BQ, dc = c / BQ;
    float f[8];
    if (q0 + r < Sq) {
      load8(qp + (size_t)(q0 + r) * D + dc * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[(dc * 8 + i) * BQ + r] = f[i] * qscale;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = NEG_INF;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * F32State<D>::NG; ++c) st.acc[i][c] = 0.f;
  }
}

// Fold the first n_kt K/V tiles of kp, vp (Sk keys) into the state, as
// the bf16 body's `attend`.  K and V are read through L2 (ld.global.cg).
template <int D>
__device__ __forceinline__ void f32_attend(float* smem, const float* kp,
                                           const float* vp, int q0, int Sk,
                                           int n_kt, int causal,
                                           int kv_offset, F32State<D>& st) {
  constexpr int CH = D / 8;
  constexpr int NG = F32State<D>::NG;
  float* Qs = smem;         // [D][BQ]
  float* Ks = Qs + D * BQ;  // [D][BK]
  float* Vs = Ks + D * BK;  // [BK][D]
  float* Ps = Vs + BK * D;  // [BK][BQ]
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged / previous tile's readers are done
    // K transposed: consecutive threads take consecutive keys, so the
    // scalar shared-memory stores fall in distinct banks.
    for (int c = tid; c < BK * CH; c += F32_NT) {
      const int r = c % BK, dc = c / BK;
      float f[8];
      if (k0 + r < Sk) {
        load8_l2(kp + (size_t)(k0 + r) * D + dc * 8, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) Ks[(dc * 8 + i) * BK + r] = f[i];
    }
    // V row-major: consecutive threads take consecutive chunks of a row.
    for (int c = tid; c < BK * CH; c += F32_NT) {
      const int r = c / CH, dc = c % CH;
      float f[8];
      if (k0 + r < Sk) {
        load8_l2(vp + (size_t)(k0 + r) * D + dc * 8, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&Vs[r * D + dc * 8]);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 piece (log2 units).
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Ks[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Masks: keys past Sk, and the causal limit.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        const bool ok = kc < Sk && (!causal || kc <= qr + kv_offset);
        if (!ok) s[i][j] = NEG_INF;
      }
    }

    // Online softmax.  The 16 threads sharing a row are 16 consecutive
    // lanes of one warp; the row max is reduced across them, the row sum
    // stays a per-thread partial until `f32_finish`.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(st.m[i], mx);
      const float alpha = exp2f(st.m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      st.l[i] = st.l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) st.acc[i][c] *= alpha;
      st.m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * BQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * BQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * D + g * 64 + tx * 4]);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            st.acc[i][g * 4 + c] = fmaf(pv[i], vf[c], st.acc[i][g * 4 + c]);
      }
    }
  }
}

// Finish the row sums, normalise, write rows [q0, q0 + BQ) of op and lsep.
template <int D>
__device__ __forceinline__ void f32_finish(float* op, float* lsep, int q0,
                                           int Sq, F32State<D>& st) {
  constexpr int NG = F32State<D>::NG;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = st.l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      const float inv = 1.f / lt;
      float* o = op + (size_t)row * D;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[g * 64 + tx * 4 + c] = st.acc[i][g * 4 + c] * inv;
      if (tx == 0) lsep[row] = lse_of(st.m[i], lt);
    }
  }
}

}  // namespace flash
}  // namespace tdt
