// The Hopper GEMM tile: out (M, N) = a (M, K) @ b (K, N) per group, bf16
// operands, f32 accumulation, written in bf16 or f32, by TMA loads into a
// shared ring and `wgmma` products from it.  The body of the grouped GEMM
// (K8 and its one-group case K6, grouped_matmul.cu) and of the
// AllGather-GEMM (K12, ag_gemm.cu) for operands on 16-byte rows.
//
// Roles (one block of 128 (C + 1) threads, `Tile<C, STAGES, TN>`):
// - Warpgroups 0 .. C - 1 consume: each owns 64 rows of the tile and issues
//   `wgmma.mma_async m64nTNk16` (TN = 256, or 64 for a narrow tile) from
//   the ring (a K-major, b MN-major), f32 accumulators in registers (TN / 2
//   a thread), then hands them to the caller's epilogue.
// - Warpgroup C produces: one thread keeps the TMA loads of the next
//   stages in flight; its other three warps run the caller's side work (a
//   collective's copies and signals), which never waits on the ring.
//   `setmaxnreg` gives the producer's registers to the consumers (40 and
//   232 a thread).
// - The ring: STAGES stages of k = 64 (one 128-byte row of bf16, the swizzle
//   span), each the a tile (BM x 64, one box) and the b tile (64 x TN,
//   TN / 64 boxes of 64 columns), loaded with 128-byte swizzle; a "full"
//   mbarrier (the producer's expected bytes) and an "empty" one (every
//   consumer thread) per stage.  A consumer keeps one stage of products in
//   flight and frees a stage once its products are done.
// - The block is persistent: it walks tiles blockIdx.x, + gridDim.x, ...
//   and the producer loads the next tile's stages while the consumers
//   write this one.
//
// A caller describes its tiles by a schedule (`at`, `pending`, `ready`,
// `side`, `store`): tile t's a map and box, its b box, its k stages, a
// wait the producer makes before the tile's first a load (a
// collective's arrival signal; the first stages' b loads go out before
// it), and the epilogue.  Groups do not leak: a is a 3-D tensor
// map (k, m, group) and b (n, k, group), so a box that runs past a group's
// M, N or K reads zeros, never the next group's rows.  Rows past M and
// columns past N are not written.
//
// The tile promise: every tile shape runs its instruction over k in the
// same order (stages of 64, four k16 steps each), and an element's
// products depend neither on the other rows nor on the other columns of
// the instruction (m64n64k16 and m64n256k16 give the same bits on the
// H100), so an output element does not depend on the tile that computed
// it.
#pragma once

#include <cuda.h>

#include "gemm_tile.cuh"
#include "mbarrier.cuh"

namespace tdt {
namespace wgmma {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;         // k per ring stage: 128 bytes of bf16
constexpr int BN = 256;        // n per tile: one m64n256k16 product
constexpr int WG = 128;        // threads of a warpgroup
constexpr int WG_ROWS = 64;    // rows of a consumer warpgroup
constexpr int BOX_N = 64;      // n per TMA box of b: 128 bytes
constexpr int ROW_BYTES = 128;     // a swizzled row
constexpr int ATOM_BYTES = 1024;   // the swizzle atom: 8 rows of 128 bytes
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

// ---- TMA -----------------------------------------------------------------

// The box of ``map`` at coordinates (c0, c1, c2), innermost first, into
// shared ``dst``; completes bytes on ``bar``.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- wgmma ---------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled tile at ``p``
// (1024-byte aligned, or a k16 step inside a swizzled row of such a tile):
// start address, leading and stride byte offsets, all in 16-byte units.
// K-major (a): the stride offset steps 8 rows, the leading one is unused.
// MN-major (b): the leading offset steps 64 columns (the next box), the
// stride offset 8 k rows.
__device__ __forceinline__ uint64_t desc(const void* p, unsigned lbo,
                                         unsigned sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t)(lbo >> 4) << 16 | (uint64_t)(sbo >> 4) << 32 |
         1ull << 62;
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across an asynchronous product.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// d (64 x 256 f32) = a (64 x 16, K-major) @ b (16 x 256, MN-major) + (d if
// accumulate).
__device__ __forceinline__ void mma_m64n256k16(float (&d)[128], uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) = a (64 x 16, K-major) @ b (16 x 64, MN-major) + (d if
// accumulate): the narrow tile's product (K12's decode `ll`, whose 256-wide
// tiles are too few for a rank's blocks).
__device__ __forceinline__ void mma_m64n64k16(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n256k16(d, da, db, accumulate);
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n64k16(d, da, db, accumulate);
}

// ---- the tile ------------------------------------------------------------

// Where tile t lies: its a map and box (first row, group), its b box
// (first column, group) and its nk stages of 64.
struct At {
  const CUtensorMap* ta;
  int a_row, a_grp;
  int col, b_grp;
  int nk;
};

// The R accumulators of consumer warpgroup ``wg`` for a tile at (row0,
// col0), 2 R columns wide, into the row-major (M, N) matrix ``o``; rows
// past M and columns past N are dropped.  Fragment of m64nNk16: row 16
// warp + lane / 4 (and + 8), columns 8 j + 2 (lane % 4) (and + 1).  N is a
// multiple of 8.
template <typename TO, int R>
__device__ __forceinline__ void store_tile(TO* o, int M, int N, int row0,
                                           int col0, int wg,
                                           const float (&acc)[R]) {
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int r = row0 + wg * WG_ROWS + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = col0 + j * 8 + (lane % 4) * 2;
    if (c < N) {
      if (r < M)
        gemm::store2(o + (size_t)r * N + c, acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < M)
        gemm::store2(o + (size_t)(r + 8) * N + c, acc[4 * j + 2],
                     acc[4 * j + 3]);
    }
  }
}

template <int C, int STAGES, int TN_ = BN>
struct Tile {
  static constexpr int TN = TN_;  // columns of a tile
  static constexpr int BM = C * WG_ROWS;
  static constexpr int NT = (C + 1) * WG;  // consumers, then the producer
  static constexpr int A_BYTES = BM * BK * 2, B_BYTES = BK * TN * 2;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = TN / 2;  // accumulators a consumer thread
  // The ring, its barriers, and slack to align the ring to the swizzle atom.
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 2 * STAGES * 8 + ATOM_BYTES;
  static_assert(A_BYTES % ATOM_BYTES == 0, "stage alignment");
  static_assert(TN == 256 || TN == 64, "a m64n256k16 or m64n64k16 tile");

  // Stage ``kt``'s b tile of tile ``w`` (TN / 64 boxes) into stage ``st``.
  static __device__ __forceinline__ void load_b(uint8_t* st,
                                                const CUtensorMap* tb,
                                                uint64_t* bar, const At& w,
                                                int kt) {
#pragma unroll
    for (int j = 0; j < TN / BOX_N; ++j)
      tma_load_3d(st + A_BYTES + j * BK * ROW_BYTES, tb, bar,
                  w.col + j * BOX_N, kt * BK, w.b_grp);
  }

  // Tiles blockIdx.x, + gridDim.x, ... of ``ntiles``, as ``sched`` says:
  // - ``At sched.at(t)``: tile t's a map and boxes and k stages (a map:
  //   (k, m, group) with box (64, BM, 1); tb: b as (n, k, group) with box
  //   (64, 64, 1); both bf16 with 128-byte swizzle);
  // - ``sched.pending(t)``: whether tile t's a must wait; then
  //   ``sched.ready(t)`` (the producer thread) waits, after the b tiles of
  //   the tile's first stages are in flight and before any a load;
  // - ``sched.side(i)``: thread i of the producer's other 96 threads, once;
  // - ``sched.store(t, at, wg, acc)``: every consumer thread, the tile's
  //   accumulators of its warpgroup ``wg``.
  template <class Sched>
  static __device__ __forceinline__ void run(uint8_t* raw,
                                             const CUtensorMap* tb,
                                             int ntiles, Sched sched) {
    uint8_t* ring = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + ATOM_BYTES - 1) &
        ~uintptr_t(ATOM_BYTES - 1));
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
    uint64_t* empty = full + STAGES;
    if (threadIdx.x == 0) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], C * WG);
      }
      mbar_init_fence();
    }
    __syncthreads();
    const int wg = threadIdx.x / WG;

    if (wg == C) {
      // The producer: the loads of every stage of every tile, in order.
      regs_dec<PRODUCER_REGS>();
      if (threadIdx.x == C * WG) {
        tma_prefetch(sched.at(blockIdx.x).ta);
        tma_prefetch(tb);
        int s = 0;
        unsigned phase = 0;
        for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
          const At w = sched.at(t);
          int kt = 0;
          if (sched.pending(t)) {
            // b waits on nothing: the first stages' b boxes go out before
            // the tile's wait, their a boxes after it.
            const int pre = STAGES < w.nk ? STAGES : w.nk;
            const int s0 = s;
            for (int i = 0; i < pre; ++i) {
              mbar_wait(&empty[s], phase ^ 1);
              mbar_expect_tx(&full[s], STAGE_BYTES);
              load_b(ring + s * STAGE_BYTES, tb, &full[s], w, kt + i);
              if (++s == STAGES) {
                s = 0;
                phase ^= 1;
              }
            }
            sched.ready(t);
            for (int i = 0; i < pre; ++i) {
              const int si = (s0 + i) % STAGES;
              tma_load_3d(ring + si * STAGE_BYTES, w.ta, &full[si],
                          (kt + i) * BK, w.a_row, w.a_grp);
            }
            kt += pre;
          }
          for (; kt < w.nk; ++kt) {
            mbar_wait(&empty[s], phase ^ 1);
            mbar_expect_tx(&full[s], STAGE_BYTES);
            uint8_t* st = ring + s * STAGE_BYTES;
            tma_load_3d(st, w.ta, &full[s], kt * BK, w.a_row, w.a_grp);
            load_b(st, tb, &full[s], w, kt);
            if (++s == STAGES) {
              s = 0;
              phase ^= 1;
            }
          }
        }
      } else if (threadIdx.x >= C * WG + 32) {
        sched.side(threadIdx.x - (C * WG + 32));
      }
    } else {
      // A consumer: rows [64 wg, 64 wg + 64) of each tile.
      regs_inc<CONSUMER_REGS>();
      float acc[ACC] = {};
      int s = 0, prev = 0;
      unsigned phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const At w = sched.at(t);
        for (int kt = 0; kt < w.nk; ++kt) {
          mbar_wait(&full[s], phase);
          const uint8_t* st = ring + s * STAGE_BYTES;
          fence_acc(acc);
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk)
            mma(acc,
                desc(st + wg * WG_ROWS * ROW_BYTES + kk * 32, 16, ATOM_BYTES),
                desc(st + A_BYTES + kk * 16 * ROW_BYTES, BK * ROW_BYTES,
                     ATOM_BYTES),
                kt | kk);
          mma_commit();
          fence_acc(acc);
          // This stage's products stay in flight; the last stage's are
          // done, so its buffers go back to the producer.
          mma_wait<1>();
          if (kt > 0) mbar_arrive(&empty[prev]);
          prev = s;
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
        mma_wait<0>();
        fence_acc(acc);
        mbar_arrive(&empty[prev]);
        sched.store(t, w, wg, acc);
      }
    }
  }
};

// ---- host ----------------------------------------------------------------

// cuTensorMapEncodeTiled, from the CUDA driver through the runtime (the
// libraries do not link libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return rc == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (d0, d1, d2) bf16 tensor, d0 innermost and contiguous, as boxes of
// (b0, b1, 1) with 128-byte swizzle; out-of-bounds elements read as zeros.
// Returns a cudaError_t code.
inline int encode_3d(CUtensorMap* map, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * 2, d0 * d1 * 2};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wgmma
}  // namespace tdt
