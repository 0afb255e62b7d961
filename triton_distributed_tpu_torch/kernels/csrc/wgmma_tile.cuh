// The Hopper GEMM tile: out (M, N) = a (M, K) @ b (K, N) per group, by TMA
// loads into a shared ring and `wgmma` products from it, in one of two
// operand forms (`Ops`):
// - `Bf16Ops`: bf16 operands, b as (K, N) (MN-major), f32 accumulation.
//   The body of the grouped GEMM (K8 and its one-group case K6,
//   grouped_matmul.cu), of the AllGather-GEMM (K12, ag_gemm.cu), of the
//   GEMM-ReduceScatter (K14, gemm_rs.cu), of the AllGather-GroupGEMM (K11,
//   ag_group_gemm.cu) and of the MoE-Reduce-RS (K10, moe_reduce_rs.cu) for
//   operands on 16-byte rows.
// - `Int8Ops`: int8 operands, b stored as (N, K) (K-major: `wgmma` on 8-bit
//   types has no transpose, so both operands are K-major), int32
//   accumulation, `wgmma m64nNk32.s32.s8.s8`.  The body of the W8A8 matmul
//   (K7, matmul_w8a8.cu) and of K11's int8 form (ag_group_gemm.cu); the
//   epilogue dequantizes (float(acc) * sa[row]) * sb[col] (`dequant`).
// A swizzled row is 128 bytes either way: k = 64 of bf16 or k = 128 of
// int8, so a stage holds the same boxes and bytes in both forms and each of
// its four k steps (k16 of bf16, k32 of int8) advances 32 bytes in the row.
//
// Roles (one block of 128 (C + 1) threads, `Tile<C, STAGES, TN, BOXES>`):
// - Warpgroups 0 .. C - 1 consume: each owns BOXES boxes of 64 rows of the
//   tile (box j of warpgroup w is the stage's box j C + w) and issues
//   `wgmma.mma_async m64nTNk16` (TN = 256; 64 for a narrow tile; 128 with
//   two boxes a warpgroup; k32 for int8) on each from the ring (a K-major,
//   b MN-major in bf16 and K-major in int8), f32 (int32) accumulators in
//   registers (BOXES TN / 2 a thread), then hands them to the caller's
//   epilogue.  With BOXES > 1 a tile may hold fewer live
//   boxes than the stage has room for (`At::boxes`): the producer loads the
//   live ones only, and the epilogue stores those only.
// - Warpgroup C produces: one thread keeps the TMA loads of the next
//   stages in flight; its other three warps run the caller's side work (a
//   collective's copies and signals), which never waits on the ring.
//   `setmaxnreg` gives the producer's registers to the consumers (40 and
//   232 a thread).
// - The ring: STAGES stages of one 128-byte row of k (the swizzle span: k =
//   64 of bf16, 128 of int8), each the a tile (BM rows, one box or the
//   schedule's boxes) and the b tile (TN columns, TN / 64 boxes of 64
//   columns), loaded with 128-byte swizzle; a "full"
//   mbarrier (the producer's expected bytes) and an "empty" one (every
//   consumer thread) per stage.  A consumer keeps one stage of products in
//   flight and frees a stage once its products are done.
// - The block is persistent: it walks tiles blockIdx.x, + gridDim.x, ...
//   and the producer loads the next tile's stages while the consumers
//   write this one.
//
// A caller describes its tiles by a schedule (`at`, `pending`, `ready`,
// `side`, `store`, and optionally `load_a`): tile t's a map and box (or the
// schedule's own loads of a stage's a rows), its b box, its k stages, a
// wait the producer makes before the tile's first a load (a
// collective's arrival signal; the first stages' b loads go out before
// it), and the epilogue.  Groups do not leak: a is a 3-D tensor
// map (k, m, group) and b (n, k, group) in bf16, (k, n, group) in int8, so a
// box that runs past a group's M, N or K reads zeros, never the next
// group's rows (zeros add nothing to either sum).  A tile may start at a k
// stage other than 0 (`At::kt0`: a k split, whose int32 partial sums are
// exact in any order).  Rows past M and columns past N are not written.
//
// The tile promise: every tile shape runs its instruction over k in the
// same order (stages of 64, four k16 steps each), and an element's
// products depend neither on the other rows nor on the other columns of
// the instruction (m64n64k16, m64n128k16 and m64n256k16 give the same bits
// on the H100), so an output element does not depend on the tile that
// computed it.  In int8 it holds exactly: every product and partial sum is
// an integer below 2^31 (k <= 2^17 at |q| <= 127), so no tile shape, row
// tile or k split changes a bit.
#pragma once

#include <cuda.h>

#include <type_traits>

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

//: The operand forms: the accumulator type, the k of a ring stage (one
//: 128-byte swizzled row) and whether b is stored K-major.
struct Bf16Ops {
  using Acc = float;
  static constexpr int K_STAGE = 64;
  static constexpr bool B_K_MAJOR = false;
};
struct Int8Ops {
  using Acc = int;
  static constexpr int K_STAGE = 128;
  static constexpr bool B_K_MAJOR = true;
};

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
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
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

// d[O .. O + 63] (64 x 128 f32) = a (64 x 16, K-major) @ b (16 x 128,
// MN-major) + (those accumulators if accumulate): one box of a tile whose
// warpgroups own two boxes each (K11's units).
#define TDT_ACC8(o)                                                   \
  "+f"(d[(o)]), "+f"(d[(o) + 1]), "+f"(d[(o) + 2]), "+f"(d[(o) + 3]), \
      "+f"(d[(o) + 4]), "+f"(d[(o) + 5]), "+f"(d[(o) + 6]), "+f"(d[(o) + 7])
template <int O, int R>
__device__ __forceinline__ void mma_m64n128k16(float (&d)[R], uint64_t da,
                                               uint64_t db, int accumulate) {
  static_assert(O + 64 <= R, "accumulators");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : TDT_ACC8(O), TDT_ACC8(O + 8), TDT_ACC8(O + 16), TDT_ACC8(O + 24),
        TDT_ACC8(O + 32), TDT_ACC8(O + 40), TDT_ACC8(O + 48),
        TDT_ACC8(O + 56)
      : "l"(da), "l"(db), "r"(accumulate));
}
#undef TDT_ACC8

// ---- int8 products: d (s32) = a (64 x 32 s8, K-major) @ b (32 x N s8,
// K-major) + (d if accumulate).  The instruction has no transpose or scale
// immediates for 8-bit types.

#define TDT_IACC8(o)                                                  \
  "+r"(d[(o)]), "+r"(d[(o) + 1]), "+r"(d[(o) + 2]), "+r"(d[(o) + 3]), \
      "+r"(d[(o) + 4]), "+r"(d[(o) + 5]), "+r"(d[(o) + 6]), "+r"(d[(o) + 7])
#define TDT_IACC32(o) \
  TDT_IACC8(o), TDT_IACC8((o) + 8), TDT_IACC8((o) + 16), TDT_IACC8((o) + 24)

// d[O .. O + 127]: a 64 x 256 tile.
template <int O, int R>
__device__ __forceinline__ void mma_m64n256k32(int (&d)[R], uint64_t da,
                                               uint64_t db, int accumulate) {
  static_assert(O + 128 <= R, "accumulators");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : TDT_IACC32(O), TDT_IACC32(O + 32), TDT_IACC32(O + 64),
        TDT_IACC32(O + 96)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[O .. O + 63]: a 64 x 128 tile (a box of a tile whose warpgroups own two
// boxes each, or one box of a 128-wide tile).
template <int O, int R>
__device__ __forceinline__ void mma_m64n128k32(int (&d)[R], uint64_t da,
                                               uint64_t db, int accumulate) {
  static_assert(O + 64 <= R, "accumulators");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : TDT_IACC32(O), TDT_IACC32(O + 32)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef TDT_IACC32
#undef TDT_IACC8

__device__ __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n256k16(d, da, db, accumulate);
}
__device__ __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n64k16(d, da, db, accumulate);
}
__device__ __forceinline__ void mma(int (&d)[128], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n256k32<0>(d, da, db, accumulate);
}
__device__ __forceinline__ void mma(int (&d)[64], uint64_t da, uint64_t db,
                                    int accumulate) {
  mma_m64n128k32<0>(d, da, db, accumulate);
}
// Box j of a tile of two boxes a warpgroup, 128 columns wide.
template <int O, int R>
__device__ __forceinline__ void mma_box(float (&d)[R], uint64_t da,
                                        uint64_t db, int accumulate) {
  mma_m64n128k16<O>(d, da, db, accumulate);
}
template <int O, int R>
__device__ __forceinline__ void mma_box(int (&d)[R], uint64_t da, uint64_t db,
                                        int accumulate) {
  mma_m64n128k32<O>(d, da, db, accumulate);
}

// ---- the tile ------------------------------------------------------------

// Whether a schedule loads a stage's a rows itself (`load_a`).
template <class S, class = void>
struct loads_a : std::false_type {};
template <class S>
struct loads_a<S, std::void_t<decltype(&S::load_a)>> : std::true_type {};

// Where tile t lies: its a map and box (first row, group), its b box
// (first column, group), its nk ring stages from stage kt0 of k and, for a
// tile of two boxes a warpgroup, its live boxes (the first ``boxes`` of the
// stage's).
struct At {
  const CUtensorMap* ta;
  int a_row, a_grp;
  int col, b_grp;
  int nk;
  int boxes = 0;
  int kt0 = 0;
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

// ---- the int8 epilogue ---------------------------------------------------

// (float(acc) * sa) * sb, each product rounded and never contracted into an
// FMA: the int8 epilogue of K7 and K11-int8 in the TPU kernels' order
// (quantized.py :85-86), the plain versions' to the bit.
__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

// A consumer thread's int8 fragment of the 64-row box at rows [row0, row0 +
// 64), columns from col0, dequantized in place: accumulator i (row lane / 4
// + 8 ((i >> 1) & 1) of its warp's 16, column col0 + 8 (i >> 2) + 2 (lane %
// 4) + (i & 1)) becomes the bits of its f32 value (`dequant` with the row's
// scale of sa (M rows) and the column's of sb (N columns); 0 past M or N,
// never stored), read back with `__int_as_float`.  In place, so the
// epilogue needs no second set of registers.
template <int R>
__device__ __forceinline__ void dequant_box(int (&acc)[R], const float* sa,
                                            int M, int row0, const float* sb,
                                            int col0, int N) {
  const int r = row0 + threadIdx.x % WG / 32 * 16 + threadIdx.x % 32 / 4;
  const float sa0 = r < M ? __ldg(sa + r) : 0.f;
  const float sa1 = r + 8 < M ? __ldg(sa + r + 8) : 0.f;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = col0 + 8 * j + 2 * (threadIdx.x % 4);
    const float sb0 = c < N ? __ldg(sb + c) : 0.f;
    const float sb1 = c + 1 < N ? __ldg(sb + c + 1) : 0.f;
    acc[4 * j] = __float_as_int(dequant(acc[4 * j], sa0, sb0));
    acc[4 * j + 1] = __float_as_int(dequant(acc[4 * j + 1], sa0, sb1));
    acc[4 * j + 2] = __float_as_int(dequant(acc[4 * j + 2], sa1, sb0));
    acc[4 * j + 3] = __float_as_int(dequant(acc[4 * j + 3], sa1, sb1));
  }
}

// A consumer thread's fragment of a 64-row box, values ``val(i)``, into rows
// [row0, row0 + 64) x columns [col0, col0 + 2 R) of the row-major (M, N)
// ``o``: rows past M and columns past N dropped, any N (pairs stored
// whole where N is even).
template <int R, typename TO, class F>
__device__ __forceinline__ void store_frag(TO* o, int M, int N, int row0,
                                           int col0, const F& val) {
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int r = row0 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const int c = col0 + j * 8 + (lane % 4) * 2;
    if (c < N) {
      if (r < M) gemm::store_pair(o, r, c, N, val(4 * j), val(4 * j + 1));
      if (r + 8 < M)
        gemm::store_pair(o, r + 8, c, N, val(4 * j + 2), val(4 * j + 3));
    }
  }
}

template <int C, int STAGES, int TN_ = BN, int BOXES_ = 1,
          class Ops = Bf16Ops>
struct Tile {
  using Acc = typename Ops::Acc;  // float, or int for int8
  static constexpr int TN = TN_;  // columns of a tile
  static constexpr int BOXES = BOXES_;  // 64-row boxes a consumer warpgroup
  static constexpr int KS = Ops::K_STAGE;  // k of a ring stage
  static constexpr int BM = C * BOXES * WG_ROWS;
  static constexpr int NT = (C + 1) * WG;  // consumers, then the producer
  static constexpr int BOX_BYTES = WG_ROWS * ROW_BYTES;  // a box's stage
  // A stage: BM rows of a and TN columns of b, a 128-byte row of k each.
  static constexpr int A_BYTES = BM * ROW_BYTES, B_BYTES = TN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int ACC = BOXES * TN / 2;  // accumulators a thread
  // The ring, its barriers, and slack to align the ring to the swizzle atom.
  static constexpr int SMEM_BYTES =
      STAGES * STAGE_BYTES + 2 * STAGES * 8 + ATOM_BYTES;
  static_assert(A_BYTES % ATOM_BYTES == 0, "stage alignment");
  static_assert((BOXES == 1 && (TN == 256 || TN == 128 || TN == 64)) ||
                    (BOXES == 2 && TN == 128),
                "m64n256, m64n128 (int8) or m64n64 (bf16) a warpgroup, or "
                "two m64n128");

  // The bytes of a stage of tile ``w``: every box, or its live ones.
  static __device__ __forceinline__ int stage_bytes(const At& w) {
    if constexpr (BOXES == 1) return STAGE_BYTES;
    return B_BYTES + w.boxes * BOX_BYTES;
  }

  // Consumer warpgroup ``wg``'s products of k step ``kk`` (k16 of bf16,
  // k32 of int8) of the stage at ``st``: each of its boxes.  A box past
  // the tile's live ones multiplies the stage's stale bytes there (nothing
  // writes them while the stage is full) into accumulators that the
  // epilogue does not store: a product skipped on a runtime condition makes
  // ptxas serialize every `wgmma` of the kernel (C7520, a warpgroup arrive
  // in a divergent path).  b's descriptor: MN-major (bf16), the next
  // 64-column box a leading offset away and 8 k rows a stride offset away,
  // a step 16 rows down; or K-major (int8), as a's: 8 columns a stride
  // offset away, a step 32 bytes along the row.
  static __device__ __forceinline__ void mma_step(Acc (&acc)[ACC],
                                                  const uint8_t* st, int wg,
                                                  int kk, int accumulate) {
    const uint64_t db =
        Ops::B_K_MAJOR
            ? desc(st + A_BYTES + kk * 32, 16, ATOM_BYTES)
            : desc(st + A_BYTES + kk * 16 * ROW_BYTES, BOX_N * ROW_BYTES,
                   ATOM_BYTES);
    if constexpr (BOXES == 1) {
      mma(acc, desc(st + wg * BOX_BYTES + kk * 32, 16, ATOM_BYTES), db,
          accumulate);
    } else {
      mma_box<0>(acc, desc(st + wg * BOX_BYTES + kk * 32, 16, ATOM_BYTES),
                 db, accumulate);
      mma_box<TN / 2>(
          acc, desc(st + (C + wg) * BOX_BYTES + kk * 32, 16, ATOM_BYTES), db,
          accumulate);
    }
  }

  // Stage ``kt``'s b tile of tile ``w`` (TN / 64 boxes of 64 columns, 8 KB
  // each) into stage ``st``: boxes (64 n, 64 k) of the map (n, k, group) in
  // bf16, (128 k, 64 n) of the map (k, n, group) in int8.
  static __device__ __forceinline__ void load_b(uint8_t* st,
                                                const CUtensorMap* tb,
                                                uint64_t* bar, const At& w,
                                                int kt) {
#pragma unroll
    for (int j = 0; j < TN / BOX_N; ++j) {
      uint8_t* dst = st + A_BYTES + j * BOX_N * ROW_BYTES;
      if constexpr (Ops::B_K_MAJOR)
        tma_load_3d(dst, tb, bar, (w.kt0 + kt) * KS, w.col + j * BOX_N,
                    w.b_grp);
      else
        tma_load_3d(dst, tb, bar, w.col + j * BOX_N, (w.kt0 + kt) * KS,
                    w.b_grp);
    }
  }

  // Tiles blockIdx.x, + gridDim.x, ... of ``ntiles``, as ``sched`` says:
  // - ``At sched.at(t)``: tile t's a map and boxes and k stages (a map:
  //   (k, m, group) with box (KS, BM, 1); tb: b as (n, k, group) with box
  //   (64, 64, 1) in bf16, as (k, n, group) with box (128, 64, 1) in int8;
  //   all with 128-byte swizzle);
  // - ``sched.load_a(dst, bar, kt)``, where the schedule has it: the
  //   producer's loads of stage kt's a rows of the tile last passed to
  //   ``at`` (A_BYTES in all, or BOX_BYTES a live box, box j at dst + j
  //   BOX_BYTES; completing on ``bar``) in place of the one box of ``at``;
  // - ``sched.pending(t)``: whether tile t's a must wait; then
  //   ``sched.ready(t)`` (the producer thread) waits, after the b tiles of
  //   the tile's first stages are in flight and before any a load;
  // - ``sched.side(i)``: thread i of the producer's other 96 threads, once;
  // - ``sched.store(t, at, wg, acc)``: every consumer thread, the tile's
  //   accumulators of its warpgroup ``wg`` (which stay live through it:
  //   the next tile's products read them, so an epilogue has the registers
  //   they leave of the consumers' 232; it may overwrite them, since the
  //   next tile's first product does not accumulate).
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
      auto load_a = [&](uint8_t* st, uint64_t* bar, const At& w, int kt) {
        if constexpr (loads_a<Sched>::value)
          sched.load_a(st, bar, kt);
        else
          tma_load_3d(st, w.ta, bar, (w.kt0 + kt) * KS, w.a_row, w.a_grp);
      };
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
              mbar_expect_tx(&full[s], stage_bytes(w));
              load_b(ring + s * STAGE_BYTES, tb, &full[s], w, kt + i);
              if (++s == STAGES) {
                s = 0;
                phase ^= 1;
              }
            }
            sched.ready(t);
            for (int i = 0; i < pre; ++i) {
              const int si = (s0 + i) % STAGES;
              load_a(ring + si * STAGE_BYTES, &full[si], w, kt + i);
            }
            kt += pre;
          }
          for (; kt < w.nk; ++kt) {
            mbar_wait(&empty[s], phase ^ 1);
            mbar_expect_tx(&full[s], stage_bytes(w));
            uint8_t* st = ring + s * STAGE_BYTES;
            load_a(st, &full[s], w, kt);
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
      // A consumer: boxes wg, C + wg, ... of each tile.
      regs_inc<CONSUMER_REGS>();
      Acc acc[ACC] = {};
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
          for (int kk = 0; kk < 4; ++kk)  // k16 (bf16) or k32 (int8) steps
            mma_step(acc, st, wg, kk, kt | kk);
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

// A (d0, d1, d2) tensor of bf16 (``elem`` 2) or int8 (``elem`` 1), d0
// innermost and contiguous, as boxes of (b0, b1, 1) with 128-byte swizzle;
// out-of-bounds elements read as zeros.  Returns a cudaError_t code.
inline int encode_3d(CUtensorMap* map, const void* base, uint64_t d0,
                     uint64_t d1, uint64_t d2, uint32_t b0, uint32_t b1,
                     int elem = 2) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * elem, d0 * d1 * elem};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult rc = fn(
      map,
      elem == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace wgmma
}  // namespace tdt
