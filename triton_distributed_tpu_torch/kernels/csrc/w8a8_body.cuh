// The first int8 GEMM tile: int8 x int8 -> int32 on the tensor cores, then
// the rank-1 f32 dequant epilogue out[m, n] = (float(acc[m, n]) * sa[m]) *
// sb[n], in bf16 or f32.  `tdt::w8a8::tile` computes one BM x BN tile of
// out at (m0, n0); it is the port of quantized.py `emit_matmul_w8a8`
// (:161), the form a block of a persistent or cooperative kernel calls:
// K10 with int8 weights (moe_reduce_rs.cu) and K13 (ag_gemm_w8a8.cu) call
// it per tile.  `w8a8_kernel` runs it once a block: K9
// (grouped_matmul_w8a8.cu, one matrix a group: group blockIdx.z reads a +
// z*M*K, b + z*K*N, sa + z*M, sb + z*N and writes out + z*M*N).  K7 and
// K11-int8 left it for the int8 form of the Hopper tile (`wgmma_tile.cuh`
// `Int8Ops`, weights K-major).  A caller that runs a second tile in the
// same block syncs the block first (`__syncthreads()`): the shared buffers
// of one tile are the next one's.
//
// Design (a first kernel that is right, on the tensor cores):
// - One block of 8 warps computes a 128 x 128 tile of out; each warp a
//   64 x 32 sub-tile as 4 x 4 `mma.sync.m16n8k32.s8.s8.s32`, int32
//   accumulators in registers.  The TPU kernel carried its accumulator
//   across the sequential k grid axis in VMEM; here a loop inside the block
//   walks k in steps of 64 bytes.
// - a and b tiles arrive by cp.async, double-buffered: the copy of step
//   k+1 overlaps the products of step k.
// - The int8 mma wants both operands k-contiguous (A row-major, B "col"),
//   and ldmatrix's .trans has no 8-bit form.  b arrives (k, n) row-major,
//   so each b tile is transposed in shared memory after it lands: 4 x 4
//   byte blocks through registers with byte permutes, into a k-contiguous
//   tile whose rows are padded by 16 bytes so the fragment loads of a warp
//   fall in distinct banks.  (The Hopper tile's int8 form reads weights
//   stored K-major by the layers and needs no transpose.)
// - Ragged m and n are predicated: rows of a past m and the k tail load as
//   zeros, warps whose rows are all past m skip their products (m = 8 in a
//   decode batch), and stores past m or n are dropped.  n not a multiple
//   of 16 (rows of b not 16-byte aligned) loads b with plain byte loads.
//   k must be a multiple of 16 (16-byte rows of a); the wrapper checks.
// - a is read through L2 only (cp.async.cg): a collective kernel reads
//   rows that another block or rank has just written.

#pragma once

#include "common.cuh"

namespace tdt {
namespace w8a8 {

constexpr int BM = 128, BN = 128, BK = 64;  // block tile; BK counts bytes
constexpr int NT = 256;                      // 8 warps: 2 (m) x 4 (n)
constexpr int WM = 64, WN = 32;              // warp tile
constexpr int MI = WM / 16, NI = WN / 8;     // mma tiles per warp
constexpr int LDK = BK + 16;                 // padded k stride, bytes

struct Smem {
  int8_t a[2][BM][LDK];  // a tiles, k contiguous
  int8_t bs[2][BK][BN];  // b tiles as they arrive, n contiguous
  int8_t bt[BN][LDK];    // the current b tile transposed, k contiguous
};

// d (16x8 s32) += a (16x32 s8, row) * b (32x8 s8, col)
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Start the copies of k-step [k0, k0 + BK) into buffer `buf`.
__device__ __forceinline__ void load_tiles(Smem& sm, int buf,
                                           const int8_t* a, const int8_t* b,
                                           int M, int N, int K, int m0,
                                           int n0, int k0, bool n16,
                                           int tid) {
  constexpr int ACH = BK / 16, BCH = BN / 16;  // 16-byte chunks per row
  for (int c = tid; c < BM * ACH; c += NT) {
    const int r = c / ACH, gk = k0 + (c % ACH) * 16;
    const bool ok = m0 + r < M && gk < K;
    cp_async16(&sm.a[buf][r][gk - k0],
               a + (ok ? (size_t)(m0 + r) * K + gk : 0), ok);
  }
  for (int c = tid; c < BK * BCH; c += NT) {
    const int r = c / BCH, ch = c % BCH;
    const int gk = k0 + r, gn = n0 + ch * 16;
    int8_t* dst = &sm.bs[buf][r][ch * 16];
    if (n16) {
      const bool ok = gk < K && gn < N;
      cp_async16(dst, b + (ok ? (size_t)gk * N + gn : 0), ok);
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = (gk < K && gn + i < N) ? b[(size_t)gk * N + gn + i] : 0;
    }
  }
}

// bs[buf] (BK x BN, n contiguous) -> bt (BN x BK, k contiguous), one 4 x 4
// byte block per thread and pass.
__device__ __forceinline__ void transpose_b(Smem& sm, int buf, int tid) {
  constexpr int WPR = BN / 4;  // 32-bit words per row of bs
  for (int c = tid; c < (BK / 4) * WPR; c += NT) {
    const int kb = c / WPR, nb = c % WPR;
    const unsigned* src =
        reinterpret_cast<const unsigned*>(&sm.bs[buf][kb * 4][nb * 4]);
    // w_i holds b[k0 + i][n0 .. n0 + 3]; o_j gets b[k0 .. k0 + 3][n0 + j].
    const unsigned w0 = src[0], w1 = src[WPR], w2 = src[2 * WPR],
                   w3 = src[3 * WPR];
    const unsigned lo01 = __byte_perm(w0, w1, 0x5140);
    const unsigned hi01 = __byte_perm(w0, w1, 0x7362);
    const unsigned lo23 = __byte_perm(w2, w3, 0x5140);
    const unsigned hi23 = __byte_perm(w2, w3, 0x7362);
    const unsigned o[4] = {__byte_perm(lo01, lo23, 0x5410),
                           __byte_perm(lo01, lo23, 0x7632),
                           __byte_perm(hi01, hi23, 0x5410),
                           __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<unsigned*>(&sm.bt[nb * 4 + j][kb * 4]) = o[j];
  }
}

// The tile of out rows [m0, m0 + BM) and columns [n0, n0 + BN) of
// out (M, N) = a (M, K) @ b (K, N), dequantized with sa (M,) and sb (N,).
template <typename TO>
__device__ __forceinline__ void tile(Smem& sm, const int8_t* a,
                                     const int8_t* b, const float* sa,
                                     const float* sb, TO* out, int M, int N,
                                     int K, int m0, int n0) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row / k quad
  const int wm = warp / 4, wn = warp % 4;
  const bool n16 = N % 16 == 0;
  // This warp's 16-row m tiles that hold a row below M (warp-uniform).
  const int mi_live = min(MI, max(0, M - m0 - wm * WM + 15) / 16);

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + BK - 1) / BK;
  load_tiles(sm, 0, a, b, M, N, K, m0, n0, 0, n16, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk)
      load_tiles(sm, buf ^ 1, a, b, M, N, K, m0, n0, (kt + 1) * BK, n16, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    transpose_b(sm, buf, tid);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned bf[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* bp = &sm.bt[wn * WN + j * 8 + g][kk + t * 4];
        bf[j][0] = lds32(bp);
        bf[j][1] = lds32(bp + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if (i < mi_live) {
          const int8_t* ap = &sm.a[buf][wm * WM + i * 16 + g][kk + t * 4];
          const unsigned af[4] = {lds32(ap), lds32(ap + 8 * LDK),
                                  lds32(ap + 16), lds32(ap + 8 * LDK + 16)};
#pragma unroll
          for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], af, bf[j][0], bf[j][1]);
        }
      }
    }
    __syncthreads();  // buf and bt are rewritten next step
  }

  // Epilogue: (float(acc) * sa[r]) * sb[c], rounded once per multiply.
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * WM + i * 16 + g + h * 8;
      if (r >= M) continue;
      const float s_a = sa[r];
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn * WN + j * 8 + t * 2 + e;
          if (c < N)
            store1(out + (size_t)r * N + c,
                   __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][h * 2 + e]),
                                       s_a),
                             sb[c]));
        }
    }
}

// Number of (BM x BN) tiles of an (M, N) output.
__host__ __device__ __forceinline__ int tiles(int M, int N) {
  return ((M + BM - 1) / BM) * ((N + BN - 1) / BN);
}

// One tile a block: tile (blockIdx.y, blockIdx.x) of group blockIdx.z.
template <typename TO>
__global__ void __launch_bounds__(NT) w8a8_kernel(
    const int8_t* __restrict__ a, const int8_t* __restrict__ b,
    const float* __restrict__ sa, const float* __restrict__ sb,
    TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) Smem sm;
  const size_t grp = blockIdx.z;
  tile(sm, a + grp * M * K, b + grp * K * N, sa + grp * M, sb + grp * N,
       out + grp * M * N, M, N, K, blockIdx.y * BM, blockIdx.x * BN);
}

}  // namespace w8a8
}  // namespace tdt
