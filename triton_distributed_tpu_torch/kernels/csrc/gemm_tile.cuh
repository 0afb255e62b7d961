// One output tile of a row-major product out (M, N) = a (M, K) @ b (K, N),
// f32 accumulation, written in bf16 or f32: the body of the collective
// GEMMs (K12 ag_gemm.cu, K14 gemm_rs.cu, K21c torus.cu, and through
// tile_body.cuh K11 ag_group_gemm.cu and K10 moe_reduce_rs.cu), which call
// it from persistent blocks, and of the grouped GEMM (K8, K6:
// grouped_matmul.cu) for operands off 16-byte rows and f32 operands; K8
// and K6 on 16-byte rows run the `wgmma` tile of wgmma_tile.cuh.  A
// caller that runs a second tile in the same block syncs the block first
// (`__syncthreads()`): the shared ring of one tile is reused by the next.
//
// bf16 (`Bf16Tile`): the tensor cores.  a and b tiles arrive by cp.async in
// a ring of 2-4 stages, the copies of the next stages in flight while the
// tensor cores work on this one (`mma.sync` m16n8k16, f32 accumulators; A
// fragments by ldmatrix, B fragments by ldmatrix.trans from the (k, n)
// tile).  Shared rows are padded by 16 bytes so an ldmatrix phase hits
// distinct banks.  Every tile shape walks k in steps of 32 with the same
// mma order, so an output element does not depend on the tile that
// computed it.  Ragged m, n and k are predicated: rows and columns past the
// edge load as zeros, warps whose rows are all past m skip their products,
// and stores past m or n are dropped.  With k and n multiples of 8 (16-byte
// rows; `vec`) tiles load by cp.async, else by element.
//
// f32 (`F32Tile`): the CUDA cores, 64 x 64 tiles, 4 x 4 outputs a thread,
// fmaf along k in order.
//
// Loads of a and b go through L2 only (cp.async.cg, ld.global.cg): a
// collective GEMM reads rows that another block, or another rank, has just
// written, and L1 is not coherent with those writes.
#pragma once

#include "common.cuh"

namespace tdt {
namespace gemm {

using bf16 = __nv_bfloat16;

constexpr int BK = 32;       // k per pipeline stage
constexpr int LDA = BK + 8;  // padded row of an a tile

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// Out elements (r, c) and (r, c + 1) of a row-major (M, N) tile, the
// second only if c + 1 < N; as one store when N is even (c is even).
template <typename TO>
__device__ __forceinline__ void store_pair(TO* out, int r, int c, int N,
                                           float x, float y) {
  TO* p = out + (size_t)r * N + c;
  if (c + 1 < N && N % 2 == 0) {
    store2(p, x, y);
  } else {
    if (c < N) store1(p, x);
    if (c + 1 < N) store1(p + 1, y);
  }
}

// Start the copies of k-step [k0, k0 + BK) of a (rows [m0, m0 + BM)) and
// b (columns [n0, n0 + BN)) into one ring stage.
template <int BM, int BN, int NT>
__device__ __forceinline__ void load_stage(bf16 (*as)[LDA],
                                           bf16 (*bs)[BN + 8],
                                           const bf16* a, const bf16* b,
                                           int M, int N, int K, int m0,
                                           int n0, int k0, bool vec,
                                           int tid) {
  constexpr int ACH = BK / 8, BCH = BN / 8;  // 16-byte chunks per row
  const bf16 zero = __float2bfloat16(0.f);
  for (int c = tid; c < BM * ACH; c += NT) {
    const int r = c / ACH, kc = (c % ACH) * 8;
    const int gm = m0 + r, gk = k0 + kc;
    if (vec) {
      const bool ok = gm < M && gk < K;
      cp_async16(&as[r][kc], a + (ok ? (size_t)gm * K + gk : 0), ok);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        as[r][kc + i] = (gm < M && gk + i < K)
                            ? __ldcg(a + (size_t)gm * K + gk + i) : zero;
    }
  }
  for (int c = tid; c < BK * BCH; c += NT) {
    const int r = c / BCH, nc = (c % BCH) * 8;
    const int gk = k0 + r, gn = n0 + nc;
    if (vec) {
      const bool ok = gk < K && gn < N;
      cp_async16(&bs[r][nc], b + (ok ? (size_t)gk * N + gn : 0), ok);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        bs[r][nc + i] = (gk < K && gn + i < N)
                            ? __ldcg(b + (size_t)gk * N + gn + i) : zero;
    }
  }
}

template <int BM_, int BN_, int WARPS_M, int WARPS_N, int STAGES>
struct Bf16Tile {
  using In = bf16;
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int NT = WARPS_M * WARPS_N * 32;
  struct __align__(16) Smem {
    bf16 as[STAGES][BM][LDA];
    bf16 bs[STAGES][BK][BN + 8];
  };

  // The tile of rows [m0, m0 + BM) and columns [n0, n0 + BN) of out.
  template <typename TO>
  static __device__ __forceinline__ void run(Smem& sm, const bf16* a,
                                             const bf16* b, TO* out, int M,
                                             int N, int K, int m0, int n0,
                                             int vec) {
    constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
    constexpr int MI = WM / 16, NI = WN / 8;             // mma tiles a warp
    static_assert(MI >= 1 && NI % 2 == 0, "warp tile");
    const int tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int wm = warp / WARPS_N, wn = warp % WARPS_N;
    const int g = lane / 4, tg = lane % 4;           // mma fragment row / pair
    const int lr = lane % 16, lc = (lane / 16) * 8;  // ldmatrix x4 address
    // This warp's 16-row m tiles that hold a row below M (warp-uniform).
    const int mi_live = min(MI, max(0, M - m0 - wm * WM + 15) / 16);

    float acc[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

    const int nk = (K + BK - 1) / BK;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nk)
        load_stage<BM, BN, NT>(sm.as[s], sm.bs[s], a, b, M, N, K, m0, n0,
                               s * BK, vec, tid);
      cp_async_commit();
    }
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<STAGES - 2>();  // stage kt has landed
      __syncthreads();              // ... for every thread; kt - 1 is consumed
      const int next = kt + STAGES - 1;
      if (next < nk)
        load_stage<BM, BN, NT>(sm.as[next % STAGES], sm.bs[next % STAGES],
                               a, b, M, N, K, m0, n0, next * BK, vec, tid);
      cp_async_commit();
      const int s = kt % STAGES;
      if (mi_live > 0) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          unsigned bf[NI / 2][4];
#pragma unroll
          for (int p = 0; p < NI / 2; ++p)
            ldsm_x4_trans(bf[p],
                          &sm.bs[s][kk * 16 + lr][wn * WN + p * 16 + lc]);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            if (i < mi_live) {
              unsigned af[4];
              ldsm_x4(af, &sm.as[s][wm * WM + i * 16 + lr][kk * 16 + lc]);
#pragma unroll
              for (int p = 0; p < NI / 2; ++p) {
                mma_bf16(acc[i][2 * p], af, bf[p][0], bf[p][1]);
                mma_bf16(acc[i][2 * p + 1], af, bf[p][2], bf[p][3]);
              }
            }
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm * WM + i * 16 + g + h * 8;
        if (r >= M) continue;
#pragma unroll
        for (int j = 0; j < NI; ++j)
          store_pair(out, r, n0 + wn * WN + j * 8 + tg * 2, N,
                     acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  }
};

// The bf16 tile that fits m rows: 16 (4 warps along n) for decode rows,
// 64 (2 x 2 warps) up to 64, 128 (2 x 4 warps) above.
using Bf16Tile16 = Bf16Tile<16, 128, 1, 4, 4>;
using Bf16Tile64 = Bf16Tile<64, 128, 2, 2, 3>;
using Bf16Tile128 = Bf16Tile<128, 128, 2, 4, 2>;

constexpr int FT = 64, FK = 16;  // f32 tile, k step

struct F32Tile {
  using In = float;
  static constexpr int BM = FT, BN = FT, NT = 256;
  struct Smem {
    float as[FK][FT + 4];  // k-major: a thread reads 4 rows at once
    float bs[FK][FT + 4];
  };

  template <typename TO>
  static __device__ __forceinline__ void run(Smem& sm, const float* a,
                                             const float* b, TO* out, int M,
                                             int N, int K, int m0, int n0,
                                             int /*vec*/) {
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += FK) {
      for (int c = tid; c < FT * FK; c += NT) {
        const int r = c / FK, kk = c % FK;
        sm.as[kk][r] = (m0 + r < M && k0 + kk < K)
                           ? __ldcg(a + (size_t)(m0 + r) * K + k0 + kk)
                           : 0.f;
      }
      for (int c = tid; c < FK * FT; c += NT) {
        const int kk = c / FT, col = c % FT;
        sm.bs[kk][col] = (k0 + kk < K && n0 + col < N)
                             ? __ldcg(b + (size_t)(k0 + kk) * N + n0 + col)
                             : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < FK; ++kk) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = sm.as[kk][ty * 4 + i];
          bv[i] = sm.bs[kk][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c < N) store1(out + (size_t)r * N + c, acc[i][j]);
      }
    }
  }
};

// Blocks an SM that a persistent kernel over these tiles is compiled for
// (`__launch_bounds__`): two caps a 256-thread tile at 128 registers a
// thread.  Left free, the ring of K12 took 190 and ran one block an SM,
// about 1.6x slower at Qwen3-8B's prefill gate_up shape on an H100
// (PERF.md).
constexpr int MIN_BLOCKS = 2;

// Number of (BM x BN) tiles of an (M, N) output; tile t covers rows
// (t % mt) * BM and columns (t / mt) * BN (m tiles fastest, so blocks that
// run together share a tile of b).
template <class Tile>
__host__ __device__ __forceinline__ int tiles(int M, int N) {
  return ((M + Tile::BM - 1) / Tile::BM) * ((N + Tile::BN - 1) / Tile::BN);
}

// Tiles first, first + stride, ... of out (M, N) = a (M, K) @ b (K, N)
// (a persistent block's share), the block synced before each.
template <class Tile, typename TO>
__device__ __forceinline__ void run_tiles(typename Tile::Smem& sm,
                                          const typename Tile::In* a,
                                          const typename Tile::In* b,
                                          TO* out, int M, int N, int K,
                                          int vec, int first, int stride) {
  const int mt = (M + Tile::BM - 1) / Tile::BM;
  const int total = tiles<Tile>(M, N);
  for (int t = first; t < total; t += stride) {
    __syncthreads();
    Tile::run(sm, a, b, out, M, N, K, (t % mt) * Tile::BM,
              (t / mt) * Tile::BN, vec);
  }
}

}  // namespace gemm
}  // namespace tdt
