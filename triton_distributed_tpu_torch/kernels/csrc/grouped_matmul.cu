// Grouped matmul: out[e] = a[e] @ b[e] for every group e, f32 accumulation,
// written in bf16 or f32.  One group is a plain matmul.
//
// Replaces: triton_distributed_tpu/kernels/grouped_gemm.py `grouped_matmul`
//   -> `_grouped_kernel` (pallas_call :71), and, as its one-group case,
//   triton_distributed_tpu/kernels/matmul.py `matmul` -> `_matmul_kernel`
//   (pallas_call :138).  The layouts are the JAX package's: a (E, m, k),
//   b (E, k, n) and out (E, m, n), all row-major.
//
// What bounds it on the H100: at the Qwen3-30B-A3B expert shapes (128
// experts, hidden 2048, 768 per expert, so gate_up b is 128 x 2048 x 1536)
// the bytes of b.  A decode step's buckets hold 16 rows an expert, so
// gate_up moves 805 MB of weights for 6.4 GFLOP (0.245 ms at 3.35 TB/s);
// a 4 x 512 prefill (256 rows an expert) still moves 1.04 GB for 206 GFLOP
// (0.310 ms against 0.208 ms of bf16 tensor cores).  One group at
// 2048 x 4096 @ 4096 x 24576 (K6 at the Qwen3-8B MLP shape) is bound by
// its 412 GFLOP (0.417 ms).
//
// Design (a first kernel that is right; bf16 on the tensor cores):
// - Grid: m tiles (fastest) x n tiles x groups.  Blocks that run together
//   share a tile of b, so a tile of b is read from device memory about
//   once while the m tiles of its group read it; a stays in the 50 MB L2.
//   The TPU kernel carried its accumulator across the sequential k grid
//   axis in VMEM; here a loop inside the block walks k.
// - The m tile follows m: 16 rows (4 warps along n) for decode buckets of
//   16 rows, so no MMA work is spent on rows that do not exist and 1,536
//   blocks stream a decode step's gate_up weights; 64 rows (2 x 2 warps)
//   up to 64; 128 rows (2 x 4 warps) above, as for prefill buckets.  All
//   three walk k in steps of 32 with the same mma order, so an output
//   element does not depend on the tile that computed it.
// - a and b tiles arrive by cp.async in a ring of 2-4 stages, the copies
//   of the next stages in flight while the tensor cores work on this one
//   (`mma.sync` m16n8k16, f32 accumulators; A fragments by ldmatrix, B
//   fragments by ldmatrix.trans from the (k, n) tile, as K1 reads V).
//   Shared rows are padded by 16 bytes so an ldmatrix phase hits distinct
//   banks.
// - Ragged m, n and k are predicated: rows and columns past the edge load
//   as zeros, warps whose rows are all past m skip their products, and
//   stores past m or n are dropped.  With k and n multiples of 8 (16-byte
//   rows) tiles load by cp.async, else by element.
// - f32 inputs (the f32 checks; no main path gives them) run on the CUDA
//   cores: 64 x 64 tiles, 4 x 4 outputs a thread, fmaf along k in order.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tdt::cp_async16;
using tdt::cp_async_commit;
using tdt::cp_async_wait;
using tdt::ldsm_x4;
using tdt::ldsm_x4_trans;
using tdt::mma_bf16;

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
    if (c < N) tdt::store1(p, x);
    if (c + 1 < N) tdt::store1(p + 1, y);
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
        as[r][kc + i] =
            (gm < M && gk + i < K) ? a[(size_t)gm * K + gk + i] : zero;
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
        bs[r][nc + i] =
            (gk < K && gn + i < N) ? b[(size_t)gk * N + gn + i] : zero;
    }
  }
}

// ---- bf16: tensor cores ---------------------------------------------------

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, typename TO>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
    grouped_bf16_kernel(const bf16* __restrict__ a,
                        const bf16* __restrict__ b, TO* __restrict__ out,
                        int M, int N, int K, int vec) {
  constexpr int NT = WARPS_M * WARPS_N * 32;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  constexpr int MI = WM / 16, NI = WN / 8;             // mma tiles a warp
  static_assert(MI >= 1 && NI % 2 == 0, "warp tile");
  __shared__ __align__(16) bf16 as[STAGES][BM][LDA];
  __shared__ __align__(16) bf16 bs[STAGES][BK][BN + 8];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  a += (size_t)e * M * K;
  b += (size_t)e * K * N;
  out += (size_t)e * M * N;
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
      load_stage<BM, BN, NT>(as[s], bs[s], a, b, M, N, K, m0, n0, s * BK,
                             vec, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for every thread; kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < nk)
      load_stage<BM, BN, NT>(as[next % STAGES], bs[next % STAGES], a, b, M,
                             N, K, m0, n0, next * BK, vec, tid);
    cp_async_commit();
    const int s = kt % STAGES;
    if (mi_live > 0) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        unsigned bf[NI / 2][4];
#pragma unroll
        for (int p = 0; p < NI / 2; ++p)
          ldsm_x4_trans(bf[p], &bs[s][kk * 16 + lr][wn * WN + p * 16 + lc]);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          if (i < mi_live) {
            unsigned af[4];
            ldsm_x4(af, &as[s][wm * WM + i * 16 + lr][kk * 16 + lc]);
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

template <int BM, int BN, int WARPS_M, int WARPS_N, int STAGES, typename TO>
void launch_bf16(const bf16* a, const bf16* b, TO* out, int E, int M, int N,
                 int K, int vec, cudaStream_t s) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, E);
  grouped_bf16_kernel<BM, BN, WARPS_M, WARPS_N, STAGES, TO>
      <<<grid, WARPS_M * WARPS_N * 32, 0, s>>>(a, b, out, M, N, K, vec);
}

template <typename TO>
void dispatch_bf16(const bf16* a, const bf16* b, TO* out, int E, int M,
                   int N, int K, int vec, cudaStream_t s) {
  if (M <= 16)
    launch_bf16<16, 128, 1, 4, 4>(a, b, out, E, M, N, K, vec, s);
  else if (M <= 64)
    launch_bf16<64, 128, 2, 2, 3>(a, b, out, E, M, N, K, vec, s);
  else
    launch_bf16<128, 128, 2, 4, 2>(a, b, out, E, M, N, K, vec, s);
}

// ---- f32: CUDA cores ------------------------------------------------------

constexpr int FT = 64, FK = 16, FNT = 256;  // tile, k step, threads

template <typename TO>
__global__ void __launch_bounds__(FNT)
    grouped_f32_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, TO* __restrict__ out,
                       int M, int N, int K) {
  __shared__ float as[FK][FT + 4];  // k-major: a thread reads 4 rows at once
  __shared__ float bs[FK][FT + 4];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * FT, n0 = blockIdx.y * FT;
  a += (size_t)e * M * K;
  b += (size_t)e * K * N;
  out += (size_t)e * M * N;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int c = tid; c < FT * FK; c += FNT) {
      const int r = c / FK, kk = c % FK;
      as[kk][r] = (m0 + r < M && k0 + kk < K)
                      ? a[(size_t)(m0 + r) * K + k0 + kk] : 0.f;
    }
    for (int c = tid; c < FK * FT; c += FNT) {
      const int kk = c / FT, col = c % FT;
      bs[kk][col] = (k0 + kk < K && n0 + col < N)
                        ? b[(size_t)(k0 + kk) * N + n0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = as[kk][ty * 4 + i];
        bv[i] = bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
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
      if (c < N) tdt::store1(out + (size_t)r * N + c, acc[i][j]);
    }
  }
}

template <typename TO>
void launch_f32(const float* a, const float* b, TO* out, int E, int M, int N,
                int K, cudaStream_t s) {
  const dim3 grid((M + FT - 1) / FT, (N + FT - 1) / FT, E);
  grouped_f32_kernel<TO><<<grid, FNT, 0, s>>>(a, b, out, M, N, K);
}

}  // namespace

// a (E, M, K), b (E, K, N) in in_dtype, out (E, M, N) in out_dtype, all
// contiguous; dtype codes as tdt::DTYPE_*.  Returns a cudaError_t code.
extern "C" int grouped_matmul(const void* a, const void* b, void* out,
                              int in_dtype, int out_dtype, int E, int M,
                              int N, int K, void* stream) {
  if (E == 0 || M == 0 || N == 0) return 0;
  if (E < 0 || M < 0 || N < 0 || K < 0 || E > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == tdt::DTYPE_BF16) {
    const bf16* ap = static_cast<const bf16*>(a);
    const bf16* bp = static_cast<const bf16*>(b);
    const int vec = K % 8 == 0 && N % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
    if (out_dtype == tdt::DTYPE_BF16)
      dispatch_bf16(ap, bp, static_cast<bf16*>(out), E, M, N, K, vec, s);
    else if (out_dtype == tdt::DTYPE_F32)
      dispatch_bf16(ap, bp, static_cast<float*>(out), E, M, N, K, vec, s);
    else
      return (int)cudaErrorInvalidValue;
  } else if (in_dtype == tdt::DTYPE_F32) {
    const float* ap = static_cast<const float*>(a);
    const float* bp = static_cast<const float*>(b);
    if (out_dtype == tdt::DTYPE_BF16)
      launch_f32(ap, bp, static_cast<bf16*>(out), E, M, N, K, s);
    else if (out_dtype == tdt::DTYPE_F32)
      launch_f32(ap, bp, static_cast<float*>(out), E, M, N, K, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
