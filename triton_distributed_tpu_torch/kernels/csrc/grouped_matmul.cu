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
// Design (a first kernel that is right; bf16 on the tensor cores).  The
// tile body (cp.async ring, `mma.sync` m16n8k16, predicated ragged edges,
// the f32 tile on the CUDA cores) is `gemm_tile.cuh`, shared with the
// collective GEMMs K12 and K14.  Here:
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
// - f32 inputs (the f32 checks; no main path gives them) run on the CUDA
//   cores: 64 x 64 tiles.

#include "gemm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace gemm = tdt::gemm;

// One block, one (BM x BN) tile of group blockIdx.z.
template <class Tile, typename TO>
__global__ void __launch_bounds__(Tile::NT)
    grouped_tile_kernel(const typename Tile::In* __restrict__ a,
                        const typename Tile::In* __restrict__ b,
                        TO* __restrict__ out, int M, int N, int K, int vec) {
  __shared__ typename Tile::Smem sm;
  const int e = blockIdx.z;
  Tile::run(sm, a + (size_t)e * M * K, b + (size_t)e * K * N,
            out + (size_t)e * M * N, M, N, K, blockIdx.x * Tile::BM,
            blockIdx.y * Tile::BN, vec);
}

template <class Tile, typename TO>
void launch(const typename Tile::In* a, const typename Tile::In* b, TO* out,
            int E, int M, int N, int K, int vec, cudaStream_t s) {
  const dim3 grid((M + Tile::BM - 1) / Tile::BM,
                  (N + Tile::BN - 1) / Tile::BN, E);
  grouped_tile_kernel<Tile, TO><<<grid, Tile::NT, 0, s>>>(a, b, out, M, N, K,
                                                          vec);
}

template <typename TO>
void dispatch_bf16(const bf16* a, const bf16* b, TO* out, int E, int M,
                   int N, int K, int vec, cudaStream_t s) {
  if (M <= 16)
    launch<gemm::Bf16Tile16>(a, b, out, E, M, N, K, vec, s);
  else if (M <= 64)
    launch<gemm::Bf16Tile64>(a, b, out, E, M, N, K, vec, s);
  else
    launch<gemm::Bf16Tile128>(a, b, out, E, M, N, K, vec, s);
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
      launch<gemm::F32Tile>(ap, bp, static_cast<bf16*>(out), E, M, N, K, 0,
                            s);
    else if (out_dtype == tdt::DTYPE_F32)
      launch<gemm::F32Tile>(ap, bp, static_cast<float*>(out), E, M, N, K, 0,
                            s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
