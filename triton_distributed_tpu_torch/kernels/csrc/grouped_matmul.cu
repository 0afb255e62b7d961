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
// Design.  bf16 operands on 16-byte rows (k and n multiples of 8, a and b
// 16-byte aligned: every main-path call) run the Hopper tile of
// `wgmma_tile.cuh`: TMA loads into a ring of k = 64 stages with 128-byte
// swizzle, one producer thread, consumer warpgroups of 64 rows issuing
// `wgmma` m64n256k16 (b MN-major, as the JAX layout gives it), `setmaxnreg`
// moving registers from the producer to the consumers.  Two shapes:
// - Up to 64 rows (decode buckets of 16): a 64 x 256 tile, one consumer
//   warpgroup, 5 stages (200 KB in flight a block, one block an SM).  Bound
//   by the bytes of b; the wasted rows of the 64-row product cost tensor
//   time that the weight stream hides, and 128 experts x 6 (gate_up) or 8
//   (down) column tiles keep every SM streaming.
// - Above (prefill buckets of 256, K6's 2048 rows): 128 x 256, two consumer
//   warpgroups, 4 stages of 48 KB.  Near the ridge for the buckets, above
//   it for K6.
// Blocks are persistent (one an SM) and walk the tiles with m fastest, so
// blocks that run together share a tile of b: a tile of b is read from
// device memory about once while the m tiles of its group read it, and a
// stays in the 50 MB L2.  The TPU kernel carried its accumulator across
// the sequential k grid axis in VMEM; here the consumers walk k over the
// ring.  a and b are 3-D tensor maps (k, m, group) and (n, k, group),
// encoded on the host for every call, so boxes past a group's edge read
// zeros and never the next group's rows.  Both tile shapes run the same
// instruction over k in the same order, so an output element does not
// depend on the tile that computed it: a token's expert product is the
// same whatever its bucket's size.
// - bf16 operands off 16-byte rows (no main path gives them) keep the
//   `mma.sync` tile of `gemm_tile.cuh` (`Bf16Tile`, loads by element), with
//   its 16-, 64- and 128-row shapes.
// - f32 inputs (the f32 checks; no main path gives them) run on the CUDA
//   cores: 64 x 64 tiles (`F32Tile`).
// A failed tensor-map encode or launch returns its error code; nothing
// falls back to another tile.

#include <algorithm>
#include <climits>

#include "gemm_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace gemm = tdt::gemm;

// One block, one (BM x BN) tile of group blockIdx.z.
template <class Tile, typename TO>
__global__ void __launch_bounds__(Tile::NT)
    grouped_tile_kernel(const typename Tile::In* __restrict__ a,
                        const typename Tile::In* __restrict__ b,
                        TO* __restrict__ out, int M, int N, int K) {
  __shared__ typename Tile::Smem sm;
  const int e = blockIdx.z;
  Tile::run(sm, a + (size_t)e * M * K, b + (size_t)e * K * N,
            out + (size_t)e * M * N, M, N, K, blockIdx.x * Tile::BM,
            blockIdx.y * Tile::BN, false);
}

template <class Tile, typename TO>
void launch(const typename Tile::In* a, const typename Tile::In* b, TO* out,
            int E, int M, int N, int K, cudaStream_t s) {
  const dim3 grid((M + Tile::BM - 1) / Tile::BM,
                  (N + Tile::BN - 1) / Tile::BN, E);
  grouped_tile_kernel<Tile, TO><<<grid, Tile::NT, 0, s>>>(a, b, out, M, N, K);
}

// bf16 operands off 16-byte rows: the `mma.sync` tile, loads by element.
template <typename TO>
void dispatch_bf16(const bf16* a, const bf16* b, TO* out, int E, int M,
                   int N, int K, cudaStream_t s) {
  if (M <= 16)
    launch<gemm::Bf16Tile16>(a, b, out, E, M, N, K, s);
  else if (M <= 64)
    launch<gemm::Bf16Tile64>(a, b, out, E, M, N, K, s);
  else
    launch<gemm::Bf16Tile128>(a, b, out, E, M, N, K, s);
}

namespace wg = tdt::wgmma;
using WgTile64 = wg::Tile<1, 5>;
using WgTile128 = wg::Tile<2, 4>;

// Persistent blocks over every (BM x 256) tile of every group.  Compiled
// for 384 threads (168 registers a thread at entry, so the consumers'
// `setmaxnreg` rises from there) and launched with Tile::NT.
template <class Tile, typename TO>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    wgmma_grouped_kernel(const __grid_constant__ CUtensorMap ta,
                         const __grid_constant__ CUtensorMap tb,
                         TO* __restrict__ out, int M, int N, int K,
                         int ntiles) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const int mt = (M + Tile::BM - 1) / Tile::BM;
  const int nt = (N + wg::BN - 1) / wg::BN;
  Tile::run(smem, &ta, &tb, out, M, N, K, ntiles, [=](int t) {
    return make_int3(t % mt * Tile::BM, t / mt % nt * wg::BN, t / (mt * nt));
  });
}

template <class Tile, typename TO>
int launch_wgmma(const bf16* a, const bf16* b, TO* out, int E, int M, int N,
                 int K, cudaStream_t s) {
  CUtensorMap ta, tb;
  int rc = wg::encode_3d(&ta, a, K, M, E, wg::BK, Tile::BM);
  if (rc == 0) rc = wg::encode_3d(&tb, b, N, K, E, wg::BOX_N, wg::BK);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wgmma_grouped_kernel<Tile, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long tiles = (long long)((M + Tile::BM - 1) / Tile::BM) *
                          ((N + wg::BN - 1) / wg::BN) * E;
  if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  wgmma_grouped_kernel<Tile, TO>
      <<<(int)std::min<long long>(tiles, sms), Tile::NT, Tile::SMEM_BYTES,
         s>>>(ta, tb, out, M, N, K, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch_wgmma(const bf16* a, const bf16* b, TO* out, int E, int M,
                   int N, int K, cudaStream_t s) {
  return M <= wg::WG_ROWS
             ? launch_wgmma<WgTile64>(a, b, out, E, M, N, K, s)
             : launch_wgmma<WgTile128>(a, b, out, E, M, N, K, s);
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
    const bool vec = K % 8 == 0 && N % 8 == 0 &&
                     reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(b) % 16 == 0;
    if (out_dtype != tdt::DTYPE_BF16 && out_dtype != tdt::DTYPE_F32)
      return (int)cudaErrorInvalidValue;
    if (K == 0)  // an empty sum: no tensor map has a zero extent
      return (int)cudaMemsetAsync(
          out, 0, (size_t)E * M * N * (out_dtype == tdt::DTYPE_BF16 ? 2 : 4),
          s);
    if (vec)
      return out_dtype == tdt::DTYPE_BF16
                 ? dispatch_wgmma(ap, bp, static_cast<bf16*>(out), E, M, N,
                                  K, s)
                 : dispatch_wgmma(ap, bp, static_cast<float*>(out), E, M, N,
                                  K, s);
    if (out_dtype == tdt::DTYPE_BF16)
      dispatch_bf16(ap, bp, static_cast<bf16*>(out), E, M, N, K, s);
    else
      dispatch_bf16(ap, bp, static_cast<float*>(out), E, M, N, K, s);
  } else if (in_dtype == tdt::DTYPE_F32) {
    const float* ap = static_cast<const float*>(a);
    const float* bp = static_cast<const float*>(b);
    if (out_dtype == tdt::DTYPE_BF16)
      launch<gemm::F32Tile>(ap, bp, static_cast<bf16*>(out), E, M, N, K, s);
    else if (out_dtype == tdt::DTYPE_F32)
      launch<gemm::F32Tile>(ap, bp, static_cast<float*>(out), E, M, N, K, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
