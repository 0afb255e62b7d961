// W8A8 matmul: int8 x int8 -> int32 on the tensor cores, then a rank-1 f32
// dequant epilogue, out[m, n] = (float(acc[m, n]) * sa[m]) * sb[n], written
// in bf16 or f32.
//
// Replaces: triton_distributed_tpu/kernels/quantized.py `matmul_w8a8` ->
//   `_w8a8_kernel` (pallas_call :120).  The layouts are the JAX package's
//   but for b: a (m, k) int8 row-major, sa (m,) and sb (n,) f32, and b read
//   as its (n, k) K-major form (the wrapper takes b (k, n) as the transpose
//   of a contiguous (n, k) tensor, which the layers store once, or makes
//   that copy).  The epilogue multiplies in the TPU kernel's order (:85-86)
//   and int32 accumulation is exact, so the result is bit-identical to an
//   exact plain product with the same epilogue.
//
// What bounds it on the H100: at the Qwen3-8B MLP shapes in a prefill
// bucket (m = 2048, k = 4096, n = 24576) the operations, 412 GOP at
// 1,979 TOP/s of int8 tensor cores (0.21 ms) against 208 MB of operands
// and output (0.06 ms at 3.35 TB/s); in a decode batch (m = 8) the bytes of
// b, which are nearly all of the 100 MB moved (0.03 ms), against 1.6 GOP.
//
// Design: the Hopper tile of `wgmma_tile.cuh` in its int8 form (`Int8Ops`):
// TMA loads of a (k, m) and b (k, n) boxes of 128 k bytes with 128-byte
// swizzle into a ring, one producer thread, consumer warpgroups of 64 rows
// on `wgmma m64nNk32.s32.s8.s8` (both operands K-major: the instruction
// has no transpose for 8-bit types, which is why b is stored (n, k)),
// int32 accumulators, persistent blocks.  The tile and the k split follow
// the shape (`quantized.plan_w8a8`, a planner in Python the CPU tests hold);
// int32 sums are exact, so neither changes a bit:
// - `rows` 128 (two consumer warpgroups, 128 x 256 tiles, 4 stages of 48
//   KB) above 64 rows; 64 (one warpgroup, 64 x 128 tiles, 8 stages) for
//   decode batches, whose cost is the stream of b.
// - A k split of `split` ranges of `per` stages: each (split, tile) unit's
//   consumers store their int32 sums into the split's slice of a workspace
//   (split, M, N), and a second kernel (`split_epilogue`) sums each
//   element's slices in split order (exact) and runs the epilogue.  It
//   spreads the 8-row down projection's 32 column tiles of 128 over 128
//   units on 132 SMs.  (Sums added in place by `red.global.add`, the last
//   block of a tile found by a counter and two fences, doing the epilogue,
//   took 2.5-3.5x the split's loads at 8 rows, with 1.4 KB spilled in the
//   consumers: `scripts/torch_w8a8_ab.py`.)
// - Units walk split fastest, then row tile, then column tile, so blocks
//   that run together share a b tile (read from device memory about once)
//   and a stays in L2.
// - The epilogue: `dequant` of each accumulator in place, then, on 16-byte
//   rows of out, through a 2 KB swizzled slab a warp as 16-byte row pieces
//   (K14's `store_pieces_of`: 64 bf16 or 32 f32 columns a slab); other rows
//   as fragment pairs or elements (`store_frag`).
// Ragged shapes: TMA reads zeros past m, n and k, which add nothing to an
// int32 sum; rows past m and columns past n are not written.  k is a
// multiple of 16 (TMA's 16-byte strides); a, b and out 16-byte aligned.

#include <algorithm>
#include <climits>

#include "wgmma_epilogue.cuh"

namespace {

namespace wg = tdt::wgmma;
using bf16 = __nv_bfloat16;
using wg::Int8Ops;

//: The two tiles: 128 x 256 (prefill) and 64 x 128 (decode).
using Tile128 = wg::Tile<2, 4, 256, 1, Int8Ops>;
using Tile64 = wg::Tile<1, 8, 128, 1, Int8Ops>;

struct Args {
  CUtensorMap ta;   // a (M, K) as (k, m, 1)
  CUtensorMap tb;   // b (N, K) as (k, n, 1)
  const float* sa;  // (M,)
  const float* sb;  // (N,)
  void* out;        // (M, N)
  int* ws;          // (split, M, N) int32: the k split's partial sums
  int M, N, mt, nt, nk, split, per;
  int slabs;        // out on 16-byte rows: the slab epilogue
};

template <class Tile, typename TO>
struct Sched {
  const Args* p;
  uint8_t* slab0;  // consumer warp w's slab at slab0 + w SLAB_BYTES

  // Unit t: split t % split, then row tile, then column tile.
  __device__ __forceinline__ wg::At at(int t) const {
    const int s = t % p->split, rest = t / p->split;
    const int kt0 = s * p->per;
    return {&p->ta, rest % p->mt * Tile::BM, 0, rest / p->mt * Tile::TN, 0,
            min(p->per, p->nk - kt0), 0, kt0};
  }
  __device__ __forceinline__ bool pending(int) const { return false; }
  __device__ __forceinline__ void ready(int) {}
  __device__ __forceinline__ void side(int) {}

  // With a k split: this unit's int32 sums into split t % split's slice of
  // the workspace, as fragment pairs (rows past M and columns past N
  // dropped).
  __device__ __forceinline__ void store_partial(int t, const wg::At& w,
                                                int wgi,
                                                const int (&acc)[Tile::ACC]) {
    const int M = p->M, N = p->N;
    int* ws = p->ws + (size_t)(t % p->split) * M * N;
    const int lane = threadIdx.x % 32;
    const int r = w.a_row + wgi * wg::WG_ROWS +
                  threadIdx.x % wg::WG / 32 * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < Tile::ACC / 4; ++j) {
      const int c = w.col + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r + 8 * h;
        if (row >= M || c >= N) continue;
        int* q = ws + (size_t)row * N + c;
        if (c + 1 < N && N % 2 == 0) {
          *reinterpret_cast<int2*>(q) =
              make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        } else {
          q[0] = acc[4 * j + 2 * h];
          if (c + 1 < N) q[1] = acc[4 * j + 2 * h + 1];
        }
      }
    }
  }

  __device__ __forceinline__ void store(int t, const wg::At& w, int wgi,
                                        int (&acc)[Tile::ACC]) {
    if (p->split > 1) {
      store_partial(t, w, wgi, acc);
      return;
    }
    const int row0 = w.a_row + wgi * wg::WG_ROWS;
    wg::dequant_box(acc, p->sa, p->M, row0, p->sb, w.col, p->N);
    const auto val = [&](int i) { return __int_as_float(acc[i]); };
    TO* out = static_cast<TO*>(p->out);
    if (p->slabs) {
      TO* rows[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = row0 + wg::piece_row(k);
        rows[k] = row < p->M ? out + (size_t)row * p->N : nullptr;
      }
      wg::store_pieces_of<Tile::ACC>(
          slab0 + threadIdx.x / 32 * wg::SLAB_BYTES, val, rows, w.col, p->N);
      return;
    }
    wg::store_frag<Tile::ACC>(out, p->M, p->N, row0, w.col, val);
  }
};

//: Dynamic shared memory: the consumer warps' slabs, then the ring.
template <class Tile>
constexpr int smem_bytes() {
  return (Tile::NT / wg::WG - 1) * 4 * wg::SLAB_BYTES + Tile::SMEM_BYTES;
}

// Persistent blocks over every unit.  Compiled for 384 threads (168
// registers a thread at entry, so the consumers' `setmaxnreg` rises from
// there) and launched with Tile::NT.
template <class Tile, typename TO>
__global__ void __launch_bounds__(3 * wg::WG, 1)
    w8a8_wgmma_kernel(const __grid_constant__ Args p, int units) {
  extern __shared__ __align__(1024) uint8_t smem[];
  constexpr int SLABS = (Tile::NT / wg::WG - 1) * 4 * wg::SLAB_BYTES;
  Tile::run(smem + SLABS, &p.tb, units, Sched<Tile, TO>{&p, smem});
}

// The k split's epilogue: out[i] = dequant(the sum over the splits, in
// order, of ws[s][i]) for every element i < M N, a thread each.
template <typename TO>
__global__ void __launch_bounds__(256)
    w8a8_split_epilogue(const int* __restrict__ ws, int split,
                        const float* __restrict__ sa,
                        const float* __restrict__ sb, TO* __restrict__ out,
                        int M, int N) {
  const size_t elems = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < elems;
       i += (size_t)gridDim.x * blockDim.x) {
    int acc = 0;
    for (int k = 0; k < split; ++k) acc += __ldg(ws + k * elems + i);
    tdt::store1(out + i, wg::dequant(acc, __ldg(sa + i / N),
                                     __ldg(sb + i % N)));
  }
}

template <class Tile, typename TO>
int launch_tile(Args& p, const void* a, const void* b, int K, cudaStream_t s) {
  p.mt = (p.M + Tile::BM - 1) / Tile::BM;
  p.nt = (p.N + Tile::TN - 1) / Tile::TN;
  int rc = wg::encode_3d(&p.ta, a, K, p.M, 1, Tile::KS, Tile::BM, 1);
  if (rc == 0)
    rc = wg::encode_3d(&p.tb, b, K, p.N, 1, Tile::KS, wg::BOX_N, 1);
  if (rc != 0) return rc;
  auto* fn = w8a8_wgmma_kernel<Tile, TO>;
  constexpr int SMEM = smem_bytes<Tile>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long units = (long long)p.mt * p.nt * p.split;
  if (units > INT_MAX) return (int)cudaErrorInvalidValue;
  fn<<<(int)std::min<long long>(units, sms), Tile::NT, SMEM, s>>>(p,
                                                                  (int)units);
  if (p.split > 1) {
    const long long elems = (long long)p.M * p.N;
    w8a8_split_epilogue<TO><<<(int)std::min<long long>(
                                  (elems + 255) / 256, 8LL * sms),
                              256, 0, s>>>(p.ws, p.split, p.sa, p.sb,
                                           static_cast<TO*>(p.out), p.M,
                                           p.N);
  }
  return (int)cudaGetLastError();
}

template <typename TO>
int dispatch(Args& p, const void* a, const void* b, int K, int rows,
             cudaStream_t s) {
  if (rows == 128) return launch_tile<Tile128, TO>(p, a, b, K, s);
  if (rows == 64) return launch_tile<Tile64, TO>(p, a, b, K, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a (M, K) int8 row-major; bt (N, K) int8 row-major (b's K-major form); sa
// (M,) and sb (N,) f32; out (M, N) in out_dtype (tdt::DTYPE_*); a, bt and
// out 16-byte aligned, K a positive multiple of 16.  The plan
// (`quantized.plan_w8a8`): the tile of ``rows`` (128 x 256 or 64 x 128)
// and k in ``split`` ranges of ``per`` stages of 128; with split > 1, ws
// (split, M, N) int32 scratch.  Returns a cudaError_t code.
extern "C" int matmul_w8a8(const void* a, const void* bt, const void* sa,
                           const void* sb, void* out, int out_dtype, int M,
                           int N, int K, int rows, int split, int per,
                           void* ws, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int nk = (K + Int8Ops::K_STAGE - 1) / Int8Ops::K_STAGE;
  if (M < 0 || N < 0 || K <= 0 || K % 16 || split < 1 || per < 1 ||
      (long long)split * per < nk || (long long)(split - 1) * per >= nk ||
      (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(bt) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return (int)cudaErrorInvalidValue;
  Args p{};
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.M = M;
  p.N = N;
  p.nk = nk;
  p.split = split;
  p.per = per;
  p.slabs = N % (out_dtype == tdt::DTYPE_BF16 ? 8 : 4) == 0;  // 16-B rows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == tdt::DTYPE_BF16)
    return dispatch<bf16>(p, a, bt, K, rows, s);
  if (out_dtype == tdt::DTYPE_F32)
    return dispatch<float>(p, a, bt, K, rows, s);
  return (int)cudaErrorInvalidValue;
}
