// AllGather-GEMM on int8 rows: out_r = dequant(all_gather(a_q) @ b_r) on
// every rank r of a team of W, int32 accumulation, then (float(acc) *
// sa[row]) * sb_r[col] in the activations' type.
//
// Replaces: triton_distributed_tpu/kernels/allgather_gemm.py `ag_gemm_w8a8`
//   -> pallas_call :440 (`_ag_gemm_w8a8_kernel` :369: K12's ring
//   `_emit_ag_ring` carrying int8 chunks, each held chunk run through
//   quantized.py `emit_matmul_w8a8` :161).  Layouts are the JAX wrapper's
//   per rank: the quantized shard a_q (mp, k) int8 (rows padded to 32 with
//   zeros), the weight shard b_r (k, n) int8, every rank's per-row scales
//   (W, mp) f32 (gathered outside the kernel, as JAX gathers them in XLA),
//   sb_r (n,) f32, the gathered rows (W, mp, k) and out_r (W * mp, n).
//
// What bounds it on the H100: `TPMLP(4096, 12288, mode="w8a8")` at world 4
// on 2048 rows (512 a rank): the gate_up product, 2 x 2048 x 4096 x 6144 =
// 103 GOP a rank on the int8 tensor cores (0.052 ms at 1,979 TOP/s)
// against 25 MB of weights a rank; on 8 rows, the weights.  On one card the
// ring's copies (3 x 2 MB a rank) are copies inside one HBM.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`; blockIdx.y is the rank); the ring is K12's
// (`comm_body.cuh` `emit_ag_ring`) on int8 chunks, half the bytes of bf16;
// on each held chunk the P blocks of a rank stride over its 128 x 128
// output tiles and run the first int8 tile (`w8a8_body.cuh` `tdt::w8a8::tile`,
// `mma.sync` m16n8k32, the dequant epilogue in the TPU kernel's order), so
// the result is bit-identical to an exact plain product with the same
// epilogue, whatever the chunk order.

#include "comm_body.cuh"
#include "gemm_tile.cuh"
#include "w8a8_body.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace w8a8 = tdt::w8a8;

template <typename TO>
struct Args {
  const int8_t* a;         // (R, mp, k): the launched ranks' quantized rows
  const int8_t* b;         // (R, k, n): their weight shards
  const float* sa;         // (W, mp): every rank's row scales
  const float* sb;         // (R, n)
  TO* out;                 // (R, W * mp, n)
  dl::Symm<char> gathered; // rank r's (W, mp, k)
  dl::Symm<u64> sig;       // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int mp, n, k;
  u64 epoch;               // the instance's sum of P before this call
};

template <typename TO>
__global__ void __launch_bounds__(w8a8::NT, tdt::gemm::MIN_BLOCKS)
    ag_gemm_w8a8_kernel(Args<TO> p) {
  __shared__ __align__(16) w8a8::Smem sm;
  const dl::Team& t = p.team;
  const int y = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t chunk = (size_t)p.mp * p.k, out_chunk = (size_t)p.mp * p.n;
  const int8_t* b = p.b + (size_t)y * p.k * p.n;
  const float* sb = p.sb + (size_t)y * p.n;
  TO* out = p.out + (size_t)y * t.world * out_chunk;
  const int mt = (p.mp + w8a8::BM - 1) / w8a8::BM;
  const int total = w8a8::tiles(p.mp, p.n);
  tdt::comm::emit_ag_ring(
      t, p.a + y * chunk, p.gathered, chunk, p.sig, target,
      tdt::WAIT_AG_GEMM_W8A8_RING, [&](int c, const char* held) {
        for (int j = part; j < total; j += parts) {
          __syncthreads();
          w8a8::tile(sm, reinterpret_cast<const int8_t*>(held), b,
                     p.sa + (size_t)c * p.mp, sb, out + c * out_chunk, p.mp,
                     p.n, p.k, (j % mt) * w8a8::BM, (j / mt) * w8a8::BN);
        }
      });
}

// P blocks a rank: as many as a chunk has tiles, at most as many as can be
// resident together with every other rank's; then one cooperative launch.
template <typename TO>
int launch(Args<TO> p, int ranks, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(ag_gemm_w8a8_kernel<TO>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, w8a8::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = w8a8::tiles(p.mp, p.n);
  const int P = want < fit ? want : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks),
                                          dim3(w8a8::NT), args, 0, s);
}

template <typename TO>
int run(const void* a, const void* b, const void* sa, const void* sb,
        void* out, void* const* gathered, void* const* sig, int world,
        int mp, int n, int k, u64 epoch, int* blocks, cudaStream_t s) {
  Args<TO> p{};
  p.a = static_cast<const int8_t*>(a);
  p.b = static_cast<const int8_t*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.out = static_cast<TO*>(out);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, 0};
  p.mp = mp;
  p.n = n;
  p.k = k;
  p.epoch = epoch;
  return launch<TO>(p, world, blocks, s);
}

}  // namespace

// a (world, mp, k) int8: every rank's quantized rows; b (world, k, n)
// int8; sa (world, mp) and sb (world, n) f32; out (world, world * mp, n) in
// ``out_dtype`` (tdt::DTYPE_*); ``gathered`` and ``sig``: host tables of
// ``world`` device pointers, rank r's gathered (world, mp, k) buffer and
// its dl::SIGNAL_WORDS u64 counters; all contiguous, a, b and the
// gathered buffers 16-byte aligned, k a multiple of 16.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a
// rank of this launch go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int ag_gemm_w8a8(const void* a, const void* b, const void* sa,
                            const void* sb, void* out, void* const* gathered,
                            void* const* sig, int world, int out_dtype,
                            int mp, int n, int k, unsigned long long epoch,
                            int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || mp < 1 || n < 1 || k < 16 ||
      k % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == tdt::DTYPE_BF16)
    return run<bf16>(a, b, sa, sb, out, gathered, sig, world, mp, n, k,
                     epoch, blocks, s);
  if (out_dtype == tdt::DTYPE_F32)
    return run<float>(a, b, sa, sb, out, gathered, sig, world, mp, n, k,
                      epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
