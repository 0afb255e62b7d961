// GEMM-ReduceScatter: rank c of a team of W gets out_c = sum over ranks r
// of rows chunk c of (a_r @ b_r), each rank's partial rounded to the
// activations' type before the sum, the sum taken in f32 in rank order.
//
// Replaces: triton_distributed_tpu/kernels/gemm_reduce_scatter.py
//   `gemm_rs` -> pallas_call :292: `_gemm_rs_fused_kernel` (:99) and
//   `_gemm_rs_ll_kernel` (:147, over reduce_scatter.py
//   `emit_scatter_reduce` :144).  Layouts are the JAX wrapper's per rank:
//   a_r (W * mcp, k) as W row chunks, b_r (k, n), the receive buffer rbuf_r
//   (W, mcp, n) whose slot w holds rank w's partial of chunk r, and out_r
//   (mcp, n).  The JAX kernels' staging and receive buffers hold a's dtype,
//   so a partial is rounded to it before the f32 sum (`_emit_reduce_sum`
//   :94); this kernel rounds in its GEMM epilogue.
//
// What bounds it on the H100: Qwen3-8B prefill at world 4 multiplies 2048
// rows of 1024 (O projection) or 3072 (down) by b_r of (k_loc, 4096): 17.2
// / 51.5 GFLOP a rank, the tensor cores; a decode step's 4 rows stream b_r:
// bytes.  On one card the scatter's copies and the reduce's reads take HBM
// bandwidth that NVLink would carry between cards.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`; see ag_gemm.cu): blockIdx.y is the rank,
// P persistent blocks a rank stride over its GEMM tiles (`gemm_tile.cuh`)
// and share its copies and its reduce.
// - `fused`: the entry barrier; for s = 0 .. W-1 the chunk c = (r + 1 + s)
//   mod W (the JAX order: remote chunks first, the own chunk last), its
//   tiles stored by the GEMM epilogue straight into slot r of rank c's
//   rbuf, then one arrival signal a block to rank c; then the wait for all
//   W partials of the own chunk, and the reduce.
// - `ll`: the entry barrier; one GEMM over all W * mcp rows into the
//   rank's own staging buffer (b_r read once: the decode regime); the rank's
//   blocks wait for each other; the scatter of chunk c to slot r of rank
//   c's rbuf; the wait and the reduce (`emit_scatter_reduce`).
// Padded rows (the wrapper pads each chunk to the row tile with zeros)
// stay in their chunk's padded rows in every partial, so they are summed
// only into padded output rows, which the wrapper slices off.

#include "comm_body.cuh"
#include "gemm_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;

template <typename T>
struct RsArgs {
  const T* a;           // (R, W * mcp, k): the launched ranks' rows
  const T* b;           // (R, k, n): their weight shards
  T* out;               // (R, mcp, n)
  T* stage;             // ll: (R, W * mcp, n), the partials before the scatter
  dl::Symm<char> rbuf;  // rank r's (W, mcp, n)
  dl::Symm<u64> sig;    // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int mcp, n, k, vec;
  u64 epoch;            // the instance's sum of P before this call
};

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    gemm_rs_fused_kernel(RsArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t a_chunk = (size_t)p.mcp * p.k, o_chunk = (size_t)p.mcp * p.n;
  const T* a = p.a + y * w * a_chunk;
  const T* b = p.b + (size_t)y * p.k * p.n;

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  for (int s = 0; s < w; ++s) {
    const int c = dl::peer_id(t, me + 1 + s);
    gemm::run_tiles<Tile>(sm, a + c * a_chunk, b,
                          reinterpret_cast<T*>(p.rbuf[c]) + me * o_chunk,
                          p.mcp, p.n, p.k, p.vec, part, parts);
    u64* word = p.sig[c] + dl::ARRIVAL_WORD + me;
    dl::signal_after_puts(&word, 1);
  }
  dl::wait(p.sig[me] + dl::ARRIVAL_WORD, w, 1, target,
           tdt::WAIT_GEMM_RS_PARTIAL);
  tdt::comm::reduce_sum(reinterpret_cast<const T*>(p.rbuf[me]),
                        p.out + y * o_chunk, w, o_chunk, part, parts);
}

template <class Tile>
__global__ void __launch_bounds__(Tile::NT, gemm::MIN_BLOCKS)
    gemm_rs_ll_kernel(RsArgs<typename Tile::In> p) {
  using T = typename Tile::In;
  __shared__ typename Tile::Smem sm;
  const dl::Team& t = p.team;
  const int w = t.world, y = blockIdx.y;
  const u64 target = p.epoch + gridDim.x;
  const size_t o_chunk = (size_t)p.mcp * p.n;
  T* stage = p.stage + y * w * o_chunk;

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  gemm::run_tiles<Tile>(sm, p.a + (size_t)y * w * p.mcp * p.k,
                        p.b + (size_t)y * p.k * p.n, stage, w * p.mcp, p.n,
                        p.k, p.vec, blockIdx.x, gridDim.x);
  dl::barrier_rank(t, p.sig, target);
  tdt::comm::emit_scatter_reduce<T>(t, stage, p.out + y * o_chunk, p.rbuf,
                                    o_chunk, p.sig, target,
                                    /*barrier=*/false);
}

// P blocks a rank: as many as a GEMM step has tiles, at most as many as can
// be resident together with every other rank's; then one cooperative
// launch.
template <class Tile>
int launch(RsArgs<typename Tile::In> p, int ranks, int ll, int* blocks,
           cudaStream_t s) {
  void* fn = ll ? reinterpret_cast<void*>(gemm_rs_ll_kernel<Tile>)
                : reinterpret_cast<void*>(gemm_rs_fused_kernel<Tile>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Tile::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = gemm::tiles<Tile>(ll ? p.team.world * p.mcp : p.mcp, p.n);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Tile::NT),
                                          args, 0, s);
}

template <typename T>
int dispatch(RsArgs<T> p, int ranks, int ll, int* blocks, cudaStream_t s);

template <>
int dispatch<bf16>(RsArgs<bf16> p, int ranks, int ll, int* blocks,
                   cudaStream_t s) {
  const int rows = ll ? p.team.world * p.mcp : p.mcp;
  if (rows <= 16) return launch<gemm::Bf16Tile16>(p, ranks, ll, blocks, s);
  if (rows <= 64) return launch<gemm::Bf16Tile64>(p, ranks, ll, blocks, s);
  return launch<gemm::Bf16Tile128>(p, ranks, ll, blocks, s);
}

template <>
int dispatch<float>(RsArgs<float> p, int ranks, int ll, int* blocks,
                    cudaStream_t s) {
  return launch<gemm::F32Tile>(p, ranks, ll, blocks, s);
}

template <typename T>
int run(const void* a, const void* b, void* out, void* stage,
        void* const* rbuf, void* const* sig, int world, int base, int ranks,
        int ll, int mcp, int n, int k, u64 epoch, int* blocks,
        cudaStream_t s) {
  RsArgs<T> p{};
  p.a = static_cast<const T*>(a);
  p.b = static_cast<const T*>(b);
  p.out = static_cast<T*>(out);
  p.stage = static_cast<T*>(stage);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r) {
    p.rbuf.ptr[r] = static_cast<char*>(rbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
  }
  p.team = dl::Team{world, base};
  p.mcp = mcp;
  p.n = n;
  p.k = k;
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  p.epoch = epoch;
  return dispatch<T>(p, ranks, ll, blocks, s);
}

}  // namespace

// a (ranks, world * mcp, k) and b (ranks, k, n): the launched ranks' rows
// and weight shards (ranks base .. base + ranks - 1 of a team of
// ``world``); out (ranks, mcp, n); ``stage`` (ranks, world * mcp, n), read
// and written by the ``ll`` method only; ``rbuf`` and ``sig``: host tables
// of ``world`` device pointers, rank r's (world, mcp, n) receive buffer and
// its dl::SIGNAL_WORDS u64 counters; all contiguous, in ``dtype``
// (tdt::DTYPE_*) but the counters.  ``ll``: the one-shot method, else the
// fused one.  ``epoch``: the instance's sum of blocks a rank over its
// earlier calls; the blocks a rank of this launch go to ``*blocks``.
// Returns a cudaError_t code.
extern "C" int gemm_rs(const void* a, const void* b, void* out, void* stage,
                       void* const* rbuf, void* const* sig, int world,
                       int base, int ranks, int ll, int dtype, int mcp, int n,
                       int k, unsigned long long epoch, int* blocks,
                       void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || ranks < 1 || base < 0 ||
      base + ranks > world || mcp < 1 || n < 1 || k < 1 ||
      (ll && stage == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return run<bf16>(a, b, out, stage, rbuf, sig, world, base, ranks, ll,
                     mcp, n, k, epoch, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return run<float>(a, b, out, stage, rbuf, sig, world, base, ranks, ll,
                      mcp, n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
