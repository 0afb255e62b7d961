// Grouped GEMM + top-k weighted combine + ReduceScatter, the MoE
// tensor-parallel epilogue: rank c of a team of W gets out_c = sum over
// ranks r of combine_c(buckets_r[c] @ down_r), the sum taken in f32 in rank
// order of the partials rounded to the activations' type.
//
// Replaces: triton_distributed_tpu/kernels/moe_reduce_rs.py
//   `moe_reduce_rs_fused` -> pallas_call :396 (`_moe_rs_fused_kernel`
//   :128, and the two-phase `_moe_rs_fused_kernel_2p` :199), with float or
//   int8 weights, over grouped_gemm.py `emit_packed_combine` (:391),
//   `emit_packed_matmul` (:514) and `emit_packed_combine_matmul` (:606).
//   Layouts are the JAX wrapper's per rank: the activated buckets of every
//   chunk (W, E, cap, k) (int8 with per-token scales (W, E, cap)), the
//   down-projection shard (E, k, n) (int8 with (E, n) scales), the packed
//   plan's tables `block_expert` / `block_slot` (W, T) and `n_blocks` (W,)
//   (moe_utils.plan_chunks), the receive buffer (W, mc, n) and out (mc, n).
//   The TPU kernel combines with a dense one-hot matmul of the per-block
//   weights `combine_blocks` (T, B, mc); here each token's kept pairs are a
//   table (W, mc, topk) of rows of the packed stage and their weights in the
//   activations' type, which the wrapper reads off the plan
//   (`moe_utils.combine_pairs`: routing metadata, as JAX builds
//   `combine_blocks` in XLA).  The TPU's choice between the single-phase
//   and the two-phase kernel is a VMEM ceiling that has no counterpart
//   here: one design serves both.
//
// What bounds it on the H100: Qwen3-30B-A3B prefill at world 4 (mc = 512,
// 128 experts of cap 64, blocks of 64 rows, k = 192 a rank, n = 2048): the
// weights, 128 x 192 x 2048 bf16 = 101 MB a rank read for each chunk that
// uses them, and the down GEMM over the occupied blocks (at most 4 x 128 x
// 64 x 192 x 2048 x 2 = 25.8 GFLOP a rank).  The combine reads at most
// topk stage rows a token: 4 x 512 x 8 x 2048 x 2 = 67 MB a rank, not the
// TPU's ~69 GFLOP one-hot product.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`; blockIdx.y is the rank); P blocks a rank.
// The entry barrier; then for s = 0 .. W-1 the chunk c = (r + 1 + s) mod W
// (JAX :158: remote chunks first, the own chunk last):
// 1. the packed grouped GEMM: the blocks stride over (occupied block t <
//    n_blocks[c], column tile), rows block_slot[t] B .. of expert
//    block_expert[t], each tile rounded to the activations' type into the
//    rank's packed stage (T B, n) (JAX :466-470: the combine runs in the
//    activations' type); int8 accumulates in int32 and dequantizes with
//    the per-token and per-channel scales (float(acc) * sa) * sw.  The tile
//    is K8's (`gemm_tile.cuh`, 16/64/128 rows by B; f32 on the CUDA cores)
//    or K7's (`w8a8_body.cuh`).
// 2. the rank's blocks wait for each other (`dl::barrier_rank`): the
//    stage is whole.
// 3. the combine: each token's <= topk kept pairs, in ascending expert
//    order (the order in which the TPU's one-hot combine meets the blocks),
//    weight times stage row in f32, summed in f32, rounded to the
//    activations' type and stored straight into slot r of rank c's receive
//    buffer; one arrival signal a block to rank c.
// Chunks alternate between two stages, so a block that runs ahead into
// chunk s + 1 never overwrites rows a slower block still combines for
// chunk s, and one barrier a chunk is enough (a block reaches the GEMM of
// s + 2 only after every block has left the combine of s).  Last, the wait
// for the W partials of the own chunk and their f32 sum in rank order
// (`comm_body.cuh` `reduce_sum`, JAX `_emit_reduce_sum`).  The result does
// not depend on the number of blocks or their timing: back-to-back calls
// are bit-identical.

#include "comm_body.cuh"
#include "tile_body.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;
namespace body = tdt::body;
namespace comm = tdt::comm;

template <class Body>
struct Args {
  using T = typename Body::Out;
  const typename Body::In* a;  // (R, W, E, cap, k): every chunk's buckets
  const typename Body::In* b;  // (R, E, k, n): the down shards
  const float* sa;             // int8: (R, W, E, cap)
  const float* sb;             // int8: (E, n)
  const int* bexp;             // (W, T)
  const int* bslot;            // (W, T)
  const int* nblk;             // (W,)
  const int* rows;             // (W, mc, topk): stage rows, -1 past the kept
  const T* weights;            // (W, mc, topk)
  T* stage;                    // (R, 2, T B, n)
  T* out;                      // (R, mc, n)
  dl::Symm<char> rbuf;         // rank r's (W, mc, n)
  dl::Symm<u64> sig;           // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int e, cap, k, n, mc, tmax, block, topk, vec;
  u64 epoch;                   // the instance's sum of P before this call
};

// Token i's combine over columns [col, col + cnt) (cnt 8 with vec8, else
// 1) into out_row.
template <typename T>
__device__ __forceinline__ void combine_cols(const T* stage, const int* rows,
                                             const T* w, int topk, int n,
                                             int col, bool vec8, T* out_row) {
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int kk = 0; kk < topk; ++kk) {
    const int r = rows[kk];
    if (r < 0) break;
    const float wv = tdt::comm::load1_cg(w + kk);
    const T* src = stage + (size_t)r * n + col;
    if (vec8) {
      float v[8];
      comm::load8_cg(src, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wv, v[j]));
    } else {
      acc[0] = __fadd_rn(acc[0], __fmul_rn(wv, comm::load1_cg(src)));
    }
  }
  if (vec8)
    comm::store8(out_row + col, acc);
  else
    tdt::store1(out_row + col, acc[0]);
}

template <class Body>
__global__ void __launch_bounds__(Body::NT, gemm::MIN_BLOCKS)
    moe_reduce_rs_kernel(Args<Body> p) {
  using In = typename Body::In;
  using T = typename Body::Out;
  __shared__ __align__(16) typename Body::Smem sm;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), w = t.world, y = blockIdx.y;
  const int part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t bucket = (size_t)p.e * p.cap;        // rows of one chunk
  const size_t stage_elems = (size_t)p.tmax * p.block * p.n;
  const size_t o_chunk = (size_t)p.mc * p.n;
  const In* b = p.b + (size_t)y * p.e * p.k * p.n;
  const int ntn = (p.n + Body::BN - 1) / Body::BN;
  const int mtb = (p.block + Body::BM - 1) / Body::BM;  // row tiles a block
  const bool vec8 = p.n % 8 == 0;
  const int ng = vec8 ? p.n / 8 : p.n;                  // column units a row

  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/false);
  for (int s = 0; s < w; ++s) {
    const int c = dl::peer_id(t, me + 1 + s);
    const size_t chunk = (size_t)y * w + c;
    const In* a = p.a + chunk * bucket * p.k;
    const float* sa = p.sa ? p.sa + chunk * bucket : nullptr;
    T* stage = p.stage + ((size_t)y * 2 + (s & 1)) * stage_elems;
    const int* bexp = p.bexp + (size_t)c * p.tmax;
    const int* bslot = p.bslot + (size_t)c * p.tmax;
    // 1. the packed grouped GEMM over the chunk's occupied blocks.
    const int tiles = p.nblk[c] * mtb;
    for (int j = part; j < tiles * ntn; j += parts) {
      const int tb = j % tiles, nt = j / tiles;
      const int blk = tb / mtb, ex = bexp[blk];
      const size_t row0 = (size_t)ex * p.cap + (size_t)bslot[blk] * p.block;
      __syncthreads();
      Body::run(sm, a + row0 * p.k, b + (size_t)ex * p.k * p.n,
                sa ? sa + row0 : nullptr, p.sb ? p.sb + (size_t)ex * p.n : nullptr,
                stage + (size_t)blk * p.block * p.n, p.block, p.n, p.k,
                (tb % mtb) * Body::BM, nt * Body::BN, p.vec);
    }
    // 2. the stage is whole: the (s + 1)-th of this call's W barriers.
    dl::barrier_rank(t, p.sig, (u64)w * p.epoch + (u64)(s + 1) * gridDim.x);
    // 3. the combine, into slot me of rank c's receive buffer.
    T* dst = reinterpret_cast<T*>(p.rbuf[c]) + me * o_chunk;
    const int* rows = p.rows + (size_t)c * p.mc * p.topk;
    const T* wts = p.weights + (size_t)c * p.mc * p.topk;
    const size_t units = (size_t)p.mc * ng;
    for (size_t u = (size_t)part * blockDim.x + threadIdx.x; u < units;
         u += (size_t)parts * blockDim.x) {
      const size_t i = u / ng;
      const int col = (int)(u % ng) * (vec8 ? 8 : 1);
      combine_cols(stage, rows + i * p.topk, wts + i * p.topk, p.topk, p.n,
                   col, vec8, dst + i * p.n);
    }
    u64* word = p.sig[c] + dl::ARRIVAL_WORD + me;
    dl::signal_after_puts(&word, 1);
  }
  dl::wait(p.sig[me] + dl::ARRIVAL_WORD, w, 1, target,
           "moe_reduce_rs partial arrival");
  comm::reduce_sum(reinterpret_cast<const T*>(p.rbuf[me]), p.out + y * o_chunk,
                   w, o_chunk, part, parts);
}

// P blocks a rank: as many as the dense block grid of a chunk has tiles, at
// most as many as can be resident together with every other rank's; then
// one cooperative launch.
template <class Body>
int launch(Args<Body> p, int ranks, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(moe_reduce_rs_kernel<Body>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Body::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = p.tmax * ((p.block + Body::BM - 1) / Body::BM) *
                   ((p.n + Body::BN - 1) / Body::BN);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Body::NT),
                                          args, 0, s);
}

struct Raw {
  const void *a, *b, *sa, *sb, *bexp, *bslot, *nblk, *rows, *weights;
  void *stage, *out;
  void* const* rbuf;
  void* const* sig;
  int world, e, cap, k, n, mc, tmax, block, topk;
  u64 epoch;
};

template <class Body>
int run(const Raw& r, int* blocks, cudaStream_t s) {
  using T = typename Body::Out;
  Args<Body> p{};
  p.a = static_cast<const typename Body::In*>(r.a);
  p.b = static_cast<const typename Body::In*>(r.b);
  p.sa = static_cast<const float*>(r.sa);
  p.sb = static_cast<const float*>(r.sb);
  p.bexp = static_cast<const int*>(r.bexp);
  p.bslot = static_cast<const int*>(r.bslot);
  p.nblk = static_cast<const int*>(r.nblk);
  p.rows = static_cast<const int*>(r.rows);
  p.weights = static_cast<const T*>(r.weights);
  p.stage = static_cast<T*>(r.stage);
  p.out = static_cast<T*>(r.out);
  uintptr_t align = reinterpret_cast<uintptr_t>(r.a) |
                    reinterpret_cast<uintptr_t>(r.b);
  for (int i = 0; i < r.world; ++i) {
    p.rbuf.ptr[i] = static_cast<char*>(r.rbuf[i]);
    p.sig.ptr[i] = static_cast<u64*>(r.sig[i]);
  }
  p.team = dl::Team{r.world, 0};
  p.e = r.e;
  p.cap = r.cap;
  p.k = r.k;
  p.n = r.n;
  p.mc = r.mc;
  p.tmax = r.tmax;
  p.block = r.block;
  p.topk = r.topk;
  p.vec = r.k % 8 == 0 && r.n % 8 == 0 && align % 16 == 0;
  p.epoch = r.epoch;
  return launch<Body>(p, r.world, blocks, s);
}

int run_bf16(const Raw& r, int* blocks, cudaStream_t s) {
  if (r.block <= 16) return run<body::Float<gemm::Bf16Tile16, bf16>>(r, blocks, s);
  if (r.block <= 64) return run<body::Float<gemm::Bf16Tile64, bf16>>(r, blocks, s);
  return run<body::Float<gemm::Bf16Tile128, bf16>>(r, blocks, s);
}

}  // namespace

// a (world, world, E, cap, k): rank r's buckets of every chunk, in
// ``dtype`` (tdt::DTYPE_*), or int8 when ``int8`` (then sa (world, world,
// E, cap) and sb (E, n) f32 scales); b (world, E, k, n) in ``dtype`` or
// int8; bexp, bslot (world, T) and nblk (world,) int32, the packed plan;
// rows (world, mc, topk) int32 and weights (world, mc, topk) in ``dtype``,
// each token's stage rows and combine weights; stage (world, 2, T block,
// n) and out (world, mc, n) in ``dtype``; ``rbuf`` and ``sig``: host tables
// of ``world`` device pointers, rank r's (world, mc, n) receive buffer and
// its dl::SIGNAL_WORDS u64 counters; all contiguous.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a rank
// of this launch go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int moe_reduce_rs(const void* a, const void* b, const void* sa,
                             const void* sb, const void* bexp,
                             const void* bslot, const void* nblk,
                             const void* rows, const void* weights,
                             void* stage, void* out, void* const* rbuf,
                             void* const* sig, int world, int int8, int dtype,
                             int e, int cap, int k, int n, int mc, int tmax,
                             int block, int topk, unsigned long long epoch,
                             int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || k < 1 ||
      n < 1 || mc < 1 || tmax < 1 || block < 1 || cap % block || topk < 1 ||
      (int8 && (sa == nullptr || sb == nullptr || k % 16)))
    return (int)cudaErrorInvalidValue;
  const Raw r{a, b, sa, sb, bexp, bslot, nblk, rows, weights, stage, out,
              rbuf, sig, world, e, cap, k, n, mc, tmax, block, topk, epoch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return int8 ? run<body::Int8<bf16>>(r, blocks, s) : run_bf16(r, blocks, s);
  if (dtype == tdt::DTYPE_F32)
    return int8 ? run<body::Int8<float>>(r, blocks, s)
                : run<body::Float<gemm::F32Tile, float>>(r, blocks, s);
  return (int)cudaErrorInvalidValue;
}
