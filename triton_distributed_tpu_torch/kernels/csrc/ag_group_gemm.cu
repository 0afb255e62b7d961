// AllGather + grouped GEMM, the MoE tensor-parallel prologue: every rank r
// of a team of W gets out_r[c, e] = buckets_c[e] @ b_r[e] for every
// chunk (source rank) c and expert e, f32 (int8: int32) accumulation.
//
// Replaces: triton_distributed_tpu/kernels/allgather_group_gemm.py
//   `ag_group_gemm` -> pallas_call :172 (`_ag_group_gemm_kernel`, K11) and
//   `ag_group_gemm_w8a8` -> pallas_call :297 (`_ag_group_gemm_w8a8_kernel`,
//   K11-int8), both over the ring `_emit_ag_ring_grouped` (:67) and the
//   in-kernel grouped GEMM `emit_grouped_matmul(_w8a8)` with `count_of`
//   (grouped_gemm.py :107, :308).  Layouts are the JAX wrapper's per rank:
//   the buckets (E, cap, k), the weight shard b_r (E, k, n), the gathered
//   buckets (W, E, cap, k) and out_r (W, E, cap, n); the int8 form also
//   takes every chunk's per-token scales (W, E, cap) (gathered outside the
//   kernel, as JAX gathers them in XLA; its lane-broadcast copy is a Mosaic
//   workaround that does not carry over) and sb_r (E, n).
//
// What bounds it on the H100: Qwen3-30B-A3B prefill at world 4 (4 x 512
// rows a rank, 128 experts of cap 64, k = 2048, n = 384 a rank): the
// tensor cores on the occupied tiles (at most 4 x 128 x 64 x 2048 x 384 x
// 2 = 51.5 GFLOP a rank, far fewer under skewed routing) against the
// weights read once a chunk (4 x 201 MB a rank on one card).  On one card
// the ring's copies (4 x 33.6 MB a rank) are copies inside one HBM.
//
// Design (a first kernel that is right).  One cooperative launch holds
// every rank's blocks (`dl.cuh`; blockIdx.y is the rank); the ring is K12's
// (`comm_body.cuh` `emit_ag_ring`): each chunk, a rank's whole bucket
// tensor, is forwarded before it is computed.  On each held chunk the P
// blocks of a rank stride over the chunk's occupied tiles only: the
// wrapper gives, per chunk, the exclusive prefix over experts of the row
// tiles that hold a token (`tile_start`, (W, E + 1): routing metadata, as
// JAX builds `counts` in XLA), and tile j of the chunk is (live row tile
// j % L, column tile j / L) of its expert, found by binary search.  With
// random weights the routing collapses onto few experts, so this walks the
// occupied tiles, not the dense (E, row tile, column tile) grid.  Rows of
// the row tiles past an expert's count compute nothing and are written as
// zeros (JAX grouped_gemm.py :160-168: a NaN there would survive the
// zero-weighted combine).  The tile is K8's (`gemm_tile.cuh`: 16, 64 or
// 128 rows by cap, f32 on the CUDA cores) or, for int8, K7's
// (`w8a8_body.cuh`, 128 rows, (float(acc) * sa) * sb).

#include "comm_body.cuh"
#include "tile_body.cuh"

namespace {

using bf16 = __nv_bfloat16;
using dl::u64;
namespace gemm = tdt::gemm;
namespace body = tdt::body;

template <class Body>
struct Args {
  const typename Body::In* a;  // (R, E, cap, k): the launched ranks' buckets
  const typename Body::In* b;  // (R, E, k, n): their weight shards
  const float* sa;             // int8: (W, E, cap), every chunk's scales
  const float* sb;             // int8: (R, E, n)
  const int* tile_start;       // (W, E + 1): live row tiles before expert e
  typename Body::Out* out;     // (R, W, E, cap, n)
  dl::Symm<char> gathered;     // rank r's (W, E, cap, k)
  dl::Symm<u64> sig;           // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int e, cap, n, k, vec;
  u64 epoch;                   // the instance's sum of P before this call
};

// Zeros into ``elems`` elements at ``o`` by a block's threads, 16 bytes a
// store where aligned.
template <typename TO>
__device__ __forceinline__ void zero_fill(TO* o, size_t elems) {
  constexpr size_t V = 16 / sizeof(TO);
  size_t done = 0;
  if (reinterpret_cast<uintptr_t>(o) % 16 == 0) {
    done = elems / V * V;
    uint4* v = reinterpret_cast<uint4*>(o);
    for (size_t i = threadIdx.x; i < done / V; i += blockDim.x)
      v[i] = make_uint4(0, 0, 0, 0);
  }
  for (size_t i = done + threadIdx.x; i < elems; i += blockDim.x)
    tdt::store1(o + i, 0.f);
}

template <class Body>
__global__ void __launch_bounds__(Body::NT, gemm::MIN_BLOCKS)
    ag_group_gemm_kernel(Args<Body> p) {
  using In = typename Body::In;
  using TO = typename Body::Out;
  __shared__ __align__(16) typename Body::Smem sm;
  const dl::Team& t = p.team;
  const int y = blockIdx.y, part = blockIdx.x, parts = gridDim.x;
  const u64 target = p.epoch + gridDim.x;
  const size_t chunk = (size_t)p.e * p.cap * p.k;
  const size_t out_chunk = (size_t)p.e * p.cap * p.n;
  const In* b = p.b + (size_t)y * p.e * p.k * p.n;
  const float* sb = p.sb ? p.sb + (size_t)y * p.e * p.n : nullptr;
  TO* out = p.out + (size_t)y * t.world * out_chunk;
  const int ntn = (p.n + Body::BN - 1) / Body::BN;

  tdt::comm::emit_ag_ring(
      t, p.a + y * chunk, p.gathered, chunk * sizeof(In), p.sig, target,
      tdt::WAIT_AG_GROUP_GEMM_RING, [&](int c, const char* bytes) {
        const In* held = reinterpret_cast<const In*>(bytes);
        const int* first = p.tile_start + (size_t)c * (p.e + 1);
        TO* oc = out + c * out_chunk;
        // Rows past each expert's live row tiles: zeros.
        for (int ex = part; ex < p.e; ex += parts) {
          const int from = min(p.cap, (first[ex + 1] - first[ex]) * Body::BM);
          zero_fill(oc + ((size_t)ex * p.cap + from) * p.n,
                    (size_t)(p.cap - from) * p.n);
        }
        const int live = first[p.e];
        for (int j = part; j < live * ntn; j += parts) {
          const int q = j % live, nt = j / live;
          int lo = 0, hi = p.e;  // the expert ex with first[ex] <= q < first[ex + 1]
          while (hi - lo > 1) {
            const int mid = (lo + hi) / 2;
            if (first[mid] <= q) lo = mid; else hi = mid;
          }
          const size_t slot0 = ((size_t)c * p.e + lo) * p.cap;
          __syncthreads();
          Body::run(sm, held + (size_t)lo * p.cap * p.k,
                    b + (size_t)lo * p.k * p.n,
                    p.sa ? p.sa + slot0 : nullptr,
                    sb ? sb + (size_t)lo * p.n : nullptr,
                    oc + (size_t)lo * p.cap * p.n, p.cap, p.n, p.k,
                    (q - first[lo]) * Body::BM, nt * Body::BN, p.vec);
        }
      });
}

// P blocks a rank: as many as the dense tile grid of a chunk has tiles, at
// most as many as can be resident together with every other rank's; then
// one cooperative launch.
template <class Body>
int launch(Args<Body> p, int ranks, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(ag_group_gemm_kernel<Body>);
  int dev = 0, sms = 0, occ = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, Body::NT, 0);
  if (e != cudaSuccess) return (int)e;
  const int fit = occ * sms / ranks;
  if (fit < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int want = p.e * ((p.cap + Body::BM - 1) / Body::BM) *
                   ((p.n + Body::BN - 1) / Body::BN);
  const int P = want < fit ? (want > 0 ? want : 1) : fit;
  *blocks = P;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, ranks), dim3(Body::NT),
                                          args, 0, s);
}

template <class Body>
int run(const void* a, const void* b, const void* sa, const void* sb,
        const void* tile_start, void* out, void* const* gathered,
        void* const* sig, int world, int e, int cap, int n, int k,
        u64 epoch, int* blocks, cudaStream_t s) {
  Args<Body> p{};
  p.a = static_cast<const typename Body::In*>(a);
  p.b = static_cast<const typename Body::In*>(b);
  p.sa = static_cast<const float*>(sa);
  p.sb = static_cast<const float*>(sb);
  p.tile_start = static_cast<const int*>(tile_start);
  p.out = static_cast<typename Body::Out*>(out);
  uintptr_t align = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b);
  for (int r = 0; r < world; ++r) {
    p.gathered.ptr[r] = static_cast<char*>(gathered[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    align |= reinterpret_cast<uintptr_t>(gathered[r]);
  }
  p.team = dl::Team{world, 0};
  p.e = e;
  p.cap = cap;
  p.n = n;
  p.k = k;
  p.vec = k % 8 == 0 && n % 8 == 0 && align % 16 == 0;
  p.epoch = epoch;
  return launch<Body>(p, world, blocks, s);
}

int run_bf16(const void* a, const void* b, const void* tile_start, void* out,
             void* const* gathered, void* const* sig, int world, int e,
             int cap, int n, int k, u64 epoch, int* blocks, cudaStream_t s) {
  if (cap <= 16)
    return run<body::Float<gemm::Bf16Tile16, bf16>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  if (cap <= 64)
    return run<body::Float<gemm::Bf16Tile64, bf16>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  return run<body::Float<gemm::Bf16Tile128, bf16>>(
      a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e, cap,
      n, k, epoch, blocks, s);
}

}  // namespace

// a (world, E, cap, k) and b (world, E, k, n): every rank's buckets and
// weight shard, in ``in_dtype`` (tdt::DTYPE_*), or int8 when ``int8`` (then
// sa (world, E, cap) and sb (world, E, n) f32 scales); tile_start (world,
// E + 1) int32; out (world, world, E, cap, n) in ``out_dtype`` (a float
// input's own type); ``gathered`` and ``sig``: host tables of ``world``
// device pointers, rank r's gathered (world, E, cap, k) buffer and its
// dl::SIGNAL_WORDS u64 counters; all contiguous.  ``epoch``: the
// instance's sum of blocks a rank over its earlier calls; the blocks a rank
// of this launch go to ``*blocks``.  Returns a cudaError_t code.
extern "C" int ag_group_gemm(const void* a, const void* b, const void* sa,
                             const void* sb, const void* tile_start,
                             void* out, void* const* gathered,
                             void* const* sig, int world, int int8,
                             int in_dtype, int out_dtype, int e, int cap,
                             int n, int k, unsigned long long epoch,
                             int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || e < 1 || cap < 1 || n < 1 ||
      k < 1 || tile_start == nullptr ||
      (int8 && (sa == nullptr || sb == nullptr || k % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int8) {
    if (out_dtype == tdt::DTYPE_BF16)
      return run<body::Int8<bf16>>(a, b, sa, sb, tile_start, out, gathered,
                                   sig, world, e, cap, n, k, epoch, blocks, s);
    if (out_dtype == tdt::DTYPE_F32)
      return run<body::Int8<float>>(a, b, sa, sb, tile_start, out, gathered,
                                    sig, world, e, cap, n, k, epoch, blocks,
                                    s);
    return (int)cudaErrorInvalidValue;
  }
  if (out_dtype != in_dtype) return (int)cudaErrorInvalidValue;
  if (in_dtype == tdt::DTYPE_BF16)
    return run_bf16(a, b, tile_start, out, gathered, sig, world, e, cap, n,
                    k, epoch, blocks, s);
  if (in_dtype == tdt::DTYPE_F32)
    return run<body::Float<gemm::F32Tile, float>>(
        a, b, nullptr, nullptr, tile_start, out, gathered, sig, world, e,
        cap, n, k, epoch, blocks, s);
  return (int)cudaErrorInvalidValue;
}
