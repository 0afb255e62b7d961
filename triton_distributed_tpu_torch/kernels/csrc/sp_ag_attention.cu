// Sequence-parallel causal prefill attention with the KV ring inside the
// kernel (K20): each of W ranks holds S query rows and S KV rows of one
// sequence (rank r's rows at global offset q_off[r]; KV chunk c at
// kv_base[r] + c * S), and gets the causal attention of its query rows
// over every rank's KV chunk: out (W, B, H, S, D) in q's dtype and the
// natural-log lse (W, B, H, S) f32.
//
// Replaces: triton_distributed_tpu/kernels/sp_ag_attention.py
//   `sp_ag_attention_fused` -> `_sp_ag_attn_fused_kernel` (:382, pallas_call
//   :520): the KV chunk goes round a +1 ring into a (W, B, Hkv, S, D)
//   buffer while a flash consumer attends the chunk it holds
//   (`_emit_flash_chunk` :181), chunks in the causal future are skipped
//   (`_emit_state_fill` :345, `_emit_state_carry` :362), and the (out, lse)
//   state ping-pongs in f32 through HBM between chunks.
//
// What bounds it on the H100: operations.  At Qwen3-8B's heads over 32,768
// tokens at W = 4 the causal products are ~8.8 TFLOP (8.9 ms at 989
// TFLOP/s) against ~0.3 GB of q, k, v, out and lse.  The consumers run the
// tensor-core tile body of K1 (`flash_body.cuh`).
//
// Design.  One cooperative launch holds every rank's blocks (`dl.cuh`;
// blockIdx.y is the rank), as many a rank as can be resident together.
// - Producers: the first NP blocks of each rank run the ring.  After the
//   neighbour entry barrier, at step s = 0 .. W-2 they put chunk c = (r -
//   s) mod W (their share of its K and V bytes: from the rank's own input at
//   s = 0, else from the slot it arrived in) into slot c of the right
//   neighbour's ring buffer, and signal that chunk's arrival word there.
//   Before forwarding a received chunk they wait for its arrival (all NP
//   blocks of the left neighbour), and never for a consumer.  Each chunk
//   has its own slot, so nothing is reused within a call and the ring
//   cannot deadlock.
// - Consumers: the other blocks of the rank are persistent and stride over
//   the rank's (b, h, tile of 64 query rows) work items, heavy causal tiles
//   first; a cooperative grid cannot hold one block a tile (32 heads x
//   8,192 rows are 4,096 tiles a rank).  A consumer stages its query tile
//   once and folds the chunks into one online-softmax state kept in
//   registers, in arrival order r, r-1, ..: the own chunk from the input,
//   every other after spinning on its arrival word.  A chunk (or the part
//   of it) in the causal future of the tile is neither waited for nor read
//   (`kv_tiles`).  That replaces the TPU kernel's f32 HBM ping-pong of
//   (out, lse) and its per-chunk merge; only the rounding order differs.
// - Load balance: in the natural layout rank r attends r + 1 chunks (the
//   diagonal one half), while every rank owns the same share of the card's
//   SMs, so rank W-1's consumers set the time; the zigzag composition
//   (`sp_ring_attention_zigzag`) is the balanced layout.
// - Signals are the monotonic epoch counters of `dl.cuh`: every arrival
//   word a chunk receives NP adds a call, so a wait's target is the
//   instance's epoch (the sum of NP over its earlier calls) plus NP.

#include "comm_body.cuh"
#include "flash_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;
using namespace tdt::flash;

struct SpArgs {
  const char* q;         // (W, B, H, S, D)
  const char* k;         // (W, B, Hkv, S, D)
  const char* v;
  char* out;             // (W, B, H, S, D)
  float* lse;            // (W, B, H, S)
  dl::Symm<char> kbuf;   // rank r's ring buffer (W chunks, B, Hkv, S, D)
  dl::Symm<char> vbuf;
  dl::Symm<u64> sig;     // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int B, H, Hkv, S;
  int q_off[dl::MAX_RANKS];
  int kv_base[dl::MAX_RANKS];
  float qscale;          // scale * log2(e)
  int producers;         // NP: ring blocks a rank
  u64 epoch;             // the instance's sum of NP before this call
  comm::Faults faults;
};

// The ring: the neighbour entry barrier, then chunk (me - s) mod W to the
// right neighbour's slot for s = 0 .. W-2 (NP blocks share each copy).
__device__ __forceinline__ void produce(const SpArgs& p, size_t chunk_bytes,
                                        u64 target) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), part = blockIdx.x, parts = p.producers;
  const int right = dl::peer_id(t, me + 1);
  const char* k_in = p.k + (size_t)blockIdx.y * chunk_bytes;
  const char* v_in = p.v + (size_t)blockIdx.y * chunk_bytes;
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  for (int s = 0; s < t.world - 1; ++s) {
    const int c = dl::peer_id(t, me - s);
    const size_t at = (size_t)c * chunk_bytes;
    if (s > 0)
      dl::wait(p.sig[me] + dl::ARRIVAL_WORD + c, 1, 0, target,
               "sp_ag_attention ring arrival (producer)");
    dl::put_nbi(p.kbuf[right] + at, s == 0 ? k_in : p.kbuf[me] + at,
                chunk_bytes, part, parts);
    dl::put_nbi(p.vbuf[right] + at, s == 0 ? v_in : p.vbuf[me] + at,
                chunk_bytes, part, parts);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + c;
    dl::signal_after_puts(&word, 1);
  }
}

template <typename T, int D, int NT>
__global__ void __launch_bounds__(NT) sp_ag_attn_kernel(SpArgs p) {
  constexpr bool kBf16 = sizeof(T) == 2;
  const dl::Team& t = p.team;
  const int me = dl::rank(t), W = t.world;
  const int S = p.S, H = p.H, Hkv = p.Hkv;
  const size_t chunk_bytes = (size_t)p.B * Hkv * S * D * sizeof(T);
  const u64 target = p.epoch + p.producers;

  comm::inject_faults(t, p.faults);
  if ((int)blockIdx.x < p.producers) {
    produce(p, chunk_bytes, target);
    return;
  }

  const int consumers = gridDim.x - p.producers;
  const int nqt = (S + BQ - 1) / BQ;
  const int items = p.B * H * nqt;
  const int q_off = p.q_off[me], kv_base = p.kv_base[me];
  const size_t rank_q = (size_t)blockIdx.y * p.B * H * S;  // rows before me
  const T* q = reinterpret_cast<const T*>(p.q) + rank_q * D;
  T* out = reinterpret_cast<T*>(p.out) + rank_q * D;
  float* lse = p.lse + rank_q;
  const char* k_in = p.k + (size_t)blockIdx.y * chunk_bytes;
  const char* v_in = p.v + (size_t)blockIdx.y * chunk_bytes;

  // Dynamic shared memory: `Bf16Smem` (bf16) or `f32_smem_bytes` (f32).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Bf16Smem<D>& sm_bf16 = *reinterpret_cast<Bf16Smem<D>*>(smem_raw);
  float* smem_f32 = reinterpret_cast<float*>(smem_raw);
  Bf16State<D> st_bf16;
  F32State<D> st_f32;

  for (int it = blockIdx.x - p.producers; it < items; it += consumers) {
    const int qt = nqt - 1 - it % nqt;  // heavy causal tiles first
    const int bh = it / nqt;
    const int b = bh / H, h = bh % H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const size_t row = (size_t)bh * S;  // (b, h)'s first row in this rank
    const size_t kv_row = (size_t)(b * Hkv + hk) * S * D;

    __syncthreads();  // the last item's readers of the tiles are done
    if constexpr (kBf16)
      bf16_begin<D>(sm_bf16, q + row * D, q0, S, st_bf16);
    else
      f32_begin<D>(smem_f32, q + row * D, q0, S, p.qscale, st_f32);
    for (int s = 0; s < W; ++s) {
      const int c = dl::peer_id(t, me - s);
      const int off = q_off - (kv_base + c * S);
      const int n_kt = tdt::kv_tiles<BQ, BK>(q0, S, S, 1, off);
      if (n_kt == 0) continue;  // the causal future of this tile
      const char* kc = k_in;
      const char* vc = v_in;
      if (s > 0) {
        dl::wait(p.sig[me] + dl::ARRIVAL_WORD + c, 1, 0, target,
                 "sp_ag_attention ring arrival (consumer)");
        kc = p.kbuf[me] + (size_t)c * chunk_bytes;
        vc = p.vbuf[me] + (size_t)c * chunk_bytes;
      }
      const T* kp = reinterpret_cast<const T*>(kc) + kv_row;
      const T* vp = reinterpret_cast<const T*>(vc) + kv_row;
      if constexpr (kBf16)
        bf16_attend<D>(sm_bf16, kp, vp, q0, S, n_kt, 1, off, p.qscale,
                       st_bf16);
      else
        f32_attend<D>(smem_f32, kp, vp, q0, S, n_kt, 1, off, st_f32);
    }
    if constexpr (kBf16)
      bf16_finish<D>(sm_bf16, out + row * D, lse + row, q0, S, st_bf16);
    else
      f32_finish<D>(out + row * D, lse + row, q0, S, st_f32);
  }
}

template <typename T, int D, int NT>
int launch(SpArgs& p, size_t smem, int* blocks, cudaStream_t s) {
  void* fn = reinterpret_cast<void*>(sp_ag_attn_kernel<T, D, NT>);
  cudaError_t e = cudaSuccess;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, NT, smem);
  if (e != cudaSuccess) return (int)e;
  // Every resident block a rank; one in eight (1 to 8) runs the ring.
  const int P = occ * sms / p.team.world;
  if (P < 2) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int np = P / 8 < 1 ? 1 : (P / 8 > 8 ? 8 : P / 8);
  p.producers = np;
  *blocks = np;
  void* args[] = {&p};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, p.team.world),
                                          dim3(NT), args, smem, s);
}

}  // namespace

// q (W, B, H, S, D), k/v (W, B, Hkv, S, D), out (W, B, H, S, D) contiguous,
// one dtype (0 f32, 1 bf16; D 64 or 128); lse (W, B, H, S) f32.  ``kbuf``,
// ``vbuf``, ``sig``: host tables of ``world`` device pointers, rank r's ring
// buffers (W chunks of B*Hkv*S*D) and its dl::SIGNAL_WORDS u64 counters.
// ``q_off``, ``kv_base``: ``world`` ints each (host).  ``epoch``: the
// instance's sum of ring blocks a rank over its earlier calls; this call's
// go to ``*blocks``.  ``straggler`` (-1: none) spins ``cycles`` first;
// ``for_correctness`` staggers every rank.  Returns a cudaError_t code.
extern "C" int sp_ag_attention_fused(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* const* kbuf, void* const* vbuf, void* const* sig, int world,
    int dtype, int B, int H, int Hkv, int S, int D, const int* q_off,
    const int* kv_base, float scale, unsigned long long epoch, int straggler,
    long long cycles, int for_correctness, int* blocks, void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || B < 1 || H < 1 || Hkv < 1 ||
      H % Hkv || S < 1 || (D != 64 && D != 128) ||
      (dtype != tdt::DTYPE_BF16 && dtype != tdt::DTYPE_F32))
    return (int)cudaErrorInvalidValue;
  SpArgs p{};
  p.q = static_cast<const char*>(q);
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.out = static_cast<char*>(out);
  p.lse = static_cast<float*>(lse);
  for (int r = 0; r < world; ++r) {
    p.kbuf.ptr[r] = static_cast<char*>(kbuf[r]);
    p.vbuf.ptr[r] = static_cast<char*>(vbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    p.q_off[r] = q_off[r];
    p.kv_base[r] = kv_base[r];
  }
  p.team = dl::Team{world, 0};
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.qscale = scale * tdt::LOG2E;
  p.epoch = epoch;
  p.faults = comm::Faults{straggler, cycles, for_correctness};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16)
    return D == 128
               ? launch<bf16, 128, MMA_NT>(p, sizeof(Bf16Smem<128>), blocks, s)
               : launch<bf16, 64, MMA_NT>(p, sizeof(Bf16Smem<64>), blocks, s);
  return D == 128
             ? launch<float, 128, F32_NT>(p, f32_smem_bytes<128>(), blocks, s)
             : launch<float, 64, F32_NT>(p, f32_smem_bytes<64>(), blocks, s);
}
