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
// TFLOP/s) against ~0.3 GB of q, k, v, out and lse.  On one card every rank
// owns 1/W of the SMs while rank r attends r + 1/2 chunks: rank W-1 does
// (2W - 1) / W^2 of the causal work (43.75% at W = 4) on a quarter of the
// card, 15.56 ms at the peak rate, so no layout with equal shares beats
// that here (the zigzag composition, `sp_ring_attention_zigzag`, is the
// balanced layout).
//
// Design.  One cooperative launch holds every rank's blocks (`dl.cuh`;
// blockIdx.y is the rank), one block an SM: P = SMs / W blocks a rank.
// bf16 (every main-path call) runs K1's Hopper body (`flash_body.cuh`
// `Hopper<D>`, 384 threads):
// - Consumers: the two consumer warpgroups of every block are persistent
//   over the rank's (b, h, tile of 128 query rows) items, heaviest causal
//   tiles first, in a snake over the rank's blocks (`Hopper::item_of`).
//   An item stages its query tile once and folds the chunks
//   r, r-1, .. into one online-softmax state in registers, in arrival
//   order, with the same `begin / attend / finish` as K1, so rank 0 (its
//   own chunk only) equals K1 bit for bit.  A chunk (or the part of it) in
//   the causal future of the tile is neither waited for nor read
//   (`kv_tiles`).  That replaces the TPU kernel's f32 HBM ping-pong of
//   (out, lse) and its per-chunk merge; only the rounding order differs.
// - The ring, with no dedicated blocks: the producer warpgroup's three
//   spare warps of every block (a crew on named barrier 1, `comm_body.cuh`)
//   run the neighbour entry barrier, then at step s = 0 .. W-2 put their
//   block's share of chunk c = (r - s) mod W (from the rank's own input at
//   s = 0, else from the slot it arrived in) into slot c of the right
//   neighbour's ring buffers, and signal that chunk's arrival word there.
//   Before forwarding a received chunk they wait for its arrival (all P
//   blocks of the left neighbour), never for a consumer.  Each chunk has
//   its own slot, so nothing is reused within a call.
// - The producer thread reads a ring chunk by TMA only after waiting for
//   its arrival word (acquire) and `fence.proxy.async.global`: the peers
//   wrote it through the generic proxy (`comm::ring_wait_chunk`), once a
//   chunk a block.  The consumers do not spin on arrival words: the full
//   barriers of the stages gate them.
// - Tensor maps, (D, S, planes) with 128-row boxes: q of all ranks (D, S,
//   W B H); the k and v inputs of all ranks (D, S, W B Hkv); rank r's kbuf
//   and vbuf (D, S, W B Hkv), chunk c of (b, hk) at plane (c B + b) Hkv +
//   hk; 2 W + 3 maps in a `__grid_constant__` struct.
// f32 (the 2-layer card-vs-CPU gates only) keeps the CUDA-core body of 256
// threads: every block first runs its share of the ring (all its threads,
// `dl::put_nbi`), then computes, reading arrived chunks through L2.
// Signals are the monotonic epoch counters of `dl.cuh`: every arrival word
// a chunk receives P adds a call, so a wait's target is the instance's
// epoch (the sum of P over its earlier calls) plus P.

#include "comm_body.cuh"
#include "flash_body.cuh"

namespace {

using dl::u64;
namespace comm = tdt::comm;
using namespace tdt::flash;

//: The ring crew: the producer warpgroup's warps 1-3 on named barrier 1.
constexpr int CREW_THREADS = 96, CREW_BARRIER = 1;

// ---- bf16: the Hopper body, the ring on the crews --------------------------

struct SpWgArgs {
  CUtensorMap tq;                   // q (W, B, H, S, D) as (D, S, W B H)
  CUtensorMap tk, tv;               // k, v (W, B, Hkv, S, D): (D, S, W B Hkv)
  CUtensorMap tkb[dl::MAX_RANKS];   // rank r's kbuf, (D, S, W B Hkv)
  CUtensorMap tvb[dl::MAX_RANKS];
  const char* k;                    // the inputs, for the crews' copies
  const char* v;
  bf16* out;                        // (W, B, H, S, D)
  float* lse;                       // (W, B, H, S)
  dl::Symm<char> kbuf;              // rank r's ring buffer (W, B, Hkv, S, D)
  dl::Symm<char> vbuf;
  dl::Symm<u64> sig;                // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int B, H, Hkv, S, nqt;
  int q_off[dl::MAX_RANKS];
  int kv_base[dl::MAX_RANKS];
  float qscale;                     // scale * log2(e)
  int ring;                         // 0: no ring, the slots as they stand
  u64 epoch;                        // the instance's sum of P before this call
  comm::Faults faults;
};

// The crew's ring: the neighbour entry barrier, then this block's share of
// chunk (me - s) mod W into the right neighbour's slot for s = 0 .. W-2.
template <int D>
__device__ __forceinline__ void forward(const SpWgArgs& p, u64 target,
                                        int i) {
  const comm::Crew c{i, CREW_THREADS, CREW_BARRIER};
  const dl::Team& t = p.team;
  const int me = dl::rank(t), right = dl::peer_id(t, me + 1);
  const size_t bytes = (size_t)p.B * p.Hkv * p.S * D * sizeof(bf16);
  const int part = blockIdx.x, parts = gridDim.x;
  comm::crew_entry_barrier(t, p.sig, target, /*neighbors_only=*/true, c);
  for (int s = 0; s < t.world - 1; ++s) {
    const int ch = dl::peer_id(t, me - s);
    const size_t at = (size_t)ch * bytes;
    if (s > 0)
      comm::crew_wait(p.sig[me] + dl::ARRIVAL_WORD + ch, 1, 0, target,
                      tdt::WAIT_SP_AG_RING_FORWARD, c);
    comm::crew_copy(p.kbuf[right] + at, s == 0 ? p.k + at : p.kbuf[me] + at,
                    bytes, part, parts, c);
    comm::crew_copy(p.vbuf[right] + at, s == 0 ? p.v + at : p.vbuf[me] + at,
                    bytes, part, parts, c);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + ch;
    comm::crew_signal(&word, 1, c);
  }
}

// The rank's items: item it is query tile nqt - 1 - it / (B H) (heaviest
// first) of (b, h) it % (B H); key range s is chunk (me - s) mod W, the
// own one from the input, the others from the ring buffer.
template <int D>
struct SpSched {
  const SpWgArgs* p;
  int me;
  u64 target;
  unsigned waited;  // the chunks the producer thread has waited for

  __device__ __forceinline__ int items() const {
    return p->nqt * p->B * p->H;
  }
  __device__ __forceinline__ const CUtensorMap* tq() const { return &p->tq; }
  __device__ __forceinline__ QTile tile(int it) const {
    const int bhn = p->B * p->H, bh = it % bhn;
    return {me * bhn + bh, bh, (p->nqt - 1 - it / bhn) * WBQ};
  }
  __device__ __forceinline__ int ranges() const { return p->team.world; }
  __device__ __forceinline__ Keys keys(const QTile& t, int s) const {
    const int c = dl::peer_id(p->team, me - s);
    const int off = p->q_off[me] - (p->kv_base[me] + c * p->S);
    const int b = t.bh / p->H, hk = t.bh % p->H / (p->H / p->Hkv);
    const int n_kt = tdt::kv_tiles<WBQ, WBK>(t.q0, p->S, p->S, 1, off);
    if (c == me)
      return {&p->tk, &p->tv, (me * p->B + b) * p->Hkv + hk, n_kt, p->S, 1,
              off, -1};
    return {&p->tkb[me], &p->tvb[me], (c * p->B + b) * p->Hkv + hk, n_kt,
            p->S, 1, off, p->ring ? c : -1};
  }
  __device__ __forceinline__ void ready(int c) {
    if (waited >> c & 1u) return;
    comm::ring_wait_chunk(p->sig, me, c, target, tdt::WAIT_SP_AG_RING_LOAD);
    waited |= 1u << c;
  }
  __device__ __forceinline__ void side(int i) {
    if (p->ring) forward<D>(*p, target, i);
  }
  __device__ __forceinline__ bf16* out(const QTile& t) const {
    return p->out + (size_t)t.plane * p->S * D;
  }
  __device__ __forceinline__ float* lse(const QTile& t) const {
    return p->lse + (size_t)t.plane * p->S;
  }
  __device__ __forceinline__ int sq() const { return p->S; }
  __device__ __forceinline__ float qscale() const { return p->qscale; }
};

template <int D>
__global__ void __launch_bounds__(WNT, 1)
    sp_ag_attn_wgmma_kernel(const __grid_constant__ SpWgArgs p) {
  extern __shared__ __align__(1024) uint8_t smem[];
  comm::inject_faults(p.team, p.faults);
  SpSched<D> sched{&p, dl::rank(p.team), p.epoch + gridDim.x, 0u};
  Hopper<D>::run(smem, sched);
}

// ---- f32: the CUDA-core body, the ring first -------------------------------

struct SpArgs {
  const float* q;        // (W, B, H, S, D)
  const char* k;         // (W, B, Hkv, S, D)
  const char* v;
  float* out;            // (W, B, H, S, D)
  float* lse;            // (W, B, H, S)
  dl::Symm<char> kbuf;   // rank r's ring buffer (W chunks, B, Hkv, S, D)
  dl::Symm<char> vbuf;
  dl::Symm<u64> sig;     // rank r's dl::SIGNAL_WORDS counters
  dl::Team team;
  int B, H, Hkv, S;
  int q_off[dl::MAX_RANKS];
  int kv_base[dl::MAX_RANKS];
  float qscale;          // scale * log2(e)
  u64 epoch;             // the instance's sum of P before this call
  comm::Faults faults;
};

// The whole ring, this block's share: the neighbour entry barrier, chunk
// (me - s) mod W to the right neighbour's slot for s = 0 .. W-2 (waiting
// for each received one), then the wait for the last chunk: after it every
// chunk has arrived.
__device__ __forceinline__ void ring(const SpArgs& p, size_t chunk_bytes,
                                     u64 target) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), part = blockIdx.x, parts = gridDim.x;
  const int right = dl::peer_id(t, me + 1);
  dl::entry_barrier(t, p.sig, target, /*neighbors_only=*/true);
  for (int s = 0; s < t.world; ++s) {
    const int c = dl::peer_id(t, me - s);
    const size_t at = (size_t)c * chunk_bytes;
    if (s > 0)
      dl::wait(p.sig[me] + dl::ARRIVAL_WORD + c, 1, 0, target,
               tdt::WAIT_SP_AG_RING);
    if (s == t.world - 1) break;
    dl::put_nbi(p.kbuf[right] + at, s == 0 ? p.k + at : p.kbuf[me] + at,
                chunk_bytes, part, parts);
    dl::put_nbi(p.vbuf[right] + at, s == 0 ? p.v + at : p.vbuf[me] + at,
                chunk_bytes, part, parts);
    u64* word = p.sig[right] + dl::ARRIVAL_WORD + c;
    dl::signal_after_puts(&word, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(F32_NT) sp_ag_attn_f32_kernel(SpArgs p) {
  const dl::Team& t = p.team;
  const int me = dl::rank(t), W = t.world;
  const int S = p.S, H = p.H, Hkv = p.Hkv;
  const size_t chunk_bytes = (size_t)p.B * Hkv * S * D * sizeof(float);

  comm::inject_faults(t, p.faults);
  ring(p, chunk_bytes, p.epoch + gridDim.x);

  const int nqt = (S + BQ - 1) / BQ;
  const int items = p.B * H * nqt;
  const int q_off = p.q_off[me], kv_base = p.kv_base[me];
  const size_t rank_q = (size_t)me * p.B * H * S;  // rows before me
  const float* q = p.q + rank_q * D;
  float* out = p.out + rank_q * D;
  float* lse = p.lse + rank_q;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  F32State<D> st;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int qt = nqt - 1 - it % nqt;  // heavy causal tiles first
    const int bh = it / nqt;
    const int b = bh / H, h = bh % H;
    const int hk = h / (H / Hkv);
    const int q0 = qt * BQ;
    const size_t row = (size_t)bh * S;  // (b, h)'s first row in this rank
    const size_t kv_row = (size_t)(b * Hkv + hk) * S * D;

    __syncthreads();  // the last item's readers of the tiles are done
    f32_begin<D>(smem, q + row * D, q0, S, p.qscale, st);
    for (int s = 0; s < W; ++s) {
      const int c = dl::peer_id(t, me - s);
      const int off = q_off - (kv_base + c * S);
      const int n_kt = tdt::kv_tiles<BQ, BK>(q0, S, S, 1, off);
      if (n_kt == 0) continue;  // the causal future of this tile
      const char* kc = s == 0 ? p.k : p.kbuf[me];
      const char* vc = s == 0 ? p.v : p.vbuf[me];
      const size_t at = (size_t)c * chunk_bytes;
      f32_attend<D>(smem, reinterpret_cast<const float*>(kc + at) + kv_row,
                    reinterpret_cast<const float*>(vc + at) + kv_row, q0, S,
                    n_kt, 1, off, st);
    }
    f32_finish<D>(out + row * D, lse + row, q0, S, st);
  }
}

// P blocks a rank, as many as can be resident together with every other
// rank's; then one cooperative launch.
int cooperative(void* fn, void** args, int nt, size_t smem, int world,
                int* blocks, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, occ = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, nt, smem);
  if (e != cudaSuccess) return (int)e;
  const int P = occ * sms / world;
  if (P < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  *blocks = P;
  return (int)cudaLaunchCooperativeKernel(fn, dim3(P, world), dim3(nt), args,
                                          smem, s);
}

template <int D>
int launch_wgmma(SpWgArgs& p, const void* q, const void* k, const void* v,
                 void* const* kbuf, void* const* vbuf, int* blocks,
                 cudaStream_t s) {
  const int W = p.team.world, S = p.S;
  const uint64_t kv_planes = (uint64_t)W * p.B * p.Hkv;
  int rc = wg::encode_3d(&p.tq, q, D, S, (uint64_t)W * p.B * p.H, 64, WBQ);
  if (rc == 0) rc = wg::encode_3d(&p.tk, k, D, S, kv_planes, 64, WBK);
  if (rc == 0) rc = wg::encode_3d(&p.tv, v, D, S, kv_planes, 64, WBK);
  for (int r = 0; r < W && rc == 0; ++r) {
    rc = wg::encode_3d(&p.tkb[r], kbuf[r], D, S, kv_planes, 64, WBK);
    if (rc == 0)
      rc = wg::encode_3d(&p.tvb[r], vbuf[r], D, S, kv_planes, 64, WBK);
  }
  if (rc != 0) return rc;
  p.nqt = (S + WBQ - 1) / WBQ;
  void* args[] = {&p};
  return cooperative(reinterpret_cast<void*>(sp_ag_attn_wgmma_kernel<D>),
                     args, WNT, Hopper<D>::SMEM_BYTES, W, blocks, s);
}

template <int D>
int launch_f32(SpArgs& p, int* blocks, cudaStream_t s) {
  void* args[] = {&p};
  return cooperative(reinterpret_cast<void*>(sp_ag_attn_f32_kernel<D>), args,
                     F32_NT, f32_smem_bytes<D>(), p.team.world, blocks, s);
}

}  // namespace

// q (W, B, H, S, D), k/v (W, B, Hkv, S, D), out (W, B, H, S, D) contiguous,
// one dtype (0 f32, 1 bf16; D 64 or 128), 16-byte aligned; lse (W, B, H, S)
// f32.  ``kbuf``, ``vbuf``, ``sig``: host tables of ``world`` device
// pointers, rank r's ring buffers (W chunks of B*Hkv*S*D) and its
// dl::SIGNAL_WORDS u64 counters.  ``q_off``, ``kv_base``: ``world`` ints
// each (host).  ``epoch``: the instance's sum of blocks a rank over its
// earlier calls; this call's go to ``*blocks``.  ``straggler`` (-1: none)
// spins ``cycles`` first; ``for_correctness`` staggers every rank.
// ``ring`` 0 (bf16 only, for timing the consumers alone): no ring, no
// wait, the chunks read from the slots as an earlier call left them, and
// ``*blocks`` 0.  Returns a cudaError_t code.
extern "C" int sp_ag_attention_fused(
    const void* q, const void* k, const void* v, void* out, void* lse,
    void* const* kbuf, void* const* vbuf, void* const* sig, int world,
    int dtype, int B, int H, int Hkv, int S, int D, const int* q_off,
    const int* kv_base, float scale, unsigned long long epoch, int straggler,
    long long cycles, int for_correctness, int ring, int* blocks,
    void* stream) {
  *blocks = 0;
  if (world < 2 || world > dl::MAX_RANKS || B < 1 || H < 1 || Hkv < 1 ||
      H % Hkv || S < 1 || (D != 64 && D != 128) ||
      (dtype != tdt::DTYPE_BF16 && dtype != tdt::DTYPE_F32) ||
      (!ring && dtype != tdt::DTYPE_BF16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dl::Team team{world, 0};
  const comm::Faults faults{straggler, cycles, for_correctness};
  if (dtype == tdt::DTYPE_BF16) {
    SpWgArgs p{};
    p.k = static_cast<const char*>(k);
    p.v = static_cast<const char*>(v);
    p.out = static_cast<bf16*>(out);
    p.lse = static_cast<float*>(lse);
    for (int r = 0; r < world; ++r) {
      p.kbuf.ptr[r] = static_cast<char*>(kbuf[r]);
      p.vbuf.ptr[r] = static_cast<char*>(vbuf[r]);
      p.sig.ptr[r] = static_cast<u64*>(sig[r]);
      p.q_off[r] = q_off[r];
      p.kv_base[r] = kv_base[r];
    }
    p.team = team;
    p.B = B;
    p.H = H;
    p.Hkv = Hkv;
    p.S = S;
    p.qscale = scale * tdt::LOG2E;
    p.ring = ring;
    p.epoch = epoch;
    p.faults = faults;
    const int rc = D == 128
                       ? launch_wgmma<128>(p, q, k, v, kbuf, vbuf, blocks, s)
                       : launch_wgmma<64>(p, q, k, v, kbuf, vbuf, blocks, s);
    if (!ring) *blocks = 0;
    return rc;
  }
  SpArgs p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const char*>(k);
  p.v = static_cast<const char*>(v);
  p.out = static_cast<float*>(out);
  p.lse = static_cast<float*>(lse);
  for (int r = 0; r < world; ++r) {
    p.kbuf.ptr[r] = static_cast<char*>(kbuf[r]);
    p.vbuf.ptr[r] = static_cast<char*>(vbuf[r]);
    p.sig.ptr[r] = static_cast<u64*>(sig[r]);
    p.q_off[r] = q_off[r];
    p.kv_base[r] = kv_base[r];
  }
  p.team = team;
  p.B = B;
  p.H = H;
  p.Hkv = Hkv;
  p.S = S;
  p.qscale = scale * tdt::LOG2E;
  p.epoch = epoch;
  p.faults = faults;
  return D == 128 ? launch_f32<128>(p, blocks, s)
                  : launch_f32<64>(p, blocks, s);
}
