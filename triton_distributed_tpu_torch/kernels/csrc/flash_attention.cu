// Causal / non-causal GQA flash attention, forward (prefill).
//
// Replaces: triton_distributed_tpu/kernels/flash_attention.py
//   `flash_attention` -> `_flash_kernel_single_diag` (pallas_call :564),
//   `_flash_kernel_packed` (:614) and `_flash_kernel` (:680).  The three
//   TPU kernels are three schedules of one function; this file computes
//   all of them (static or run-time kv_offset, causal or not) with one
//   kernel per input type.
//
// What bounds it on the H100: at the Qwen3-8B prefill shape (q 4x32x512x128,
// k/v 4x8x512x128, bf16, causal) the function moves ~42 MB (12.5 us at
// 3.35 TB/s) and does ~8.6 GFLOP (8.7 us at 989 TFLOP/s of bf16 tensor
// cores), so its least time is set by the bytes, with the products close
// behind; over long sequences (32,768 tokens) by the products.  The bf16
// kernel therefore runs FlashAttention-3's shape on Hopper: TMA loads into
// a ring of K/V stages and `wgmma` products from shared memory, the only
// way to the card's full tensor-core rate, and reads each K/V tile from
// device memory once per tile of 128 query rows; the f32 kernel (inputs the
// main path never gives it) stays on the CUDA cores.
//
// Design: a work item is one (batch, query head, tile of query rows), the
// heaviest causal tiles (the last rows) first; one persistent block an SM
// walks its items in a snake over the grid (`Hopper::item_of`), running
// the bodies of `flash_body.cuh` (shared with K20): `begin` stages the
// query tile (the producer loads the next tile's into the second Q buffer
// while the consumers finish this one), one
// `attend` walks the K/V tiles up to the exact causal limit of the tile's
// last row (q_row + kv_offset) with the online softmax state (m, l, O) in
// registers, and `finish` stores out and the natural-log lse.  The TPU
// kernels carried that state across sequential grid steps in VMEM scratch;
// CUDA blocks run in no order, so the loop replaces that grid dimension.
// GQA: query head h reads KV head h / (H / Hkv).  Ragged edges and fully
// masked rows (possible only with a negative kv_offset: lse ~ -inf, out
// unspecified, as on the TPU, :211-219) are handled in the bodies.
//
// bf16 kernel: the Hopper body `Hopper<D>` (384 threads, 128-row tiles,
// a producer warpgroup and two consumer warpgroups taking turns at the
// tensor cores; q, k and v as 3-D tensor maps (D, S, planes) encoded on
// the host each call).  f32 kernel: one block a 64-row tile, 256 threads
// on the CUDA cores (`f32_begin/attend/finish`).

#include "flash_body.cuh"

namespace {

using namespace tdt::flash;

// ---- bf16: the Hopper body -------------------------------------------------

struct FwdArgs {
  CUtensorMap tq;  // q (B, H, Sq, D) as (D, Sq, B H)
  CUtensorMap tk;  // k (B, Hkv, Sk, D) as (D, Sk, B Hkv)
  CUtensorMap tv;
  bf16* out;       // (B, H, Sq, D)
  float* lse;      // (B, H, Sq)
  int bh, H, Hkv, nqt, sq, sk, causal, kv_offset;
  float qscale;
};

// Item it is query tile nqt - 1 - it / (B H) (the heaviest first) of
// (batch, head) it % (B H), with one key range.
template <int D>
struct FwdSched {
  const FwdArgs* p;

  __device__ __forceinline__ int items() const { return p->nqt * p->bh; }
  __device__ __forceinline__ const CUtensorMap* tq() const { return &p->tq; }
  __device__ __forceinline__ QTile tile(int it) const {
    const int bh = it % p->bh;
    return {bh, bh, (p->nqt - 1 - it / p->bh) * WBQ};
  }
  __device__ __forceinline__ int ranges() const { return 1; }
  __device__ __forceinline__ Keys keys(const QTile& t, int) const {
    const int b = t.bh / p->H, hk = t.bh % p->H / (p->H / p->Hkv);
    return {&p->tk, &p->tv, b * p->Hkv + hk,
            tdt::kv_tiles<WBQ, WBK>(t.q0, p->sq, p->sk, p->causal,
                                    p->kv_offset),
            p->sk, p->causal, p->kv_offset, -1};
  }
  __device__ __forceinline__ void ready(int) {}
  __device__ __forceinline__ void side(int) {}
  __device__ __forceinline__ bf16* out(const QTile& t) const {
    return p->out + (size_t)t.plane * p->sq * D;
  }
  __device__ __forceinline__ float* lse(const QTile& t) const {
    return p->lse + (size_t)t.plane * p->sq;
  }
  __device__ __forceinline__ int sq() const { return p->sq; }
  __device__ __forceinline__ float qscale() const { return p->qscale; }
};

template <int D>
__global__ void __launch_bounds__(WNT, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ FwdArgs p) {
  extern __shared__ __align__(1024) uint8_t wg_smem[];
  FwdSched<D> sched{&p};
  Hopper<D>::run(wg_smem, sched);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                int kv_offset, float scale, cudaStream_t stream) {
  if (Sk < 1) return (int)cudaErrorInvalidValue;
  FwdArgs p{};
  int rc = wg::encode_3d(&p.tq, q, D, Sq, (uint64_t)B * H, 64, WBQ);
  if (rc == 0)
    rc = wg::encode_3d(&p.tk, k, D, Sk, (uint64_t)B * Hkv, 64, WBK);
  if (rc == 0)
    rc = wg::encode_3d(&p.tv, v, D, Sk, (uint64_t)B * Hkv, 64, WBK);
  if (rc != 0) return rc;
  p.out = static_cast<bf16*>(out);
  p.lse = static_cast<float*>(lse);
  p.bh = B * H;
  p.H = H;
  p.Hkv = Hkv;
  p.nqt = (Sq + WBQ - 1) / WBQ;
  p.sq = Sq;
  p.sk = Sk;
  p.causal = causal;
  p.kv_offset = kv_offset;
  p.qscale = scale * tdt::LOG2E;
  auto* fn = flash_fwd_wgmma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Hopper<D>::SMEM_BYTES);
  if (attr != cudaSuccess) return (int)attr;
  // One block an SM, each walking its tiles (`Hopper::item_of`).
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = p.nqt * p.bh < sms ? p.nqt * p.bh : sms;
  flash_fwd_wgmma_kernel<D>
      <<<blocks, WNT, Hopper<D>::SMEM_BYTES, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---- f32: CUDA cores --------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(F32_NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale) {
  extern __shared__ float smem[];
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t bh = (size_t)(b * H + h);
  const size_t bhk = (size_t)(b * Hkv + hk);

  F32State<D> st;
  f32_begin<D>(smem, q + bh * Sq * D, q0, Sq, qscale, st);
  f32_attend<D>(smem, k + bhk * Sk * D, v + bhk * Sk * D, q0, Sk,
                tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset), causal,
                kv_offset, st);
  f32_finish<D>(out + bh * Sq * D, lse + bh * Sq, q0, Sq, st);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
               int kv_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<D><<<grid, F32_NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, kv_offset,
      scale * tdt::LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,H,Sq,D), k/v (B,Hkv,Sk,D), out (B,H,Sq,D) contiguous, same dtype;
// lse (B,H,Sq) f32.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, void* lse, int dtype, int B,
                                   int H, int Hkv, int Sq, int Sk, int D,
                                   int causal, int kv_offset, float scale,
                                   void* stream) {
  if (Sq == 0 || B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tdt::DTYPE_BF16 && D == 128)
    return launch_bf16<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                            kv_offset, scale, s);
  if (dtype == tdt::DTYPE_BF16 && D == 64)
    return launch_bf16<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                           kv_offset, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 128)
    return launch_f32<128>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                           kv_offset, scale, s);
  if (dtype == tdt::DTYPE_F32 && D == 64)
    return launch_f32<64>(q, k, v, out, lse, B, H, Hkv, Sq, Sk, causal,
                          kv_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
