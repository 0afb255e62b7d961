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
// behind.  The bf16 kernel therefore does both products on the tensor
// cores (mma.sync m16n8k16, f32 accumulators) and reads each K/V tile from
// device memory once per block of 64 query rows; the f32 kernel (inputs
// the main path never gives it) stays on the CUDA cores.
//
// Design, both kernels:
// - One thread block = one (batch, query head, tile of 64 query rows).
//   A loop inside the block walks the K/V tiles of 64 keys; the online
//   softmax state (m, l, acc) lives in registers for the whole loop.  The
//   TPU kernels carried that state across sequential grid steps in VMEM
//   scratch; CUDA blocks run in no order, so the loop replaces that grid
//   dimension.
// - Causal: the loop stops at the exact causal limit of the tile's last
//   row (q_row + kv_offset), so K/V tiles above the diagonal are never read.
// - The softmax runs in the exp2 domain with scores scaled by
//   scale*log2(e) as the TPU kernel does (:170-179).  m is in log2 units and
//   l is a natural-domain sum, so lse = m*ln2 + log(l) (natural log at the
//   API), converted once.
// - GQA: query head h reads KV head h / (H / Hkv).
// - Ragged edges: K/V rows past Sk and Q rows past Sq are loaded as zeros
//   (predicated loads: the `zero_oob_rows` concern, :36-52); scores past
//   Sk are masked; rows past Sq are never stored.
// - Fully masked rows (possible only with a negative kv_offset) end with
//   lse ~ -inf; their `out` is unspecified, as on the TPU (:211-219).
//
// bf16 kernel (FlashAttention-2 layout): 4 warps, each owning 16 query
// rows.  Q is held in registers as mma A fragments for the whole loop.
// K and V tiles arrive in padded shared memory by cp.async (V's copy
// overlaps the Q K^T product) and are read with ldmatrix (V transposed).
// The score accumulators are rescaled, exponentiated and repacked as bf16
// A fragments of P in registers, so P never touches shared memory.  The
// output is staged through shared memory for 16-byte coalesced stores.
// Heavy causal tiles (last query rows) are scheduled first.
//
// f32 kernel: 256 threads; thread (ty, tx) owns query rows 4*ty..4*ty+3,
// score columns 4*tx..4*tx+3 and output columns {64*g + 4*tx + c}, all
// products as f32 FMAs from transposed shared-memory tiles.

#include "common.cuh"

namespace {

using tdt::LN2;
using tdt::NEG_INF;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile

// Number of K/V tiles a block of query rows [q0, q0 + BQ) must visit.
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal,
                                        int kv_offset) {
  if (!causal) return (Sk + BK - 1) / BK;
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int last_k = min(last_q + kv_offset, Sk - 1);
  return last_k < 0 ? 0 : last_k / BK + 1;
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; writes zeros instead when !pred.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 f32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// Rows [r0, r0 + 64) of a (n, D) bf16 matrix into a padded shared tile by
// cp.async; rows at or past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16 (*dst)[D + 8],
                                                const bf16* src, int r0,
                                                int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CH; c += MMA_NT) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n;
    cp_async16(&dst[r][ch * 8], src + (size_t)(ok ? r0 + r : 0) * D + ch * 8,
               ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_NT) flash_fwd_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale) {
  constexpr int KS = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // 8-wide output column tiles
  constexpr int NS = BK / 8;  // 8-wide score column tiles
  // Rows padded by 16 bytes: the 8 row addresses of an ldmatrix phase fall
  // in distinct banks.  Ks also stages Q before the loop and out after it.
  __shared__ __align__(16) bf16 Ks[BK][D + 8];
  __shared__ __align__(16) bf16 Vs[BK][D + 8];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest rows first
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;  // mma fragment row / column pair
  const int lr = lane % 16, lc = (lane / 16) * 8;  // ldmatrix x4 address
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const bf16* qp = q + (size_t)(b * H + h) * Sq * D;
  const bf16* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* vp = v + (size_t)(b * Hkv + hk) * Sk * D;

  // Q: device memory -> Ks -> A fragments in registers.
  load_tile_async<D>(Ks, qp, q0, Sq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], &Ks[warp * 16 + lr][kk * 16 + lc]);

  const int n_kt = kv_tiles(q0, Sq, Sk, causal, kv_offset);
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done reading Ks / Vs
    load_tile_async<D>(Ks, kp, k0, Sk, tid);
    cp_async_commit();
    load_tile_async<D>(Vs, vp, k0, Sk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // K has landed; V may still be in flight
    __syncthreads();

    // S = Q K^T: 16 rows x 64 keys per warp.  One ldmatrix x4 gives the B
    // fragments of two 8-key column tiles.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        unsigned kb[4];
        ldsm_x4(kb, &Ks[p * 16 + lr][kk * 16 + lc]);
        mma_bf16(s[2 * p], qf[kk], kb[0], kb[2]);
        mma_bf16(s[2 * p + 1], qf[kk], kb[1], kb[3]);
      }

    // Scale into log2 units; mask only where this tile crosses Sk or the
    // causal limit of the block's first row.
    const bool edge =
        k0 + BK > Sk || (causal && k0 + BK - 1 > q0 + kv_offset);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= qscale;
        if (edge) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int row = row0 + (e >> 1) * 8;
          if (key >= Sk || (causal && key > row + kv_offset)) s[j][e] = NEG_INF;
        }
      }

    // Online softmax.  A row's 64 scores are spread over the 4 lanes of a
    // quad; the max is reduced across them, the sum stays a per-lane
    // partial until the epilogue.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          rs += s[j][e];
        }
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

    cp_async_wait<0>();
    __syncthreads();

    // O += P V.  The accumulators of two score tiles are the A fragment of
    // a 16-key step; one transposed ldmatrix x4 gives the B fragments of
    // two 8-wide output tiles.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const unsigned pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        unsigned vb[4];
        ldsm_x4_trans(vb, &Vs[t * 16 + lr][p * 16 + lc]);
        mma_bf16(o[2 * p], pa, vb[0], vb[1]);
        mma_bf16(o[2 * p + 1], pa, vb[2], vb[3]);
      }
    }
  }

  // Epilogue.  Every warp is past the last read of Ks (the loop's second
  // barrier), and each warp only touches its own 16 rows of it.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    const int row = row0 + r * 8;
    if (tg == 0 && row < Sq)
      lse[(size_t)(b * H + h) * Sq + row] = m[r] * LN2 + logf(l[r]);
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<unsigned*>(&Ks[warp * 16 + g][n * 8 + tg * 2]) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<unsigned*>(&Ks[warp * 16 + g + 8][n * 8 + tg * 2]) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  bf16* op = out + (size_t)(b * H + h) * Sq * D;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(op + (size_t)row * D + ch * 8) =
          *reinterpret_cast<const uint4*>(&Ks[warp * 16 + r][ch * 8]);
  }
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs [D][BQ] + Ks [D][BK] + Vs [BK][D] + Ps [BK][BQ], all f32
  return sizeof(float) * (size_t)(D * BQ + D * BK + BK * D + BK * BQ);
}

template <int D>
__global__ void __launch_bounds__(F32_NT) flash_fwd_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale) {
  constexpr int CH = D / 8;       // 8-element chunks per row
  constexpr int NG = D / 64;      // 64-wide output column groups
  extern __shared__ float smem[];
  float* Qs = smem;               // [D][BQ]
  float* Ks = Qs + D * BQ;        // [D][BK]
  float* Vs = Ks + D * BK;        // [BK][D]
  float* Ps = Vs + BK * D;        // [BK][BQ]

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  const float* qp = q + (size_t)(b * H + h) * Sq * D;
  const float* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * Sk * D;

  // Stage Q, transposed and pre-scaled into the exp2 domain.
  for (int c = tid; c < BQ * CH; c += F32_NT) {
    const int r = c % BQ, dc = c / BQ;
    float f[8];
    if (q0 + r < Sq) {
      tdt::load8(qp + (size_t)(q0 + r) * D + dc * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[(dc * 8 + i) * BQ + r] = f[i] * qscale;
  }

  const int n_kt = kv_tiles(q0, Sq, Sk, causal, kv_offset);

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged / previous tile's readers are done
    // K transposed: consecutive threads take consecutive keys, so the
    // scalar shared-memory stores fall in distinct banks.
    for (int c = tid; c < BK * CH; c += F32_NT) {
      const int r = c % BK, dc = c / BK;
      float f[8];
      if (k0 + r < Sk) {
        tdt::load8(kp + (size_t)(k0 + r) * D + dc * 8, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) Ks[(dc * 8 + i) * BK + r] = f[i];
    }
    // V row-major: consecutive threads take consecutive chunks of a row.
    for (int c = tid; c < BK * CH; c += F32_NT) {
      const int r = c / CH, dc = c % CH;
      float f[8];
      if (k0 + r < Sk) {
        tdt::load8(vp + (size_t)(k0 + r) * D + dc * 8, f);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(&Vs[r * D + dc * 8]);
      dst[0] = make_float4(f[0], f[1], f[2], f[3]);
      dst[1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    __syncthreads();

    // S = Q K^T for this thread's 4x4 piece (log2 units).
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * BQ + ty * 4]);
      const float4 bb = *reinterpret_cast<const float4*>(&Ks[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Masks: keys past Sk, and the causal limit.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx * 4 + j;
        const bool ok = kc < Sk && (!causal || kc <= qr + kv_offset);
        if (!ok) s[i][j] = NEG_INF;
      }
    }

    // Online softmax.  The 16 threads sharing a row are 16 consecutive
    // lanes of one warp; the row max is reduced across them, the row sum
    // stays a per-thread partial until the epilogue.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * BQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * BQ + ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&Vs[j * D + g * 64 + tx * 4]);
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(pv[i], vf[c], acc[i][g * 4 + c]);
      }
    }
  }

  // Epilogue: finish the row sums, normalise, write out and lse.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      const float inv = 1.f / lt;
      float* op = out + ((size_t)(b * H + h) * Sq + row) * D;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          op[g * 64 + tx * 4 + c] = acc[i][g * 4 + c] * inv;
      if (tx == 0) lse[(size_t)(b * H + h) * Sq + row] = m[i] * LN2 + logf(lt);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, int causal,
                int kv_offset, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (Sq + BQ - 1) / BQ);
  flash_fwd_bf16_kernel<D><<<grid, MMA_NT, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, causal, kv_offset,
      scale * tdt::LOG2E);
  return (int)cudaGetLastError();
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
