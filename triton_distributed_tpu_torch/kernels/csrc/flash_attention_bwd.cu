// Causal / non-causal GQA flash attention, backward (training): K4 computes
// dq, K5 computes dk and dv.
//
// Replaces: triton_distributed_tpu/kernels/flash_attention.py
//   `_flash_backward` -> `_flash_bwd_dq_kernel` (pallas_call :948) and
//   `_flash_bwd_dkv_kernel` (pallas_call :987).
//
// Contract (the JAX package's): with p = exp(s - lse) on the scores
// s = scale * q k^T, delta = rowsum(do * out) - dlse (XLA code in the JAX
// package; here K4's prologue computes it and writes it for K5, which runs
// after K4 on the same stream), ds = p * (do v^T - delta):
//   dq = scale * ds k,   dk = scale * ds^T q,   dv = p^T do,
// dk and dv summed over each GQA group.  Rows whose lse is at the fully
// masked sentinel (lse <= NEG_INF * ln2 / 2, possible only with a negative
// kv_offset) contribute nothing: their p and ds are SELECTED to zero, so a
// NaN `out` (and delta) on such a row never reaches a product.  Key columns
// past Sk and past the causal limit get p = 0; query rows past Sq are
// zero-filled and masked, because they are the contraction dimension of
// dk and dv.
//
// What bounds it on the H100: at the Qwen3-8B training shape (q/do/out/dq
// 4x32x512x128, k/v 4x8x512x128 bf16, causal) K4 moves ~76 MB (22.8 us at
// 3.35 TB/s) against 12.9 GFLOP of products (13 us at 989 TFLOP/s), so its
// bound is bytes; K5 does 17.2 GFLOP (17.4 us) against ~51 MB, so its bound
// is operations.  At 1x32x2048x128 both are bound by operations (51.5 and
// 68.7 GFLOP).  Every product therefore runs on the tensor cores (mma.sync
// m16n8k16, f32 accumulators), and each block reads its streamed tiles from
// device memory once.
//
// Design, bf16 (4 warps, 64-row tiles, operands in padded shared memory read
// with ldmatrix, as the forward kernel K1 does):
// - K4: one block per (batch, query head, 64 query rows); a prologue forms
//   the tile's delta from do and out (two threads a row); a loop over the
//   visible K/V tiles (tiles wholly above the causal diagonal are skipped)
//   recomputes s = q k^T and p in the exp2 domain, dp = do v^T and ds, and
//   accumulates dq += ds k in registers; dq * scale is written once.  The TPU
//   kernel carried dq across sequential grid steps in VMEM scratch; here the
//   loop inside the block replaces that grid dimension.
// - K5: one block per (batch, KV head, 64 key rows); a loop over the group's
//   query heads and their visible query tiles computes s^T = k q^T, p^T,
//   dp^T = v do^T and ds^T, and accumulates dv += p^T do and
//   dk += ds^T q in registers (a query tile in two halves of 32 rows, so
//   that the score fragments of only one half are live beside dk and dv).
//   Summing the GQA group inside the block needs no atomics, is
//   deterministic, and avoids the TPU version's (B, H, Sk, D) f32
//   intermediates.
// - Operand precision follows the TPU kernels: p is rounded to bf16 for
//   dv = p^T do, ds to bf16 for dq and dk; s and dp are exact products of
//   bf16 values summed in f32.
//
// f32 kernels (inputs the main path never gives them; tests and the f32
// model-gradient check do) compute the same on the CUDA cores: 256 threads,
// each owning a 4x4 (K5: 4x2) piece of the score tile and 4 rows of the
// output, from transposed shared-memory tiles.

#include "common.cuh"

namespace {

using tdt::LN2;
using tdt::LOG2E;
using tdt::NEG_INF;
using tdt::cp_async_commit;
using tdt::cp_async_wait;
using tdt::ldsm_x4;
using tdt::ldsm_x4_trans;
using tdt::mma_bf16;
using tdt::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
// lse at or below this marks a fully masked row (the JAX kernels' test).
constexpr float LSE_DEAD = NEG_INF * (LN2 / 2);

// First query tile (of BQ rows) that sees any key of [k0, k0 + BK).
__device__ __forceinline__ int first_q_tile(int k0, int causal,
                                            int kv_offset) {
  if (!causal) return 0;
  return max(k0 - kv_offset, 0) / BQ;
}

__device__ __forceinline__ bool visible(int key, int row, int Sk, int causal,
                                        int kv_offset) {
  return key < Sk && (!causal || key <= row + kv_offset);
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps x 16 rows

template <int D>
constexpr size_t bf16_smem_bytes() {
  // four padded (64, D + 8) bf16 tiles, plus per-row lse and delta
  return 4 * 64 * (D + 8) * sizeof(bf16) + 2 * BQ * sizeof(float);
}

// delta = rowsum(do * out) - dlse for rows [q0, q0 + 64) of one head, NT /
// 64 threads a row (consecutive lanes): written to `delta` and to `ds`
// (shared, 64 floats).  dlse may be null.  Ends in a block barrier.
template <int D, int NT, typename T>
__device__ __forceinline__ void row_delta(const T* dout, const T* out,
                                          const float* dlse, float* delta,
                                          float* ds, int q0, int Sq,
                                          int tid) {
  constexpr int PER = NT / 64;  // threads a row
  constexpr int W = D / PER;    // elements a thread
  const int r = tid / PER, part = tid % PER;
  const int row = q0 + r;
  float acc = 0.f;
  if (row < Sq) {
    const T* dp = dout + (size_t)row * D + part * W;
    const T* op = out + (size_t)row * D + part * W;
#pragma unroll
    for (int c = 0; c < W; c += 8) {
      float a[8], b[8];
      tdt::load8(dp + c, a);
      tdt::load8(op + c, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc = fmaf(a[i], b[i], acc);
    }
  }
#pragma unroll
  for (int off = 1; off < PER; off <<= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) {
    const float d = row < Sq ? acc - (dlse ? dlse[row] : 0.f) : 0.f;
    if (row < Sq) delta[row] = d;
    ds[r] = d;
  }
  __syncthreads();
}

// Writes a warp's 16 rows of f32 fragments (acc[n][4], 8-wide column tiles)
// times `mul` as bf16 rows [r0, r0 + 16) of a (n_rows, D) matrix, staged
// through the warp's own 16 rows of the shared tile `stage` so that each
// row goes out in 16-byte stores.
template <int D>
__device__ __forceinline__ void store_rows_bf16(bf16* dst, bf16 (*stage)[D + 8],
                                                const float (&acc)[D / 8][4],
                                                float mul, int r0, int n_rows,
                                                int warp, int lane) {
  const int g = lane / 4, tg = lane % 4;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<unsigned*>(&stage[warp * 16 + g][n * 8 + tg * 2]) =
        pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    *reinterpret_cast<unsigned*>(&stage[warp * 16 + g + 8][n * 8 + tg * 2]) =
        pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    if (r0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * D + ch * 8) =
          *reinterpret_cast<const uint4*>(&stage[warp * 16 + r][ch * 8]);
  }
}

// K4: dq.  Grid (H, B, ceil(Sq / BQ)), heaviest causal tiles first.
template <int D>
__global__ void __launch_bounds__(MMA_NT) bwd_dq_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const bf16* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dlse, float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale, float scale) {
  constexpr int KS = D / 16;  // k-steps over D
  constexpr int NO = D / 8;   // 8-wide dq column tiles
  constexpr int NS = BK / 8;  // 8-wide score column tiles
  using Tile = bf16[D + 8];
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* Qs = reinterpret_cast<Tile*>(smem);
  Tile* dOs = Qs + BQ;
  Tile* Ks = dOs + BQ;
  Tile* Vs = Ks + BK;
  float* Dsm = reinterpret_cast<float*>(Vs + BK);  // the tile's delta

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int lr = lane % 16, lc = (lane / 16) * 8;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const size_t qoff = (size_t)(b * H + h) * Sq;
  const bf16* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const bf16* vp = v + (size_t)(b * Hkv + hk) * Sk * D;

  tdt::load_tile_async<D, MMA_NT>(Qs, q + qoff * D, q0, Sq, tid);
  tdt::load_tile_async<D, MMA_NT>(dOs, dout + qoff * D, q0, Sq, tid);
  cp_async_commit();
  row_delta<D, MMA_NT>(dout + qoff * D, out + qoff * D,
                       dlse ? dlse + qoff : nullptr, delta + qoff, Dsm, q0,
                       Sq, tid);

  // Row statistics, in the exp2 domain.  A row past Sq or at the lse
  // sentinel is dead: its p and ds are zero.
  float lse2[2], dlt[2];
  bool live[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    const float l = row < Sq ? lse[qoff + row] : NEG_INF;
    live[r] = l > LSE_DEAD;
    lse2[r] = live[r] ? l * LOG2E : 0.f;
    dlt[r] = live[r] ? Dsm[row - q0] : 0.f;
  }

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_kt = tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done reading Ks / Vs
    tdt::load_tile_async<D, MMA_NT>(Ks, kp, k0, Sk, tid);
    cp_async_commit();
    tdt::load_tile_async<D, MMA_NT>(Vs, vp, k0, Sk, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and K have landed; V may be in flight
    __syncthreads();

    // S = Q K^T (16 rows x 64 keys per warp), then P in place.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned qa[4];
      ldsm_x4(qa, &Qs[warp * 16 + lr][kk * 16 + lc]);
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        unsigned kb[4];
        ldsm_x4(kb, &Ks[p * 16 + lr][kk * 16 + lc]);
        mma_bf16(s[2 * p], qa, kb[0], kb[2]);
        mma_bf16(s[2 * p + 1], qa, kb[1], kb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const bool ok =
            live[r] && visible(key, row0 + r * 8, Sk, causal, kv_offset);
        s[j][e] = ok ? exp2f(fminf(s[j][e] * qscale - lse2[r], 0.f)) : 0.f;
      }

    cp_async_wait<0>();
    __syncthreads();

    // dP = dO V^T, then dS = P (dP - delta) in place (selected to zero on
    // dead rows, so a NaN delta there never leaks).
    float ds[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      unsigned da[4];
      ldsm_x4(da, &dOs[warp * 16 + lr][kk * 16 + lc]);
#pragma unroll
      for (int p = 0; p < NS / 2; ++p) {
        unsigned vb[4];
        ldsm_x4(vb, &Vs[p * 16 + lr][kk * 16 + lc]);
        mma_bf16(ds[2 * p], da, vb[0], vb[2]);
        mma_bf16(ds[2 * p + 1], da, vb[1], vb[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        ds[j][e] = live[r] ? s[j][e] * (ds[j][e] - dlt[r]) : 0.f;
      }

    // dQ += dS K: dS's accumulators are the A fragments of a 16-key step;
    // one transposed ldmatrix x4 gives the B fragments of two 8-wide
    // column tiles of K.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const unsigned a[4] = {pack_bf16(ds[2 * t][0], ds[2 * t][1]),
                             pack_bf16(ds[2 * t][2], ds[2 * t][3]),
                             pack_bf16(ds[2 * t + 1][0], ds[2 * t + 1][1]),
                             pack_bf16(ds[2 * t + 1][2], ds[2 * t + 1][3])};
#pragma unroll
      for (int p = 0; p < NO / 2; ++p) {
        unsigned kb[4];
        ldsm_x4_trans(kb, &Ks[t * 16 + lr][p * 16 + lc]);
        mma_bf16(acc[2 * p], a, kb[0], kb[1]);
        mma_bf16(acc[2 * p + 1], a, kb[2], kb[3]);
      }
    }
  }
  if (n_kt == 0) {  // nothing visible: dq = 0, but Q / dO are in flight
    cp_async_wait<0>();
    __syncthreads();
  }
  // Each warp reads only its own 16 rows of Qs, so it may stage dq there.
  store_rows_bf16<D>(dq + qoff * D, Qs, acc, scale, q0 + warp * 16, Sq, warp,
                     lane);
}

// K5: dk and dv.  Grid (Hkv, B, ceil(Sk / BK)); the first key tiles see
// the most query rows under a causal mask and are scheduled first.
template <int D>
__global__ void __launch_bounds__(MMA_NT) bwd_dkv_bf16_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
    int Sk, int causal, int kv_offset, float qscale, float scale) {
  constexpr int KS = D / 16;  // k-steps over D
  constexpr int NO = D / 8;   // 8-wide dk / dv column tiles
  constexpr int HQ = 32;      // query rows computed at once
  constexpr int NS = HQ / 8;  // 8-wide score column tiles (query rows)
  using Tile = bf16[D + 8];
  extern __shared__ __align__(16) unsigned char smem[];
  Tile* Ks = reinterpret_cast<Tile*>(smem);
  Tile* Vs = Ks + BK;
  Tile* Qs = Vs + BK;
  Tile* dOs = Qs + BQ;
  // lse * log2(e) of each query row of the tile, NEG_INF on dead rows;
  // delta, 0 on dead rows.
  float* Ls = reinterpret_cast<float*>(dOs + BQ);
  float* Ds = Ls + BQ;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BK;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int lr = lane % 16, lc = (lane / 16) * 8;
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8

  const size_t kvoff = (size_t)(b * Hkv + hk) * Sk;
  tdt::load_tile_async<D, MMA_NT>(Ks, k + kvoff * D, k0, Sk, tid);
  tdt::load_tile_async<D, MMA_NT>(Vs, v + kvoff * D, k0, Sk, tid);
  cp_async_commit();

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;

  const int nq = (Sq + BQ - 1) / BQ;
  const int qt0 = first_q_tile(k0, causal, kv_offset);
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (size_t)(b * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done reading Qs / dOs / Ls / Ds
      tdt::load_tile_async<D, MMA_NT>(Qs, q + qoff * D, q0, Sq, tid);
      tdt::load_tile_async<D, MMA_NT>(dOs, dout + qoff * D, q0, Sq, tid);
      cp_async_commit();
      if (tid < BQ) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[qoff + row] : NEG_INF;
        const bool live = l > LSE_DEAD;
        Ls[tid] = live ? l * LOG2E : NEG_INF;
        Ds[tid] = live ? delta[qoff + row] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // The tile's query rows in halves of HQ: the score and dS fragments
      // of a half stay live, not the whole tile's (register pressure).
#pragma unroll 1
      for (int c0 = 0; c0 < BQ; c0 += HQ) {
        // S^T = K Q^T (16 keys x HQ query rows per warp), then P^T in place.
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          unsigned ka[4];
          ldsm_x4(ka, &Ks[warp * 16 + lr][kk * 16 + lc]);
#pragma unroll
          for (int p = 0; p < NS / 2; ++p) {
            unsigned qb[4];
            ldsm_x4(qb, &Qs[c0 + p * 16 + lr][kk * 16 + lc]);
            mma_bf16(s[2 * p], ka, qb[0], qb[2]);
            mma_bf16(s[2 * p + 1], ka, qb[1], qb[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + tg * 2 + (e & 1);  // row in the tile
            const int key = key0 + (e >> 1) * 8;
            const bool ok = Ls[c] > NEG_INF && q0 + c < Sq &&
                            visible(key, q0 + c, Sk, causal, kv_offset);
            s[j][e] = ok ? exp2f(fminf(s[j][e] * qscale - Ls[c], 0.f)) : 0.f;
          }

        // dP^T = V dO^T.
        float ds[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          unsigned va[4];
          ldsm_x4(va, &Vs[warp * 16 + lr][kk * 16 + lc]);
#pragma unroll
          for (int p = 0; p < NS / 2; ++p) {
            unsigned db[4];
            ldsm_x4(db, &dOs[c0 + p * 16 + lr][kk * 16 + lc]);
            mma_bf16(ds[2 * p], va, db[0], db[2]);
            mma_bf16(ds[2 * p + 1], va, db[1], db[3]);
          }
        }

        // dV += P^T dO, with P^T rounded to bf16 as the A fragments.
#pragma unroll
        for (int t = 0; t < HQ / 16; ++t) {
          const unsigned a[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                                 pack_bf16(s[2 * t][2], s[2 * t][3]),
                                 pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                                 pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
          for (int p = 0; p < NO / 2; ++p) {
            unsigned ob[4];
            ldsm_x4_trans(ob, &dOs[c0 + t * 16 + lr][p * 16 + lc]);
            mma_bf16(dva[2 * p], a, ob[0], ob[1]);
            mma_bf16(dva[2 * p + 1], a, ob[2], ob[3]);
          }
        }

        // dS^T = P^T (dP^T - delta), selected to zero on dead query rows.
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = c0 + j * 8 + tg * 2 + (e & 1);
            ds[j][e] = Ls[c] > NEG_INF ? s[j][e] * (ds[j][e] - Ds[c]) : 0.f;
          }

        // dK += dS^T Q.
#pragma unroll
        for (int t = 0; t < HQ / 16; ++t) {
          const unsigned a[4] = {pack_bf16(ds[2 * t][0], ds[2 * t][1]),
                                 pack_bf16(ds[2 * t][2], ds[2 * t][3]),
                                 pack_bf16(ds[2 * t + 1][0], ds[2 * t + 1][1]),
                                 pack_bf16(ds[2 * t + 1][2], ds[2 * t + 1][3])};
#pragma unroll
          for (int p = 0; p < NO / 2; ++p) {
            unsigned qb[4];
            ldsm_x4_trans(qb, &Qs[c0 + t * 16 + lr][p * 16 + lc]);
            mma_bf16(dka[2 * p], a, qb[0], qb[1]);
            mma_bf16(dka[2 * p + 1], a, qb[2], qb[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // K / V are in flight if no query tile was visible
  __syncthreads();
  // Each warp reads only its own 16 rows of Ks and Vs.
  store_rows_bf16<D>(dk + kvoff * D, Ks, dka, scale, k0 + warp * 16, Sk, warp,
                     lane);
  store_rows_bf16<D>(dv + kvoff * D, Vs, dva, 1.f, k0 + warp * 16, Sk, warp,
                     lane);
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block
constexpr int BQ5 = 32;      // K5 f32: query rows per tile

template <int D>
constexpr size_t dq_f32_smem_bytes() {
  // QsT, dOsT, KsT, VsT [D][64]; Ks [64][D]; dSs [64][64]; delta [64]
  return sizeof(float) * (size_t)(5 * D * 64 + BK * BQ + BQ);
}

template <int D>
constexpr size_t dkv_f32_smem_bytes() {
  // KsT, VsT [D][64]; QsT, dOsT [D][32]; Qs, dOs [32][D]; Ps, dSs [32][64];
  // Ls, Ds [32]
  return sizeof(float) *
         (size_t)(2 * D * BK + 4 * D * BQ5 + 2 * BQ5 * BK + 2 * BQ5);
}

// Rows [r0, r0 + n_rows_tile) of a (n, D) f32 matrix into shared memory,
// transposed (dstT[d * ld + r]) and/or row-major (dst[r * D + d]); rows at
// or past n are zeros.
template <int D>
__device__ __forceinline__ void stage_f32(const float* src, int r0, int n,
                                          int rows, float* dstT, int ld,
                                          float* dst, int tid) {
  constexpr int CH = D / 8;
  for (int c = tid; c < rows * CH; c += F32_NT) {
    const int r = c % rows, dc = c / rows;  // consecutive threads, rows
    float f[8];
    if (r0 + r < n) {
      tdt::load8(src + (size_t)(r0 + r) * D + dc * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
    if (dstT) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dstT[(dc * 8 + i) * ld + r] = f[i];
    }
    if (dst) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[r * D + dc * 8 + i] = f[i];
    }
  }
}

// K4 f32.  Thread (ty, tx) owns query rows 4*ty..4*ty+3, keys 4*tx..4*tx+3
// of the score tile and dq columns {64*gc + 4*tx + c}.
template <int D>
__global__ void __launch_bounds__(F32_NT) bwd_dq_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ out, const float* __restrict__ lse,
    const float* __restrict__ dlse, float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int causal,
    int kv_offset, float qscale, float scale) {
  constexpr int NG = D / 64;
  extern __shared__ float smem_f[];
  float* QsT = smem_f;          // [D][BQ]
  float* dOsT = QsT + D * BQ;   // [D][BQ]
  float* KsT = dOsT + D * BQ;   // [D][BK]
  float* VsT = KsT + D * BK;    // [D][BK]
  float* Ks = VsT + D * BK;     // [BK][D]
  float* dSs = Ks + BK * D;     // [BK][BQ]
  float* Dsm = dSs + BK * BQ;   // [BQ], the tile's delta

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t qoff = (size_t)(b * H + h) * Sq;
  const float* kp = k + (size_t)(b * Hkv + hk) * Sk * D;
  const float* vp = v + (size_t)(b * Hkv + hk) * Sk * D;

  stage_f32<D>(q + qoff * D, q0, Sq, BQ, QsT, BQ, nullptr, tid);
  stage_f32<D>(dout + qoff * D, q0, Sq, BQ, dOsT, BQ, nullptr, tid);
  row_delta<D, F32_NT>(dout + qoff * D, out + qoff * D,
                       dlse ? dlse + qoff : nullptr, delta + qoff, Dsm, q0,
                       Sq, tid);

  float lse2[4], dlt[4];
  bool live[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float l = row < Sq ? lse[qoff + row] : NEG_INF;
    live[i] = l > LSE_DEAD;
    lse2[i] = live[i] ? l * LOG2E : 0.f;
    dlt[i] = live[i] ? Dsm[ty * 4 + i] : 0.f;
  }
  float acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;

  const int n_kt = tdt::kv_tiles<BQ, BK>(q0, Sq, Sk, causal, kv_offset);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage_f32<D>(kp, k0, Sk, BK, KsT, BK, Ks, tid);
    stage_f32<D>(vp, k0, Sk, BK, VsT, BK, nullptr, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&QsT[d * BQ + ty * 4]);
      const float4 o = *reinterpret_cast<const float4*>(&dOsT[d * BQ + ty * 4]);
      const float4 kk = *reinterpret_cast<const float4*>(&KsT[d * BK + tx * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&VsT[d * BK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float ov[4] = {o.x, o.y, o.z, o.w};
      const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
      const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(av[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vf[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = live[i] && visible(k0 + tx * 4 + j, q0 + ty * 4 + i,
                                           Sk, causal, kv_offset);
        const float p =
            ok ? exp2f(fminf(s[i][j] * qscale - lse2[i], 0.f)) : 0.f;
        dp[i][j] = live[i] ? p * (dp[i][j] - dlt[i]) : 0.f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&dSs[(tx * 4 + j) * BQ + ty * 4]) =
          make_float4(dp[0][j], dp[1][j], dp[2][j], dp[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(&dSs[j * BQ + ty * 4]);
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int gc = 0; gc < NG; ++gc) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&Ks[j * D + gc * 64 + tx * 4]);
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][gc * 4 + c] = fmaf(wv[i], kv[c], acc[i][gc * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      float* op = dq + (qoff + row) * D;
#pragma unroll
      for (int gc = 0; gc < NG; ++gc)
        *reinterpret_cast<float4*>(&op[gc * 64 + tx * 4]) = make_float4(
            acc[i][gc * 4] * scale, acc[i][gc * 4 + 1] * scale,
            acc[i][gc * 4 + 2] * scale, acc[i][gc * 4 + 3] * scale);
    }
  }
}

// K5 f32.  Thread (ty, tx) owns keys 4*ty..4*ty+3, query rows 2*tx, 2*tx+1
// of the (64 keys x 32 rows) score tile, and dk / dv columns
// {64*gc + 4*tx + c} of its keys.
template <int D>
__global__ void __launch_bounds__(F32_NT) bwd_dkv_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq,
    int Sk, int causal, int kv_offset, float qscale, float scale) {
  constexpr int NG = D / 64;
  extern __shared__ float smem_f[];
  float* KsT = smem_f;           // [D][BK]
  float* VsT = KsT + D * BK;     // [D][BK]
  float* QsT = VsT + D * BK;     // [D][BQ5]
  float* dOsT = QsT + D * BQ5;   // [D][BQ5]
  float* Qs = dOsT + D * BQ5;    // [BQ5][D]
  float* dOs = Qs + BQ5 * D;     // [BQ5][D]
  float* Ps = dOs + BQ5 * D;     // [BQ5][BK]
  float* dSs = Ps + BQ5 * BK;    // [BQ5][BK]
  float* Ls = dSs + BQ5 * BK;    // [BQ5]
  float* Ds = Ls + BQ5;          // [BQ5]

  const int k0 = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = H / Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const size_t kvoff = (size_t)(b * Hkv + hk) * Sk;

  stage_f32<D>(k + kvoff * D, k0, Sk, BK, KsT, BK, nullptr, tid);
  stage_f32<D>(v + kvoff * D, k0, Sk, BK, VsT, BK, nullptr, tid);

  float dka[4][4 * NG], dva[4][4 * NG];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) dka[j][c] = dva[j][c] = 0.f;

  const int nq = (Sq + BQ5 - 1) / BQ5;
  const int qt0 = causal ? max(k0 - kv_offset, 0) / BQ5 : 0;
  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const size_t qoff = (size_t)(b * H + h) * Sq;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ5;
      __syncthreads();
      stage_f32<D>(q + qoff * D, q0, Sq, BQ5, QsT, BQ5, Qs, tid);
      stage_f32<D>(dout + qoff * D, q0, Sq, BQ5, dOsT, BQ5, dOs, tid);
      if (tid < BQ5) {
        const int row = q0 + tid;
        const float l = row < Sq ? lse[qoff + row] : NEG_INF;
        const bool live = l > LSE_DEAD;
        Ls[tid] = live ? l * LOG2E : NEG_INF;
        Ds[tid] = live ? delta[qoff + row] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) s[j][i] = dp[j][i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&KsT[d * BK + ty * 4]);
        const float4 vv =
            *reinterpret_cast<const float4*>(&VsT[d * BK + ty * 4]);
        const float2 a = *reinterpret_cast<const float2*>(&QsT[d * BQ5 + tx * 2]);
        const float2 o =
            *reinterpret_cast<const float2*>(&dOsT[d * BQ5 + tx * 2]);
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float vf[4] = {vv.x, vv.y, vv.z, vv.w};
        const float av[2] = {a.x, a.y};
        const float ov[2] = {o.x, o.y};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            s[j][i] = fmaf(kv[j], av[i], s[j][i]);
            dp[j][i] = fmaf(vf[j], ov[i], dp[j][i]);
          }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = tx * 2 + i;
          const bool live = Ls[c] > NEG_INF;
          const bool ok = live && q0 + c < Sq &&
                          visible(k0 + ty * 4 + j, q0 + c, Sk, causal,
                                  kv_offset);
          const float p = ok ? exp2f(fminf(s[j][i] * qscale - Ls[c], 0.f))
                             : 0.f;
          s[j][i] = p;
          dp[j][i] = live ? p * (dp[j][i] - Ds[c]) : 0.f;
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<float4*>(&Ps[(tx * 2 + i) * BK + ty * 4]) =
            make_float4(s[0][i], s[1][i], s[2][i], s[3][i]);
        *reinterpret_cast<float4*>(&dSs[(tx * 2 + i) * BK + ty * 4]) =
            make_float4(dp[0][i], dp[1][i], dp[2][i], dp[3][i]);
      }
      __syncthreads();

#pragma unroll 4
      for (int i = 0; i < BQ5; ++i) {
        const float4 p4 = *reinterpret_cast<const float4*>(&Ps[i * BK + ty * 4]);
        const float4 s4 =
            *reinterpret_cast<const float4*>(&dSs[i * BK + ty * 4]);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int gc = 0; gc < NG; ++gc) {
          const float4 o4 =
              *reinterpret_cast<const float4*>(&dOs[i * D + gc * 64 + tx * 4]);
          const float4 q4 =
              *reinterpret_cast<const float4*>(&Qs[i * D + gc * 64 + tx * 4]);
          const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
          const float qv[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dva[j][gc * 4 + c] = fmaf(pv[j], ov[c], dva[j][gc * 4 + c]);
              dka[j][gc * 4 + c] = fmaf(sv[j], qv[c], dka[j][gc * 4 + c]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + ty * 4 + j;
    if (key < Sk) {
      float* kop = dk + (kvoff + key) * D;
      float* vop = dv + (kvoff + key) * D;
#pragma unroll
      for (int gc = 0; gc < NG; ++gc) {
        *reinterpret_cast<float4*>(&kop[gc * 64 + tx * 4]) = make_float4(
            dka[j][gc * 4] * scale, dka[j][gc * 4 + 1] * scale,
            dka[j][gc * 4 + 2] * scale, dka[j][gc * 4 + 3] * scale);
        *reinterpret_cast<float4*>(&vop[gc * 64 + tx * 4]) =
            make_float4(dva[j][gc * 4], dva[j][gc * 4 + 1],
                        dva[j][gc * 4 + 2], dva[j][gc * 4 + 3]);
      }
    }
  }
}

// Raises a kernel's dynamic shared-memory limit once per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) done = true;
  return e;
}

struct Args {
  const void *q, *k, *v, *dout, *lse;
  int B, H, Hkv, Sq, Sk, causal, kv_offset;
  float scale;
};

template <int D>
int launch_dq(const Args& a, const void* out, const void* dlse, void* delta,
              void* dq, int dtype, cudaStream_t s) {
  const float qscale = a.scale * LOG2E;
  if (dtype == tdt::DTYPE_BF16) {
    static bool ready = false;
    constexpr size_t smem = bf16_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dq_bf16_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.H, a.B, (a.Sq + BQ - 1) / BQ);
    bwd_dq_bf16_kernel<D><<<grid, MMA_NT, smem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const bf16*>(out), static_cast<const float*>(a.lse),
        static_cast<const float*>(dlse), static_cast<float*>(delta),
        static_cast<bf16*>(dq), a.H, a.Hkv, a.Sq, a.Sk, a.causal,
        a.kv_offset, qscale, a.scale);
  } else {
    static bool ready = false;
    constexpr size_t smem = dq_f32_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dq_f32_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sq + BQ - 1) / BQ, a.H, a.B);
    bwd_dq_f32_kernel<D><<<grid, F32_NT, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(out), static_cast<const float*>(a.lse),
        static_cast<const float*>(dlse), static_cast<float*>(delta),
        static_cast<float*>(dq), a.H, a.Hkv, a.Sq, a.Sk, a.causal,
        a.kv_offset, qscale, a.scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const Args& a, const void* delta, void* dk, void* dv,
               int dtype, cudaStream_t s) {
  const float qscale = a.scale * LOG2E;
  if (dtype == tdt::DTYPE_BF16) {
    static bool ready = false;
    constexpr size_t smem = bf16_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dkv_bf16_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(a.Hkv, a.B, (a.Sk + BK - 1) / BK);
    bwd_dkv_bf16_kernel<D><<<grid, MMA_NT, smem, s>>>(
        static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
        static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.H, a.Hkv, a.Sq,
        a.Sk, a.causal, a.kv_offset, qscale, a.scale);
  } else {
    static bool ready = false;
    constexpr size_t smem = dkv_f32_smem_bytes<D>();
    const cudaError_t e = allow_smem(bwd_dkv_f32_kernel<D>, smem, ready);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Sk + BK - 1) / BK, a.Hkv, a.B);
    bwd_dkv_f32_kernel<D><<<grid, F32_NT, smem, s>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k),
        static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), a.H, a.Hkv, a.Sq,
        a.Sk, a.causal, a.kv_offset, qscale, a.scale);
  }
  return (int)cudaGetLastError();
}

bool supported(int dtype, int D) {
  return (dtype == tdt::DTYPE_BF16 || dtype == tdt::DTYPE_F32) &&
         (D == 64 || D == 128);
}

}  // namespace

// K4.  q/dout/out/dq (B,H,Sq,D), k/v (B,Hkv,Sk,D) contiguous, one dtype;
// lse, dlse (may be null) and delta (written: rowsum(dout * out) - dlse)
// (B,H,Sq) f32.  Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* out, const void* lse,
                                      const void* dlse, void* delta, void* dq,
                                      int dtype, int B, int H, int Hkv,
                                      int Sq, int Sk, int D, int causal,
                                      int kv_offset, float scale,
                                      void* stream) {
  if (!supported(dtype, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Args a{q, k, v, dout, lse, B, H, Hkv, Sq, Sk, causal, kv_offset,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dq<128>(a, out, dlse, delta, dq, dtype, s)
                  : launch_dq<64>(a, out, dlse, delta, dq, dtype, s);
}

// K5.  The same q, k, v, dout, lse and K4's delta; dk, dv (B,Hkv,Sk,D) in
// the inputs' dtype.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int dtype, int B,
                                       int H, int Hkv, int Sq, int Sk, int D,
                                       int causal, int kv_offset, float scale,
                                       void* stream) {
  if (!supported(dtype, D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  const Args a{q, k, v, dout, lse, B, H, Hkv, Sq, Sk, causal, kv_offset,
               scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch_dkv<128>(a, delta, dk, dv, dtype, s)
                  : launch_dkv<64>(a, delta, dk, dv, dtype, s);
}
