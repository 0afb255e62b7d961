// The flash-attention tile bodies shared by K1 (`flash_attention.cu`) and
// K20 (`sp_ag_attention.cu`): one block owns a tile of BQ = 64 query rows
// of one (batch, head) and walks K/V tiles of BK = 64 keys with the online
// softmax state (m, l, acc) in registers.  Each body is three device
// functions: `begin` stages the query tile and clears the state, `attend`
// folds the K/V tiles of one key range into it (callable again on further
// ranges: the state carries over, so K20 folds one ring chunk after another
// into it), and `finish` normalises and stores out and lse.
//
// Replaces the online-softmax block of triton_distributed_tpu/kernels/
// flash_attention.py `_flash_kernel` (:150-230) and its in-kernel form
// sp_ag_attention.py `_emit_flash_chunk` (:181).  The math, for both:
// - scores are scaled by scale*log2(e) into the exp2 domain as the TPU
//   kernel does (:170-179); m is in log2 units and l a natural-domain sum,
//   so lse = m*ln2 + log(l) (natural log at the API);
// - causal: query row i sees keys <= i + kv_offset; an `attend` call visits
//   only the K/V tiles up to the tile's last row's limit (`kv_tiles`), so
//   tiles above the diagonal are never read;
// - keys past Sk and query rows past Sq are loaded as zeros; scores past Sk
//   are masked (NEG_INF, finite as on the TPU); rows past Sq are not stored;
// - a row that saw no key ends with lse ~ -inf and an unspecified out.  A
//   fully masked tile row adds exp2(0) weights while m is still NEG_INF;
//   the first real key resets them (alpha = exp2(NEG_INF - m) = 0), so a
//   row that sees any key in any range is exact.
//
// bf16 body (FlashAttention-2 layout): 4 warps, each owning 16 query rows.
// Q is held in registers as mma.sync A fragments.  K and V tiles arrive in
// padded shared memory by cp.async.cg (V's copy overlaps the Q K^T product;
// .cg reads through L2, so a tile another rank's blocks wrote is read
// fresh) and are read with ldmatrix (V transposed).  The score accumulators
// are rescaled, exponentiated and repacked as bf16 A fragments of P in
// registers.  The output is staged through shared memory for 16-byte
// stores.
//
// f32 body: 256 threads; thread (ty, tx) owns query rows 4*ty..4*ty+3,
// score columns 4*tx..4*tx+3 and output columns {64*g + 4*tx + c}, all
// products as f32 FMAs from transposed shared-memory tiles.
#pragma once

#include "common.cuh"

namespace tdt {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per K/V tile

// The natural-log lse of a row, m * ln2 + log(l), rounded after the
// product and after the sum: spelled out with intrinsics, which the
// compiler never contracts into an FMA, so every kernel that inlines the
// bodies rounds it alike (K1 compiled it this way before the bodies were
// shared).
__device__ __forceinline__ float lse_of(float m, float l) {
  return __fadd_rn(__fmul_rn(m, LN2), logf(l));
}

// ---- bf16: tensor cores ---------------------------------------------------

constexpr int MMA_NT = 128;  // 4 warps x 16 query rows

// Rows padded by 16 bytes: the 8 row addresses of an ldmatrix phase fall in
// distinct banks.  Ks also stages Q before the loop and out after it.
template <int D>
struct Bf16Smem {
  bf16 Ks[BK][D + 8];
  bf16 Vs[BK][D + 8];
};

// One thread's share of a query tile: Q fragments and the softmax state of
// its two rows (row0, row0 + 8) over D/8 output column tiles.
template <int D>
struct Bf16State {
  static constexpr int KS = D / 16;  // k-steps of Q K^T
  static constexpr int NO = D / 8;   // 8-wide output column tiles
  unsigned qf[KS][4];
  float o[NO][4];
  float m[2], l[2];
};

// Stage rows [q0, q0 + BQ) of qp (Sq rows of D) into registers and clear the
// state.  Every thread of the block calls it; Ks must be free.
template <int D>
__device__ __forceinline__ void bf16_begin(Bf16Smem<D>& sm, const bf16* qp,
                                           int q0, int Sq, Bf16State<D>& st) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int lr = lane % 16, lc = (lane / 16) * 8;  // ldmatrix x4 address
  load_tile_async<D, MMA_NT>(sm.Ks, qp, q0, Sq, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < Bf16State<D>::KS; ++kk)
    ldsm_x4(st.qf[kk], &sm.Ks[warp * 16 + lr][kk * 16 + lc]);
#pragma unroll
  for (int n = 0; n < Bf16State<D>::NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[n][e] = 0.f;
  st.m[0] = st.m[1] = NEG_INF;
  st.l[0] = st.l[1] = 0.f;
}

// Fold the first n_kt K/V tiles of kp, vp (Sk keys of D) into the state of
// the query tile at q0, query row i seeing keys <= i + kv_offset when causal.
// ``qscale`` is scale * log2(e).
template <int D>
__device__ __forceinline__ void bf16_attend(Bf16Smem<D>& sm, const bf16* kp,
                                            const bf16* vp, int q0, int Sk,
                                            int n_kt, int causal,
                                            int kv_offset, float qscale,
                                            Bf16State<D>& st) {
  constexpr int NO = Bf16State<D>::NO;
  constexpr int KS = Bf16State<D>::KS;
  constexpr int NS = BK / 8;  // 8-wide score column tiles
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;  // mma fragment row / column pair
  const int lr = lane % 16, lc = (lane / 16) * 8;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done reading Ks / Vs
    load_tile_async<D, MMA_NT>(sm.Ks, kp, k0, Sk, tid);
    cp_async_commit();
    load_tile_async<D, MMA_NT>(sm.Vs, vp, k0, Sk, tid);
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
        ldsm_x4(kb, &sm.Ks[p * 16 + lr][kk * 16 + lc]);
        mma_bf16(s[2 * p], st.qf[kk], kb[0], kb[2]);
        mma_bf16(s[2 * p + 1], st.qf[kk], kb[1], kb[3]);
      }

    // Scale into log2 units; mask only where this tile crosses Sk or the
    // causal limit of the tile's first row.
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
    // partial until `bf16_finish`.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(st.m[r], mx);
      const float alpha = exp2f(st.m[r] - m_new);
      st.m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          s[j][e] = exp2f(s[j][e] - m_new);
          rs += s[j][e];
        }
      st.l[r] = st.l[r] * alpha + rs;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        st.o[n][2 * r] *= alpha;
        st.o[n][2 * r + 1] *= alpha;
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
        ldsm_x4_trans(vb, &sm.Vs[t * 16 + lr][p * 16 + lc]);
        mma_bf16(st.o[2 * p], pa, vb[0], vb[1]);
        mma_bf16(st.o[2 * p + 1], pa, vb[2], vb[3]);
      }
    }
  }
}

// Normalise and store rows [q0, q0 + BQ) of op (Sq rows of D) and of the
// natural-log lse.  Each warp stages only its own 16 rows of Ks, after its
// last read of them (`bf16_attend`'s second barrier, or `bf16_begin`'s).
template <int D>
__device__ __forceinline__ void bf16_finish(Bf16Smem<D>& sm, bf16* op,
                                            float* lsep, int q0, int Sq,
                                            Bf16State<D>& st) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 1);
    st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], 2);
    st.l[r] = fmaxf(st.l[r], 1e-30f);
    inv[r] = 1.f / st.l[r];
    const int row = row0 + r * 8;
    if (tg == 0 && row < Sq) lsep[row] = lse_of(st.m[r], st.l[r]);
  }
#pragma unroll
  for (int n = 0; n < Bf16State<D>::NO; ++n) {
    *reinterpret_cast<unsigned*>(&sm.Ks[warp * 16 + g][n * 8 + tg * 2]) =
        pack_bf16(st.o[n][0] * inv[0], st.o[n][1] * inv[0]);
    *reinterpret_cast<unsigned*>(&sm.Ks[warp * 16 + g + 8][n * 8 + tg * 2]) =
        pack_bf16(st.o[n][2] * inv[1], st.o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CH = D / 8;
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, ch = c % CH;
    const int row = q0 + warp * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(op + (size_t)row * D + ch * 8) =
          *reinterpret_cast<const uint4*>(&sm.Ks[warp * 16 + r][ch * 8]);
  }
}

// ---- f32: CUDA cores --------------------------------------------------------

constexpr int F32_NT = 256;  // threads per block

template <int D>
constexpr size_t f32_smem_bytes() {
  // Qs [D][BQ] + Ks [D][BK] + Vs [BK][D] + Ps [BK][BQ], all f32
  return sizeof(float) * (size_t)(D * BQ + D * BK + BK * D + BK * BQ);
}

// Eight floats read through L2 (ld.global.cg; 16-byte aligned).
__device__ __forceinline__ void load8_l2(const float* p, float* f) {
  const float4 a = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

template <int D>
struct F32State {
  static constexpr int NG = D / 64;  // 64-wide output column groups
  float m[4], l[4], acc[4][4 * NG];
};

// Stage Q transposed and pre-scaled into the exp2 domain (``qscale`` =
// scale * log2(e)), and clear the state.  Qs must be free.
template <int D>
__device__ __forceinline__ void f32_begin(float* smem, const float* qp,
                                          int q0, int Sq, float qscale,
                                          F32State<D>& st) {
  constexpr int CH = D / 8;  // 8-element chunks per row
  float* Qs = smem;          // [D][BQ]
  const int tid = threadIdx.x;
  for (int c = tid; c < BQ * CH; c += F32_NT) {
    const int r = c % BQ, dc = c / BQ;
    float f[8];
    if (q0 + r < Sq) {
      load8(qp + (size_t)(q0 + r) * D + dc * 8, f);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) Qs[(dc * 8 + i) * BQ + r] = f[i] * qscale;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = NEG_INF;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * F32State<D>::NG; ++c) st.acc[i][c] = 0.f;
  }
}

// Fold the first n_kt K/V tiles of kp, vp (Sk keys) into the state, as
// `bf16_attend`.  K and V are read through L2 (ld.global.cg).
template <int D>
__device__ __forceinline__ void f32_attend(float* smem, const float* kp,
                                           const float* vp, int q0, int Sk,
                                           int n_kt, int causal,
                                           int kv_offset, F32State<D>& st) {
  constexpr int CH = D / 8;
  constexpr int NG = F32State<D>::NG;
  float* Qs = smem;         // [D][BQ]
  float* Ks = Qs + D * BQ;  // [D][BK]
  float* Vs = Ks + D * BK;  // [BK][D]
  float* Ps = Vs + BK * D;  // [BK][BQ]
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q staged / previous tile's readers are done
    // K transposed: consecutive threads take consecutive keys, so the
    // scalar shared-memory stores fall in distinct banks.
    for (int c = tid; c < BK * CH; c += F32_NT) {
      const int r = c % BK, dc = c / BK;
      float f[8];
      if (k0 + r < Sk) {
        load8_l2(kp + (size_t)(k0 + r) * D + dc * 8, f);
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
        load8_l2(vp + (size_t)(k0 + r) * D + dc * 8, f);
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
    // stays a per-thread partial until `f32_finish`.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(st.m[i], mx);
      const float alpha = exp2f(st.m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
      st.l[i] = st.l[i] * alpha + rs;
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) st.acc[i][c] *= alpha;
      st.m[i] = m_new;
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
            st.acc[i][g * 4 + c] = fmaf(pv[i], vf[c], st.acc[i][g * 4 + c]);
      }
    }
  }
}

// Finish the row sums, normalise, write rows [q0, q0 + BQ) of op and lsep.
template <int D>
__device__ __forceinline__ void f32_finish(float* op, float* lsep, int q0,
                                           int Sq, F32State<D>& st) {
  constexpr int NG = F32State<D>::NG;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = st.l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int row = q0 + ty * 4 + i;
    if (row < Sq) {
      const float inv = 1.f / lt;
      float* o = op + (size_t)row * D;
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[g * 64 + tx * 4 + c] = st.acc[i][g * 4 + c] * inv;
      if (tx == 0) lsep[row] = lse_of(st.m[i], lt);
    }
  }
}

}  // namespace flash
}  // namespace tdt
