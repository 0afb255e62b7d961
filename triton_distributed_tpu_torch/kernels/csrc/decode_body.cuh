// One-position GQA decode attention, shared by the dense (flash_decode.cu)
// and the paged (flash_decode_paged.cu) kernels.  The two differ only in
// where a cached position's K/V row lies (`Rows`); the copies, the
// per-stream online softmax and both combines are this one body, so the two
// kernels return bit-identical out and lse for the same logical K/V.
//
// What bounds it on the H100: bytes.  Each call reads the K and V rows
// below kv_len once and does only 4 FLOP per cached element per query
// head, ~70 times below the tensor-core balance point: the FLOPs need no
// tensor cores, and the design keeps HBM busy.
//
// Design (split-KV over fixed chunks):
// - Each (batch row, KV head) is cut into chunks of DECODE_CH = 128
//   logical positions, one block of 128 threads each: grid (Hkv, B,
//   chunk), chunks counted from the capacity (S, or T * ps), since the
//   host does not know kv_len without a sync.  A block whose chunk starts
//   at or past its row's length exits at once.  The chunk is the slowest
//   grid dimension, so every row's first chunks are dispatched before any
//   row's last ones and a long row does not wait behind the short rows'
//   empty blocks.  CH does not depend on the page size, so a row is cut at
//   the same positions in every layout.  (The first form's grid of B * Hkv
//   blocks, 32-64 for 132 SMs with the longest row setting the time, is
//   gone with it.)
// - The block holds all G = H/Hkv query heads of its group
//   (flash_decode.py:41-42, 183), so each K/V row is read once for all G.
// - Copies: the chunk's page ids are read once into shared memory
//   (clamped into [0, P), as the TPU clamps an out-of-range block index).
//   Then warp 0 issues 1-D bulk copies (`cp.async.bulk`, one for each run
//   of contiguous rows: a page's rows of one KV head in the pool layout,
//   the chunk itself in the dense one) into DECODE_NSTAGE stages of
//   DECODE_SP positions, each completing on its own mbarrier.  The whole
//   chunk is in flight at once (64 KB of bf16 K/V at D = 128), and the
//   stages let the block compute on the first rows while the last arrive.
//   Nothing in the consumers' loop reads the table, divides or takes a
//   modulo.
// - Consumers: D/8 lanes share one cached position (8 elements each, read
//   from shared memory); a warp covers 32/(D/8) positions at a time.  Each
//   such lane group is a "stream" with its own f32 online softmax (natural
//   exp, as :89-114) over positions stream, stream + NS, ... of the chunk;
//   the streams are combined through shared memory with log-sum-exp
//   weights into the chunk's partial (m, l, unnormalised acc) per head.
// - A row with one chunk (kv_len <= CH) writes out and lse directly.  A
//   longer row's chunks write f32 partials to a scratch buffer; the last
//   of its blocks to finish (an atomic count per (row, KV head), reset by
//   that block for the next call) combines them in chunk order.  The count
//   decides only who combines, never an order of sums: a row's out and lse
//   depend on its own q, K/V, scales and kv_len alone, not on B, the other
//   rows, the capacity, the SM count or the schedule.
// - Positions at or past kv_len are never read, so they contribute
//   exactly 0 whatever the cache (or an unmapped page) holds there.  A row
//   with kv_len <= 0 reads nothing and gets out 0 and lse -1e30.
// - int8 cache (C = int8_t, the TPU kernel's `quantized` form, :44-48,
//   :66-103): q, out and the arithmetic stay in T (bf16 or f32), lse f32.
//   Codes arrive by the same bulk copies (half the bytes); a lane still
//   covers 8 positions' columns, so the order of every sum is the float
//   kernel's.  Each position's two f32 scales are plain loads into shared
//   memory (their runs are not 16-byte aligned at every page size), from
//   the index of its row, (B, Hkv, S) dense or (P, Hkv, ps) paged.  The K
//   scale multiplies the score after `scale` (:76-82); l sums the unscaled
//   p, and the V scale multiplies p only in the accumulation (:93-103).
//   Positions at or past kv_len load no scale, so a stale or NaN scale
//   there (a reused slot, the null page) never reaches the sums.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "mbarrier.cuh"

namespace tdt {
// Internal linkage: each library keeps its own kernels and launch state
// (a template's function-local static would otherwise be one symbol
// shared by every library loaded into the process).
namespace {

constexpr int DECODE_NT = 128;  // threads per block (4 warps)
constexpr int DECODE_CH = 128;  // positions per chunk (one block)
constexpr int DECODE_SP = 32;   // positions per stage
constexpr int DECODE_NSTAGE = DECODE_CH / DECODE_SP;

// Dense cache (B, Hkv, S, D): position j of (b, hk) is row (b*Hkv+hk)*S+j,
// so a chunk is one run of rows.
struct DenseRows {
  int Hkv, S;
  __device__ __forceinline__ int capacity() const { return S; }
  // Positions [u * unit, (u + 1) * unit) lie in contiguous rows.
  __device__ __forceinline__ int unit() const { return DECODE_CH; }
  __device__ __forceinline__ int fetch_page(int, int, int) const {
    return 0;
  }
  __device__ __forceinline__ void stage_page(int*, int, int, int,
                                             int) const {}
  __device__ __forceinline__ size_t row(const int*, int b, int hk, int,
                                        int j) const {
    return (size_t)(b * Hkv + hk) * S + j;
  }
};

// Page pool (P, Hkv, ps, D) with a (B, T) int32 page table: position j of
// (b, hk) is row ps*(table[b, j/ps]*Hkv + hk) + j%ps.  A table entry
// outside [0, P) is clamped into the pool, so a bad table reads wrong
// data, never memory outside the pool.
struct PagedRows {
  const int* table;
  int T, ps, Hkv, P;
  __device__ __forceinline__ int capacity() const { return T * ps; }
  __device__ __forceinline__ int unit() const { return ps; }
  // Thread tid's table entry of the chunk at c0: page c0/ps + tid (at
  // most CH pages touch a chunk), read before kv_len is known, so the two
  // loads overlap.  Entries past kv_len are read but never used.
  __device__ __forceinline__ int fetch_page(int b, int c0, int tid) const {
    const int p = c0 / ps + tid;
    return p < T && p * ps < c0 + DECODE_CH ? table[(size_t)b * T + p] : 0;
  }
  // The ids of the pages holding positions [c0, end) into pg[0..].
  __device__ __forceinline__ void stage_page(int* pg, int entry, int c0,
                                             int end, int tid) const {
    if (end > c0 && tid <= (end - 1) / ps - c0 / ps)
      pg[tid] = min(max(entry, 0), P - 1);
  }
  // Position j's row, for c0 <= j < end of the chunk staged in pg.
  __device__ __forceinline__ size_t row(const int* pg, int, int hk, int c0,
                                        int j) const {
    const int p = j / ps;
    return ((size_t)pg[p - c0 / ps] * Hkv + hk) * ps + (j - p * ps);
  }
};

// Shared memory of the stage buffers, reused by the streams' partials.
template <typename C, int D, int G>
constexpr int decode_smem_bytes() {
  constexpr int NS = (DECODE_NT / 32) * (32 / (D / 8));
  constexpr int kv = 2 * DECODE_CH * D * (int)sizeof(C);
  constexpr int acc = NS * G * D * (int)sizeof(float);
  return kv > acc ? kv : acc;
}

// T: q and out (bf16 or f32); C: the cache, T itself or int8_t with f32
// scales ks/vs (null for a float cache).  part: f32 partials of G*(D+2)
// values per (row, KV head, chunk), cnt: one int per (row, KV head), zero
// between calls; both unused when every row has at most one chunk.  Below
// G = 8 three blocks fit an SM (64 KB of bf16 stages each), so registers
// are held to a third of the SM's.
template <typename T, typename C, int D, int G, typename Rows>
__global__ void __launch_bounds__(DECODE_NT, G >= 8 ? 1 : 3) decode_kernel(
    const T* __restrict__ q, const C* __restrict__ kc,
    const C* __restrict__ vc, const float* __restrict__ ks,
    const float* __restrict__ vs, Rows rows, const int* __restrict__ kv_len,
    T* __restrict__ out, float* __restrict__ lse, float* __restrict__ part,
    int* __restrict__ cnt, int Hkv, float scale) {
  constexpr bool QUANT = std::is_same<C, int8_t>::value;
  constexpr int NT = DECODE_NT, CH = DECODE_CH, SP = DECODE_SP;
  constexpr int LPK = D / 8;            // lanes per position
  constexpr int KPW = 32 / LPK;         // positions per warp step
  constexpr int NS = (NT / 32) * KPW;   // streams per block
  constexpr int UPS = SP / NS;          // positions per stream and stage
  constexpr int UB = G >= 8 && UPS > 2 ? 2 : UPS;  // positions a rescale
  constexpr int ROW_BYTES = D * (int)sizeof(C);
  constexpr int PART = G * (D + 2);     // floats of one chunk's partial
  static_assert(SP % NS == 0 && ROW_BYTES % 16 == 0, "decode layout");

  extern __shared__ __align__(128) unsigned char smem[];
  C* sk = reinterpret_cast<C*>(smem);
  C* sv = sk + CH * D;
  float* sm_acc = reinterpret_cast<float*>(smem);  // [NS][G][D], after use
  __shared__ __align__(8) uint64_t bar[DECODE_NSTAGE];
  __shared__ int pg[CH];
  __shared__ float sks[QUANT ? CH : 1], svs[QUANT ? CH : 1];
  __shared__ float sm_m[NS][G], sm_l[NS][G];
  __shared__ float sm_w[NT], sm_lk[NT], sm_big[G], sm_sum[G];
  __shared__ int last;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int c = blockIdx.z;
  const int tid = threadIdx.x;
  const int c0 = c * CH;
  const int entry = rows.fetch_page(b, c0, tid);
  const int len = min(max(kv_len[b], 0), rows.capacity());
  const int nact = (len + CH - 1) / CH;  // chunks holding positions
  // Chunk 0 of an empty row still writes its (empty) result.
  if (c >= max(nact, 1)) return;
  const int end = min(c0 + CH, len);
  const int n = end - c0;  // positions of this chunk (<= 0: none)

  const int lane = tid % 32;
  const int stream = (tid / 32) * KPW + lane / LPK;
  const int sl = lane % LPK;  // this lane's 8 columns: sl*8 .. sl*8+7
  const size_t head0 = (size_t)b * Hkv * G + (size_t)hk * G;

  float qf[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load8(q + (head0 + g) * D + sl * 8, qf[g]);
#pragma unroll
    for (int i = 0; i < 8; ++i) qf[g][i] *= scale;
  }

  if (tid == 0) {
    for (int s = 0; s < DECODE_NSTAGE; ++s) mbar_init(&bar[s], 1);
    mbar_init_fence();
  }
  rows.stage_page(pg, entry, c0, end, tid);
  __syncthreads();

  if (tid < 32 && n > 0) {
    // Warp 0 issues the copies: each stage's expected bytes first, then
    // each run of contiguous rows cut at stage edges, a unit a lane.
    if (tid == 0)
      for (int s = 0; s < DECODE_NSTAGE && s * SP < n; ++s)
        mbar_expect_tx(&bar[s], 2u * min(SP, n - s * SP) * ROW_BYTES);
    __syncwarp();
    const int unit = rows.unit();
    for (int u = c0 / unit + tid; u <= (end - 1) / unit; u += 32) {
      const int ue = min((u + 1) * unit, end);
      for (int j = max(u * unit, c0); j < ue;) {
        const int s = (j - c0) / SP;
        const int je = min(ue, c0 + (s + 1) * SP);
        const size_t r = rows.row(pg, b, hk, c0, j);
        const unsigned bytes = (unsigned)(je - j) * ROW_BYTES;
        bulk_load(sk + (j - c0) * D, kc + r * D, bytes, &bar[s]);
        bulk_load(sv + (j - c0) * D, vc + r * D, bytes, &bar[s]);
        j = je;
      }
    }
  }
  if constexpr (QUANT) {
    if (tid < CH) {
      float a = 0.f, v = 0.f;
      if (tid < n) {
        const size_t r = rows.row(pg, b, hk, c0, c0 + tid);
        a = ks[r];
        v = vs[r];
      }
      sks[tid] = a;
      svs[tid] = v;
    }
    __syncthreads();
  }

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;
  }

  // The trip counts depend on n only, so every lane of the warp runs the
  // shuffles below the same number of times.  A stream takes UB positions
  // at a time: their scores together, then one rescale of (m, l, acc) and
  // their weights in position order.
  for (int s = 0; s < DECODE_NSTAGE && s * SP < n; ++s) {
    mbar_wait(&bar[s], 0);
#pragma unroll
    for (int u0 = 0; u0 < UPS; u0 += UB) {
      float sc[UB][G];
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int j = s * SP + (u0 + u) * NS + stream;  // within the chunk
        float kf[8];
        if (j < n) {
          load8(sk + j * D + sl * 8, kf);
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) kf[i] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float t = 0.f;
#pragma unroll
          for (int i = 0; i < 8; ++i) t = fmaf(qf[g][i], kf[i], t);
          sc[u][g] = t;
        }
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < UB; ++u)
#pragma unroll
          for (int g = 0; g < G; ++g)
            sc[u][g] += __shfl_xor_sync(0xffffffffu, sc[u][g], off);
      const int j0 = s * SP + u0 * NS + stream;
      if (j0 >= n) continue;  // none of this stream's UB positions
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int u = 0; u < UB; ++u) {
          const int j = j0 + u * NS;
          if (j < n) {
            if constexpr (QUANT) sc[u][g] *= sks[j];
            m_new = fmaxf(m_new, sc[u][g]);
          }
        }
        const float alpha = expf(m[g] - m_new);
        l[g] *= alpha;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= alpha;
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int j = j0 + u * NS;
        if (j >= n) break;
        float vf[8];
        load8(sv + j * D + sl * 8, vf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float p = expf(sc[u][g] - m[g]);
          l[g] += p;
          if constexpr (QUANT) p *= svs[j];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
        }
      }
    }
  }

  // Combine the streams with log-sum-exp weights (their buffers reuse the
  // stage buffers, so every stream must be done reading them first): one
  // thread a head forms the weights and l in stream order.
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      sm_acc[(stream * G + g) * D + sl * 8 + i] = acc[g][i];
    if (sl == 0) {
      sm_m[stream][g] = m[g];
      sm_l[stream][g] = l[g];
    }
  }
  __syncthreads();
  if (tid < G) {
    float mx = NEG_INF;
#pragma unroll
    for (int s = 0; s < NS; ++s) mx = fmaxf(mx, sm_m[s][tid]);
    float lt = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const float w = expf(sm_m[s][tid] - mx);
      sm_m[s][tid] = w;
      lt = fmaf(w, sm_l[s][tid], lt);
    }
    sm_big[tid] = mx;
    sm_sum[tid] = lt;
  }
  __syncthreads();
  const size_t bh = (size_t)b * Hkv + hk;
  for (int idx = tid; idx < G * D; idx += NT) {
    const int g = idx / D, d = idx % D;
    float o = 0.f;
#pragma unroll
    for (int s = 0; s < NS; ++s)
      o = fmaf(sm_m[s][g], sm_acc[(s * G + g) * D + d], o);
    if (nact <= 1) {
      const float lt = fmaxf(sm_sum[g], 1e-30f);
      store1(out + (head0 + g) * D + d, o / lt);
      if (d == 0) lse[head0 + g] = sm_big[g] + logf(lt);
    } else {
      float* mine = part + (bh * gridDim.z + c) * PART;
      mine[idx] = o;
      if (d == 0) {
        mine[G * D + g] = sm_big[g];
        mine[G * D + G + g] = sm_sum[g];
      }
    }
  }
  if (nact <= 1) return;

  // The last of the row's chunks to finish combines them, in chunk order.
  // The barrier orders the block's partials before thread 0's fence, which
  // makes them visible to the device before its count.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int done = atomicAdd(&cnt[bh], 1);
    last = done == nact - 1;
    if (last) cnt[bh] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const float* rowp = part + bh * gridDim.z * PART;
  constexpr int OUTS = (G * D + NT - 1) / NT;  // outputs a thread
  constexpr int TILE = NT / G;                 // chunks a round
  if (nact > TILE) {
    // The largest m of each head over every chunk first (exact in any
    // order): thread tid reads head tid % G of chunks tid / G, + TILE, ...
    float mx = NEG_INF;
    for (int k = tid / G; k < nact; k += TILE)
      mx = fmaxf(mx, __ldcg(rowp + (size_t)k * PART + G * D + tid % G));
    sm_w[tid] = mx;
    __syncthreads();
    if (tid < G) {
      for (int t = tid + G; t < NT; t += G) mx = fmaxf(mx, sm_w[t]);
      sm_big[tid] = mx;
    }
  }
  if (tid < G) sm_sum[tid] = 0.f;
  // Then the chunks in order, TILE at a time: their m and l into shared
  // memory, the weights w = exp(m - max), l summed by one thread a head,
  // acc summed by the thread of each output.
  float o[OUTS];
#pragma unroll
  for (int i = 0; i < OUTS; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < nact; k0 += TILE) {
    const int nk = min(TILE, nact - k0);
    __syncthreads();
    if (tid < nk * G) {
      const float* pk = rowp + (size_t)(k0 + tid / G) * PART + G * D;
      sm_w[tid] = __ldcg(pk + tid % G);
      sm_lk[tid] = __ldcg(pk + G + tid % G);
    }
    __syncthreads();
    if (nact <= TILE) {
      if (tid < G) {
        float mx = NEG_INF;
        for (int k = 0; k < nk; ++k) mx = fmaxf(mx, sm_w[k * G + tid]);
        sm_big[tid] = mx;
      }
      __syncthreads();
    }
    if (tid < nk * G) sm_w[tid] = expf(sm_w[tid] - sm_big[tid % G]);
    __syncthreads();
    if (tid < G)
      for (int k = 0; k < nk; ++k)
        sm_sum[tid] = fmaf(sm_w[k * G + tid], sm_lk[k * G + tid],
                           sm_sum[tid]);
#pragma unroll 8
    for (int k = 0; k < nk; ++k) {
      const float* pk = rowp + (size_t)(k0 + k) * PART;
#pragma unroll
      for (int i = 0; i < OUTS; ++i) {
        const int idx = tid + i * NT;
        if (idx < G * D)
          o[i] = fmaf(sm_w[k * G + idx / D], __ldcg(pk + idx), o[i]);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < OUTS; ++i) {
    const int idx = tid + i * NT;
    if (idx < G * D) {
      const int g = idx / D, d = idx % D;
      const float lt = fmaxf(sm_sum[g], 1e-30f);
      store1(out + (head0 + g) * D + d, o[i] / lt);
      if (d == 0) lse[head0 + g] = sm_big[g] + logf(lt);
    }
  }
}

// The kernel's arguments apart from its template parameters.
template <typename Rows>
struct DecodeArgs {
  const void *q, *k, *v;
  const float *ks, *vs;  // null for a float cache
  Rows rows;
  const int* kv_len;
  void *out, *lse;
  float* part;  // f32 scratch of B*Hkv*chunks*G*(D+2) (chunks > 1)
  int* cnt;     // B*Hkv ints, zero between calls (chunks > 1)
  int B, Hkv, capacity;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename C, int D, int G, typename Rows>
int launch_decode(const DecodeArgs<Rows>& a) {
  constexpr int smem = decode_smem_bytes<C, D, G>();
  auto kernel = decode_kernel<T, C, D, G, Rows>;
  if (smem > 48 * 1024) {
    // Once per device: above 48 KB of dynamic shared memory is opt-in.
    static unsigned set = 0;
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 32 || !(set >> dev & 1u)) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 32) set |= 1u << dev;
    }
  }
  const int chunks = (a.capacity + DECODE_CH - 1) / DECODE_CH;
  const dim3 grid(a.Hkv, a.B, chunks);
  kernel<<<grid, DECODE_NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const C*>(a.k),
      static_cast<const C*>(a.v), a.ks, a.vs, a.rows, a.kv_len,
      static_cast<T*>(a.out), static_cast<float*>(a.lse), a.part, a.cnt,
      a.Hkv, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, typename C, int D, typename Rows>
int dispatch_group(int G, const DecodeArgs<Rows>& a) {
  switch (G) {
    case 1: return launch_decode<T, C, D, 1>(a);
    case 2: return launch_decode<T, C, D, 2>(a);
    case 4: return launch_decode<T, C, D, 4>(a);
    case 8: return launch_decode<T, C, D, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, typename Rows>
int dispatch_cache(bool quant, int G, int D, const DecodeArgs<Rows>& a) {
  if (quant && D == 128) return dispatch_group<T, int8_t, 128>(G, a);
  if (quant && D == 64) return dispatch_group<T, int8_t, 64>(G, a);
  if (D == 128) return dispatch_group<T, T, 128>(G, a);
  if (D == 64) return dispatch_group<T, T, 64>(G, a);
  return (int)cudaErrorInvalidValue;
}

// q (B,H,D), out (B,H,D) contiguous in dtype; the cache in dtype, or int8
// with f32 scales when ks and vs are given (both or neither); kv_len (B,)
// int32; lse (B,H) f32.  ``chunk`` is the caller's chunk length, which
// sized ``part``: it must be DECODE_CH.  Returns a cudaError_t code.
template <typename Rows>
int dispatch_decode(int dtype, int H, int D, int chunk,
                    const DecodeArgs<Rows>& a) {
  if (a.B == 0 || H == 0) return 0;
  if (a.Hkv <= 0 || H % a.Hkv != 0 || chunk != DECODE_CH || a.capacity <= 0)
    return (int)cudaErrorInvalidValue;
  if (a.capacity > DECODE_CH && (a.part == nullptr || a.cnt == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((a.ks == nullptr) != (a.vs == nullptr)) return (int)cudaErrorInvalidValue;
  const bool quant = a.ks != nullptr;
  const int G = H / a.Hkv;
  if (dtype == DTYPE_BF16) return dispatch_cache<__nv_bfloat16>(quant, G, D, a);
  if (dtype == DTYPE_F32) return dispatch_cache<float>(quant, G, D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tdt
