// Helpers shared by the kernels: vector loads that widen to float, stores
// that narrow from float, cp.async copies, bf16 tensor-core fragments
// (ldmatrix, mma.sync), the spin timeout of every wait, and the C entries
// every library exports (the error string, the spin-timeout record).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace tdt {

constexpr float NEG_INF = -1e30f;  // finite "minus infinity", as the TPU kernels use
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

// Eight consecutive elements, widened to float.  bf16: one 16-byte load;
// f32: two; int8 (cache codes, exact in float): one 8-byte load.  The
// caller guarantees 16-byte (int8: 8-byte) alignment.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float* f) {
  const int2 u = *reinterpret_cast<const int2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) f[i] = static_cast<float>(c[i]);
}

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

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

// ---- the spin timeout ------------------------------------------------------
//
// Every wait of every library (dl.cuh's signal waits, mbarrier.cuh's phase
// waits) spins at most TDT_SPIN_BUDGET_CYCLES, then records what it waited
// for and traps, so a fault in a protocol fails the launch instead of
// hanging the card.  The timeout path calls nothing: any function call in a
// kernel, even a printf in another warp's branch, makes ptxas serialize its
// `wgmma`s (info C7510).  The record lies in mapped pinned host memory,
// which the host can still read once the trap has killed the context; a
// library gets its device address once, when it is loaded
// (`tdt_spin_record_attach`; kernels/_build.py `spin_report` reads it).  The
// first thread of a library that times out writes it.

#ifndef TDT_SPIN_BUDGET_CYCLES
//: About 10 s at the H100's 1.98 GHz boost clock.
#define TDT_SPIN_BUDGET_CYCLES 20000000000LL
#endif

// What a spin waited for: the record's ``what``.  kernels/_build.py names
// each from its ``//:`` comment, so every entry has one, on its own line.
enum Wait : int {
  WAIT_NONE = 0,                  //: nothing (no wait timed out)
  WAIT_MBARRIER,                  //: an mbarrier phase (TMA or bulk copies)
  WAIT_BARRIER_ALL,               //: barrier_all
  WAIT_BARRIER_NEIGHBORS,         //: barrier_neighbors
  WAIT_GRID_BARRIER,              //: grid barrier
  WAIT_BARRIER_RANK,              //: barrier_rank
  WAIT_BROADCAST_ARRIVAL,         //: broadcast arrival
  WAIT_BROADCAST_ROOT,            //: broadcast root outside the team (no wait)
  WAIT_PUSH_ALLGATHER,            //: push all-gather arrival
  WAIT_SCATTER_REDUCE,            //: scatter-reduce arrival
  WAIT_ALL_GATHER_RING,           //: all_gather ring arrival
  WAIT_ALL_GATHER_BIDIR_RIGHT,    //: all_gather bidir ring arrival (rightwards)
  WAIT_ALL_GATHER_BIDIR_LEFT,     //: all_gather bidir ring arrival (leftwards)
  WAIT_REDUCE_SCATTER_ACK,        //: reduce_scatter ack
  WAIT_REDUCE_SCATTER_RING,       //: reduce_scatter ring arrival
  WAIT_REDUCE_SCATTER_ACK_DRAIN,  //: reduce_scatter ack drain
  WAIT_TWO_SHOT_SCATTER,          //: two-shot scatter arrival
  WAIT_TWO_SHOT_BROADCAST,        //: two-shot broadcast arrival
  WAIT_CHAIN_REDUCE,              //: chain reduce arrival
  WAIT_CHAIN_BROADCAST,           //: chain broadcast arrival
  WAIT_ALL_TO_ALL,                //: all_to_all arrival
  WAIT_AG_GEMM_RING,              //: ag_gemm ring arrival
  WAIT_AG_GEMM_FORWARD,           //: ag_gemm ring forward
  WAIT_AG_GEMM_PUSH,              //: ag_gemm push arrival
  WAIT_AG_GEMM_W8A8_RING,         //: ag_gemm_w8a8 ring arrival
  WAIT_AG_GROUP_GEMM_RING,        //: ag_group_gemm ring arrival
  WAIT_GEMM_RS_PARTIAL,           //: gemm_rs partial arrival
  WAIT_MOE_REDUCE_RS_PARTIAL,     //: moe_reduce_rs partial arrival
  WAIT_SP_AG_RING_FORWARD,        //: sp_ag_attention ring forward
  WAIT_SP_AG_RING_LOAD,           //: sp_ag_attention ring arrival (TMA loads)
  WAIT_SP_AG_RING,                //: sp_ag_attention ring arrival (f32 blocks)
  WAIT_TORUS_ALL_GATHER,          //: torus all-gather arrival
  WAIT_TORUS_RS_ACK,              //: torus reduce-scatter ack
  WAIT_TORUS_RS_ARRIVAL,          //: torus reduce-scatter arrival
  WAIT_TORUS_RS_ACK_DRAIN,        //: torus reduce-scatter ack drain
};

// The record (kernels/_build.py `_SpinRecord` mirrors it).
struct SpinRecord {
  int what;                 // a Wait, 0 until a spin timed out
  int block[3];             // blockIdx
  int thread;               // threadIdx.x
  int pad;
  unsigned long long addr;  // the word or mbarrier waited on
  unsigned long long want;  // the value (or phase) waited for
  unsigned long long seen;  // what the word held (or the phase waited past)
};

namespace {
__device__ SpinRecord* spin_record = nullptr;
__device__ int spin_claimed = 0;
}  // namespace

// Record the wait and trap.  Plain stores and fences only: no call.
__device__ __forceinline__ void spin_timeout(int what, const void* addr,
                                             unsigned long long want,
                                             unsigned long long seen) {
  SpinRecord* r = spin_record;
  if (r != nullptr && atomicCAS(&spin_claimed, 0, 1) == 0) {
    volatile SpinRecord* v = r;
    v->block[0] = blockIdx.x;
    v->block[1] = blockIdx.y;
    v->block[2] = blockIdx.z;
    v->thread = threadIdx.x;
    v->addr = reinterpret_cast<unsigned long long>(addr);
    v->want = want;
    v->seen = seen;
    __threadfence_system();
    v->what = what;  // last: the host reads a record whose what is set
    __threadfence_system();
  }
  __trap();
}

// Number of K/V tiles of BK keys that a tile of query rows [q0, q0 + BQ)
// must visit: all of them, or under a causal mask (query row i sees keys
// <= i + kv_offset) those up to the tile's last row's limit.
template <int BQ, int BK>
__device__ __forceinline__ int kv_tiles(int q0, int Sq, int Sk, int causal,
                                        int kv_offset) {
  if (!causal) return (Sk + BK - 1) / BK;
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int last_k = min(last_q + kv_offset, Sk - 1);
  return last_k < 0 ? 0 : last_k / BK + 1;
}

// ---- bf16 tensor-core fragments (mma.sync m16n8k16, ldmatrix) ----------

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
// cp.async from NT threads; rows at or past n are zero-filled.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16 (*dst)[D + 8],
                                                const __nv_bfloat16* src,
                                                int r0, int n, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < 64 * CH; c += NT) {
    const int r = c / CH, ch = c % CH;
    const bool ok = r0 + r < n;
    cp_async16(&dst[r][ch * 8], src + (size_t)(ok ? r0 + r : 0) * D + ch * 8,
               ok);
  }
}

}  // namespace tdt

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The spin-timeout record in mapped pinned host memory, zeroed (one for the
// process: the host allocates it once, through any library).
extern "C" int tdt_spin_record_alloc(void** host) {
  const cudaError_t e =
      cudaHostAlloc(host, sizeof(tdt::SpinRecord),
                    cudaHostAllocMapped | cudaHostAllocPortable);
  if (e == cudaSuccess) memset(*host, 0, sizeof(tdt::SpinRecord));
  return (int)e;
}

// Point this library's kernels (on the current device) at the record.
extern "C" int tdt_spin_record_attach(void* host) {
  void* dev = nullptr;
  cudaError_t e = cudaHostGetDevicePointer(&dev, host, 0);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(tdt::spin_record, &dev, sizeof(dev));
  return (int)e;
}
