// Shared-memory transaction barriers (`mbarrier`) and the 1-D bulk copy
// (`cp.async.bulk`, global -> shared) that completes on one: the Hopper
// pieces shared by the wgmma tile (wgmma_tile.cuh, K6/K8) and the decode
// body (decode_body.cuh, K2/K3).
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace tdt {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the block's barrier initialisations visible to the async proxy
// (the bulk copies and TMA loads that complete on them).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects ``bytes`` of TMA transactions.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar,
                                              unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}

// Until the barrier's phase is not ``parity``.  A wait that outlasts
// TDT_SPIN_BUDGET_CYCLES records itself and traps (`spin_timeout`), so a
// fault in a ring's protocol fails the launch instead of hanging it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > TDT_SPIN_BUDGET_CYCLES)
      spin_timeout(WAIT_MBARRIER, bar, parity ^ 1, parity);
}

// ``bytes`` (a multiple of 16) from global ``src`` to shared ``dst`` (both
// 16-byte aligned); completes ``bytes`` transactions on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace tdt
