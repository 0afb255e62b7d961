// One-position GQA decode attention over a paged float KV pool.
//
// Replaces: triton_distributed_tpu/kernels/flash_decode.py
//   `flash_decode_paged` -> `_paged_decode_kernel` (pallas_call :310),
//   float-pool form.
//
// The TPU kernel is the dense split-KV kernel with its KV block index
// taken through a scalar-prefetched page table.  Here the same holds one
// level down: the body is decode_body.cuh unchanged, and each position's
// row address goes through the (B, T) table (`tdt::PagedRows`).  Bound:
// bytes, as the dense kernel, plus one table entry per position read
// (from L1/L2: one row of the table serves ps positions).  Because the
// body is shared, out and lse are bit-identical to flash_decode's for the
// same logical K/V.

#include "decode_body.cuh"

// q (B,H,D), k/v pool (P,Hkv,ps,D), out (B,H,D) contiguous, same dtype;
// page_table (B,T) int32; kv_len (B,) int32; lse (B,H) f32.  Returns a
// cudaError_t code.
extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const void* page_table,
                                  const void* kv_len, void* out, void* lse,
                                  int dtype, int B, int H, int Hkv, int P,
                                  int ps, int T, int D, float scale,
                                  void* stream) {
  if (P <= 0 || ps <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  return tdt::dispatch_decode(
      dtype, B, H, Hkv, D, q, k_pool, v_pool,
      tdt::PagedRows{static_cast<const int*>(page_table), T, ps, Hkv, P},
      kv_len, out, lse, scale, stream);
}
