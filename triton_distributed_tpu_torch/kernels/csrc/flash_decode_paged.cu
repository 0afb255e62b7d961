// One-position GQA decode attention over a paged KV pool, float or int8.
//
// Replaces: triton_distributed_tpu/kernels/flash_decode.py
//   `flash_decode_paged` -> `_paged_decode_kernel` (pallas_call :310),
//   both its float-pool form (K3) and its int8 form with (P, Hkv, page)
//   f32 scale pools (K3q).
//
// The TPU kernel is the dense split-KV kernel with its KV block index
// taken through a scalar-prefetched page table, walking pages as
// sequential grid steps.  Here the body is decode_body.cuh unchanged:
// each block takes one chunk of 128 logical positions of one (row, KV
// head), reads the chunk's page ids once into shared memory, and brings
// each page's run of rows (4 KB at 16 positions of bf16, D = 128) by one
// bulk copy (`tdt::PagedRows`); the chunks are combined in order.  Bound:
// bytes, as the dense kernel, plus one table entry per page.  Because the
// body and the chunking are shared (the chunk does not depend on the page
// size), out and lse are bit-identical to flash_decode's for the same
// logical K/V (and scales).

#include "decode_body.cuh"

// q (B,H,D), out (B,H,D) contiguous in dtype; k/v pool (P,Hkv,ps,D) in
// dtype, or int8 when k_scale/v_scale (P,Hkv,ps) f32 are given (else both
// null); page_table (B,T) int32; kv_len (B,) int32; lse (B,H) f32; part and
// counters as flash_decode's over a capacity of T*ps; chunk must be 128.
// Returns a cudaError_t code.
extern "C" int flash_decode_paged(const void* q, const void* k_pool,
                                  const void* v_pool, const void* k_scale,
                                  const void* v_scale, const void* page_table,
                                  const void* kv_len, void* out, void* lse,
                                  void* part, void* counters, int dtype,
                                  int B, int H, int Hkv, int P, int ps, int T,
                                  int D, int chunk, float scale,
                                  void* stream) {
  if (P <= 0 || ps <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  return tdt::dispatch_decode(
      dtype, H, D, chunk,
      tdt::DecodeArgs<tdt::PagedRows>{
          q, k_pool, v_pool, static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale),
          tdt::PagedRows{static_cast<const int*>(page_table), T, ps, Hkv, P},
          static_cast<const int*>(kv_len), out, lse,
          static_cast<float*>(part), static_cast<int*>(counters), B, Hkv,
          T * ps, scale, static_cast<cudaStream_t>(stream)});
}
