// One-position GQA decode attention over a dense float KV cache.
//
// Replaces: triton_distributed_tpu/kernels/flash_decode.py `flash_decode`
//   -> `_decode_kernel` (pallas_call :195), float-cache form.
//
// The body (bound, design, known limit) is decode_body.cuh, shared with
// the paged kernel.  At the Qwen3-8B decode shape, 4 x 8 KV heads x ~530
// positions x 128 x 2 B x 2 = ~8.7 MB of K/V, ~2.6 us at 3.35 TB/s.

#include "decode_body.cuh"

// q (B,H,D), k/v cache (B,Hkv,S,D), out (B,H,D) contiguous, same dtype;
// kv_len (B,) int32; lse (B,H) f32.  Returns a cudaError_t code.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* kv_len, void* out, void* lse,
                            int dtype, int B, int H, int Hkv, int S, int D,
                            float scale, void* stream) {
  return tdt::dispatch_decode(dtype, B, H, Hkv, D, q, k, v,
                              tdt::DenseRows{Hkv, S}, kv_len, out, lse,
                              scale, stream);
}
