// One-position GQA decode attention over a dense KV cache, float or int8.
//
// Replaces: triton_distributed_tpu/kernels/flash_decode.py `flash_decode`
//   -> `_decode_kernel` (pallas_call :195), both its float-cache form
//   (K2) and its int8 form with per-token k_scale/v_scale (K2q).
//
// The body (bound, design) is decode_body.cuh, shared with the paged
// kernel: split-KV over chunks of 128 positions, one block each, the
// chunk's rows brought by one bulk copy a stage, the chunks combined in
// order by the last block of a row.  Bound: bytes.  At the Qwen3-8B decode
// shape, 4 x 8 KV heads x ~530 positions x 128 x 2 B x 2 = ~8.7 MB of bf16
// K/V, ~2.6 us at 3.35 TB/s; the int8 cache moves half of that plus 8 B of
// scales per position and head.

#include "decode_body.cuh"

// q (B,H,D), out (B,H,D) contiguous in dtype; k/v cache (B,Hkv,S,D) in
// dtype, or int8 when k_scale/v_scale (B,Hkv,S) f32 are given (else both
// null); kv_len (B,) int32; lse (B,H) f32; part f32 scratch of
// B*Hkv*ceil(S/chunk)*(H/Hkv)*(D+2) and counters B*Hkv int32 that are zero
// (both may be null when S <= chunk); chunk must be the kernel's chunk
// length (128).  Returns a cudaError_t code.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const void* k_scale, const void* v_scale,
                            const void* kv_len, void* out, void* lse,
                            void* part, void* counters, int dtype, int B,
                            int H, int Hkv, int S, int D, int chunk,
                            float scale, void* stream) {
  return tdt::dispatch_decode(
      dtype, H, D, chunk,
      tdt::DecodeArgs<tdt::DenseRows>{
          q, k, v, static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale), tdt::DenseRows{Hkv, S},
          static_cast<const int*>(kv_len), out, lse,
          static_cast<float*>(part), static_cast<int*>(counters), B, Hkv, S,
          scale, static_cast<cudaStream_t>(stream)});
}
