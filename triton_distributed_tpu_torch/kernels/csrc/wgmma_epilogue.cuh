// The epilogue of the `wgmma` tile's consumers, shared by the bodies that
// send a tile's rows somewhere other than a plain output (K14 `gemm_rs.cu`,
// K10 `moe_reduce_rs.cu`) and by K7 (`matmul_w8a8.cu`, its dequantized
// bf16 rows): the consumers' own named barrier and waits, the
// crew's entry barrier that opens the consumers' remote stores, the rows
// rounded to bf16 and stored as 16-byte pieces through a slab of shared
// memory a warp, and the rank-order sum of W bf16 partials run by the
// consumers.
#pragma once

#include "comm_body.cuh"
#include "wgmma_tile.cuh"

namespace tdt {
namespace wgmma {

//: The crew (the producer warpgroup's warps 1-3) syncs on named barrier 1,
//: the consumer warpgroups on named barrier 2.
constexpr int CREW_THREADS = 96, CREW_BARRIER = 1, STORE_BARRIER = 2;

// The C consumer warpgroups of a block (threads [0, 128 C)) meet.
template <int C>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(STORE_BARRIER), "n"(C * WG)
               : "memory");
}

// Consumer thread i < n waits until words[i] holds ``target`` (or records
// ``what`` and traps); then the consumers meet, and the data the words
// announce may be read through L2 (`dl::wait` on the consumers).
template <int C>
__device__ __forceinline__ void consumers_wait(const dl::u64* words, int n,
                                               dl::u64 target, int what) {
  const int i = threadIdx.x;
  if (i < n) dl::signal_wait_until(words + i, target, what);
  consumers_sync<C>();
}

// The crew thread ``i``: the entry barrier of every rank, then the
// consumers may store into the peers' buffers (a peer has left the last
// call's reads of them).
__device__ __forceinline__ void crew_enter(const dl::Team& t,
                                           dl::Symm<dl::u64> sig,
                                           uint64_t* entered, dl::u64 target,
                                           int i) {
  const comm::Crew c{i, CREW_THREADS, CREW_BARRIER};
  comm::crew_entry_barrier(t, sig, target, /*neighbors_only=*/false, c);
  if (i == 0) mbar_arrive(entered);
}

// A consumer's first remote store waits for the crew's entry barrier.
__device__ __forceinline__ void wait_entered(uint64_t* entered, bool& open) {
  if (!open) {
    mbar_wait(entered, 0);
    open = true;
  }
}

// ---- the epilogue: 16-byte row pieces through a slab a warp ---------------
//
// A consumer warp holds 16 rows of its warpgroup's 64 as `wgmma`
// fragments (row lane / 4 and + 8, columns 8 j + 2 (lane % 4) and + 1).
// Stored as they are, each instruction writes 8 pieces of 4 bytes (8 of f32).
// So a warp writes its accumulators, rounded to the output type, into a slab
// of shared memory beside the ring, 128 bytes of a row at a time (64 bf16
// or 32 f32 columns; 16 rows, the 16-byte chunk j of row i at j ^ (i % 8):
// no bank conflict either way), and reads them back as 16-byte pieces of a
// row, 8 lanes a row: 128 contiguous bytes a row.

//: A warp's slab.
constexpr int SLAB_BYTES = 16 * 128;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// The columns a slab holds: 128 bytes of a row in TO.
template <typename TO>
constexpr int SLAB_COLS = 128 / (int)sizeof(TO);

// Columns [SLAB_COLS s, + SLAB_COLS) of a consumer warp's accumulator
// values (``val(i)``, the accumulator itself or its dequantized value),
// rounded to TO (bf16 or f32), into its slab.
template <typename TO, class F>
__device__ __forceinline__ void to_slab(uint8_t* slab, int s, const F& val) {
  constexpr int GROUPS = SLAB_COLS<TO> / 8;  // 8-column groups a slab
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int jj = 0; jj < GROUPS; ++jj) {
    const int j = GROUPS * s + jj;
    // The pair's bytes in the row: its 16-byte chunk and offset in it.
    const int b = (8 * jj + 2 * (lane % 4)) * (int)sizeof(TO);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = lane / 4 + 8 * h;
      uint8_t* q = slab + i * 128 + ((b / 16) ^ (i % 8)) * 16 + b % 16;
      const float x = val(4 * j + 2 * h), y = val(4 * j + 2 * h + 1);
      if constexpr (std::is_same<TO, float>::value)
        *reinterpret_cast<float2*>(q) = make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(q) = __floats2bfloat162_rn(x, y);
    }
  }
}

// A lane's piece k (0 .. 3) of its warp's slab: row lane / 8 + 4 k of the
// warp's 16, bytes 16 (lane % 8) .. + 16 of the row's 128.
__device__ __forceinline__ uint4 slab_piece(const uint8_t* slab, int k) {
  const int lane = threadIdx.x % 32, i = lane / 8 + 4 * k, c = lane % 8;
  return *reinterpret_cast<const uint4*>(slab + i * 128 + (c ^ (i % 8)) * 16);
}

// The row of the warpgroup's 64 that a lane's piece k (0 .. 3) of every
// slab lies in.
__device__ __forceinline__ int piece_row(int k) {
  return threadIdx.x % WG / 32 * 16 + threadIdx.x % 32 / 8 + 4 * k;
}

// The R accumulator values (``val(i)``) of a consumer warp, rounded to TO,
// stored as 16-byte pieces: a lane's piece k of every slab goes to
// ``rows[k]`` (its row's destination, 16-byte aligned, null past the chunk)
// at the slab's columns, from ``col0``, that lie below ``N`` (a multiple of
// 16 / sizeof(TO)).
template <int R, typename TO, class F>
__device__ __forceinline__ void store_pieces_of(uint8_t* slab, const F& val,
                                                TO* const (&rows)[4],
                                                int col0, int N) {
  constexpr int COLS = SLAB_COLS<TO>;
  const int col = col0 + 16 / (int)sizeof(TO) * (threadIdx.x % 8);
#pragma unroll
  for (int s = 0; s < 2 * R / COLS; ++s) {
    to_slab<TO>(slab, s, val);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (rows[k] != nullptr && col + COLS * s < N)
        *reinterpret_cast<uint4*>(rows[k] + col + COLS * s) =
            slab_piece(slab, k);
    __syncwarp();
  }
}

// `store_pieces_of` the f32 accumulators themselves.
template <int R>
__device__ __forceinline__ void store_pieces(uint8_t* slab,
                                             const float (&acc)[R],
                                             bf16* const (&rows)[4], int col0,
                                             int N) {
  store_pieces_of<R, bf16>(slab, [&](int i) { return acc[i]; }, rows, col0,
                           N);
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// One 16-byte piece of the f32 sum, in rank order 0 .. W-1, of ``world``
// partials rounded to bf16, rank q's at ``src + q * slot`` (read through
// L2); four ranks' loads at a time go out before their sums.  Stored to
// ``dst``.  The sums run in the epilogue, where the live accumulators
// leave about 70 registers, so a lane holds one piece at a time.
__device__ __forceinline__ void sum_piece(bf16* dst, const bf16* src,
                                          size_t slot, int world) {
  float sum[8];
  for (int q0 = 0; q0 < world; q0 += 4) {
    uint4 raw[4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      if (q0 + qq < world)
        raw[qq] =
            __ldcg(reinterpret_cast<const uint4*>(src + (q0 + qq) * slot));
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      if (q0 + qq < world) {
        float f[8];
        unpack8(raw[qq], f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sum[e] = q0 + qq == 0 ? f[e] : sum[e] + f[e];
      }
  }
  comm::store8(dst, sum);
}

// out = the sum of the W partials of ``src`` (W slots of ``elems``
// elements, a multiple of 8) over block ``part`` of ``parts``'s share,
// with the consumers' 128 C threads, a piece of 8 a thread at a time, the
// next piece's prefetched into L2 (32-bit counts: a 64-bit division is a
// call, and a call serializes the `wgmma`s).
template <int C>
__device__ __forceinline__ void reduce_partials(const bf16* src, bf16* out,
                                                int world, unsigned elems,
                                                int part, int parts) {
  constexpr unsigned NT = C * WG;
  const unsigned units = elems / 8;
  const unsigned share = (units + parts - 1) / (unsigned)parts;
  const unsigned start = (unsigned)part * share;
  const unsigned lo = start < units ? start : units;
  const unsigned hi = units - lo < share ? units : lo + share;
  for (unsigned i = lo + threadIdx.x; i < hi; i += NT) {
    if (i + NT < hi)
      for (int q = 0; q < world; ++q)
        prefetch_l2(src + (size_t)q * elems + (size_t)(i + NT) * 8);
    sum_piece(out + (size_t)i * 8, src + (size_t)i * 8, elems, world);
  }
}


}  // namespace wgmma
}  // namespace tdt
