// The GEMM tiles of the fused MoE kernels' first bodies (K11 in
// ag_group_gemm.cu, K10 in moe_reduce_rs.cu) behind one interface: `Float`
// wraps a bf16 or f32 tile of `gemm_tile.cuh` (the K6/K8 body), `Int8` the
// int8 tile of `w8a8_body.cuh` (the K9 body) with its dequant epilogue.
// `run` computes the BM x BN tile at (m0, n0) of out (M, N) = a (M, K) @
// b (K, N), in TO; sa (M,) and sb (N,) are the int8 form's scales, unread
// by `Float`.  A caller syncs the block before each tile.
#pragma once

#include "gemm_tile.cuh"
#include "w8a8_body.cuh"

namespace tdt {
namespace body {

template <class Tile, typename TO>
struct Float {
  using In = typename Tile::In;
  using Out = TO;
  using Smem = typename Tile::Smem;
  static constexpr int BM = Tile::BM, BN = Tile::BN, NT = Tile::NT;
  static __device__ __forceinline__ void run(Smem& sm, const In* a,
                                             const In* b, const float*,
                                             const float*, TO* out, int M,
                                             int N, int K, int m0, int n0,
                                             int vec) {
    Tile::run(sm, a, b, out, M, N, K, m0, n0, vec);
  }
};

template <typename TO>
struct Int8 {
  using In = int8_t;
  using Out = TO;
  using Smem = w8a8::Smem;
  static constexpr int BM = w8a8::BM, BN = w8a8::BN, NT = w8a8::NT;
  static __device__ __forceinline__ void run(Smem& sm, const int8_t* a,
                                             const int8_t* b, const float* sa,
                                             const float* sb, TO* out, int M,
                                             int N, int K, int m0, int n0,
                                             int /*vec*/) {
    w8a8::tile(sm, a, b, sa, sb, out, M, N, K, m0, n0);
  }
};

}  // namespace body
}  // namespace tdt
