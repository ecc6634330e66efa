// The expert-FFN backwards' shared pieces (expert_ffn_bwd.cu: K4, K9's and
// K10's backward; expert_ffn_bwd_defer.cu: K8): the row multiple their
// entry points take, the GELU pair, the row lookup of the permuted form,
// and the 16-byte copy loop of their f32 tiles. Every kernel of both files
// runs on the tensor cores (bf16 on mma.sync m16n8k16, f32 in split TF32).
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace ssmv_ffn {

using ssmv::tc::bf16;

constexpr int kRows = 64;  // the row multiple the expert-FFN entries take

__device__ __forceinline__ void gelu_pair(float h, float* g, float* dg) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  *g = h * cdf;
  *dg = cdf + h * expf(-0.5f * h * h) * 0.39894228040143268f;
}

// The xs row of layout row `row0` (in step order): itself, or its row in
// the tile tile_perm[step] visits (kPerm, K10).
template <bool kPerm>
__device__ __forceinline__ int permuted_row(const int* tile_perm, int row0,
                                            int tile_rows) {
  if (!kPerm) return row0;
  return tile_perm[row0 / tile_rows] * tile_rows + row0 % tile_rows;
}

// The 16-byte copies of an f32 slice of R rows of C floats over the block's
// NTH threads: fn(row, column) issues one.
template <int R, int C, int NTH, typename Fn>
__device__ __forceinline__ void each_vec4(Fn fn) {
  constexpr int V = C / 4;
  static_assert(R * V % NTH == 0, "whole copies a thread");
#pragma unroll
  for (int q = 0; q < R * V / NTH; ++q) {
    const int i = threadIdx.x + q * NTH;
    fn(i / V, i % V * 4);
  }
}

}  // namespace ssmv_ffn
