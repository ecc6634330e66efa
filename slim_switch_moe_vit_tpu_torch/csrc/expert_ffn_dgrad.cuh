// The expert-FFN backwards' shared pieces (expert_ffn_bwd.cu: K4, K9's and
// K10's backward; expert_ffn_bwd_defer.cu: K8): the GELU pair, the row
// lookup of the permuted form, and the SIMT dgrad of K8's f32 form.
//
// The SIMT dgrad replaces, with K8's SIMT deferred-dW kernel, the Pallas
// kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py _bwd_kernel_defer (:312)
// in f32: dx of the expert FFN, with h and dy . W2^T recomputed on chip
// (expert_ffn_bwd.cu has the math). What bounds it on the card: the FLOPs
// (6 x D x H a row) at the split-TF32 rate, 164.9 TFLOP/s; this form runs
// on the CUDA cores' f32 FMAs instead, a first, correct kernel that K8's
// f32 redesign replaces (ROADMAP Queue 2). K4, K9's and K10's f32 forms run
// on the tensor cores in expert_ffn_bwd.cu, and every bf16 form has its own
// dgrad on them.
//
// kSRows = 16 rows a block; H streamed in 32-wide chunks through one weight
// buffer: the W2 chunk (32 x D+1) for p = dy . W2^T first, then the W1
// chunk (D x 33) for h and for dx += T(dh) . W1^T. dx accumulates in
// registers (2 rows x D/32 columns a thread), f32 FMAs, T(dh) rounded to
// the activation dtype.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace ssmv_ffn {

using ssmv::tc::bf16;

constexpr int kRows = 64;      // the row multiple the expert-FFN entries take
constexpr int kThreads = 256;  // K8's SIMT forms' 8 warps

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

using ssmv::kSHC;
using ssmv::kSRows;
using ssmv::simt_wbuf;

template <typename T>
__host__ __device__ constexpr size_t simt_dgrad_smem(int d) {
  return sizeof(T) * (2 * (size_t)kSRows * d + simt_wbuf(d)) +
         sizeof(float) * kSRows * kSHC;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dgrad_simt(const T* __restrict__ xs, const T* __restrict__ dy,
                      const T* __restrict__ w1, const float* __restrict__ b1,
                      const T* __restrict__ w2,
                      const int* __restrict__ e_of_tile, T* __restrict__ dxs,
                      int H, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);    // kSRows x D
  T* DYs = Xs + kSRows * D;              // kSRows x D
  T* Wb = DYs + kSRows * D;              // W2 chunk, then W1 chunk
  float* DHs = reinterpret_cast<float*>(Wb + simt_wbuf(D));  // T(dh), f32

  const int row0 = blockIdx.x * kSRows;
  const int e = e_of_tile[row0 / tile_rows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* w1e = w1 + (size_t)e * D * H;
  const T* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;

  for (int i = tid; i < kSRows * D; i += kThreads) {
    Xs[i] = xs[(size_t)row0 * D + i];
    DYs[i] = dy[(size_t)row0 * D + i];
  }

  constexpr int NJ = D / 32;  // dx columns lane + 32 j of rows 2 warp + i
  const int r0 = warp * 2;
  float dxacc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dxacc[i][j] = 0.f;

  for (int c0 = 0; c0 < H; c0 += kSHC) {
    __syncthreads();  // last chunk's readers of Wb and DHs are done
    for (int i = tid; i < kSHC * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Wb[r * (D + 1) + c] = w2e[(size_t)(c0 + r) * D + c];
    }
    __syncthreads();
    float p0 = 0.f, p1 = 0.f;  // (dy . W2^T) of rows r0, r0 + 1, column lane
    for (int k = 0; k < D; ++k) {
      const float wv = ssmv::to_f32(Wb[lane * (D + 1) + k]);
      p0 = fmaf(ssmv::to_f32(DYs[r0 * D + k]), wv, p0);
      p1 = fmaf(ssmv::to_f32(DYs[(r0 + 1) * D + k]), wv, p1);
    }
    __syncthreads();  // every warp is done with the W2 chunk
    for (int i = tid; i < D * kSHC; i += kThreads) {
      const int k = i / kSHC, c = i % kSHC;
      Wb[k * (kSHC + 1) + c] = w1e[(size_t)k * H + c0 + c];
    }
    __syncthreads();
    float h0 = 0.f, h1 = 0.f;
    for (int k = 0; k < D; ++k) {
      const float wv = ssmv::to_f32(Wb[k * (kSHC + 1) + lane]);
      h0 = fmaf(ssmv::to_f32(Xs[r0 * D + k]), wv, h0);
      h1 = fmaf(ssmv::to_f32(Xs[(r0 + 1) * D + k]), wv, h1);
    }
    const float bias = b1e[c0 + lane];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float g, dg;
      gelu_pair((i ? h1 : h0) + bias, &g, &dg);
      DHs[(r0 + i) * kSHC + lane] =
          ssmv::to_f32(ssmv::from_f32<T>((i ? p1 : p0) * dg));
    }
    __syncthreads();  // DHs complete
    for (int c = 0; c < kSHC; ++c) {
      const float d0 = DHs[r0 * kSHC + c], d1 = DHs[(r0 + 1) * kSHC + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = ssmv::to_f32(Wb[(lane + 32 * j) * (kSHC + 1) + c]);
        dxacc[0][j] = fmaf(d0, wv, dxacc[0][j]);
        dxacc[1][j] = fmaf(d1, wv, dxacc[1][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      dxs[(size_t)(row0 + r0 + i) * D + lane + 32 * j] =
          ssmv::from_f32<T>(dxacc[i][j]);
}

// Launch the SIMT dgrad kernel on Tp / 16 blocks: xs, dy, w1, b1, w2 and
// e_of_tile as K8's entry point takes them.
template <typename T, int D>
cudaError_t launch_dgrad_simt(const void* xs, const void* dy, const void* w1,
                              const void* b1, const void* w2,
                              const void* e_of_tile, void* dxs, int Tp, int H,
                              int tile_rows, cudaStream_t stream) {
  const size_t smem = simt_dgrad_smem<T>(D);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = expert_ffn_dgrad_simt<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / kSRows, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(dy),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<T*>(dxs), H, tile_rows);
  return cudaGetLastError();
}

}  // namespace ssmv_ffn
