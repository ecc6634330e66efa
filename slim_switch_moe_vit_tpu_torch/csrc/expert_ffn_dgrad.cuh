// The SIMT dgrad that the f32 forms of K4, K8, K9's and K10's backward
// share (expert_ffn_bwd.cu, expert_ffn_bwd_defer.cu): dx of the expert FFN,
// with h and dy . W2^T recomputed on chip (expert_ffn_bwd.cu has the math).
// The bf16 forms run on the tensor cores instead: K4, K9's and K10's
// backward in expert_ffn_bwd.cu, K8 in expert_ffn_bwd_defer.cu, each with
// its own dgrad.
//
// kSRows = 16 rows a block; H streamed in 32-wide chunks through one weight
// buffer: the W2 chunk (32 x D+1) for p = dy . W2^T first, then the W1
// chunk (D x 33) for h and for dx += T(dh) . W1^T. dx accumulates in
// registers (2 rows x D/32 columns a thread), f32 FMAs, T(dh) rounded to
// the activation dtype as the tensor-core forms round it to bf16.
// kWorkspace: it also writes T(dh) and T(gelu(h)) to (Tp, H) workspaces
// and the block's f32 column sums of dh to a (Tp / 16, H) table, for the
// SIMT wgrad of expert_ffn_bwd.cu (K4, K9, K10 in f32). kGather: layout
// row s reads x row gather_idx[s] (K9); dy and dx stay in layout (slot)
// space. kPerm (K10): block b reads x and dy of, and writes dx to, its rows
// of row tile tile_perm[step], with the expert e_of_tile[step]; the
// workspace and the dh partials stay in step order.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace ssmv_ffn {

using ssmv::tc::bf16;

constexpr int kRows = 64;      // the row multiple the expert-FFN entries take
constexpr int kThreads = 256;  // the SIMT forms' 8 warps
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void gelu_pair(float h, float* g, float* dg) {
  const float cdf = 0.5f * (1.f + erff(h * 0.70710678118654752f));
  *g = h * cdf;
  *dg = cdf + h * expf(-0.5f * h * h) * 0.39894228040143268f;
}

// The first row of layout row block `row0` (in step order): itself, or
// its row in the tile tile_perm[step] visits (kPerm).
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
         sizeof(float) * (kSRows * kSHC + kWarps * kSHC);
}

template <typename T, int D, bool kGather, bool kWorkspace, bool kPerm>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dgrad_simt(const T* __restrict__ xs,
                      const long long* __restrict__ gather_idx,
                      const T* __restrict__ dy, const T* __restrict__ w1,
                      const float* __restrict__ b1, const T* __restrict__ w2,
                      const int* __restrict__ e_of_tile,
                      const int* __restrict__ tile_perm, T* __restrict__ dxs,
                      T* __restrict__ ws_dh, T* __restrict__ ws_g,
                      float* __restrict__ db1_part, int H, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);    // kSRows x D
  T* DYs = Xs + kSRows * D;              // kSRows x D
  T* Wb = DYs + kSRows * D;              // W2 chunk, then W1 chunk
  float* DHs = reinterpret_cast<float*>(Wb + simt_wbuf(D));  // T(dh), f32
  float* Red = DHs + kSRows * kSHC;      // kWarps x kSHC

  const int row0 = blockIdx.x * kSRows;  // step order: workspace rows
  const int e = e_of_tile[row0 / tile_rows];
  const int prow0 = permuted_row<kPerm>(tile_perm, row0, tile_rows);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* w1e = w1 + (size_t)e * D * H;
  const T* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;

  for (int i = tid; i < kSRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const size_t src = kGather ? (size_t)gather_idx[row0 + r]
                               : (size_t)(prow0 + r);
    Xs[i] = xs[src * D + c];
    DYs[i] = dy[(size_t)(prow0 + r) * D + c];
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
    float dsum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float g, dg;
      gelu_pair((i ? h1 : h0) + bias, &g, &dg);
      const float dh = (i ? p1 : p0) * dg;
      const T dht = ssmv::from_f32<T>(dh);
      DHs[(r0 + i) * kSHC + lane] = ssmv::to_f32(dht);
      if (kWorkspace) {
        dsum += dh;
        const size_t o = (size_t)(row0 + r0 + i) * H + c0 + lane;
        ws_dh[o] = dht;
        ws_g[o] = ssmv::from_f32<T>(g);
      }
    }
    if (kWorkspace) Red[warp * kSHC + lane] = dsum;
    __syncthreads();  // DHs (and Red) complete
    if (kWorkspace && warp == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += Red[w * kSHC + lane];
      db1_part[(size_t)blockIdx.x * H + c0 + lane] = s;
    }
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
      dxs[(size_t)(prow0 + r0 + i) * D + lane + 32 * j] =
          ssmv::from_f32<T>(dxacc[i][j]);
}

// Launch the SIMT dgrad kernel on Tp / 16 blocks: xs (or x, with
// gather_idx), dy, w1, b1, w2 and e_of_tile as the entry points take them;
// the workspace pointers are read only with kWorkspace.
template <typename T, int D, bool kGather, bool kWorkspace, bool kPerm = false>
cudaError_t launch_dgrad_simt(const void* xs, const void* gather_idx,
                              const void* dy, const void* w1, const void* b1,
                              const void* w2, const void* e_of_tile,
                              void* dxs, void* ws_dh, void* ws_g,
                              void* db1_part, int Tp, int H, int tile_rows,
                              cudaStream_t stream,
                              const void* tile_perm = nullptr) {
  static_assert(!(kGather && kPerm), "K9 and K10 do not compose");
  const size_t smem = simt_dgrad_smem<T>(D);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = expert_ffn_dgrad_simt<T, D, kGather, kWorkspace, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / kSRows, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const T*>(dy), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const int*>(e_of_tile), static_cast<const int*>(tile_perm),
      static_cast<T*>(dxs), static_cast<T*>(ws_dh), static_cast<T*>(ws_g),
      static_cast<float*>(db1_part), H, tile_rows);
  return cudaGetLastError();
}

}  // namespace ssmv_ffn
