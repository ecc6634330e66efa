// The dgrad kernels that K8 (expert_ffn_bwd_defer.cu) and the f32 forms
// of K4, K9's and K10's backward (expert_ffn_bwd.cu) share: dx of the
// expert FFN, with h and dy . W2^T recomputed on chip (expert_ffn_bwd.cu
// has the math). The bf16 forms of K4, K9's and K10's backward at every D
// run the tensor-core design of expert_ffn_bwd.cu instead.
//
// (a) The WMMA dgrad, K8's at bf16 D = 192 and 384: one block of 8 warps
//     per 64-row block of the layout (a quarter of a 256-row tile); x and
//     dy of the block stay in shared memory, H is streamed in 32-wide
//     chunks of W1 / W2, and each chunk's h and dy . W2^T pass through
//     shared f32 tiles; dx accumulates in WMMA fragments over the chunks and
//     is rounded to bf16 once. K8 computes its dW and db from x and dy
//     itself, so this form writes dx only.
// (b) The SIMT dgrad: f32 at every D, and K8's bf16 at D = 768 (the WMMA
//     layout's full-D x and dy tiles with a D-row W1 chunk exceed shared
//     memory there). kWorkspace: it also writes T(dh) and T(gelu(h)) to
//     (Tp, H) workspaces and the block's f32 column sums of dh to a
//     (Tp / 16, H) table, for the SIMT wgrad of expert_ffn_bwd.cu (K4,
//     K9, K10 in f32). kGather: layout row s reads x row gather_idx[s]
//     (K9); dy and dx stay in layout (slot) space. kPerm (K10): block b
//     reads x and dy of, and writes dx to, its rows of row tile
//     tile_perm[step], with the expert e_of_tile[step]; the workspace and
//     the dh partials stay in step order.
#pragma once

#include "common.cuh"
#include "mma_sync.cuh"

namespace ssmv_ffn {

using namespace nvcuda;
using ssmv::tc::bf16;

constexpr int kRows = 64;      // rows per dgrad block
constexpr int kHC = 32;        // hidden chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBPad = 8;
constexpr int kFPad = 4;

template <int D>
struct DgradSmem {
  static constexpr int XLD = D + kBPad;     // x, dy and W2-chunk rows (bf16)
  static constexpr int W1LD = kHC + kBPad;  // W1 chunk rows (bf16)
  static constexpr int HLD = kHC + kFPad;   // h / dy.W2^T chunk rows (f32)
  static constexpr int GLD = kHC + kBPad;   // bf16(dh) chunk rows
  static constexpr int DXLD = D + kFPad;    // dx staging rows (f32)
  static constexpr size_t X = 0;
  static constexpr size_t DY = X + sizeof(bf16) * kRows * XLD;
  static constexpr size_t W1 = DY + sizeof(bf16) * kRows * XLD;
  static constexpr size_t W2 = W1 + sizeof(bf16) * D * W1LD;
  static constexpr size_t Hs = W2 + sizeof(bf16) * kHC * XLD;
  static constexpr size_t Ps = Hs + sizeof(float) * kRows * HLD;
  static constexpr size_t Gs = Ps + sizeof(float) * kRows * HLD;
  static constexpr size_t bytes = Gs + sizeof(bf16) * kRows * GLD;
  // dx is staged over the x and dy tiles once the hidden loop is done
  static_assert(sizeof(float) * kRows * DXLD <= W1, "dx staging overflow");
  static_assert(DY % 32 == 0 && W1 % 32 == 0 && W2 % 32 == 0 &&
                    Hs % 32 == 0 && Ps % 32 == 0 && Gs % 32 == 0,
                "WMMA needs 32-byte aligned tiles");
  static_assert(bytes <= ssmv::kMaxSmemBytes, "shared memory budget");
};

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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dgrad_kernel(const bf16* __restrict__ xs,
                        const bf16* __restrict__ dy,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const int* __restrict__ e_of_tile,
                        bf16* __restrict__ dxs, int H, int tile_rows) {
  using L = DgradSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X);
  bf16* DYs = reinterpret_cast<bf16*>(smem + L::DY);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* Hs = reinterpret_cast<float*>(smem + L::Hs);
  float* Ps = reinterpret_cast<float*>(smem + L::Ps);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::Gs);
  float* DXs = reinterpret_cast<float*>(smem + L::X);

  const int row0 = blockIdx.x * kRows;
  const int e = e_of_tile[row0 / tile_rows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bf16* w1e = w1 + (size_t)e * D * H;
  const bf16* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;

  constexpr int XV = D / 8;  // 16-byte vectors per row of D
  for (int i = tid; i < kRows * XV; i += kThreads) {
    const int r = i / XV, v = i % XV;
    const size_t g = (size_t)(row0 + r) * D + v * 8;
    *reinterpret_cast<uint4*>(Xs + r * L::XLD + v * 8) =
        *reinterpret_cast<const uint4*>(xs + g);
    *reinterpret_cast<uint4*>(DYs + r * L::XLD + v * 8) =
        *reinterpret_cast<const uint4*>(dy + g);
  }

  const int rs = warp & 3;     // this warp's 16-row strip
  const int half = warp >> 2;  // its chunk column tile (h) / dx column half
  constexpr int NF = D / 32;   // dx fragments per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> dxacc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(dxacc[f], 0.f);

  for (int c0 = 0; c0 < H; c0 += kHC) {
    __syncthreads();  // last chunk's readers of W1s, W2s, Gs are done
    for (int i = tid; i < D * (kHC / 8); i += kThreads) {
      const int k = i / (kHC / 8), v = i % (kHC / 8);
      *reinterpret_cast<uint4*>(W1s + k * L::W1LD + v * 8) =
          *reinterpret_cast<const uint4*>(w1e + (size_t)k * H + c0 + v * 8);
    }
    for (int i = tid; i < kHC * XV; i += kThreads) {
      const int r = i / XV, v = i % XV;
      *reinterpret_cast<uint4*>(W2s + r * L::XLD + v * 8) =
          *reinterpret_cast<const uint4*>(w2e + (size_t)(c0 + r) * D + v * 8);
    }
    __syncthreads();

    {  // h = x . W1[:, chunk] and p = dy . W2[chunk, :]^T; one tile each
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc, pacc;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bh;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bp;
      wmma::fill_fragment(hacc, 0.f);
      wmma::fill_fragment(pacc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(a, Xs + rs * 16 * L::XLD + kk, L::XLD);
        wmma::load_matrix_sync(bh, W1s + kk * L::W1LD + half * 16, L::W1LD);
        wmma::mma_sync(hacc, a, bh, hacc);
        wmma::load_matrix_sync(a, DYs + rs * 16 * L::XLD + kk, L::XLD);
        wmma::load_matrix_sync(bp, W2s + half * 16 * L::XLD + kk, L::XLD);
        wmma::mma_sync(pacc, a, bp, pacc);
      }
      wmma::store_matrix_sync(Hs + rs * 16 * L::HLD + half * 16, hacc, L::HLD,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Ps + rs * 16 * L::HLD + half * 16, pacc, L::HLD,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // dh = p * gelu'(h + b1); thread (warp, lane) takes column lane of
    // rows warp, warp + 8, ...
    const float bias = b1e[c0 + lane];
    for (int r = warp; r < kRows; r += kWarps) {
      float g, dg;
      gelu_pair(Hs[r * L::HLD + lane] + bias, &g, &dg);
      (void)g;
      Gs[r * L::GLD + lane] = __float2bfloat16(Ps[r * L::HLD + lane] * dg);
    }
    __syncthreads();  // Gs is complete before the dx product reads it

    {  // dx += bf16(dh) . W1[:, chunk]^T; this warp: rows rs*16, its half
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
#pragma unroll
      for (int kk = 0; kk < kHC; kk += 16) {
        wmma::load_matrix_sync(a, Gs + rs * 16 * L::GLD + kk, L::GLD);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::load_matrix_sync(
              bm, W1s + (half * (D / 2) + f * 16) * L::W1LD + kk, L::W1LD);
          wmma::mma_sync(dxacc[f], a, bm, dxacc[f]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with x and dy before dx overwrites
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(DXs + rs * 16 * L::DXLD + half * (D / 2) + f * 16,
                            dxacc[f], L::DXLD, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kRows * (D / 2); i += kThreads) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    *reinterpret_cast<__nv_bfloat162*>(dxs + (size_t)(row0 + r) * D + c) =
        __floats2bfloat162_rn(DXs[r * L::DXLD + c], DXs[r * L::DXLD + c + 1]);
  }
}


// Launch the WMMA dgrad kernel on Tp / 64 blocks (K8, bf16 at D = 192 and
// 384).
template <int D>
cudaError_t launch_dgrad(const void* xs, const void* dy, const void* w1,
                         const void* b1, const void* w2,
                         const void* e_of_tile, void* dxs, int Tp, int H,
                         int tile_rows, cudaStream_t stream) {
  const size_t smem = DgradSmem<D>::bytes;
  auto kernel = expert_ffn_dgrad_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / kRows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<bf16*>(dxs), H, tile_rows);
  return cudaGetLastError();
}

// The SIMT dgrad, (b) above: kSRows = 16 rows a block; H streamed in
// 32-wide chunks through one weight buffer: the W2 chunk (32 x D+1) for
// p = dy . W2^T first, then the W1 chunk (D x 33) for h and for
// dx += T(dh) . W1^T. dx accumulates in registers (2 rows x D/32 columns a
// thread). The same math and roundings as the WMMA form (T in place of
// bf16); with kWorkspace the dh partials table holds one row per 16-row
// block, (Tp / 16, H).
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

// Launch the SIMT dgrad kernel on Tp / 16 blocks (arguments as
// launch_dgrad).
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
