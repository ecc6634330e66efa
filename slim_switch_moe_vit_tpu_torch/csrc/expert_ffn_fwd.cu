// Per-expert FFN forward over the tile-aligned expert layout (K3), its
// gather-in-kernel form (K9 forward) and its permuted-tile form (K10
// forward).
//
// K3 replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _fwd_kernel (:166), reached through _fwd (:176) and fused_expert_ffn
// (:511). K9's forward replaces _fwd_gather_kernel (:605), reached through
// _fwd_gather (:628) and fused_expert_ffn_gather (:763): the same function
// of the rows x[gather_idx[s]], with the dispatch row gather folded into
// the kernel's x load, so the expanded (Tp, D) xs is never written. The TPU
// kernel issues one DMA per 768-byte row, double-buffered a tile ahead
// (and never lowered: Mosaic needs 8-row-aligned slices of device memory);
// on the card an indexed row is 48 aligned 16-byte loads, so K9 is K3 with
// each row's source address read from gather_idx (kGather).
//
// K10's forward replaces the tile_perm branch of _fwd (:176-214), reached
// through fused_expert_ffn_permuted (:865): grid step i of the layout's
// 256-row tiles visits row tile tile_perm[i] of xs, reads it and writes the
// same tile of y, with the expert e_of_tile[i] indexed by step. The a2a
// expert-parallel form uses it to visit source-major rows expert-major
// without a relayout copy. The TPU kernel does this through scalar-prefetch
// block index maps; here a block reads one table entry and offsets its row
// base (kPerm), so the permutation costs one indirection per row block.
//
// Rows of xs are
// sorted by expert and every 256-row layout tile (TILE_ROWS) belongs to one
// expert, e = e_of_tile[tile]; each row computes
//   y = GELU(x . W1[e] + b1[e]) . W2[e] + b2[e]
// with W1 (E, D, H) and W2 (E, H, D) expert-major, as the JAX package stores
// them.
//
// What bounds it on the H100: the FLOPs. At ViT-S (D = 384, H = 1536) a row
// costs 2.4 MFLOP against 768 bytes of x and y, and the unfused chain would
// also write and re-read the (rows, H) hidden activation (4x the bytes of x).
// Like the TPU kernel, this one keeps the hidden activation out of device
// memory: it streams H in 64-wide chunks, and each chunk's h, GELU(h) and
// its contribution to y stay in shared memory and registers. Both products
// run on the tensor cores through WMMA bf16 16x16x16 fragments with f32
// accumulation. The expert weights are re-read from L2 by every 64-row block
// of that expert (2.4 MB of bf16 per expert; all 8 experts fit in the 50 MB
// L2); loads are synchronous 16-byte copies without overlap, which bounds
// this first kernel well below the tensor-core peak. Pipelined TMA/wgmma is
// later work.
//
// Arithmetic order, as the TPU kernel: h = x . W1 in f32 (+ b1 in f32), the
// exact erf GELU in f32 (erff), g rounded to bf16, y += g . W2 in f32, + b2,
// then one rounding to bf16. The TPU kernel evaluates GELU for bf16 with an
// odd polynomial (fused_ffn.py:107-113, within 5.7e-4 of the exact GELU);
// that is a TPU VPU policy and is not ported, so the two differ by up to
// 5.7e-4 before the bf16 rounding of g.
//
// Layout padding slots gather token 0 (in both forms) and yield finite rows
// that the combine never reads.
//
// f32 at every D, and bf16 at D = 768, take the SIMT form at the end of
// this file (expert_ffn_fwd_simt), with the same three entry points.
#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows per block: a quarter of a layout tile
constexpr int kHC = 64;        // hidden chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kBPad = 8;       // bf16 row padding: keeps 32-byte fragment rows
constexpr int kFPad = 4;       // f32 row padding

template <int D>
struct Smem {
  static constexpr int XLD = D + kBPad;     // x tile and W2 chunk rows (bf16)
  static constexpr int W1LD = kHC + kBPad;  // W1 chunk rows (bf16)
  static constexpr int HLD = kHC + kFPad;   // h chunk rows (f32)
  static constexpr int GLD = kHC + kBPad;   // GELU(h) chunk rows (bf16)
  static constexpr int YLD = D + kFPad;     // y staging rows (f32)
  static constexpr size_t X = 0;
  static constexpr size_t W1 = X + sizeof(bf16) * kRows * XLD;
  static constexpr size_t W2 = W1 + sizeof(bf16) * D * W1LD;
  static constexpr size_t Hs = W2 + sizeof(bf16) * kHC * XLD;
  static constexpr size_t Gs = Hs + sizeof(float) * kRows * HLD;
  static constexpr size_t bytes = Gs + sizeof(bf16) * kRows * GLD;
  // y is staged over the W1/W2 chunk buffers once the hidden loop is done
  static_assert(sizeof(float) * kRows * YLD <= Hs - W1, "y staging overflow");
  static_assert(W1 % 32 == 0 && W2 % 32 == 0 && Hs % 32 == 0 && Gs % 32 == 0,
                "WMMA needs 32-byte aligned tiles");
  static_assert(bytes <= ssmv::kMaxSmemBytes, "shared memory budget");
};

// kGather: row s of the layout is row gather_idx[s] of xs (K9); else row s.
// kPerm: block b is in step-order row block b, which lies in row tile
// tile_perm[step] of xs and y (K10).
template <int D, bool kGather, bool kPerm>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_fwd_kernel(const bf16* __restrict__ xs,
                      const long long* __restrict__ gather_idx,
                      const int* __restrict__ tile_perm,
                      const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const int* __restrict__ e_of_tile, bf16* __restrict__ y,
                      int H, int tile_rows) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* Hs = reinterpret_cast<float*>(smem + L::Hs);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::Gs);
  float* Ys = reinterpret_cast<float*>(smem + L::W1);

  const int step_row0 = blockIdx.x * kRows;
  const int e = e_of_tile[step_row0 / tile_rows];
  const int row0 = kPerm ? tile_perm[step_row0 / tile_rows] * tile_rows +
                               step_row0 % tile_rows
                         : step_row0;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const bf16* w1e = w1 + (size_t)e * D * H;
  const bf16* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;
  const float* b2e = b2 + (size_t)e * D;

  constexpr int XV = D / 8;  // 16-byte vectors per row of D
  for (int i = tid; i < kRows * XV; i += kThreads) {
    const int r = i / XV, v = i % XV;
    const size_t src = kGather ? (size_t)gather_idx[row0 + r]
                               : (size_t)(row0 + r);
    *reinterpret_cast<uint4*>(Xs + r * L::XLD + v * 8) =
        *reinterpret_cast<const uint4*>(xs + src * D + v * 8);
  }

  const int rs = warp & 3;    // this warp's 16-row strip
  const int half = warp >> 2; // its column pair (h) / column half (y)
  constexpr int NF = D / 32;  // y fragments per warp
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> yacc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(yacc[f], 0.f);

  for (int c0 = 0; c0 < H; c0 += kHC) {
    __syncthreads();  // last chunk's readers of W1s/W2s are done
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

    {  // h chunk = x . W1[:, c0:c0+kHC]; this warp: rows rs*16, 2 column blocks
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::fill_fragment(hacc[0], 0.f);
      wmma::fill_fragment(hacc[1], 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::load_matrix_sync(a, Xs + rs * 16 * L::XLD + kk, L::XLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(bm, W1s + kk * L::W1LD + (half * 2 + j) * 16,
                                 L::W1LD);
          wmma::mma_sync(hacc[j], a, bm, hacc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Hs + rs * 16 * L::HLD + (half * 2 + j) * 16,
                                hacc[j], L::HLD, wmma::mem_row_major);
    }
    __syncthreads();

    // g = bf16(GELU(h + b1)), exact erf GELU in f32
    for (int i = tid; i < kRows * kHC; i += kThreads) {
      const int r = i / kHC, c = i % kHC;
      const float hv = Hs[r * L::HLD + c] + b1e[c0 + c];
      const float g = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
      Gs[r * L::GLD + c] = __float2bfloat16(g);
    }
    __syncthreads();

    {  // y += g . W2[c0:c0+kHC, :]; this warp: rows rs*16, columns of its half
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
      for (int kk = 0; kk < kHC; kk += 16) {
        wmma::load_matrix_sync(a, Gs + rs * 16 * L::GLD + kk, L::GLD);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::load_matrix_sync(
              bm, W2s + kk * L::XLD + half * (D / 2) + f * 16, L::XLD);
          wmma::mma_sync(yacc[f], a, bm, yacc[f]);
        }
      }
    }
  }
  __syncthreads();  // every warp is done with W1s/W2s before y overwrites them
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(Ys + rs * 16 * L::YLD + half * (D / 2) + f * 16,
                            yacc[f], L::YLD, wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < kRows * (D / 2); i += kThreads) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    const float v0 = Ys[r * L::YLD + c] + b2e[c];
    const float v1 = Ys[r * L::YLD + c + 1] + b2e[c + 1];
    *reinterpret_cast<__nv_bfloat162*>(y + (size_t)(row0 + r) * D + c) =
        __floats2bfloat162_rn(v0, v1);
  }
}

template <int D, bool kGather, bool kPerm>
cudaError_t launch(const void* xs, const void* gather_idx,
                   const void* tile_perm, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* e_of_tile,
                   void* y, int Tp, int H, int tile_rows,
                   cudaStream_t stream) {
  const size_t smem = Smem<D>::bytes;
  auto kernel = expert_ffn_fwd_kernel<D, kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / kRows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs),
      static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(e_of_tile),
      static_cast<bf16*>(y), H, tile_rows);
  return cudaGetLastError();
}

// The SIMT form: f32 at every D, and bf16 at D = 768.
//
// The WMMA layout above keeps a full-D x tile, a D-row W1 chunk and a
// full-D W2 chunk on chip: about 335 KB at D = 768, over the 232,448-byte
// cap, and 24 y fragments a warp. f32 has no exact tensor-core product
// (single-pass TF32 keeps 10 mantissa bits), so f32 runs on the CUDA
// cores. This kernel takes kSRows = 16 rows a block and streams H in
// 32-wide chunks through one weight buffer, which holds the W1 chunk
// (D x 33) for h and then the W2 chunk (32 x D+1) for y; y accumulates in
// registers (2 rows x D/32 columns a thread). All products are f32 FMAs on
// the activation-dtype operands, in the order of the WMMA form: h in f32
// (+ b1), the exact erf GELU, g rounded to T, y += g . W2 in f32, + b2, one
// rounding to T. A first, correct kernel: tensor-core tiling for D = 768
// and faster f32 are kernel-speed work.
using ssmv::kSHC;
using ssmv::kSRows;
using ssmv::simt_wbuf;

template <typename T>
__host__ __device__ constexpr size_t simt_fwd_smem(int d) {
  return sizeof(T) * ((size_t)kSRows * d + simt_wbuf(d)) +
         sizeof(float) * kSRows * kSHC;
}

template <typename T, int D, bool kGather, bool kPerm>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_fwd_simt(const T* __restrict__ xs,
                    const long long* __restrict__ gather_idx,
                    const int* __restrict__ tile_perm,
                    const T* __restrict__ w1, const float* __restrict__ b1,
                    const T* __restrict__ w2, const float* __restrict__ b2,
                    const int* __restrict__ e_of_tile, T* __restrict__ y,
                    int H, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* Xs = reinterpret_cast<T*>(smem);      // kSRows x D
  T* Wb = Xs + kSRows * D;                 // W1 chunk, then W2 chunk
  float* Gs = reinterpret_cast<float*>(Wb + simt_wbuf(D));  // kSRows x kSHC

  const int step_row0 = blockIdx.x * kSRows;
  const int e = e_of_tile[step_row0 / tile_rows];
  const int row0 = kPerm ? tile_perm[step_row0 / tile_rows] * tile_rows +
                               step_row0 % tile_rows
                         : step_row0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* w1e = w1 + (size_t)e * D * H;
  const T* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;
  const float* b2e = b2 + (size_t)e * D;

  for (int i = tid; i < kSRows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const size_t src = kGather ? (size_t)gather_idx[step_row0 + r]
                               : (size_t)(row0 + r);
    Xs[i] = xs[src * D + c];
  }

  constexpr int NJ = D / 32;  // y columns lane + 32 j of rows 2 warp + i
  const int r0 = warp * 2;
  float yacc[2][NJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) yacc[i][j] = 0.f;

  for (int c0 = 0; c0 < H; c0 += kSHC) {
    __syncthreads();  // last chunk's readers of Wb are done
    for (int i = tid; i < D * kSHC; i += kThreads) {
      const int k = i / kSHC, c = i % kSHC;
      Wb[k * (kSHC + 1) + c] = w1e[(size_t)k * H + c0 + c];
    }
    __syncthreads();
    float h0 = 0.f, h1 = 0.f;  // h of rows r0, r0 + 1 at chunk column lane
    for (int k = 0; k < D; ++k) {
      const float wv = ssmv::to_f32(Wb[k * (kSHC + 1) + lane]);
      h0 = fmaf(ssmv::to_f32(Xs[r0 * D + k]), wv, h0);
      h1 = fmaf(ssmv::to_f32(Xs[(r0 + 1) * D + k]), wv, h1);
    }
    const float bias = b1e[c0 + lane];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float hv = (i ? h1 : h0) + bias;
      const float g = 0.5f * hv * (1.f + erff(hv * 0.70710678118654752f));
      Gs[(r0 + i) * kSHC + lane] = ssmv::to_f32(ssmv::from_f32<T>(g));
    }
    __syncthreads();  // every warp is done with the W1 chunk
    for (int i = tid; i < kSHC * D; i += kThreads) {
      const int r = i / D, c = i % D;
      Wb[r * (D + 1) + c] = w2e[(size_t)(c0 + r) * D + c];
    }
    __syncthreads();
    for (int k = 0; k < kSHC; ++k) {
      const float g0 = Gs[r0 * kSHC + k], g1 = Gs[(r0 + 1) * kSHC + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float wv = ssmv::to_f32(Wb[k * (D + 1) + lane + 32 * j]);
        yacc[0][j] = fmaf(g0, wv, yacc[0][j]);
        yacc[1][j] = fmaf(g1, wv, yacc[1][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = lane + 32 * j;
      y[(size_t)(row0 + r0 + i) * D + c] =
          ssmv::from_f32<T>(yacc[i][j] + b2e[c]);
    }
}

template <typename T, int D, bool kGather, bool kPerm>
cudaError_t launch_simt(const void* xs, const void* gather_idx,
                        const void* tile_perm, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* e_of_tile,
                        void* y, int Tp, int H, int tile_rows,
                        cudaStream_t stream) {
  const size_t smem = simt_fwd_smem<T>(D);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  auto kernel = expert_ffn_fwd_simt<T, D, kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / kSRows, kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(e_of_tile),
      static_cast<T*>(y), H, tile_rows);
  return cudaGetLastError();
}

template <bool kGather, bool kPerm>
int dispatch(const void* xs, const void* gather_idx, const void* tile_perm,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* e_of_tile, void* y, int Tp, int D, int H,
             int tile_rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < kRows || Tp % kRows || H < kHC || H % kHC || tile_rows % kRows ||
      (kPerm && Tp % tile_rows))
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && D == 384)
    return (int)launch<384, kGather, kPerm>(xs, gather_idx, tile_perm, w1,
                                            b1, w2, b2, e_of_tile, y, Tp, H,
                                            tile_rows, s);
  if (is_bf16 && D == 192)
    return (int)launch<192, kGather, kPerm>(xs, gather_idx, tile_perm, w1,
                                            b1, w2, b2, e_of_tile, y, Tp, H,
                                            tile_rows, s);
#define SSMV_SIMT_FWD(TT, DD)                                              \
  if (D == DD)                                                             \
    return (int)launch_simt<TT, DD, kGather, kPerm>(                       \
        xs, gather_idx, tile_perm, w1, b1, w2, b2, e_of_tile, y, Tp, H,    \
        tile_rows, s);
  if (is_bf16) {
    SSMV_SIMT_FWD(bf16, 768)
  } else {
    SSMV_SIMT_FWD(float, 192)
    SSMV_SIMT_FWD(float, 384)
    SSMV_SIMT_FWD(float, 768)
  }
#undef SSMV_SIMT_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: xs (Tp, D), w1 (E, D, H), w2 (E, H, D) of one activation dtype, bf16
// (is_bf16 = 1) or f32 (is_bf16 = 0); b1 (E, H) f32, b2 (E, D) f32,
// e_of_tile (Tp / tile_rows,) int32 -> y (Tp, D) in the activation dtype;
// all contiguous and 16-byte aligned. D is 192, 384 or 768 (bf16 at 192 and
// 384 on the tensor cores, the rest in the SIMT form); H a multiple of 64;
// tile_rows and Tp multiples of 64.
extern "C" int ssmv_expert_ffn_fwd(const void* xs, const void* w1,
                                   const void* b1, const void* w2,
                                   const void* b2, const void* e_of_tile,
                                   void* y, int Tp, int D, int H,
                                   int tile_rows, int is_bf16, void* stream) {
  return dispatch<false, false>(xs, nullptr, nullptr, w1, b1, w2, b2,
                                e_of_tile, y, Tp, D, H, tile_rows, is_bf16,
                                stream);
}

// K9 forward: x (T, D) tokens and gather_idx (Tp,) int64, each in [0, T);
// the rest as K3. Layout row s computes from x[gather_idx[s]].
extern "C" int ssmv_expert_ffn_fwd_gather(const void* x, const void* gather_idx,
                                          const void* w1, const void* b1,
                                          const void* w2, const void* b2,
                                          const void* e_of_tile, void* y,
                                          int Tp, int D, int H, int tile_rows,
                                          int is_bf16, void* stream) {
  return dispatch<true, false>(x, gather_idx, nullptr, w1, b1, w2, b2,
                               e_of_tile, y, Tp, D, H, tile_rows, is_bf16,
                               stream);
}

// K10 forward: tile_perm (Tp / tile_rows,) int32, a permutation of the row
// tiles; e_of_step (Tp / tile_rows,) int32, the expert of the tile visited
// at step i; the rest as K3. Step i computes row tile tile_perm[i] of y
// from the same tile of xs with the expert e_of_step[i].
extern "C" int ssmv_expert_ffn_fwd_perm(const void* xs, const void* w1,
                                        const void* b1, const void* w2,
                                        const void* b2, const void* e_of_step,
                                        const void* tile_perm, void* y,
                                        int Tp, int D, int H, int tile_rows,
                                        int is_bf16, void* stream) {
  return dispatch<false, true>(xs, nullptr, tile_perm, w1, b1, w2, b2,
                               e_of_step, y, Tp, D, H, tile_rows, is_bf16,
                               stream);
}
