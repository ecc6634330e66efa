// Per-expert FFN backward over the tile-aligned expert layout (K4).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _bwd_kernel (:261) with _tile_dx (:237), reached through _bwd (:374) and
// _ffn_bwd (:834). Rows of xs are sorted by expert and every 256-row layout
// tile belongs to one expert, e = e_of_tile[tile] (nondecreasing). For the
// forward y = GELU(x . W1[e] + b1[e]) . W2[e] + b2[e] and its cotangent dy:
//   h   = x . W1[e] + b1[e]                   (f32 sums, recomputed)
//   dh  = (dy . W2[e]^T) * gelu'(h)           (f32; exact erf derivative)
//   dx  = bf16(dh) . W1[e]^T                  (rounded once to bf16)
//   dW1[e] = sum over e's rows of x^T . bf16(dh)
//   dW2[e] = sum over e's rows of bf16(gelu(h))^T . dy   (f32 sums, bf16 out)
//   db1[e] = sum of the f32 dh,  db2[e] = sum of dy      (f32)
// The JAX kernel splits H in two halves and sums the two bf16 dx partials
// in bf16 (fused_ffn.py:497); this kernel sums over all of H in f32 and
// rounds once, so dx may differ from the JAX package's by one bf16 ulp.
// GELU and its derivative are the exact erf forms at every dtype (the JAX
// package's bf16 polynomials are a TPU policy that is not ported).
//
// What bounds it on the H100: the FLOPs. The three dgrad products (h
// recomputed, dy . W2^T, dh . W1^T) and the two wgrad products make
// 5 x 2 x D x H flops a row: 309.5 GFLOP at ViT-S, B = 128 (Tp = 52,480),
// 0.313 ms at the 989 TFLOP/s bf16 peak. All five run on the tensor cores
// through WMMA bf16 16x16x16 fragments with f32 accumulation.
//
// Design, two kernels on the caller's stream:
//  (a) dgrad: one block per 64-row block of xs (a quarter of a layout tile),
//      as the forward kernel: x and dy of the block stay in shared memory,
//      H is streamed in 32-wide chunks of W1 / W2, and each chunk's h and
//      dy . W2^T stay on chip; dx accumulates in registers over the chunks.
//      Each chunk writes bf16(dh) and bf16(gelu(h)) to a (Tp, H) workspace
//      each, for the wgrad kernel, and the block's f32 column sums of dh to
//      a (Tp / 64, H) partials table.
//  (b) wgrad: one block per (64 x 64 tile of dW1 or dW2 or 64 columns of db1
//      or db2, expert). The block finds its expert's tile range from
//      e_of_tile on the device (no host sync) and loops over the expert's
//      rows in 64-row steps, accumulating in f32, then writes its tile once.
//      An expert with no tokens owns one all-padding tile whose dy is zero,
//      and an expert owning nothing would sum over no rows: either way its
//      dW and db are written, as exact zeros, never left uninitialized.
// The workspace traffic (2 x Tp x H bf16, written once and read about
// 6-24 times from L2) and the synchronous loads keep this first version
// well below the tensor-core peak; keeping dh on chip is later work.
#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;      // rows per dgrad block
constexpr int kHC = 32;        // hidden chunk
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBPad = 8;
constexpr int kFPad = 4;
constexpr int kWT = 64;        // wgrad output tile edge and row step
constexpr int kWLD = kWT + kBPad;

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
  static constexpr size_t Red = Gs + sizeof(bf16) * kRows * GLD;
  static constexpr size_t bytes = Red + sizeof(float) * kWarps * kHC;
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dgrad_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy,
                        const bf16* __restrict__ w1, const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const int* __restrict__ e_of_tile,
                        bf16* __restrict__ dxs, bf16* __restrict__ ws_dh,
                        bf16* __restrict__ ws_g, float* __restrict__ db1_part,
                        int H, int tile_rows) {
  using L = DgradSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X);
  bf16* DYs = reinterpret_cast<bf16*>(smem + L::DY);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* Hs = reinterpret_cast<float*>(smem + L::Hs);
  float* Ps = reinterpret_cast<float*>(smem + L::Ps);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::Gs);
  float* Red = reinterpret_cast<float*>(smem + L::Red);
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

    // dh = p * gelu'(h + b1), g = gelu(h + b1); thread (warp, lane) takes
    // column lane of rows warp, warp + 8, ... and sums its f32 dh
    float dsum = 0.f;
    const float bias = b1e[c0 + lane];
    for (int r = warp; r < kRows; r += kWarps) {
      float g, dg;
      gelu_pair(Hs[r * L::HLD + lane] + bias, &g, &dg);
      const float dh = Ps[r * L::HLD + lane] * dg;
      dsum += dh;
      const bf16 dhb = __float2bfloat16(dh);
      Gs[r * L::GLD + lane] = dhb;
      const size_t o = (size_t)(row0 + r) * H + c0 + lane;
      ws_dh[o] = dhb;
      ws_g[o] = __float2bfloat16(g);
    }
    Red[warp * kHC + lane] = dsum;
    __syncthreads();
    if (warp == 0) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += Red[w * kHC + lane];
      db1_part[(size_t)blockIdx.x * H + c0 + lane] = s;
    }

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

// Grid (jobs, E). Jobs in order: the (D/64) x (H/64) tiles of dW1[e], the
// (H/64) x (D/64) tiles of dW2[e], the H/64 column blocks of db1[e], the
// D/64 column blocks of db2[e].
__global__ void __launch_bounds__(kThreads)
expert_ffn_wgrad_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy,
                        const bf16* __restrict__ ws_dh,
                        const bf16* __restrict__ ws_g,
                        const float* __restrict__ db1_part,
                        const int* __restrict__ e_of_tile, int n_tiles,
                        int tile_rows, bf16* __restrict__ dw1,
                        float* __restrict__ db1, bf16* __restrict__ dw2,
                        float* __restrict__ db2, int D, int H) {
  __shared__ __align__(128) bf16 As[kWT * kWLD];
  __shared__ __align__(128) bf16 Bs[kWT * kWLD];
  __shared__ __align__(128) float stage[kWarps * 256];
  __shared__ float red[kThreads];

  const int e = blockIdx.y, job = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5;
  // this expert's tiles: e_of_tile is nondecreasing, so they are the
  // [#tiles with e_of_tile < e, + #tiles with e_of_tile == e) range
  int first = 0, count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }
  const int r_begin = first * tile_rows, r_end = (first + count) * tile_rows;
  const int DT = D / kWT, HT = H / kWT;

  if (job < 2 * DT * HT) {
    // out[i, j] = sum over the rows r of A[r, a0 + i] * B[r, b0 + j]
    const bool is_w1 = job < DT * HT;
    const int jj = is_w1 ? job : job - DT * HT;
    const bf16 *A, *Bsrc;
    int lda, ldb, a0, b0, ldo;
    bf16* out;
    if (is_w1) {  // dW1[e] (D, H) = x^T . bf16(dh)
      a0 = (jj / HT) * kWT, b0 = (jj % HT) * kWT;
      A = xs, lda = D, Bsrc = ws_dh, ldb = H;
      out = dw1 + (size_t)e * D * H, ldo = H;
    } else {      // dW2[e] (H, D) = bf16(g)^T . dy
      a0 = (jj / DT) * kWT, b0 = (jj % DT) * kWT;
      A = ws_g, lda = H, Bsrc = dy, ldb = D;
      out = dw2 + (size_t)e * H * D, ldo = D;
    }
    const int ti = warp >> 1, tj0 = (warp & 1) * 2;  // 4 x 4 tiles, 2 a warp
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    constexpr int V8 = kWT / 8;
    for (int r0 = r_begin; r0 < r_end; r0 += kWT) {
      __syncthreads();
      for (int i = tid; i < kWT * V8; i += kThreads) {
        const int r = i / V8, v = i % V8;
        *reinterpret_cast<uint4*>(As + r * kWLD + v * 8) =
            *reinterpret_cast<const uint4*>(A + (size_t)(r0 + r) * lda + a0 + v * 8);
        *reinterpret_cast<uint4*>(Bs + r * kWLD + v * 8) =
            *reinterpret_cast<const uint4*>(Bsrc + (size_t)(r0 + r) * ldb + b0 + v * 8);
      }
      __syncthreads();
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
      for (int kk = 0; kk < kWT; kk += 16) {
        wmma::load_matrix_sync(a, As + kk * kWLD + ti * 16, kWLD);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::load_matrix_sync(bm, Bs + kk * kWLD + (tj0 + j) * 16, kWLD);
          wmma::mma_sync(acc[j], a, bm, acc[j]);
        }
      }
    }
    float* stg = stage + warp * 256;
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ssmv::store_frag_bf16(acc[j], stg, out + (size_t)a0 * ldo + b0 + (tj0 + j) * 16,
                            ldo, ti * 16, kWT);
    return;
  }

  // column sums: thread (g, c) sums rows g, g + 4, ... of column c, then
  // thread c adds the four in order (deterministic)
  const int c = tid % kWT, grp = tid / kWT;
  const int jb = job - 2 * DT * HT;
  float s = 0.f;
  if (jb < HT) {  // db1[e] from the dgrad kernel's per-64-row-block sums
    const int col = jb * kWT + c;
    for (int blk = r_begin / kRows + grp; blk < r_end / kRows; blk += 4)
      s += db1_part[(size_t)blk * H + col];
  } else {        // db2[e] = sum of dy over the expert's rows
    const int col = (jb - HT) * kWT + c;
    for (int r = r_begin + grp; r < r_end; r += 4)
      s += __bfloat162float(dy[(size_t)r * D + col]);
  }
  red[tid] = s;
  __syncthreads();
  if (tid < kWT) {
    const float total = red[c] + red[kWT + c] + red[2 * kWT + c] + red[3 * kWT + c];
    if (jb < HT)
      db1[(size_t)e * H + jb * kWT + c] = total;
    else
      db2[(size_t)e * D + (jb - HT) * kWT + c] = total;
  }
}

template <int D>
cudaError_t launch(const void* xs, const void* dy, const void* w1,
                   const void* b1, const void* w2, const void* e_of_tile,
                   void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                   void* ws_dh, void* ws_g, void* ws_db1, int Tp, int H, int E,
                   int tile_rows, cudaStream_t stream) {
  const size_t smem = DgradSmem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      expert_ffn_dgrad_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  expert_ffn_dgrad_kernel<D><<<Tp / kRows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<bf16*>(dxs), static_cast<bf16*>(ws_dh),
      static_cast<bf16*>(ws_g), static_cast<float*>(ws_db1), H, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int jobs = 2 * (D / kWT) * (H / kWT) + H / kWT + D / kWT;
  expert_ffn_wgrad_kernel<<<dim3(jobs, E), kThreads, 0, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(ws_dh), static_cast<const bf16*>(ws_g),
      static_cast<const float*>(ws_db1), static_cast<const int*>(e_of_tile),
      Tp / tile_rows, tile_rows, static_cast<bf16*>(dw1),
      static_cast<float*>(db1), static_cast<bf16*>(dw2),
      static_cast<float*>(db2), D, H);
  return cudaGetLastError();
}

}  // namespace

// xs, dy (Tp, D) bf16; w1 (E, D, H) bf16, b1 (E, H) f32, w2 (E, H, D) bf16;
// e_of_tile (Tp / tile_rows,) int32, nondecreasing -> dxs (Tp, D) bf16,
// dw1 (E, D, H) bf16, db1 (E, H) f32, dw2 (E, H, D) bf16, db2 (E, D) f32.
// Workspace from the caller: ws_dh, ws_g (Tp, H) bf16 and ws_db1
// (Tp / 64, H) f32. All contiguous and 16-byte aligned; D is 192 or 384, H
// a multiple of 64, tile_rows and Tp multiples of 64.
extern "C" int ssmv_expert_ffn_bwd(const void* xs, const void* dy,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* e_of_tile,
                                   void* dxs, void* dw1, void* db1, void* dw2,
                                   void* db2, void* ws_dh, void* ws_g,
                                   void* ws_db1, int Tp, int D, int H, int E,
                                   int tile_rows, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < kRows || Tp % kRows || H < kWT || H % kWT || tile_rows % kRows ||
      Tp % tile_rows || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (D == 384)
    return (int)launch<384>(xs, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1, dw2,
                            db2, ws_dh, ws_g, ws_db1, Tp, H, E, tile_rows, s);
  if (D == 192)
    return (int)launch<192>(xs, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1, dw2,
                            db2, ws_dh, ws_g, ws_db1, Tp, H, E, tile_rows, s);
  return (int)cudaErrorInvalidValue;
}
