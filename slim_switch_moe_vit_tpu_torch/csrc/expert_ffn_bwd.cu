// Per-expert FFN backward over the tile-aligned expert layout (K4), its
// gather-in-kernel form (K9 backward) and its permuted-tile form (K10
// backward).
//
// K4 replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _bwd_kernel (:261) with _tile_dx (:237), reached through _bwd (:374) and
// _ffn_bwd (:834). K9's backward replaces _bwd_gather_kernel (:658), reached
// through _bwd_gather (:693) and fused_expert_ffn_gather's VJP (:801): the
// same function with x re-read by index, x[gather_idx[s]] for layout row s
// (kGather in both kernels below), and dx returned in layout (slot) space;
// the token-space dx, k row gathers masked by keep, is glue in Python, as
// it is outside the TPU kernel. The TPU wrapper promotes this backward to
// 512-row tiles when every pair of tiles shares an expert (:783-790), a
// TPU tiling policy that is not ported: both forms run 256-row tiles.
//
// K10's backward replaces the tile_perm branch of _bwd (:374, :408-431,
// :478-499), reached through fused_expert_ffn_permuted's VJP (:894): grid
// step i visits row tile tile_perm[i] of xs and dy and writes dx to the
// same tile, so dx keeps xs's row order; e_of_tile is indexed by step and
// nondecreasing (kPerm in both kernels below). The dgrad kernel writes the
// workspace and the dh partials in step order, so the wgrad kernel still
// finds an expert's rows as one contiguous range of steps and sums its dW
// over that expert's steps; only its x and dy row loads go through
// tile_perm. The TPU kernel refuses the deferred-dW and 512-row forms with
// a permutation (:408-412); so does this port (K8 takes no permutation).
//
// Rows of xs are sorted by expert and every 256-row layout tile belongs to
// one expert, e = e_of_tile[tile] (nondecreasing). For the
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
//  (a) dgrad (expert_ffn_dgrad.cuh): one block per 64-row block of xs (a
//      quarter of a layout tile),
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
//
// f32 at every D, and bf16 at D = 768, take the SIMT forms of both kernels
// (expert_ffn_dgrad.cuh's SIMT dgrad, 16 rows a block, and the SIMT wgrad
// below): the same math with f32 FMAs, T in place of bf16.
#include "expert_ffn_dgrad.cuh"

namespace {

using namespace ssmv_ffn;

constexpr int kWT = 64;        // wgrad output tile edge and row step
constexpr int kWLD = kWT + kBPad;

// Grid (jobs, E). Jobs in order: the (D/64) x (H/64) tiles of dW1[e], the
// (H/64) x (D/64) tiles of dW2[e], the H/64 column blocks of db1[e], the
// D/64 column blocks of db2[e].
// kGather: the dW1 jobs read x row gather_idx[r] for layout row r (K9).
// kPerm: layout rows r are in step order; x and dy are read at r's row in
// tile tile_perm[r / tile_rows] (K10); the workspace stays in step order.
template <bool kGather, bool kPerm>
__global__ void __launch_bounds__(kThreads)
expert_ffn_wgrad_kernel(const bf16* __restrict__ xs,
                        const long long* __restrict__ gather_idx,
                        const int* __restrict__ tile_perm,
                        const bf16* __restrict__ dy,
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
  // this expert's tiles (steps, with kPerm): e_of_tile is nondecreasing,
  // so they are the [#tiles with e_of_tile < e, + #tiles with
  // e_of_tile == e) range
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
      // x (dW1's A) and dy (dW2's B) in xs's row order; the workspace in
      // step order
      const size_t prow =
          (size_t)permuted_row<kPerm>(tile_perm, r0, tile_rows);
      for (int i = tid; i < kWT * V8; i += kThreads) {
        const int r = i / V8, v = i % V8;
        const size_t ar = (kGather && is_w1) ? (size_t)gather_idx[r0 + r]
                          : is_w1            ? prow + r
                                             : (size_t)(r0 + r);
        const size_t br = is_w1 ? (size_t)(r0 + r) : prow + r;
        *reinterpret_cast<uint4*>(As + r * kWLD + v * 8) =
            *reinterpret_cast<const uint4*>(A + ar * lda + a0 + v * 8);
        *reinterpret_cast<uint4*>(Bs + r * kWLD + v * 8) =
            *reinterpret_cast<const uint4*>(Bsrc + br * ldb + b0 + v * 8);
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
      s += __bfloat162float(
          dy[(size_t)permuted_row<kPerm>(tile_perm, r, tile_rows) * D + col]);
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

template <int D, bool kGather, bool kPerm>
cudaError_t launch(const void* xs, const void* gather_idx,
                   const void* tile_perm, const void* dy, const void* w1,
                   const void* b1, const void* w2, const void* e_of_tile,
                   void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                   void* ws_dh, void* ws_g, void* ws_db1, int Tp, int H, int E,
                   int tile_rows, cudaStream_t stream) {
  cudaError_t err = launch_dgrad<D, kGather, true, kPerm>(
      xs, gather_idx, dy, w1, b1, w2, e_of_tile, dxs, ws_dh, ws_g, ws_db1, Tp,
      H, tile_rows, stream, tile_perm);
  if (err != cudaSuccess) return err;
  const int jobs = 2 * (D / kWT) * (H / kWT) + H / kWT + D / kWT;
  expert_ffn_wgrad_kernel<kGather, kPerm>
      <<<dim3(jobs, E), kThreads, 0, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(ws_dh), static_cast<const bf16*>(ws_g),
      static_cast<const float*>(ws_db1), static_cast<const int*>(e_of_tile),
      Tp / tile_rows, tile_rows, static_cast<bf16*>(dw1),
      static_cast<float*>(db1), static_cast<bf16*>(dw2),
      static_cast<float*>(db2), D, H);
  return cudaGetLastError();
}

// The SIMT wgrad, beside the SIMT dgrad (f32 at every D, bf16 at D = 768):
// the same jobs and expert walk as the WMMA wgrad, each block a 64 x 64
// tile of dW1 or dW2 (4 x 4 outputs a thread, f32 FMAs over 32-row steps),
// or 64 columns of db1 (from the SIMT dgrad's (Tp / 16, H) partials) or of
// db2. Outputs in T (dW) and f32 (db).
constexpr int kSStep = 32;  // rows per step of the SIMT wgrad

template <typename T, bool kGather, bool kPerm>
__global__ void __launch_bounds__(kThreads)
expert_ffn_wgrad_simt(const T* __restrict__ xs,
                      const long long* __restrict__ gather_idx,
                      const int* __restrict__ tile_perm,
                      const T* __restrict__ dy, const T* __restrict__ ws_dh,
                      const T* __restrict__ ws_g,
                      const float* __restrict__ db1_part,
                      const int* __restrict__ e_of_tile, int n_tiles,
                      int tile_rows, T* __restrict__ dw1,
                      float* __restrict__ db1, T* __restrict__ dw2,
                      float* __restrict__ db2, int D, int H) {
  __shared__ __align__(16) float As[kSStep * kWT];
  __shared__ __align__(16) float Bs[kSStep * kWT];
  __shared__ float red[kThreads];

  const int e = blockIdx.y, job = blockIdx.x;
  const int tid = threadIdx.x;
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
    const bool is_w1 = job < DT * HT;
    const int jj = is_w1 ? job : job - DT * HT;
    const T *A, *Bsrc;
    int lda, ldb, a0, b0, ldo;
    T* out;
    if (is_w1) {  // dW1[e] (D, H) = x^T . T(dh)
      a0 = (jj / HT) * kWT, b0 = (jj % HT) * kWT;
      A = xs, lda = D, Bsrc = ws_dh, ldb = H;
      out = dw1 + (size_t)e * D * H, ldo = H;
    } else {      // dW2[e] (H, D) = T(g)^T . dy
      a0 = (jj / DT) * kWT, b0 = (jj % DT) * kWT;
      A = ws_g, lda = H, Bsrc = dy, ldb = D;
      out = dw2 + (size_t)e * H * D, ldo = D;
    }
    const int ti = (tid >> 4) * 4, tj = (tid & 15) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int r0 = r_begin; r0 < r_end; r0 += kSStep) {
      __syncthreads();
      for (int i = tid; i < kSStep * kWT; i += kThreads) {
        const int r = i / kWT, c = i % kWT;
        const size_t prow =
            (size_t)permuted_row<kPerm>(tile_perm, r0 + r, tile_rows);
        const size_t ar = (kGather && is_w1) ? (size_t)gather_idx[r0 + r]
                          : is_w1            ? prow
                                             : (size_t)(r0 + r);
        const size_t br = is_w1 ? (size_t)(r0 + r) : prow;
        As[i] = ssmv::to_f32(A[ar * lda + a0 + c]);
        Bs[i] = ssmv::to_f32(Bsrc[br * ldb + b0 + c]);
      }
      __syncthreads();
      for (int r = 0; r < kSStep; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(As + r * kWT + ti);
        const float4 b = *reinterpret_cast<const float4*>(Bs + r * kWT + tj);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        out[(size_t)(a0 + ti + i) * ldo + b0 + tj + j] =
            ssmv::from_f32<T>(acc[i][j]);
    return;
  }

  const int c = tid % kWT, grp = tid / kWT;
  const int jb = job - 2 * DT * HT;
  float s = 0.f;
  if (jb < HT) {  // db1[e] from the SIMT dgrad's per-16-row-block sums
    const int col = jb * kWT + c;
    for (int blk = r_begin / kSRows + grp; blk < r_end / kSRows; blk += 4)
      s += db1_part[(size_t)blk * H + col];
  } else {        // db2[e] = sum of dy over the expert's rows
    const int col = (jb - HT) * kWT + c;
    for (int r = r_begin + grp; r < r_end; r += 4)
      s += ssmv::to_f32(
          dy[(size_t)permuted_row<kPerm>(tile_perm, r, tile_rows) * D + col]);
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

template <typename T, int D, bool kGather, bool kPerm>
cudaError_t launch_simt(const void* xs, const void* gather_idx,
                        const void* tile_perm, const void* dy, const void* w1,
                        const void* b1, const void* w2, const void* e_of_tile,
                        void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                        void* ws_dh, void* ws_g, void* ws_db1, int Tp, int H,
                        int E, int tile_rows, cudaStream_t stream) {
  cudaError_t err = launch_dgrad_simt<T, D, kGather, true, kPerm>(
      xs, gather_idx, dy, w1, b1, w2, e_of_tile, dxs, ws_dh, ws_g, ws_db1, Tp,
      H, tile_rows, stream, tile_perm);
  if (err != cudaSuccess) return err;
  const int jobs = 2 * (D / kWT) * (H / kWT) + H / kWT + D / kWT;
  expert_ffn_wgrad_simt<T, kGather, kPerm>
      <<<dim3(jobs, E), kThreads, 0, stream>>>(
      static_cast<const T*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const T*>(dy),
      static_cast<const T*>(ws_dh), static_cast<const T*>(ws_g),
      static_cast<const float*>(ws_db1), static_cast<const int*>(e_of_tile),
      Tp / tile_rows, tile_rows, static_cast<T*>(dw1),
      static_cast<float*>(db1), static_cast<T*>(dw2),
      static_cast<float*>(db2), D, H);
  return cudaGetLastError();
}

template <bool kGather, bool kPerm>
int dispatch(const void* xs, const void* gather_idx, const void* tile_perm,
             const void* dy, const void* w1, const void* b1, const void* w2,
             const void* e_of_tile, void* dxs, void* dw1, void* db1, void* dw2,
             void* db2, void* ws_dh, void* ws_g, void* ws_db1, int Tp, int D,
             int H, int E, int tile_rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < kRows || Tp % kRows || H < kWT || H % kWT || tile_rows % kRows ||
      Tp % tile_rows || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && D == 384)
    return (int)launch<384, kGather, kPerm>(
        xs, gather_idx, tile_perm, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1,
        dw2, db2, ws_dh, ws_g, ws_db1, Tp, H, E, tile_rows, s);
  if (is_bf16 && D == 192)
    return (int)launch<192, kGather, kPerm>(
        xs, gather_idx, tile_perm, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1,
        dw2, db2, ws_dh, ws_g, ws_db1, Tp, H, E, tile_rows, s);
#define SSMV_SIMT_BWD(TT, DD)                                                \
  if (D == DD)                                                               \
    return (int)launch_simt<TT, DD, kGather, kPerm>(                         \
        xs, gather_idx, tile_perm, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1, \
        dw2, db2, ws_dh, ws_g, ws_db1, Tp, H, E, tile_rows, s);
  if (is_bf16) {
    SSMV_SIMT_BWD(bf16, 768)
  } else {
    SSMV_SIMT_BWD(float, 192)
    SSMV_SIMT_BWD(float, 384)
    SSMV_SIMT_BWD(float, 768)
  }
#undef SSMV_SIMT_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K4: xs, dy (Tp, D); w1 (E, D, H), b1 (E, H) f32, w2 (E, H, D); e_of_tile
// (Tp / tile_rows,) int32, nondecreasing -> dxs (Tp, D), dw1 (E, D, H), db1
// (E, H) f32, dw2 (E, H, D), db2 (E, D) f32; xs, dy, w1, w2, dxs, dw1, dw2
// of one activation dtype, bf16 (is_bf16 = 1) or f32. Workspace from the
// caller: ws_dh, ws_g (Tp, H) in the activation dtype and ws_db1
// (Tp / 16, H) f32. All contiguous and 16-byte aligned; D is 192, 384 or
// 768 (bf16 at 192 and 384 on the tensor cores, the rest in the SIMT
// form), H a multiple of 64, tile_rows and Tp multiples of 64.
extern "C" int ssmv_expert_ffn_bwd(const void* xs, const void* dy,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* e_of_tile,
                                   void* dxs, void* dw1, void* db1, void* dw2,
                                   void* db2, void* ws_dh, void* ws_g,
                                   void* ws_db1, int Tp, int D, int H, int E,
                                   int tile_rows, int is_bf16, void* stream) {
  return dispatch<false, false>(xs, nullptr, nullptr, dy, w1, b1, w2,
                                e_of_tile, dxs, dw1, db1, dw2, db2, ws_dh,
                                ws_g, ws_db1, Tp, D, H, E, tile_rows, is_bf16,
                                stream);
}

// K9 backward: x (T, D) bf16 tokens and gather_idx (Tp,) int64, each in
// [0, T); dy and the returned dxs in layout (slot) space, (Tp, D); the rest
// as K4. Layout row s reads x row gather_idx[s].
extern "C" int ssmv_expert_ffn_bwd_gather(
    const void* x, const void* gather_idx, const void* dy, const void* w1,
    const void* b1, const void* w2, const void* e_of_tile, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_g,
    void* ws_db1, int Tp, int D, int H, int E, int tile_rows, int is_bf16,
    void* stream) {
  return dispatch<true, false>(x, gather_idx, nullptr, dy, w1, b1, w2,
                               e_of_tile, dxs, dw1, db1, dw2, db2, ws_dh,
                               ws_g, ws_db1, Tp, D, H, E, tile_rows, is_bf16,
                               stream);
}

// K10 backward: tile_perm (Tp / tile_rows,) int32, a permutation of the row
// tiles, and e_of_step (Tp / tile_rows,) int32, the nondecreasing expert of
// the tile visited at step i; xs, dy and the returned dxs in xs's own row
// order; the workspace in step order; the rest as K4.
extern "C" int ssmv_expert_ffn_bwd_perm(
    const void* xs, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* e_of_step, const void* tile_perm, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_g,
    void* ws_db1, int Tp, int D, int H, int E, int tile_rows, int is_bf16,
    void* stream) {
  return dispatch<false, true>(xs, nullptr, tile_perm, dy, w1, b1, w2,
                               e_of_step, dxs, dw1, db1, dw2, db2, ws_dh,
                               ws_g, ws_db1, Tp, D, H, E, tile_rows, is_bf16,
                               stream);
}
