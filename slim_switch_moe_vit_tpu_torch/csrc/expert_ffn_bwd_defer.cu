// Per-expert FFN backward with the dW products deferred over pairs of
// same-expert tiles (K8).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _bwd_kernel_defer (:312) with its flags _bwd_flags (:285), reached
// through _bwd(defer_dw=True) (:374, call :467) from _ffn_bwd (:834) when
// SSMV_DEFER_DW=1. It computes K4's function (expert_ffn_bwd.cu has the
// math): dx, dW1, db1, dW2, db2 of y = GELU(x . W1[e] + b1[e]) . W2[e] +
// b2[e] over the tile-aligned expert layout. What makes it K8: the dW
// products are taken over pairs of consecutive same-expert 256-row tiles
// (K = 512 rows), as the flags direct, from x, dh, g = GELU(h) and dy held
// on chip; K4 instead writes dh and g to a (Tp, H) workspace in device
// memory and reads them back.
//
// The flags, one int32 per tile, computed by the wrapper on the device from
// the nondecreasing e_of_tile exactly as _bwd_flags does:
//   bit 0 (flush):   issue the dW products at this tile (the 2nd tile of a
//                    pair, or the expert's last tile)
//   bit 1 (include): the previous tile, of the same expert, is the pair's
//                    first half: the products run over both (K = 512)
//   bit 2 (first):   the expert's first flush, where the TPU kernel
//                    initializes its VMEM dW window. Here the accumulators
//                    are registers zeroed when the block starts, the same
//                    point of the walk, so this kernel reads bits 0 and 1.
//
// What bounds it on the H100: the FLOPs, as K4 (10 x D x H flops a row at
// the least). Translated for the card:
//  - The TPU grid runs tiles in order on one core and carries the pair in
//    VMEM scratch from one step to the next. Blocks on the card run in no
//    order, and a block cannot hold both a row block's dx (all of H) and a
//    hidden chunk's dW (all of an expert's rows). So K8 is two kernels: the
//    WMMA dgrad of expert_ffn_dgrad.cuh (dx only, no workspace), and the
//    deferred-dW kernel below, one block per (32-column
//    hidden chunk, expert), which walks its expert's tiles in order as the
//    TPU grid does and follows the flags: at each flush it recomputes h and
//    dh of the pair's 512 (or the single tile's 256) rows, 64 rows at a
//    time, from x and dy in shared memory, and adds x^T . bf16(dh) and
//    bf16(g)^T . dy into its dW1[:, chunk] and dW2[chunk, :] accumulators in
//    registers (WMMA bf16, f32 sums). Recomputing h and dy . W2^T costs two
//    more products per row than K4 (7 instead of 5) and saves the
//    workspace's write and reads.
//  - Single-tile flush (an odd tile count, or a one-tile expert): the TPU
//    kernel zeroes the stale half of its scratch pair, since garbage times
//    a zero cotangent is still NaN. Here a flush loops over its own rows
//    only, so no stale shared memory is ever read.
//  - An expert with no tokens owns one all-padding tile (dy zero): its dW
//    and db are written as exact zeros; an expert owning no tile at all is
//    written as zeros too, never left uninitialized.
//  - The sums over an expert's rows run in one block, in row order: no
//    atomics, the same result on every run.
// db1 is the column sum of the f32 dh, db2 of dy, both in f32, in the same
// walk: the chunk's block takes db1[e, chunk], the first D / 32 blocks of
// each expert db2[e, 32 columns each].
//
// f32 at every D, and bf16 at D = 768, take the SIMT forms: the SIMT dgrad
// of expert_ffn_dgrad.cuh, then the SIMT deferred-dW kernel below.
#include "expert_ffn_dgrad.cuh"

namespace {

using namespace ssmv_ffn;

template <int D>
struct DeferSmem {
  static constexpr int XLD = D + kBPad;     // x, dy and W2-chunk rows (bf16)
  static constexpr int W1LD = kHC + kBPad;  // W1 chunk rows (bf16)
  static constexpr int HLD = kHC + kFPad;   // h and dy . W2^T rows (f32)
  static constexpr int GLD = kHC + kBPad;   // bf16(dh) and bf16(g) rows
  static constexpr size_t X = 0;
  static constexpr size_t DY = X + sizeof(bf16) * kRows * XLD;
  static constexpr size_t W1 = DY + sizeof(bf16) * kRows * XLD;
  static constexpr size_t W2 = W1 + sizeof(bf16) * D * W1LD;
  static constexpr size_t Hs = W2 + sizeof(bf16) * kHC * XLD;
  static constexpr size_t Ps = Hs + sizeof(float) * kRows * HLD;
  static constexpr size_t DH = Ps + sizeof(float) * kRows * HLD;
  static constexpr size_t G = DH + sizeof(bf16) * kRows * GLD;
  static constexpr size_t STG = G + sizeof(bf16) * kRows * GLD;
  static constexpr size_t RED = STG + sizeof(float) * kWarps * 256;
  static constexpr size_t bytes = RED + sizeof(float) * 2 * kWarps * kHC;
  static_assert(DY % 32 == 0 && W1 % 32 == 0 && W2 % 32 == 0 &&
                    Hs % 32 == 0 && Ps % 32 == 0 && DH % 32 == 0 &&
                    G % 32 == 0 && STG % 32 == 0,
                "WMMA needs 32-byte aligned tiles");
  static_assert(bytes <= ssmv::kMaxSmemBytes, "shared memory budget");
};

// Grid (H / kHC, E): block (c, e) owns dW1[e][:, c*32 : c*32+32],
// dW2[e][c*32 : c*32+32, :], db1[e][c*32 : ...] and, for c < D / 32,
// db2[e][c*32 : c*32+32].
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dw_defer_kernel(const bf16* __restrict__ xs,
                           const bf16* __restrict__ dy,
                           const bf16* __restrict__ w1,
                           const float* __restrict__ b1,
                           const bf16* __restrict__ w2,
                           const int* __restrict__ e_of_tile,
                           const int* __restrict__ flags, int n_tiles,
                           int tile_rows, bf16* __restrict__ dw1,
                           float* __restrict__ db1, bf16* __restrict__ dw2,
                           float* __restrict__ db2, int H) {
  using L = DeferSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X);
  bf16* DYs = reinterpret_cast<bf16*>(smem + L::DY);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* Hs = reinterpret_cast<float*>(smem + L::Hs);
  float* Ps = reinterpret_cast<float*>(smem + L::Ps);
  bf16* DHs = reinterpret_cast<bf16*>(smem + L::DH);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::G);
  float* stage = reinterpret_cast<float*>(smem + L::STG);
  float* red = reinterpret_cast<float*>(smem + L::RED);

  const int c0 = blockIdx.x * kHC, e = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_db2 = c0 < D;
  const bf16* w1e = w1 + (size_t)e * D * H;
  const bf16* w2e = w2 + (size_t)e * H * D;

  // this expert's tiles: e_of_tile is nondecreasing, so they are the
  // [#tiles with e_of_tile < e, + #tiles with e_of_tile == e) range
  int first = 0, count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }

  // the chunk's weights stay in shared memory for the whole walk
  constexpr int XV = D / 8;  // 16-byte vectors per row of D
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
  const float bias = b1[(size_t)e * H + c0 + lane];

  // dW1 chunk (D x 32) and dW2 chunk (32 x D): 2 * D / 16 tiles of 16 x 16
  // each, NT of them a warp; tile j of warp w is t = w + 8 j
  constexpr int NT = (2 * D / 16) / kWarps;
  static_assert((2 * D / 16) % kWarps == 0, "dW tiles per warp");
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc1[NT], acc2[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    wmma::fill_fragment(acc1[j], 0.f);
    wmma::fill_fragment(acc2[j], 0.f);
  }
  float db1_sum = 0.f, db2_sum = 0.f;  // column lane, rows warp + 8 i
  const int rs = warp & 3, ct = warp >> 2;  // h / p: 16-row strip, column tile

  for (int t = first; t < first + count; ++t) {
    const int f = flags[t];
    if (!(f & 1)) continue;  // deferred: this tile joins the next flush
    const int r_begin = (t - ((f & 2) ? 1 : 0)) * tile_rows;
    const int r_end = (t + 1) * tile_rows;
    for (int r0 = r_begin; r0 < r_end; r0 += kRows) {
      __syncthreads();  // the last step's readers of Xs, DYs, DHs, Gs are done
      for (int i = tid; i < kRows * XV; i += kThreads) {
        const int r = i / XV, v = i % XV;
        const size_t g = (size_t)(r0 + r) * D + v * 8;
        *reinterpret_cast<uint4*>(Xs + r * L::XLD + v * 8) =
            *reinterpret_cast<const uint4*>(xs + g);
        *reinterpret_cast<uint4*>(DYs + r * L::XLD + v * 8) =
            *reinterpret_cast<const uint4*>(dy + g);
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
          wmma::load_matrix_sync(bh, W1s + kk * L::W1LD + ct * 16, L::W1LD);
          wmma::mma_sync(hacc, a, bh, hacc);
          wmma::load_matrix_sync(a, DYs + rs * 16 * L::XLD + kk, L::XLD);
          wmma::load_matrix_sync(bp, W2s + ct * 16 * L::XLD + kk, L::XLD);
          wmma::mma_sync(pacc, a, bp, pacc);
        }
        wmma::store_matrix_sync(Hs + rs * 16 * L::HLD + ct * 16, hacc, L::HLD,
                                wmma::mem_row_major);
        wmma::store_matrix_sync(Ps + rs * 16 * L::HLD + ct * 16, pacc, L::HLD,
                                wmma::mem_row_major);
      }
      __syncthreads();

      // dh = p * gelu'(h + b1), g = gelu(h + b1), both rounded to bf16 for
      // the products; the f32 dh and dy summed for db1 and db2
      for (int r = warp; r < kRows; r += kWarps) {
        float g, dg;
        gelu_pair(Hs[r * L::HLD + lane] + bias, &g, &dg);
        const float dh = Ps[r * L::HLD + lane] * dg;
        db1_sum += dh;
        DHs[r * L::GLD + lane] = __float2bfloat16(dh);
        Gs[r * L::GLD + lane] = __float2bfloat16(g);
        if (has_db2) db2_sum += __bfloat162float(DYs[r * L::XLD + c0 + lane]);
      }
      __syncthreads();

      // dW1[:, chunk] += x^T . bf16(dh); dW2[chunk, :] += bf16(g)^T . dy
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
#pragma unroll
      for (int kk = 0; kk < kRows; kk += 16) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int tt = warp + kWarps * j;
          const int m1 = tt >> 1, n1 = tt & 1;  // dW1: (D / 16) x 2 tiles
          wmma::load_matrix_sync(a, Xs + kk * L::XLD + m1 * 16, L::XLD);
          wmma::load_matrix_sync(bm, DHs + kk * L::GLD + n1 * 16, L::GLD);
          wmma::mma_sync(acc1[j], a, bm, acc1[j]);
          const int m2 = tt / (D / 16), n2 = tt % (D / 16);  // dW2: 2 x D/16
          wmma::load_matrix_sync(a, Gs + kk * L::GLD + m2 * 16, L::GLD);
          wmma::load_matrix_sync(bm, DYs + kk * L::XLD + n2 * 16, L::XLD);
          wmma::mma_sync(acc2[j], a, bm, acc2[j]);
        }
      }
    }
  }

  float* stg = stage + warp * 256;
  bf16* dw1e = dw1 + (size_t)e * D * H;
  bf16* dw2e = dw2 + (size_t)e * H * D;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int tt = warp + kWarps * j;
    const int m1 = tt >> 1, n1 = tt & 1;
    ssmv::store_frag_bf16(acc1[j], stg, dw1e + c0 + n1 * 16, H, m1 * 16, D);
    const int m2 = tt / (D / 16), n2 = tt % (D / 16);
    ssmv::store_frag_bf16(acc2[j], stg, dw2e + (size_t)c0 * D + n2 * 16, D,
                          m2 * 16, kHC);
  }
  // db1 and db2: the eight warps' partials added in order (deterministic)
  red[warp * kHC + lane] = db1_sum;
  red[(kWarps + warp) * kHC + lane] = db2_sum;
  __syncthreads();
  if (warp == 0) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s1 += red[w * kHC + lane];
      s2 += red[(kWarps + w) * kHC + lane];
    }
    db1[(size_t)e * H + c0 + lane] = s1;
    if (has_db2) db2[(size_t)e * D + c0 + lane] = s2;
  }
}

// The SIMT deferred-dW kernel, beside the SIMT dgrad (f32 at every D,
// bf16 at D = 768): one block per (16-column hidden chunk, expert), the
// chunk's W1 (D x 17) and W2 (16 x D+1) columns on chip for the whole walk,
// the same flag-directed walk over the expert's tiles in 16-row steps
// (h and dy . W2^T recomputed, dh and g rounded to T), and dW1[:, chunk]
// and dW2[chunk, :] accumulated in registers (D / 8 a thread) with f32
// FMAs. db1 and, in the first D / 16 chunk blocks, db2 are summed per
// (row, column) thread over the walk, then over the 16 rows in order.
constexpr int kDHC = 16;  // hidden columns per SIMT deferred-dW block

template <typename T>
__host__ __device__ constexpr size_t simt_defer_smem(int d) {
  return sizeof(T) * ((size_t)d * (kDHC + 1) + (size_t)kDHC * (d + 1) +
                      2 * (size_t)kSRows * d + 8) +
         sizeof(float) * (2 * kSRows * kDHC + 2 * kSRows * kDHC);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
expert_ffn_dw_defer_simt(const T* __restrict__ xs, const T* __restrict__ dy,
                         const T* __restrict__ w1, const float* __restrict__ b1,
                         const T* __restrict__ w2,
                         const int* __restrict__ e_of_tile,
                         const int* __restrict__ flags, int n_tiles,
                         int tile_rows, T* __restrict__ dw1,
                         float* __restrict__ db1, T* __restrict__ dw2,
                         float* __restrict__ db2, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* DHs = reinterpret_cast<float*>(smem);  // kSRows x kDHC, T(dh)
  float* Gs = DHs + kSRows * kDHC;              // kSRows x kDHC, T(g)
  float* R1 = Gs + kSRows * kDHC;               // db1 partials
  float* R2 = R1 + kSRows * kDHC;               // db2 partials
  T* W1s = reinterpret_cast<T*>(R2 + kSRows * kDHC);  // D x (kDHC + 1)
  T* W2s = W1s + D * (kDHC + 1);                      // kDHC x (D + 1)
  T* Xs = W2s + kDHC * (D + 1);                       // kSRows x D
  T* DYs = Xs + kSRows * D;                           // kSRows x D

  const int c0 = blockIdx.x * kDHC, e = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool has_db2 = c0 < D;
  const T* w1e = w1 + (size_t)e * D * H;
  const T* w2e = w2 + (size_t)e * H * D;

  int first = 0, count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }
  for (int i = tid; i < D * kDHC; i += kThreads) {
    const int k = i / kDHC, c = i % kDHC;
    W1s[k * (kDHC + 1) + c] = w1e[(size_t)k * H + c0 + c];
  }
  for (int i = tid; i < kDHC * D; i += kThreads) {
    const int r = i / D, c = i % D;
    W2s[r * (D + 1) + c] = w2e[(size_t)(c0 + r) * D + c];
  }
  // h / p / db: thread (hr, hc) = (tid / 16, tid % 16)
  const int hr = tid / kDHC, hc = tid % kDHC;
  const float bias = b1[(size_t)e * H + c0 + hc];
  float db1_sum = 0.f, db2_sum = 0.f;
  // dW1[k][c] for k = lane + 32 j, c = 2 warp + q; dW2[c][k] likewise
  constexpr int NJ = D / 32;
  float acc1[NJ][2], acc2[2][NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) acc1[j][q] = acc2[q][j] = 0.f;
  const int cq = warp * 2;

  for (int t = first; t < first + count; ++t) {
    const int f = flags[t];
    if (!(f & 1)) continue;  // deferred: this tile joins the next flush
    const int r_begin = (t - ((f & 2) ? 1 : 0)) * tile_rows;
    const int r_end = (t + 1) * tile_rows;
    for (int r0 = r_begin; r0 < r_end; r0 += kSRows) {
      __syncthreads();  // the last step's readers are done (and W1s/W2s set)
      for (int i = tid; i < kSRows * D; i += kThreads) {
        const size_t g = (size_t)r0 * D + i;
        Xs[i] = xs[g];
        DYs[i] = dy[g];
      }
      __syncthreads();
      float h = 0.f, p = 0.f;
      for (int k = 0; k < D; ++k) {
        h = fmaf(ssmv::to_f32(Xs[hr * D + k]),
                 ssmv::to_f32(W1s[k * (kDHC + 1) + hc]), h);
        p = fmaf(ssmv::to_f32(DYs[hr * D + k]),
                 ssmv::to_f32(W2s[hc * (D + 1) + k]), p);
      }
      float g, dg;
      gelu_pair(h + bias, &g, &dg);
      const float dh = p * dg;
      db1_sum += dh;
      if (has_db2) db2_sum += ssmv::to_f32(DYs[hr * D + c0 + hc]);
      DHs[hr * kDHC + hc] = ssmv::to_f32(ssmv::from_f32<T>(dh));
      Gs[hr * kDHC + hc] = ssmv::to_f32(ssmv::from_f32<T>(g));
      __syncthreads();
      for (int r = 0; r < kSRows; ++r) {
        const float d0 = DHs[r * kDHC + cq], d1 = DHs[r * kDHC + cq + 1];
        const float g0 = Gs[r * kDHC + cq], g1 = Gs[r * kDHC + cq + 1];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const float xv = ssmv::to_f32(Xs[r * D + lane + 32 * j]);
          const float yv = ssmv::to_f32(DYs[r * D + lane + 32 * j]);
          acc1[j][0] = fmaf(xv, d0, acc1[j][0]);
          acc1[j][1] = fmaf(xv, d1, acc1[j][1]);
          acc2[0][j] = fmaf(g0, yv, acc2[0][j]);
          acc2[1][j] = fmaf(g1, yv, acc2[1][j]);
        }
      }
    }
  }

  T* dw1e = dw1 + (size_t)e * D * H;
  T* dw2e = dw2 + (size_t)e * H * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = lane + 32 * j, c = cq + q;
      dw1e[(size_t)k * H + c0 + c] = ssmv::from_f32<T>(acc1[j][q]);
      dw2e[(size_t)(c0 + c) * D + k] = ssmv::from_f32<T>(acc2[q][j]);
    }
  __syncthreads();  // the walk's readers of DHs / Gs are done
  R1[hr * kDHC + hc] = db1_sum;
  R2[hr * kDHC + hc] = db2_sum;
  __syncthreads();
  if (tid < kDHC) {
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < kSRows; ++r) {
      s1 += R1[r * kDHC + tid];
      s2 += R2[r * kDHC + tid];
    }
    db1[(size_t)e * H + c0 + tid] = s1;
    if (has_db2) db2[(size_t)e * D + c0 + tid] = s2;
  }
}

template <typename T, int D>
cudaError_t launch_simt(const void* xs, const void* dy, const void* w1,
                        const void* b1, const void* w2, const void* e_of_tile,
                        const void* flags, void* dxs, void* dw1, void* db1,
                        void* dw2, void* db2, int Tp, int H, int E,
                        int tile_rows, cudaStream_t stream) {
  cudaError_t err = launch_dgrad_simt<T, D, false, false>(
      xs, nullptr, dy, w1, b1, w2, e_of_tile, dxs, nullptr, nullptr, nullptr,
      Tp, H, tile_rows, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = simt_defer_smem<T>(D);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(expert_ffn_dw_defer_simt<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  expert_ffn_dw_defer_simt<T, D>
      <<<dim3(H / kDHC, E), kThreads, smem, stream>>>(
      static_cast<const T*>(xs), static_cast<const T*>(dy),
      static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<const int*>(flags), Tp / tile_rows, tile_rows,
      static_cast<T*>(dw1), static_cast<float*>(db1), static_cast<T*>(dw2),
      static_cast<float*>(db2), H);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* xs, const void* dy, const void* w1,
                   const void* b1, const void* w2, const void* e_of_tile,
                   const void* flags, void* dxs, void* dw1, void* db1,
                   void* dw2, void* db2, int Tp, int H, int E, int tile_rows,
                   cudaStream_t stream) {
  cudaError_t err =
      launch_dgrad<D>(xs, dy, w1, b1, w2, e_of_tile, dxs, Tp, H, tile_rows,
                      stream);
  if (err != cudaSuccess) return err;
  const size_t smem = DeferSmem<D>::bytes;
  err = cudaFuncSetAttribute(expert_ffn_dw_defer_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  expert_ffn_dw_defer_kernel<D><<<dim3(H / kHC, E), kThreads, smem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<const int*>(flags), Tp / tile_rows, tile_rows,
      static_cast<bf16*>(dw1), static_cast<float*>(db1),
      static_cast<bf16*>(dw2), static_cast<float*>(db2), H);
  return cudaGetLastError();
}

}  // namespace

// K8: xs, dy (Tp, D); w1 (E, D, H), b1 (E, H) f32, w2 (E, H, D); e_of_tile
// (Tp / tile_rows,) int32, nondecreasing; flags (Tp / tile_rows,) int32 from
// e_of_tile as _bwd_flags gives them -> dxs (Tp, D), dw1 (E, D, H), db1
// (E, H) f32, dw2 (E, H, D), db2 (E, D) f32; xs, dy, w1, w2, dxs, dw1, dw2
// of one activation dtype, bf16 (is_bf16 = 1) or f32. All contiguous and
// 16-byte aligned; D is 192, 384 or 768 (bf16 at 192 and 384 on the tensor
// cores, the rest in the SIMT form), H a multiple of 64 and at least D,
// tile_rows and Tp multiples of 64. No workspace.
extern "C" int ssmv_expert_ffn_bwd_defer(
    const void* xs, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* e_of_tile, const void* flags, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, int Tp, int D, int H, int E,
    int tile_rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // H >= D: the first D / 32 (D / 16) chunk blocks of each expert take db2
  if (Tp < kRows || Tp % kRows || H < 64 || H % 64 || H < D ||
      tile_rows % kRows || Tp % tile_rows || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
  if (is_bf16 && D == 384)
    return (int)launch<384>(xs, dy, w1, b1, w2, e_of_tile, flags, dxs, dw1,
                            db1, dw2, db2, Tp, H, E, tile_rows, s);
  if (is_bf16 && D == 192)
    return (int)launch<192>(xs, dy, w1, b1, w2, e_of_tile, flags, dxs, dw1,
                            db1, dw2, db2, Tp, H, E, tile_rows, s);
#define SSMV_SIMT_DEFER(TT, DD)                                            \
  if (D == DD)                                                             \
    return (int)launch_simt<TT, DD>(xs, dy, w1, b1, w2, e_of_tile, flags,  \
                                    dxs, dw1, db1, dw2, db2, Tp, H, E,     \
                                    tile_rows, s);
  if (is_bf16) {
    SSMV_SIMT_DEFER(bf16, 768)
  } else {
    SSMV_SIMT_DEFER(float, 192)
    SSMV_SIMT_DEFER(float, 384)
    SSMV_SIMT_DEFER(float, 768)
  }
#undef SSMV_SIMT_DEFER
  return (int)cudaErrorInvalidValue;
}
