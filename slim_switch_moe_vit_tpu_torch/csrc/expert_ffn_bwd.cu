// Per-expert FFN backward over the tile-aligned expert layout (K4), its
// gather-in-kernel form (K9 backward) and its permuted-tile form (K10
// backward).
//
// K4 replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _bwd_kernel (:261) with _tile_dx (:237), reached through _bwd (:374) and
// _ffn_bwd (:834). K9's backward replaces _bwd_gather_kernel (:658), reached
// through _bwd_gather (:693) and fused_expert_ffn_gather's VJP (:801): the
// same function with x re-read by index, x[gather_idx[s]] for layout row s
// (kGather below), and dx returned in layout (slot) space; the token-space
// dx, k row gathers masked by keep, is glue in Python, as it is outside the
// TPU kernel. The TPU wrapper promotes this backward to 512-row tiles when
// every pair of tiles shares an expert (:783-790), a TPU tiling policy that
// is not ported: both forms run 256-row tiles.
//
// K10's backward replaces the tile_perm branch of _bwd (:374, :408-431,
// :478-499), reached through fused_expert_ffn_permuted's VJP (:894): grid
// step i visits row tile tile_perm[i] of xs and dy and writes dx to the
// same tile, so dx keeps xs's row order; e_of_tile is indexed by step and
// nondecreasing (kPerm below). The workspace and the dh partials are
// written in step order, so the dW products still find an expert's rows as
// one contiguous range of steps; only the x and dy row loads and the dx
// stores go through tile_perm. The TPU kernel refuses the deferred-dW and
// 512-row forms with a permutation (:408-412); so does this port (K8 takes
// no permutation).
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
// What bounds it on the H100: the FLOPs. The five products (h recomputed,
// dy . W2^T, dh . W1^T, and the two dW products) make 10 x D x H flops a
// row: 309.5 GFLOP at ViT-S, B = 128 (Tp = 52,480), 0.313 ms at the 989
// TFLOP/s bf16 peak. Each is a GEMM, so the design is a GEMM's: bf16
// operands in shared memory, fed by 3-stage cp.async rings of 64-deep k
// steps so that the next steps' copies overlap this one's products, f32
// sums in registers on mma.sync m16n8k16 (mma_sync.cuh), and blocks of 16
// warps over tiles large enough (128 x 128 to 256 x 128) that the operand
// traffic from L2 stays near what the tensor cores consume. What holds it
// back from the bound: mma.sync and its ldmatrix traffic (a warp's 32 x 32
// or 64 x 32 tile loads one fragment per 2-3 products), the 128 registers
// a thread of a 16-warp block may hold, and the operands' L2 traffic.
// wgmma (operands as core matrices filled by cp.async) was tried on the
// grads kernel's products and measured slower; TMA's swizzled tiles are
// the untried step.
//
// bf16, at every D (192, 384, 768), two to three launches on the caller's
// stream:
//  (a) the dh kernel: one block of 16 warps per (128-row block, 128 hidden
//      columns): the two products h = x . W1[:, cols] and p = dy .
//      W2[cols, :]^T side by side over K = D (x and dy slices m-major, the
//      W1 slice k-major through ldmatrix.trans, the W2 slice n-major), each
//      warp 32 x 32 of both, 2 x 32 f32 accumulators a thread. The epilogue
//      runs in registers: b1 added in f32, GELU and gelu' in f32, dh = p *
//      gelu'(h); the f32 dh's column sums over the block's rows (in-thread,
//      then shuffles over the lanes of a column, then the four row warps in
//      order) go to a (Tp / 128, H) partials table, and bf16(dh) and
//      bf16(gelu(h)) to the (Tp, H) workspaces through a staging tile in
//      shared memory, as 16-byte stores.
//  (b) the grads kernel, one launch of 16-warp blocks (the long dW tiles
//      first, then db, then the short dx tiles to fill the tail; K9's and
//      K10's row lookups read a k step ahead): dx = ws_dh . W1[e]^T over
//      K = H in 256-row x 128-column
//      tiles (a layout tile's rows, one expert; warps 64 x 32); dW1[e] =
//      x^T . ws_dh and dW2[e]^T = dy^T . ws_g over K = the expert's rows in
//      128 x 256 tiles of D x H (warps 32 x 64; dW2 stored transposed, so
//      both products tile alike and D = 192 wastes only its last 64
//      columns), the rows' operands k-major through ldmatrix.trans; 64 f32
//      accumulators a thread, rounded to bf16 once; and 64-column blocks
//      of db1 and db2. Output edges that are not a tile multiple are
//      zero-filled on load and not stored. A dW block finds its expert's
//      rows from e_of_tile on the device (no host sync); an expert with no
//      tokens owns one all-padding tile whose dy is zero, and an expert
//      owning nothing sums over no rows: either way its dW and db are
//      written, as exact zeros.
//  (c) where the dW tiles alone would fill fewer than two waves of the
//      card (small E or D), the wrapper asks for `splits` > 1: each dW tile
//      is split over its expert's rows into that many f32 partials, and a
//      third kernel adds them in split order and rounds once to bf16.
// Everything is deterministic: no atomics, and every sum in a fixed order.
//
// Why dh does not stay in registers as the A operand of dx (K5's P does):
// dx's accumulator spans all of D for its rows, BM x D f32 over the block
// (96 a thread for 64 rows at D = 384 over 8 warps, 192 at D = 768), so
// the warps that share a row strip split dx's columns, and each would need
// all of that strip's dh: computed once per warp (h and dy . W2^T twice or
// four times over), or passed through shared memory. A fused block must
// also keep its x and dy rows and a chunk of W1 resident, which at D = 768
// leaves no room for a ring (64 rows of x and dy: 199 KB). dh goes to the
// workspace for the dW products in any case, so the dx product reads it
// back as a GEMM of its own: every product keeps the same tiles, registers
// and ring at every D, and D = 768 is no special case. The cost is the
// workspace's extra reads by the dx tiles (Tp x H bf16, D / 128 times,
// mostly from L2).
//
// f32, at every D: the same three launches on the tensor cores in split
// TF32 (mma_tf32.cuh), with f32 in place of bf16 throughout (dh and g kept
// in f32); the note above the f32 kernels says what bounds them and how.
#include "expert_ffn_dgrad.cuh"
#include "mma_sync.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace ssmv_ffn;
using namespace ssmv::tc;

constexpr int kWT = 64;  // db column blocks

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTC = 512;  // threads of the tensor-core kernels: 16 warps,
                          // 4 x 4 over a block's tile
constexpr int kBK = 64;   // k step
constexpr int kMLd = kBK + 8;  // row of an m- or n-major slice (72 bf16)

// dh kernel: 128 rows x 128 hidden columns a block, each warp 32 x 32 of h
// and of p
constexpr int kDhRows = 128;
constexpr int kDhCols = 128;
constexpr int kDhStages = 3;
constexpr int kW1Ld = kDhCols + 8;             // W1 slice rows (k-major)
constexpr int kXSz = kDhRows * kMLd;           // x or dy slice, elements
constexpr int kW1Sz = kBK * kW1Ld;
constexpr int kW2Sz = kDhCols * kMLd;
constexpr int kDhStage = 2 * kXSz + kW1Sz + kW2Sz;
constexpr size_t kDhSmem = sizeof(bf16) * kDhStage * kDhStages;
constexpr int kStLd = kDhCols + 8;             // epilogue staging rows
static_assert(sizeof(bf16) * 2 * kDhRows * kStLd +
                      sizeof(float) * 4 * kDhCols <= kDhSmem,
              "the dh epilogue's staging fits in the ring");

// grads kernel: dx tiles of 256 rows x 128 columns (warps 64 x 32), dW
// tiles of 128 x 256 (warps 32 x 64); a ring stage holds the largest A and
// B slices of either
constexpr int kGStages = 3;
constexpr int kSliceA = 256 * kMLd;            // dx's m-major A
constexpr int kSliceB = kBK * (256 + 8);       // dW's k-major B
constexpr size_t kGSmem = sizeof(bf16) * (kSliceA + kSliceB) * kGStages;

// The xs row that layout row r (step order) reads: gather_idx[r] (kGather),
// r's row in tile tile_perm[r / tile_rows] (kPerm), or r itself.
template <bool kGather, bool kPerm>
__device__ __forceinline__ size_t x_row(const long long* gather_idx,
                                        const int* tile_perm, int r,
                                        int tile_rows) {
  if (kGather) return (size_t)gather_idx[r];
  return (size_t)permuted_row<kPerm>(tile_perm, r, tile_rows);
}

// The 16-byte copies of a slice of R rows of C bf16, spread over the
// block's threads: fn(row, column) issues one.
template <int R, int C, typename Fn>
__device__ __forceinline__ void each_vec(Fn fn) {
  constexpr int V = C / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * V; i += kTC) fn(i / V, (i % V) * 8);
}

// (a) Grid (Tp / 128, ceil(H / 128)).
template <bool kGather, bool kPerm>
__global__ void __launch_bounds__(kTC, 1)
expert_ffn_dh_kernel(const bf16* __restrict__ xs,
                     const long long* __restrict__ gather_idx,
                     const int* __restrict__ tile_perm,
                     const bf16* __restrict__ dy, const bf16* __restrict__ w1,
                     const float* __restrict__ b1, const bf16* __restrict__ w2,
                     const int* __restrict__ e_of_tile,
                     bf16* __restrict__ ws_dh, bf16* __restrict__ ws_g,
                     float* __restrict__ db1_part, int D, int H,
                     int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int row0 = blockIdx.x * kDhRows;  // step order: workspace rows
  const int c0 = blockIdx.y * kDhCols;
  const int e = e_of_tile[row0 / tile_rows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this thread's copies of each stage: kXQ 16-byte vectors of x and of
  // dy (rows xr + q * kTC / kV, column xc), and the W1 and W2 slices'
  // (hidden columns at and past H zero-filled)
  constexpr int kV = kBK / 8, kXQ = kDhRows * kV / kTC;
  const int xr = tid / kV, xc = (tid % kV) * 8;
  const bf16* xsrc[kXQ];
  const bf16* dsrc[kXQ];
#pragma unroll
  for (int q = 0; q < kXQ; ++q) {
    const int r = row0 + xr + q * (kTC / kV);
    xsrc[q] = xs + x_row<kGather, kPerm>(gather_idx, tile_perm, r,
                                         tile_rows) * D + xc;
    dsrc[q] = dy + (size_t)permuted_row<kPerm>(tile_perm, r, tile_rows) * D +
              xc;
  }
  const bf16* w1e = w1 + (size_t)e * D * H;
  const bf16* w2e = w2 + (size_t)e * H * D;
  const int nk = D / kBK;
  auto issue = [&](int t) {  // k step t into its stage, one commit group
    if (t < nk) {
      bf16* st = smem + (t % kDhStages) * kDhStage;
      const int k0 = t * kBK;
#pragma unroll
      for (int q = 0; q < kXQ; ++q) {
        const int r = xr + q * (kTC / kV);
        cp_async16(st + r * kMLd + xc, xsrc[q] + k0, true);
        cp_async16(st + kXSz + r * kMLd + xc, dsrc[q] + k0, true);
      }
      each_vec<kBK, kDhCols>([&](int k, int c) {  // W1[k0 + k, c0 + c]
        const bool ok = c0 + c < H;
        cp_async16(st + 2 * kXSz + k * kW1Ld + c,
                   ok ? w1e + (size_t)(k0 + k) * H + c0 + c : w1e, ok);
      });
      each_vec<kDhCols, kBK>([&](int n, int c) {  // W2[c0 + n, k0 + c]
        const bool ok = c0 + n < H;
        cp_async16(st + 2 * kXSz + kW1Sz + n * kMLd + c,
                   ok ? w2e + (size_t)(c0 + n) * D + k0 + c : w2e, ok);
      });
    }
    cp_async_commit();
  };

  const int wm = warp & 3, wn = warp >> 2;  // rows wm * 32, columns wn * 32
  float h[2][4][4], p[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) h[i][j][c] = p[i][j][c] = 0.f;

  for (int s = 0; s < kDhStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kDhStages - 2>();  // step t landed, for this thread
    __syncthreads();                 // ... for all; step t - 1 is done
    issue(t + kDhStages - 1);        // into the stage step t - 1 used
    const bf16* st = smem + (t % kDhStages) * kDhStage;
    const bf16* Xt = st + wm * 32 * kMLd;
    const bf16* DYt = st + kXSz + wm * 32 * kMLd;
    const bf16* W1t = st + 2 * kXSz;
    const bf16* W2t = W1t + kW1Sz;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t ax[2][4], ad[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ld_a(ax[i], Xt + i * 16 * kMLd, kMLd, kk);
        ld_a(ad[i], DYt + i * 16 * kMLd, kMLd, kk);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ld_b_kn(b, W1t, kW1Ld, kk, wn * 32 + jj * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(h[i][2 * jj], ax[i], b[0], b[1]);
          mma(h[i][2 * jj + 1], ax[i], b[2], b[3]);
        }
        ld_b_nk(b, W2t, kMLd, wn * 32 + jj * 16, kk);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(p[i][2 * jj], ad[i], b[0], b[1]);
          mma(p[i][2 * jj + 1], ad[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages over it

  bf16* DHst = smem;
  bf16* Gst = smem + kDhRows * kStLd;
  float* red = reinterpret_cast<float*>(smem + 2 * kDhRows * kStLd);
  const int g = lane >> 2, tq = lane & 3;
  const float* b1e = b1 + (size_t)e * H;
  float csum[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + 2 * tq;
    const bool ok = c0 + col < H;
    const float bias[2] = {ok ? b1e[c0 + col] : 0.f,
                           ok ? b1e[c0 + col + 1] : 0.f};
    csum[j][0] = csum[j][1] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the m-tile
        const int row = wm * 32 + i * 16 + g + hh * 8;
        float gv[2], dh[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float dg;
          gelu_pair(h[i][j][2 * hh + c] + bias[c], &gv[c], &dg);
          dh[c] = p[i][j][2 * hh + c] * dg;
          csum[j][c] += dh[c];
        }
        *reinterpret_cast<uint32_t*>(DHst + row * kStLd + col) =
            pack2(dh[0], dh[1]);
        *reinterpret_cast<uint32_t*>(Gst + row * kStLd + col) =
            pack2(gv[0], gv[1]);
      }
  }
  // db1's column sums: over the lanes that share a column (the warp's 32
  // rows), then over the four row warps in order
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = csum[j][c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm * kDhCols + wn * 32 + j * 8 + 2 * tq + c] = v;
    }
  __syncthreads();
  if (tid < kDhCols && c0 + tid < H)
    db1_part[(size_t)blockIdx.x * H + c0 + tid] =
        red[tid] + red[kDhCols + tid] + red[2 * kDhCols + tid] +
        red[3 * kDhCols + tid];
  each_vec<kDhRows, kDhCols>([&](int r, int v) {
    if (c0 + v >= H) return;
    const size_t o = (size_t)(row0 + r) * H + c0 + v;
    *reinterpret_cast<uint4*>(ws_dh + o) =
        *reinterpret_cast<const uint4*>(DHst + r * kStLd + v);
    *reinterpret_cast<uint4*>(ws_g + o) =
        *reinterpret_cast<const uint4*>(Gst + r * kStLd + v);
  });
}

// The grads kernel's main loop over a (4 WM) x (4 WN) f32 tile, this
// warp's WM x WN in acc (rows wm * WM, columns wn * WN): acc = the sum over
// nk k steps of A_t . B_t, where load(t, a_dst, b_dst) issues the copies
// of step t's A slice (m-major (4 WM) x 32, or k-major 32 x (4 WM) as
// kAkm) and B slice (n-major, or k-major as kBkm). Returns with every copy
// landed and every thread past its last read of the ring.
template <bool kAkm, bool kBkm, int WM, int WN, typename Load>
__device__ __forceinline__ void gemm_tile(int nk, bf16* smem, Load load,
                                          float (&acc)[WM / 16][WN / 8][4]) {
  constexpr int AL = kAkm ? 4 * WM + 8 : kMLd, BL = kBkm ? 4 * WN + 8 : kMLd;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  auto issue = [&](int t) {
    if (t < nk) {
      bf16* st = smem + (t % kGStages) * (kSliceA + kSliceB);
      load(t, st, st + kSliceA);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  for (int s = 0; s < kGStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kGStages - 2>();
    __syncthreads();
    issue(t + kGStages - 1);
    const bf16* As = smem + (t % kGStages) * (kSliceA + kSliceB);
    const bf16* Bs = As + kSliceA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[WM / 16][4];
#pragma unroll
      for (int i = 0; i < WM / 16; ++i) {
        if (kAkm)
          ld_a_t(a[i], As, AL, kk, wm * WM + i * 16);
        else
          ld_a(a[i], As + (wm * WM + i * 16) * AL, AL, kk);
      }
#pragma unroll
      for (int jj = 0; jj < WN / 16; ++jj) {
        uint32_t b[4];
        if (kBkm)
          ld_b_kn(b, Bs, BL, kk, wn * WN + jj * 16);
        else
          ld_b_nk(b, Bs, BL, wn * WN + jj * 16, kk);
#pragma unroll
        for (int i = 0; i < WM / 16; ++i) {
          mma(acc[i][2 * jj], a[i], b[0], b[1]);
          mma(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Store this warp's part of a gemm_tile or gemm_tile_f32 result: rows
// [m0, M) x columns [n0, N) of a row-major output with row stride ldo, as
// bf16 (out) or as f32 (part: the split partials, and every f32 output),
// tile row m at row out_row(m); kTrans stores the transpose (element
// (m, n) at n * ldo + m).
template <int WM, int WN, bool kTrans, typename RowOf>
__device__ __forceinline__ void store_tile(
    const float (&acc)[WM / 16][WN / 8][4], bf16* out, float* part, int ldo,
    int m0, int M, int n0, int N, RowOf out_row) {
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < WM / 16; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * WM + i * 16 + g + hh * 8;
      if (m >= M) continue;
      const size_t row = kTrans ? 0 : (size_t)out_row(m) * ldo;
#pragma unroll
      for (int j = 0; j < WN / 8; ++j) {
        const int n = n0 + wn * WN + j * 8 + 2 * tq;
        if (n >= N) continue;
        const float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        if (kTrans) {
          const size_t o0 = (size_t)n * ldo + m, o1 = o0 + ldo;
          if (part) {
            part[o0] = v0;
            part[o1] = v1;
          } else {
            out[o0] = __float2bfloat16(v0);
            out[o1] = __float2bfloat16(v1);
          }
        } else if (part) {
          *reinterpret_cast<float2*>(part + row + n) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<uint32_t*>(out + row + n) = pack2(v0, v1);
        }
      }
    }
}

// The layout tiles of expert e (steps, with kPerm): e_of_tile is
// nondecreasing, so they are the [#tiles with e_of_tile < e, + #tiles with
// e_of_tile == e) range; every thread of the block gets both.
__device__ __forceinline__ void expert_tiles(const int* __restrict__ e_of_tile,
                                             int n_tiles, int e, int& first,
                                             int& count) {
  first = count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += blockDim.x) {
    const int t = t0 + threadIdx.x;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }
}

// A db job of the grads kernels: the 64 columns jb of [db1[e] | db2[e]],
// db1 from the dh kernels' per-128-row partials, db2 the sum of dy (T) over
// the expert's rows. Thread (grp, c) sums rows grp, grp + kGroups, ... of
// column c, then thread c adds the kGroups sums in order (deterministic);
// red holds a float a thread.
template <bool kPerm, typename T>
__device__ __forceinline__ void db_job(const int* __restrict__ tile_perm,
                                       const T* __restrict__ dy,
                                       const float* __restrict__ db1_part,
                                       int first, int count, int tile_rows,
                                       int jb, int e, float* __restrict__ db1,
                                       float* __restrict__ db2, int D, int H,
                                       float* red) {
  constexpr int kGroups = kTC / kWT;
  const int tid = threadIdx.x;
  const int r_begin = first * tile_rows, r_end = (first + count) * tile_rows;
  const int c = tid % kWT, grp = tid / kWT;
  float sum = 0.f;
  if (jb < H / kWT) {  // db1[e] from the dh kernel's per-128-row sums
    const int col = jb * kWT + c;
    for (int blk = r_begin / kDhRows + grp; blk < r_end / kDhRows;
         blk += kGroups)
      sum += db1_part[(size_t)blk * H + col];
  } else {             // db2[e] = sum of dy over the expert's rows
    const int col = (jb - H / kWT) * kWT + c;
#pragma unroll 16  // loads in flight; the adds keep row order
    for (int r = r_begin + grp; r < r_end; r += kGroups)
      sum += ssmv::to_f32(
          dy[(size_t)permuted_row<kPerm>(tile_perm, r, tile_rows) * D + col]);
  }
  red[tid] = sum;
  __syncthreads();
  if (tid < kWT) {
    float total = red[c];
#pragma unroll
    for (int q = 1; q < kGroups; ++q) total += red[q * kWT + c];
    if (jb < H / kWT)
      db1[(size_t)e * H + jb * kWT + c] = total;
    else
      db2[(size_t)e * D + (jb - H / kWT) * kWT + c] = total;
  }
}

// (b) Grid (E * splits * 2 * TD * TH + E * (H + D) / 64 + (Tp / 256) * TD),
// TD = ceil(D / 128), TH = ceil(H / 256). Jobs in order: for each expert e
// and split s, the TD x TH tiles of dW1[e] and of dW2[e]^T (into
// dw_part[s] when splits > 1); for each expert the H / 64 column blocks
// of db1 and the D / 64 of db2; the (Tp / 256) x TD tiles of dx, short
// and uniform, last, to fill the tail.
template <bool kGather, bool kPerm>
__global__ void __launch_bounds__(kTC, 1)
expert_ffn_grads_kernel(const bf16* __restrict__ xs,
                        const long long* __restrict__ gather_idx,
                        const int* __restrict__ tile_perm,
                        const bf16* __restrict__ dy,
                        const bf16* __restrict__ w1,
                        const bf16* __restrict__ ws_dh,
                        const bf16* __restrict__ ws_g,
                        const float* __restrict__ db1_part,
                        const int* __restrict__ e_of_tile, int n_tiles,
                        int tile_rows, bf16* __restrict__ dxs,
                        bf16* __restrict__ dw1, float* __restrict__ db1,
                        bf16* __restrict__ dw2, float* __restrict__ db2,
                        float* __restrict__ dw_part, int D, int H, int E,
                        int splits) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int tid = threadIdx.x;
  const int TD = (D + 127) / 128, TH = (H + 255) / 256;
  const int per_split = 2 * TD * TH;
  int job = blockIdx.x;

  const int n_dw = E * splits * per_split;
  const int n_db = E * ((H + D) / kWT);
  if (job >= n_dw + n_db) {  // dx = ws_dh . W1[e]^T
    job -= n_dw + n_db;
    const int r0 = job / TD * 256, n0 = job % TD * 128;
    const int e = e_of_tile[r0 / tile_rows];
    const bf16* w1e = w1 + (size_t)e * D * H;
    float acc[4][4][4];
    gemm_tile<false, false, 64, 32>(
        H / kBK, smem,
        [&](int t, bf16* a, bf16* b) {
          const int k0 = t * kBK;
          each_vec<256, kBK>([&](int m, int c) {
            cp_async16(a + m * kMLd + c,
                       ws_dh + (size_t)(r0 + m) * H + k0 + c, true);
          });
          each_vec<128, kBK>([&](int n, int c) {
            const bool ok = n0 + n < D;
            cp_async16(b + n * kMLd + c,
                       ok ? w1e + (size_t)(n0 + n) * H + k0 + c : w1e, ok);
          });
        },
        acc);
    store_tile<64, 32, false>(acc, dxs, nullptr, D, 0, 256, n0, D,
                              [&](int m) {
                                return permuted_row<kPerm>(tile_perm, r0 + m,
                                                           tile_rows);
                              });
    return;
  }

  // the expert's tiles (steps, with kPerm): e_of_tile is nondecreasing, so
  // they are the [#tiles with e_of_tile < e, + #tiles with e_of_tile == e)
  // range
  const bool is_dw = job < n_dw;
  const int e = is_dw ? job / (splits * per_split)
                      : (job - n_dw) / ((H + D) / kWT);
  int first, count;
  expert_tiles(e_of_tile, n_tiles, e, first, count);

  if (is_dw) {
    // dW1[e] (D, H) = x^T . bf16(dh), and dW2[e] (H, D) as its transpose
    // dy^T . bf16(g) (D, H), so both tile D x H the same way
    const int s = job / per_split % splits, jj = job % per_split;
    const int r_begin = (first + count * s / splits) * tile_rows;
    const int nk = (first + count * (s + 1) / splits) * tile_rows / kBK -
                   r_begin / kBK;
    const bool is_w1 = jj < TD * TH;
    const int tj = is_w1 ? jj : jj - TD * TH;
    const int m0 = tj / TH * 128, n0 = tj % TH * 256;
    // this thread copies A's (x's or dy's) rows ak and ak + 32 of each
    // step at column ac; their source rows (a gather_idx or tile_perm
    // lookup in K9's and K10's forms) are read a step ahead, off the
    // copies' issue path (gemm_tile loads the steps in order)
    const bf16* A = is_w1 ? xs : dy;
    const bf16* Bsrc = is_w1 ? ws_dh : ws_g;
    const int ak = tid >> 4, ac = (tid & 15) * 8;
    const bool aok = m0 + ac < D;
    size_t src_row[2];
    const auto rows_of = [&](int t) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = r_begin + t * kBK + ak + 32 * q;
        src_row[q] = t >= nk ? 0
                     : is_w1 ? x_row<kGather, kPerm>(gather_idx, tile_perm, r,
                                                     tile_rows)
                             : (size_t)permuted_row<kPerm>(tile_perm, r,
                                                           tile_rows);
      }
    };
    static_assert(kBK * 128 / 8 == 2 * kTC, "two A copies a thread");
    float acc[2][8][4];
    rows_of(0);
    gemm_tile<true, true, 32, 64>(
        nk, smem,
        [&](int t, bf16* a, bf16* b) {
#pragma unroll
          for (int q = 0; q < 2; ++q)
            cp_async16(a + (ak + 32 * q) * (128 + 8) + ac,
                       aok ? A + src_row[q] * D + m0 + ac : A, aok);
          rows_of(t + 1);
          const int r0 = r_begin + t * kBK;
          each_vec<kBK, 256>([&](int k, int c) {
            const bool ok = n0 + c < H;
            cp_async16(b + k * (256 + 8) + c,
                       ok ? Bsrc + (size_t)(r0 + k) * H + n0 + c : Bsrc, ok);
          });
        },
        acc);
    float* part = splits > 1 ? dw_part + ((size_t)(s * 2 + !is_w1) * E + e) *
                                             D * H
                             : nullptr;
    const auto same = [](int m) { return m; };
    if (is_w1)
      store_tile<32, 64, false>(acc, part ? nullptr : dw1 + (size_t)e * D * H,
                                part, H, m0, D, n0, H, same);
    else
      store_tile<32, 64, true>(acc, part ? nullptr : dw2 + (size_t)e * H * D,
                               part, D, m0, D, n0, H, same);
    return;
  }

  db_job<kPerm>(tile_perm, dy, db1_part, first, count, tile_rows,
                (job - n_dw) % ((H + D) / kWT), e, db1, db2, D, H,
                reinterpret_cast<float*>(smem));
}

// (c) dW1 and dW2 from the splits' f32 partials (splits x [dW1 | dW2], n
// = E * D * H values each), added in split order and rounded once (to T).
__device__ __forceinline__ void store4(bf16* out, float4 v) {
  *reinterpret_cast<uint2*>(out) = make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
}
__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

template <typename T>
__global__ void __launch_bounds__(kTC)
expert_ffn_dw_reduce(const float* __restrict__ part, int splits, size_t n,
                     T* __restrict__ dw1, T* __restrict__ dw2) {
  const size_t stride = (size_t)gridDim.x * kTC * 4;
  for (size_t i = ((size_t)blockIdx.x * kTC + threadIdx.x) * 4; i < 2 * n;
       i += stride) {
    float4 v = *reinterpret_cast<const float4*>(part + i);
    for (int s = 1; s < splits; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(part + s * 2 * n + i);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    store4(i < n ? dw1 + i : dw2 + (i - n), v);
  }
}

// the reduce's launch: at most 4096 blocks
template <typename T>
cudaError_t launch_dw_reduce(const void* ws_dw, int splits, size_t n, void* dw1,
                             void* dw2, cudaStream_t stream) {
  const size_t blocks = (2 * n / 4 + kTC - 1) / kTC;
  expert_ffn_dw_reduce<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), kTC, 0,
                            stream>>>(static_cast<const float*>(ws_dw), splits,
                                      n, static_cast<T*>(dw1),
                                      static_cast<T*>(dw2));
  return cudaGetLastError();
}

template <bool kGather, bool kPerm>
cudaError_t launch_tc(const void* xs, const void* gather_idx,
                      const void* tile_perm, const void* dy, const void* w1,
                      const void* b1, const void* w2, const void* e_of_tile,
                      void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                      void* ws_dh, void* ws_g, void* ws_db1, void* ws_dw,
                      int splits, int Tp, int D, int H, int E, int tile_rows,
                      cudaStream_t stream) {
  auto dh = expert_ffn_dh_kernel<kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      dh, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kDhSmem);
  if (err != cudaSuccess) return err;
  dh<<<dim3(Tp / kDhRows, (H + kDhCols - 1) / kDhCols), kTC, kDhSmem,
       stream>>>(
      static_cast<const bf16*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), static_cast<const float*>(b1),
      static_cast<const bf16*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<bf16*>(ws_dh), static_cast<bf16*>(ws_g),
      static_cast<float*>(ws_db1), D, H, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto grads = expert_ffn_grads_kernel<kGather, kPerm>;
  err = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kGSmem);
  if (err != cudaSuccess) return err;
  const long long TD = (D + 127) / 128, TH = (H + 255) / 256;
  const long long jobs = (long long)E * splits * 2 * TD * TH +
                         (long long)Tp / 256 * TD + (long long)E * (H + D) / kWT;
  if (jobs > 0x7fffffffLL) return cudaErrorInvalidValue;
  grads<<<(unsigned)jobs, kTC, kGSmem, stream>>>(
      static_cast<const bf16*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const bf16*>(dy),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(ws_dh),
      static_cast<const bf16*>(ws_g), static_cast<const float*>(ws_db1),
      static_cast<const int*>(e_of_tile), Tp / tile_rows, tile_rows,
      static_cast<bf16*>(dxs), static_cast<bf16*>(dw1),
      static_cast<float*>(db1), static_cast<bf16*>(dw2),
      static_cast<float*>(db2), static_cast<float*>(ws_dw), D, H, E, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;

  return launch_dw_reduce<bf16>(ws_dw, splits, (size_t)E * D * H, dw1, dw2,
                                stream);
}

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores (mma_tf32.cuh)
// ---------------------------------------------------------------------------
//
// The bf16 form's structure with f32 tiles: (a) a dh kernel, (b) one grads
// launch, (c) the ordered split-reduce. Each product is a GEMM tile in split
// TF32: f32 operands in shared memory through 3-stage cp.async rings of
// 32-deep k steps (f32 doubles a slice's bytes), fragments by 32-bit
// loads split into hi and lo parts once per k step, and three
// mma.sync.m16n8k8 a product swept over 4 (grads: 2) n-tiles of two
// m-tiles at once, each k step's products summed into zeroed fragments and
// added to the accumulators on the CUDA cores (mma_group2_rn: the tensor
// cores' own f32 sums across all of k read 38-43x an f32 FMA chain's error
// from the f64 function in dx and dW at D = 384, 1.2-1.3x summed apart).
// What bounds it: 10 x D x H flops a row at the split-TF32 rate, 164.9
// TFLOP/s: 0.531 ms at ViT-S, B = 32 (Tp = 14,848). What holds it back (0.28
// of the bound at D = 384, 0.30 at 768, 0.23 at 192, measured on the card):
// as the f32 forward's note says, the issue slots every mma shares with its
// fragment loads, splits and CUDA-core adds; 4 ring stages, groups of 1-4
// n-tiles and an unrolled k step time within 4%. The products' operands:
//  - h = x . W1 and p = dy . W2^T: x and dy m-major (ld_a), W1's slice
//    k-major (ld_b_km), W2's n-major (ld_b_nk);
//  - dx = dh . W1^T: dh m-major, W1 n-major;
//  - dW1 = x^T . dh and dW2^T = dy^T . g over each expert's rows: both
//    sides k-major row slices (ld_a_km, ld_b_km: ldmatrix has no f32
//    transpose), rows of 128 + 8 words so every fragment read is
//    conflict-free.
// (a) the dh kernel, f32: a block of 8 warps per (128-row block, 64 hidden
//     columns), each warp 32 x 32 of h and of p (64 accumulators a
//     thread); the epilogue runs gelu' in registers and writes dh and g
//     (f32) to the (Tp, H) workspaces as 32-byte row segments, and the
//     block's column sums of dh (over lanes, then the 4 row warps in
//     order) to the (Tp / 128, H) partials, as the bf16 kernel does.
// (b) the grads kernel, f32: 16-warp blocks over 128 x 128 tiles (warps
//     32 x 32) for dx and for dW1 and dW2^T (D x H), jobs in the bf16
//     kernel's order (dW, db, dx), the dW tiles split over the rows by
//     wgrad_splits (ops/fused_ffn.py) where 128 x 128 tiles would fill
//     fewer than two waves, each split's partial summed by (c) in order.
// No atomics, every sum in a fixed order: two calls are bit-identical.
namespace tf = ssmv::tf32;

constexpr int kFBK = 32;         // k step of the f32 kernels
constexpr int kFMLd = kFBK + 4;  // row of an m- or n-major slice (36 words)

// (a) dh, f32: 128 rows x 64 hidden columns a block, 8 warps (4 x 2)
constexpr int kFDhCols = 64;
constexpr int kFDhThreads = 256;
constexpr int kFDhStages = 3;
constexpr int kFW1Ld = kFDhCols + 8;    // W1 slice rows (k-major)
constexpr int kFXSz = kDhRows * kFMLd;  // x or dy slice, floats
constexpr int kFW1Sz = kFBK * kFW1Ld;
constexpr int kFW2Sz = kFDhCols * kFMLd;
constexpr int kFDhStage = 2 * kFXSz + kFW1Sz + kFW2Sz;
constexpr size_t kFDhSmem = sizeof(float) * kFDhStage * kFDhStages;

// (b) grads, f32: 128 x 128 tiles, 16 warps (4 x 4) of 32 x 32; a ring
// stage holds the larger A and B slice of either product
constexpr int kFG = 128;
constexpr int kFGStages = 3;
// n-tiles a swept group (mma_group2_rn): 4 spilled under the 128
// registers a thread of a 16-warp block may hold
constexpr int kFGroup = 2;
constexpr int kFKLd = kFG + 8;          // row of a k-major slice (136 words)
constexpr int kFSlice = kFG * kFMLd;    // an m- or n-major slice, floats
static_assert(kFBK * kFKLd <= kFSlice, "a k-major slice fits a stage's half");
constexpr size_t kFGSmem = sizeof(float) * 2 * kFSlice * kFGStages;

// (a) Grid (Tp / 128, H / 64).
template <bool kGather, bool kPerm>
__global__ void __launch_bounds__(kFDhThreads, 1)
expert_ffn_dh_f32_kernel(const float* __restrict__ xs,
                         const long long* __restrict__ gather_idx,
                         const int* __restrict__ tile_perm,
                         const float* __restrict__ dy,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const int* __restrict__ e_of_tile,
                         float* __restrict__ ws_dh, float* __restrict__ ws_g,
                         float* __restrict__ db1_part, int D, int H,
                         int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int row0 = blockIdx.x * kDhRows;  // step order: workspace rows
  const int c0 = blockIdx.y * kFDhCols;
  const int e = e_of_tile[row0 / tile_rows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this thread's copies of x and dy: rows xr + q * kRP at column xc
  constexpr int kV = kFBK / 4, kRP = kFDhThreads / kV, kXQ = kDhRows / kRP;
  const int xr = tid / kV, xc = tid % kV * 4;
  const float* xsrc[kXQ];
  const float* dsrc[kXQ];
#pragma unroll
  for (int q = 0; q < kXQ; ++q) {
    const int r = row0 + xr + q * kRP;
    xsrc[q] = xs + x_row<kGather, kPerm>(gather_idx, tile_perm, r,
                                         tile_rows) * D + xc;
    dsrc[q] = dy + (size_t)permuted_row<kPerm>(tile_perm, r, tile_rows) * D +
              xc;
  }
  const float* w1e = w1 + (size_t)e * D * H;
  const float* w2e = w2 + (size_t)e * H * D;
  const int nk = D / kFBK;
  auto issue = [&](int t) {  // k step t into its stage, one commit group
    if (t < nk) {
      float* st = smem + (t % kFDhStages) * kFDhStage;
      const int k0 = t * kFBK;
#pragma unroll
      for (int q = 0; q < kXQ; ++q) {
        const int r = xr + q * kRP;
        cp_async16(st + r * kFMLd + xc, xsrc[q] + k0, true);
        cp_async16(st + kFXSz + r * kFMLd + xc, dsrc[q] + k0, true);
      }
      each_vec4<kFBK, kFDhCols, kFDhThreads>([&](int k, int c) {
        cp_async16(st + 2 * kFXSz + k * kFW1Ld + c,
                   w1e + (size_t)(k0 + k) * H + c0 + c, true);
      });
      each_vec4<kFDhCols, kFBK, kFDhThreads>([&](int n, int c) {
        cp_async16(st + 2 * kFXSz + kFW1Sz + n * kFMLd + c,
                   w2e + (size_t)(c0 + n) * D + k0 + c, true);
      });
    }
    cp_async_commit();
  };

  const int wm = warp & 3, wn = warp >> 2;  // rows wm * 32, columns wn * 32
  float h[2][4][4], p[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) h[i][j][c] = p[i][j][c] = 0.f;

  for (int s = 0; s < kFDhStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kFDhStages - 2>();
    __syncthreads();
    issue(t + kFDhStages - 1);
    const float* st = smem + (t % kFDhStages) * kFDhStage;
    const float* Xt = st + wm * 32 * kFMLd;
    const float* DYt = st + kFXSz + wm * 32 * kFMLd;
    const float* W1t = st + 2 * kFXSz;
    const float* W2t = W1t + kFW1Sz;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 8) {
      tf::FragA a0, a1;
      tf::FragB b[4];
      tf::ld_a(a0, Xt, kFMLd, kk);
      tf::ld_a(a1, Xt + 16 * kFMLd, kFMLd, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf::ld_b_km(b[j], W1t, kFW1Ld, kk, wn * 32 + j * 8);
      tf::mma_group2_rn<4>(h[0], 0, a0, b, h[1], 0, a1, b);
      tf::ld_a(a0, DYt, kFMLd, kk);
      tf::ld_a(a1, DYt + 16 * kFMLd, kFMLd, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        tf::ld_b_nk(b[j], W2t, kFMLd, wn * 32 + j * 8, kk);
      tf::mma_group2_rn<4>(p[0], 0, a0, b, p[1], 0, a1, b);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the column sums stage over it

  float* red = smem;  // 4 row warps x kFDhCols
  const int g = lane >> 2, tq = lane & 3;
  const float* b1e = b1 + (size_t)e * H;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + 2 * tq;
    const float2 bias = *reinterpret_cast<const float2*>(b1e + c0 + col);
    float csum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the m-tile
        float gv[2], dh[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float dg;
          gelu_pair(h[i][j][2 * hh + c] + (c ? bias.y : bias.x), &gv[c], &dg);
          dh[c] = p[i][j][2 * hh + c] * dg;
          csum[c] += dh[c];
        }
        const size_t o =
            (size_t)(row0 + wm * 32 + i * 16 + g + hh * 8) * H + c0 + col;
        *reinterpret_cast<float2*>(ws_dh + o) = make_float2(dh[0], dh[1]);
        *reinterpret_cast<float2*>(ws_g + o) = make_float2(gv[0], gv[1]);
      }
    // over the lanes that share a column (the warp's 32 rows)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float v = csum[c];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[wm * kFDhCols + col + c] = v;
    }
  }
  __syncthreads();
  if (tid < kFDhCols)  // the four row warps in order
    db1_part[(size_t)blockIdx.x * H + c0 + tid] =
        red[tid] + red[kFDhCols + tid] + red[2 * kFDhCols + tid] +
        red[3 * kFDhCols + tid];
}

// The f32 grads kernel's main loop over a 128 x 128 tile, this warp's
// 32 x 32 in acc (rows wm * 32, columns wn * 32): acc = the sum over nk k
// steps of A_t . B_t, where load(t, a_dst, b_dst) issues the copies of step
// t's A slice (m-major 128 x 32, or k-major 32 x 128 as kAkm) and B slice
// (n-major, or k-major as kBkm). Returns with every copy landed and every
// thread past its last read of the ring.
template <bool kAkm, bool kBkm, typename Load>
__device__ __forceinline__ void gemm_tile_f32(int nk, float* smem, Load load,
                                              float (&acc)[2][4][4]) {
  constexpr int AL = kAkm ? kFKLd : kFMLd, BL = kBkm ? kFKLd : kFMLd;
  const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
  auto issue = [&](int t) {
    if (t < nk) {
      float* st = smem + (t % kFGStages) * 2 * kFSlice;
      load(t, st, st + kFSlice);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  for (int s = 0; s < kFGStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    cp_async_wait<kFGStages - 2>();
    __syncthreads();
    issue(t + kFGStages - 1);
    const float* As = smem + (t % kFGStages) * 2 * kFSlice;
    const float* Bs = As + kFSlice;
#pragma unroll 1  // unrolled, it spills past 128 registers
    for (int kk = 0; kk < kFBK; kk += 8) {
      tf::FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (kAkm)
          tf::ld_a_km(a[i], As, AL, kk, wm * 32 + i * 16);
        else
          tf::ld_a(a[i], As + (wm * 32 + i * 16) * AL, AL, kk);
      }
#pragma unroll
      for (int j0 = 0; j0 < 4; j0 += kFGroup) {
        tf::FragB b[kFGroup];
#pragma unroll
        for (int j = 0; j < kFGroup; ++j) {
          const int n0 = wn * 32 + (j0 + j) * 8;
          if (kBkm)
            tf::ld_b_km(b[j], Bs, BL, kk, n0);
          else
            tf::ld_b_nk(b[j], Bs, BL, n0, kk);
        }
        tf::mma_group2_rn<kFGroup>(acc[0], j0, a[0], b, acc[1], j0, a[1], b);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// (b) Grid (E * splits * 2 * TD * TH + E * (H + D) / 64 + (Tp / 128) * TD),
// TD = ceil(D / 128), TH = H / 128 rounded up; jobs in the bf16 kernel's
// order: the dW tiles, the db column blocks, the dx tiles.
template <bool kGather, bool kPerm>
__global__ void __launch_bounds__(kTC, 1)
expert_ffn_grads_f32_kernel(const float* __restrict__ xs,
                            const long long* __restrict__ gather_idx,
                            const int* __restrict__ tile_perm,
                            const float* __restrict__ dy,
                            const float* __restrict__ w1,
                            const float* __restrict__ ws_dh,
                            const float* __restrict__ ws_g,
                            const float* __restrict__ db1_part,
                            const int* __restrict__ e_of_tile, int n_tiles,
                            int tile_rows, float* __restrict__ dxs,
                            float* __restrict__ dw1, float* __restrict__ db1,
                            float* __restrict__ dw2, float* __restrict__ db2,
                            float* __restrict__ dw_part, int D, int H, int E,
                            int splits) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x;
  const int TD = (D + kFG - 1) / kFG, TH = (H + kFG - 1) / kFG;
  const int per_split = 2 * TD * TH;
  int job = blockIdx.x;
  const int n_dw = E * splits * per_split;
  const int n_db = E * ((H + D) / kWT);
  float acc[2][4][4];
  if (job >= n_dw + n_db) {  // dx = ws_dh . W1[e]^T over K = H
    job -= n_dw + n_db;
    const int r0 = job / TD * kFG, n0 = job % TD * kFG;
    const float* w1e = w1 + (size_t)e_of_tile[r0 / tile_rows] * D * H;
    gemm_tile_f32<false, false>(
        H / kFBK, smem,
        [&](int t, float* a, float* b) {
          const int k0 = t * kFBK;
          each_vec4<kFG, kFBK, kTC>([&](int m, int c) {
            cp_async16(a + m * kFMLd + c,
                       ws_dh + (size_t)(r0 + m) * H + k0 + c, true);
          });
          each_vec4<kFG, kFBK, kTC>([&](int n, int c) {
            const bool ok = n0 + n < D;
            cp_async16(b + n * kFMLd + c,
                       ok ? w1e + (size_t)(n0 + n) * H + k0 + c : w1e, ok);
          });
        },
        acc);
    store_tile<32, 32, false>(acc, nullptr, dxs, D, 0, kFG, n0, D,
                              [&](int m) {
                                return permuted_row<kPerm>(tile_perm, r0 + m,
                                                           tile_rows);
                              });
    return;
  }

  const bool is_dw = job < n_dw;
  const int e = is_dw ? job / (splits * per_split)
                      : (job - n_dw) / ((H + D) / kWT);
  int first, count;
  expert_tiles(e_of_tile, n_tiles, e, first, count);
  if (!is_dw) {
    db_job<kPerm>(tile_perm, dy, db1_part, first, count, tile_rows,
                  (job - n_dw) % ((H + D) / kWT), e, db1, db2, D, H, smem);
    return;
  }
  // dW1[e] (D, H) = x^T . dh, and dW2[e] (H, D) as its transpose dy^T . g
  // (D, H), over the split's rows of the expert
  const int s = job / per_split % splits, jj = job % per_split;
  const int r_begin = (first + count * s / splits) * tile_rows;
  const int nk = ((first + count * (s + 1) / splits) * tile_rows - r_begin) /
                 kFBK;
  const bool is_w1 = jj < TD * TH;
  const int tj = is_w1 ? jj : jj - TD * TH;
  const int m0 = tj / TH * kFG, n0 = tj % TH * kFG;
  // this thread copies A's (x's or dy's) rows ak and ak + 16 of each step
  // at column ac; their source rows (K9's and K10's lookups) are read a
  // step ahead, off the copies' issue path
  const float* A = is_w1 ? xs : dy;
  const float* Bsrc = is_w1 ? ws_dh : ws_g;
  static_assert(kFBK * kFG / 4 == 2 * kTC, "two A copies a thread");
  const int ak = tid >> 5, ac = (tid & 31) * 4;
  const bool aok = m0 + ac < D;
  size_t src_row[2];
  const auto rows_of = [&](int t) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int r = r_begin + t * kFBK + ak + 16 * q;
      src_row[q] = t >= nk ? 0
                   : is_w1 ? x_row<kGather, kPerm>(gather_idx, tile_perm, r,
                                                   tile_rows)
                           : (size_t)permuted_row<kPerm>(tile_perm, r,
                                                         tile_rows);
    }
  };
  rows_of(0);
  gemm_tile_f32<true, true>(
      nk, smem,
      [&](int t, float* a, float* b) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          cp_async16(a + (ak + 16 * q) * kFKLd + ac,
                     aok ? A + src_row[q] * D + m0 + ac : A, aok);
        rows_of(t + 1);
        const int r0 = r_begin + t * kFBK;
        each_vec4<kFBK, kFG, kTC>([&](int k, int c) {
          const bool ok = n0 + c < H;
          cp_async16(b + k * kFKLd + c,
                     ok ? Bsrc + (size_t)(r0 + k) * H + n0 + c : Bsrc, ok);
        });
      },
      acc);
  float* part = splits > 1 ? dw_part + ((size_t)(s * 2 + !is_w1) * E + e) *
                                           D * H
                           : nullptr;
  const auto same = [](int m) { return m; };
  if (is_w1)
    store_tile<32, 32, false>(acc, nullptr,
                              part ? part : dw1 + (size_t)e * D * H, H, m0, D,
                              n0, H, same);
  else
    store_tile<32, 32, true>(acc, nullptr,
                             part ? part : dw2 + (size_t)e * H * D, D, m0, D,
                             n0, H, same);
}

template <bool kGather, bool kPerm>
cudaError_t launch_f32(const void* xs, const void* gather_idx,
                       const void* tile_perm, const void* dy, const void* w1,
                       const void* b1, const void* w2, const void* e_of_tile,
                       void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                       void* ws_dh, void* ws_g, void* ws_db1, void* ws_dw,
                       int splits, int Tp, int D, int H, int E, int tile_rows,
                       cudaStream_t stream) {
  auto dh = expert_ffn_dh_f32_kernel<kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      dh, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFDhSmem);
  if (err != cudaSuccess) return err;
  dh<<<dim3(Tp / kDhRows, H / kFDhCols), kFDhThreads, kFDhSmem, stream>>>(
      static_cast<const float*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const int*>(e_of_tile),
      static_cast<float*>(ws_dh), static_cast<float*>(ws_g),
      static_cast<float*>(ws_db1), D, H, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto grads = expert_ffn_grads_f32_kernel<kGather, kPerm>;
  err = cudaFuncSetAttribute(grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kFGSmem);
  if (err != cudaSuccess) return err;
  const long long TD = (D + kFG - 1) / kFG, TH = (H + kFG - 1) / kFG;
  const long long jobs = (long long)E * splits * 2 * TD * TH +
                         (long long)Tp / kFG * TD + (long long)E * (H + D) / kWT;
  if (jobs > 0x7fffffffLL) return cudaErrorInvalidValue;
  grads<<<(unsigned)jobs, kTC, kFGSmem, stream>>>(
      static_cast<const float*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const float*>(dy),
      static_cast<const float*>(w1), static_cast<const float*>(ws_dh),
      static_cast<const float*>(ws_g), static_cast<const float*>(ws_db1),
      static_cast<const int*>(e_of_tile), Tp / tile_rows, tile_rows,
      static_cast<float*>(dxs), static_cast<float*>(dw1),
      static_cast<float*>(db1), static_cast<float*>(dw2),
      static_cast<float*>(db2), static_cast<float*>(ws_dw), D, H, E, splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_dw_reduce<float>(ws_dw, splits, (size_t)E * D * H, dw1, dw2,
                                 stream);
}

template <bool kGather, bool kPerm>
int dispatch(const void* xs, const void* gather_idx, const void* tile_perm,
             const void* dy, const void* w1, const void* b1, const void* w2,
             const void* e_of_tile, void* dxs, void* dw1, void* db1, void* dw2,
             void* db2, void* ws_dh, void* ws_g, void* ws_db1, void* ws_dw,
             int splits, int Tp, int D, int H, int E, int tile_rows,
             int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < kRows || Tp % kRows || H < kWT || H % kWT || tile_rows % kRows ||
      Tp % tile_rows || E < 1 || E > 65535 ||
      (D != 192 && D != 384 && D != 768) ||
      tile_rows % (is_bf16 ? 256 : kFG) || splits < 1 ||
      (splits > 1 && ws_dw == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? launch_tc<kGather, kPerm>
                       : launch_f32<kGather, kPerm>)(
      xs, gather_idx, tile_perm, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1,
      dw2, db2, ws_dh, ws_g, ws_db1, ws_dw, splits, Tp, D, H, E, tile_rows, s);
}

}  // namespace

// K4: xs, dy (Tp, D); w1 (E, D, H), b1 (E, H) f32, w2 (E, H, D); e_of_tile
// (Tp / tile_rows,) int32, nondecreasing -> dxs (Tp, D), dw1 (E, D, H), db1
// (E, H) f32, dw2 (E, H, D), db2 (E, D) f32; xs, dy, w1, w2, dxs, dw1, dw2
// of one activation dtype, bf16 (is_bf16 = 1) or f32. Workspace from the
// caller: ws_dh, ws_g (Tp, H) in the activation dtype, ws_db1 (Tp / 128, H)
// f32, and, with splits > 1, ws_dw (splits, 2, E, D * H) f32 (the dW
// products split over each expert's rows; splits = 1 takes none). All
// contiguous and 16-byte aligned; D is 192, 384 or 768 (bf16 on the tensor
// cores, f32 in split TF32 on them), H a multiple of 64, tile_rows and Tp
// multiples of 256 in bf16 and of 128 in f32.
extern "C" int ssmv_expert_ffn_bwd(const void* xs, const void* dy,
                                   const void* w1, const void* b1,
                                   const void* w2, const void* e_of_tile,
                                   void* dxs, void* dw1, void* db1, void* dw2,
                                   void* db2, void* ws_dh, void* ws_g,
                                   void* ws_db1, void* ws_dw, int splits,
                                   int Tp, int D, int H, int E, int tile_rows,
                                   int is_bf16, void* stream) {
  return dispatch<false, false>(xs, nullptr, nullptr, dy, w1, b1, w2,
                                e_of_tile, dxs, dw1, db1, dw2, db2, ws_dh,
                                ws_g, ws_db1, ws_dw, splits, Tp, D, H, E,
                                tile_rows, is_bf16, stream);
}

// K9 backward: x (T, D) tokens and gather_idx (Tp,) int64, each in [0, T);
// dy and the returned dxs in layout (slot) space, (Tp, D); the rest as K4.
// Layout row s reads x row gather_idx[s].
extern "C" int ssmv_expert_ffn_bwd_gather(
    const void* x, const void* gather_idx, const void* dy, const void* w1,
    const void* b1, const void* w2, const void* e_of_tile, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_g,
    void* ws_db1, void* ws_dw, int splits, int Tp, int D, int H, int E,
    int tile_rows, int is_bf16, void* stream) {
  return dispatch<true, false>(x, gather_idx, nullptr, dy, w1, b1, w2,
                               e_of_tile, dxs, dw1, db1, dw2, db2, ws_dh,
                               ws_g, ws_db1, ws_dw, splits, Tp, D, H, E,
                               tile_rows, is_bf16, stream);
}

// K10 backward: tile_perm (Tp / tile_rows,) int32, a permutation of the row
// tiles, and e_of_step (Tp / tile_rows,) int32, the nondecreasing expert of
// the tile visited at step i; xs, dy and the returned dxs in xs's own row
// order; the workspace in step order; the rest as K4.
extern "C" int ssmv_expert_ffn_bwd_perm(
    const void* xs, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* e_of_step, const void* tile_perm, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, void* ws_dh, void* ws_g,
    void* ws_db1, void* ws_dw, int splits, int Tp, int D, int H, int E,
    int tile_rows, int is_bf16, void* stream) {
  return dispatch<false, true>(xs, nullptr, tile_perm, dy, w1, b1, w2,
                               e_of_step, dxs, dw1, db1, dw2, db2, ws_dh,
                               ws_g, ws_db1, ws_dw, splits, Tp, D, H, E,
                               tile_rows, is_bf16, stream);
}
