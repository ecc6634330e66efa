// Per-expert FFN backward with the dW products taken on chip, with no
// (Tp, H) workspace (K8).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/fused_ffn.py
// _bwd_kernel_defer (:312) with its flags _bwd_flags (:285), reached
// through _bwd(defer_dw=True) (:374, call :467) from _ffn_bwd (:834) when
// SSMV_DEFER_DW=1. It computes K4's function (expert_ffn_bwd.cu has the
// math): dx, dW1, db1, dW2, db2 of y = GELU(x . W1[e] + b1[e]) . W2[e] +
// b2[e] over the tile-aligned expert layout. What makes it K8: the TPU
// kernel takes the dW products over pairs of consecutive same-expert
// 256-row tiles (K = 512 rows) as the flags direct, from x, dh, g =
// GELU(h) and dy held in VMEM, where K4 writes dh and g to a (Tp, H)
// workspace in device memory and reads them back. At cfg4 (Tp = 63,488,
// H = 1,536) that workspace is 390 MB a call; K8 allocates nothing but
// its outputs.
//
// What bounds it on the H100: the FLOPs. Without the workspace h and
// dy . W2^T are computed twice, once for dx and once for dW: 14 x D x H
// flops a row against the function's 10 (the bound counts 10). Blocks on
// the card run in no order, and a block cannot hold both a row block's dx
// (all of H) and a hidden chunk's dW (all of an expert's rows), so K8 is
// two kernels, both on mma.sync m16n8k16 (bf16 in, f32 sums; mma_sync.cuh)
// fed by cp.async, 16 warps a block:
//  (a) dgrad: one block per RS rows (one expert), dx's RS x D f32 sums in
//      registers across all of H. The rows' x and dy stay in shared
//      memory; H streams in 32-column chunks of W1[:, chunk] (double-
//      buffered; it serves h = x . W1 and dx += bf16(dh) . W1^T) and
//      W2[chunk, :]. Per chunk: h and p = dy . W2^T (phase A), the erf
//      GELU' epilogue into a bf16 dh tile, dx's product (phase B).
//  (b) dW: one block per (expert, 32-64 hidden columns), the columns'
//      W1 and W2 slices resident, the expert's rows through a ring of
//      32-row steps of x and dy. Per step: h and p of the step's
//      rows (phase A), the epilogue's bf16(dh), bf16(g) and the f32 db1 /
//      db2 column sums, then dW1[:, cols] += x^T . bf16(dh) and
//      dW2[cols, :]^T += dy^T . bf16(g) (phase B; dW2 transposed, so both
//      products tile alike) with both accumulators in registers, stored
//      through shared memory as whole rows at the end.
// Phase A's products go to f32 scratch tiles, so that one epilogue
// thread owns both h and p of an element (phase A's warps take one
// product each). At D = 768 neither kernel fits a block's x and dy at
// full width in shared memory, so a cluster of two blocks splits D: block
// r holds columns [384 r, 384 r + 384) of x, dy, W1's rows and W2's
// columns, takes h and p over its half of K, and sends each partial sum to
// the block that reduces its column (distributed shared memory); that
// block adds the two in rank order and writes bf16(dh) (and bf16(g)) into
// both blocks' tiles. Each block then sums its half of dx's columns (a)
// or of dW's rows (b).
// What set the tiling (NVIDIA H100 80GB HBM3, 700 W; at cfg4's layout,
// Tp = 63,488, unless named; scripts/ffn_bwd_defer_tilings.py times the
// tilings kept in its TILINGS, and PERF.md names the run each number
// comes from):
//  - Registers bound the dW block: dW1[:, cols] and dW2[cols, :]^T are
//    2 x D x HW f32, 24,576 in a 16-warp block (48 a thread): HW = 64 at
//    D = 192, 32 at D = 384 and (a cluster's 384 columns of D a block) at
//    D = 768. Shared memory bounds the rows: 32 rows of x and dy at
//    D = 384 are 50 KB a ring stage.
//  - Both kernels move more operand bytes on chip than they multiply:
//    phase A's output per chunk or step is only 64 or 32 rows by 32
//    columns a product, over K = D, so its warp tiles are 16 x 16 to
//    16 x 32 (0.19-0.25 bytes of ldmatrix a multiply-add, against 0.10 for
//    phase B's 32 x 48 and 48 x 32 tiles).
//  - Taken: the dgrad's phase A in 16 x 32 tiles over half of K each (two
//    scratch slots a product): 1.4613 ms against 1.5107 for 16 x 16 tiles
//    over all of K (TILINGS' d384_g16). The dW ring's depth (two or three
//    stages, d384_w3) and 32-wide phase A tiles over a quarter of K each
//    (d384_w32k4) moved it by at most 3% either way from layout to
//    layout, within the runs' spread; the first form is kept.
//  - Losers: a cluster of two blocks splitting D at D = 384 as well (192
//    columns a block, so 128 rows a dgrad block and 64 hidden columns a
//    dW cluster, half the L2 and ldmatrix traffic a row; d384_cl2):
//    4.9593 ms against 3.3227, since the step's two cluster barriers and
//    the distributed shared-memory stores cost more than they save;
//    clusters of four at
//    D = 768: 8.33 ms against 6.87; the first form at D = 768, every
//    partial sum sent to every block (each reducing all columns) and dW2
//    stored element by element from the registers: 8.26 ms; the dW sums
//    split over the rows (f32 partials of each split, a third kernel
//    adding them in split order): 3.3804 ms against 3.3227 at cfg4 (2
//    splits), 2.9757 against 2.8814 dropless (2), 0.9653 against 0.9610
//    at D = 192 (moe_tiny's dropless layout at B = 128, 3 splits; its 96
//    dW blocks sit one to an SM, so 288 still take three waves of a third
//    of the work each), so every block walks all of its expert's rows;
//    (b) in two warp groups as K3 (4 warps taking h, p and the epilogue of
//    step t + 1 while 8 warps add step t's dW products, on mbarriers; 384
//    threads, 166 registers): 1.8487 ms against 1.8221 at cfg4 and 1.5819
//    against 1.6051 dropless, since the h group's own products over K = D
//    then set the pace. For (a) the same split was not built: its h group
//    would carry four times the dx group's work a warp, and the rows' x
//    and dy leave no shared memory for a third W1 buffer.
// The sums run in a fixed order: dx over H in chunk order, dW and db over
// an expert's rows in 32-row steps in row order, each scratch sum in slot
// order. No atomics, so two calls agree bit for bit.
// This is not the TPU kernel's order (a flush per tile pair, the pairs
// added into the dW window in turn): the divergence is recorded in
// ROADMAP.md (Queue 3), as K4's is. An expert with no tokens owns one
// all-padding tile (dy zero): its dW and db come out as exact zeros; an
// expert owning no tile at all sums over no rows and is written as zeros
// too. The bf16 kernels need no flags (they take every row of the
// expert); the f32 SIMT form follows the flags that the wrapper computes
// from e_of_tile as _bwd_flags gives them.
//
// f32 at every D takes the SIMT forms: the SIMT dgrad of
// expert_ffn_dgrad.cuh, then the SIMT deferred-dW kernel below, which
// walks its expert's tiles as the flags direct.
#include "expert_ffn_dgrad.cuh"
#include "mma_sync.cuh"

namespace {

using namespace ssmv_ffn;
using namespace ssmv::tc;

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kTC = 512;        // threads of a tensor-core block: 16 warps
constexpr int kTW = kTC / 32;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// every thread of the block (CL = 1) or of the cluster (CL > 1)
template <int CL>
__device__ __forceinline__ void group_sync() {
  if constexpr (CL == 1)
    __syncthreads();
  else
    cluster_sync();
}

// two floats to this offset of block `rank`'s shared memory
__device__ __forceinline__ void st_cluster_f2(const void* local, uint32_t rank,
                                              float a, float b) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " st.shared::cluster.v2.f32 [ra], {%2, %3};\n}\n" ::"r"(smem_u32(local)),
      "r"(rank), "f"(a), "f"(b)
      : "memory");
}

// acc = A[16 rows, k in [k0, k1)] . B[k, n0 + (0..AN)]: A m-major (row
// stride lda), B k-major (kBkm: W1's rows) or n-major (W2's rows); one warp
template <bool kBkm, int AN>
__device__ __forceinline__ void tile_product(float (&acc)[AN / 8][4],
                                             const bf16* A, int lda,
                                             const bf16* B, int ldb, int n0,
                                             int k0, int k1) {
#pragma unroll
  for (int j = 0; j < AN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; k += 16) {
    uint32_t a[4];
    ld_a(a, A, lda, k);
#pragma unroll
    for (int jj = 0; jj < AN / 16; ++jj) {
      uint32_t b[4];
      if (kBkm)
        ld_b_kn(b, B, ldb, k, n0 + jj * 16);
      else
        ld_b_nk(b, B, ldb, n0 + jj * 16, k);
      mma(acc[2 * jj], a, b[0], b[1]);
      mma(acc[2 * jj + 1], a, b[2], b[3]);
    }
  }
}

// a 4-byte store to this offset of block `rank`'s shared memory
__device__ __forceinline__ void st_cluster_u32(const void* local,
                                               uint32_t rank, uint32_t v) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " st.shared::cluster.u32 [ra], %2;\n}\n" ::"r"(smem_u32(local)),
      "r"(rank), "r"(v)
      : "memory");
}

// The partial-sum scratch of a cluster of CL blocks: a chunk's W hidden
// columns are split into CL parts of W / CL, block r reduces part r. Each
// block owns CL slots (one a source block, x KS slices of K within a
// block) of the 2 products' RS x (W / CL) partial sums, rows padded by 4.
template <int CL, int W, int RS>
struct Scratch {
  static constexpr int COLS = W / CL, LD = COLS + 4;
  static constexpr int SLOT = 2 * RS * LD;  // floats
  static_assert(COLS % 8 == 0, "an 8-column n-tile in one block's part");
};

// A warp's 16 x AN tile of product q (rows m0.., the chunk's columns
// n0..), this block's partial sums over its slice `slot` of K, into slot
// `slot` of the block that reduces each column (CL = 1: this block)
template <int CL, int W, int RS, int AN>
__device__ __forceinline__ void put_partial(float* sc, int slot, int q,
                                            int m0, int n0,
                                            const float (&acc)[AN / 8][4]) {
  using S = Scratch<CL, W, RS>;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < AN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * tq;
    float* base = sc + (slot * 2 + q) * RS * S::LD + col % S::COLS;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* p = base + (m0 + g + 8 * hh) * S::LD;
      const float a = acc[j][2 * hh], b = acc[j][2 * hh + 1];
      if constexpr (CL == 1)
        *reinterpret_cast<float2*>(p) = make_float2(a, b);
      else
        st_cluster_f2(p, col / S::COLS, a, b);
    }
  }
}

// h and p of row r, this block's columns c, c + 1 of its part: the slots'
// sums added in slot order
template <int CL, int W, int RS, int NSLOT>
__device__ __forceinline__ void sum_slots(const float* sc, int r, int c,
                                          float (&h)[2], float (&p)[2]) {
  using S = Scratch<CL, W, RS>;
  h[0] = h[1] = p[0] = p[1] = 0.f;
#pragma unroll
  for (int s = 0; s < NSLOT; ++s) {
    const float2 hv = *reinterpret_cast<const float2*>(
        sc + ((s * 2) * RS + r) * S::LD + c);
    const float2 pv = *reinterpret_cast<const float2*>(
        sc + ((s * 2 + 1) * RS + r) * S::LD + c);
    h[0] += hv.x, h[1] += hv.y, p[0] += pv.x, p[1] += pv.y;
  }
}

// two bf16 to this offset of every block of the cluster
template <int CL>
__device__ __forceinline__ void put_all(bf16* p, uint32_t v) {
  if constexpr (CL == 1) {
    *reinterpret_cast<uint32_t*>(p) = v;
  } else {
#pragma unroll
    for (uint32_t q = 0; q < CL; ++q) st_cluster_u32(p, q, v);
  }
}

// (a) The dgrad kernel's tiling. A block (a cluster of CL blocks) owns RS
// rows of the layout, all of one expert; block r of the cluster holds the
// columns [r DC, (r + 1) DC) of the rows' x and dy and sums those columns
// of dx. Per hidden chunk of HC columns: phase A, h = x . W1[:, chunk] and
// p = dy . W2[chunk, :]^T over the block's DC (warp = product x K slice of
// DC / KS x 16-row tile x AN-column tile) into the scratch (Scratch:
// partial sums sent to the block that reduces their columns); the
// epilogue adds a part's CL x KS slots in order and takes bf16(dh) =
// bf16(p * gelu'(h + b1)) into every block's dh tile; phase B, dx += bf16(dh) .
// W1[cols, chunk]^T (warps 32 x 48 of the RS x DC accumulator, f32 in registers
// across all of H). The W1 chunk serves both phases (k-major for h, n-major for
// dx); two W1 buffers and one W2 buffer, the next chunk's W1 copied during this
// chunk and its W2 during this chunk's epilogue and phase B.
template <int DC_, int RS_, int HC_, int AN_, int KS_, int CL_>
struct Dgrad {
  static constexpr int DC = DC_, RS = RS_, HC = HC_, AN = AN_, KS = KS_;
  static constexpr int CL = CL_;
  static constexpr int D = DC * CL;
  using S = Scratch<CL, HC, RS>;
  static constexpr int XLD = DC + 8, W1LD = HC + 8, W2LD = DC + 8;
  static constexpr int DHLD = HC + 8;
  static constexpr int BWM = RS / 32, BWN = kTW / BWM, BN = DC / BWN;
  static constexpr int W1SZ = DC * W1LD;  // one W1 buffer, elements
  static constexpr size_t X = 0;
  static constexpr size_t DY = X + 2 * RS * XLD;
  static constexpr size_t W1 = DY + 2 * RS * XLD;
  static constexpr size_t W2 = W1 + 2 * 2 * W1SZ;
  static constexpr size_t SC = W2 + 2 * HC * W2LD;
  static constexpr size_t DH = SC + 4 * CL * KS * S::SLOT;
  static constexpr size_t SMEM = DH + 2 * RS * DHLD;
  static_assert(2 * KS * (RS / 16) * (HC / AN) == kTW,
                "phase A: a tile a warp");
  static_assert(RS % 32 == 0 && BN == 48 && 256 % RS == 0, "phase B tiles");
  static_assert(AN % 16 == 0 && HC % AN == 0 && DC % (16 * KS) == 0,
                "mma tiles");
  static_assert(DY % 16 == 0 && W1 % 16 == 0 && W2 % 16 == 0 &&
                    SC % 16 == 0 && DH % 16 == 0,
                "16-byte aligned tiles");
  static_assert(SMEM <= ssmv::kMaxSmemBytes, "shared memory budget");
};

// Grid Tp / RS * CL, clusters of CL.
template <class L>
__global__ void __launch_bounds__(kTC, 1)
defer_dgrad_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy,
                   const bf16* __restrict__ w1, const float* __restrict__ b1,
                   const bf16* __restrict__ w2,
                   const int* __restrict__ e_of_tile, bf16* __restrict__ dxs,
                   int H, int tile_rows) {
  using S = typename L::S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem + L::X);
  bf16* DYs = reinterpret_cast<bf16*>(smem + L::DY);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* SCs = reinterpret_cast<float*>(smem + L::SC);
  bf16* DHs = reinterpret_cast<bf16*>(smem + L::DH);
  const int rank = L::CL == 1 ? 0 : (int)cluster_rank();
  const int row0 = blockIdx.x / L::CL * L::RS;
  const int e = e_of_tile[row0 / tile_rows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = rank * L::DC;  // this block's columns of D
  const bf16* w1e = w1 + ((size_t)e * L::D + d0) * H;
  const bf16* w2e = w2 + (size_t)e * H * L::D + d0;
  const float* b1e = b1 + (size_t)e * H;
  if constexpr (L::CL > 1) cluster_sync();  // every block has started

  constexpr int V = L::DC / 8;  // 16-byte vectors of a row's DC columns
  for (int i = tid; i < L::RS * V; i += kTC) {
    const int r = i / V, v = i % V * 8;
    const size_t src = (size_t)(row0 + r) * L::D + d0 + v;
    cp_async16(Xs + r * L::XLD + v, xs + src, true);
    cp_async16(DYs + r * L::XLD + v, dy + src, true);
  }
  const auto load_w1 = [&](int c0, bf16* dst) {  // W1[e][d0 + d][c0 + n]
    constexpr int VC = L::HC / 8;
    for (int i = tid; i < L::DC * VC; i += kTC) {
      const int d = i / VC, v = i % VC * 8;
      cp_async16(dst + d * L::W1LD + v, w1e + (size_t)d * H + c0 + v, true);
    }
  };
  const auto load_w2 = [&](int c0) {  // W2[e][c0 + n][d0 + k]
    for (int i = tid; i < L::HC * V; i += kTC) {
      const int n = i / V, v = i % V * 8;
      cp_async16(W2s + n * L::W2LD + v, w2e + (size_t)(c0 + n) * L::D + v,
                 true);
    }
  };
  load_w1(0, W1s);
  load_w2(0);
  cp_async_commit();

  // phase A: warp = (product q: h or p, K slice ks, 16-row tile mi, AN
  // columns ni)
  constexpr int NI = L::HC / L::AN, TMN = L::RS / 16 * NI;
  constexpr int KW = L::DC / L::KS;
  const int q = warp >> 3, ks = (warp & 7) / TMN;
  const int mi = (warp & 7) % TMN / NI, ni = (warp & 7) % NI;
  // epilogue: this thread's column pair of this block's part, first row
  constexpr int CP = S::COLS / 2, RSTEP = kTC / CP;
  const int ec = tid % CP * 2, er = tid / CP;
  const int gc = rank * S::COLS + ec;  // the pair's column in the chunk
  // phase B: this warp's 32 x 48 tile of dx
  const int bm = warp / L::BWN, bn = warp % L::BWN;
  float dx[2][6][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dx[i][j][c] = 0.f;

  const int n_chunks = H / L::HC;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * L::HC;
    const bf16* W1c = W1s + (c & 1) * L::W1SZ;
    cp_async_wait<0>();  // this chunk's W1 and W2 (and x, dy) landed
    __syncthreads();     // ... for all; the last chunk's phase B is done
    if (c + 1 < n_chunks) load_w1(c0 + L::HC, W1s + ((c + 1) & 1) * L::W1SZ);
    cp_async_commit();
    {
      float acc[L::AN / 8][4];
      if (q == 0)
        tile_product<true, L::AN>(acc, Xs + mi * 16 * L::XLD, L::XLD, W1c,
                                  L::W1LD, ni * L::AN, ks * KW,
                                  (ks + 1) * KW);
      else
        tile_product<false, L::AN>(acc, DYs + mi * 16 * L::XLD, L::XLD, W2s,
                                   L::W2LD, ni * L::AN, ks * KW,
                                   (ks + 1) * KW);
      put_partial<L::CL, L::HC, L::RS, L::AN>(SCs, rank * L::KS + ks, q,
                                              mi * 16, ni * L::AN, acc);
    }
    group_sync<L::CL>();  // the partial sums are in; W2 is read
    if (c + 1 < n_chunks) load_w2(c0 + L::HC);
    cp_async_commit();
    const float2 bias = *reinterpret_cast<const float2*>(b1e + c0 + gc);
#pragma unroll
    for (int r = er; r < L::RS; r += RSTEP) {
      float h[2], p[2];
      sum_slots<L::CL, L::HC, L::RS, L::CL * L::KS>(SCs, r, ec, h, p);
      float gv, dg0, dg1;
      gelu_pair(h[0] + bias.x, &gv, &dg0);
      gelu_pair(h[1] + bias.y, &gv, &dg1);
      put_all<L::CL>(DHs + r * L::DHLD + gc, pack2(p[0] * dg0, p[1] * dg1));
    }
    group_sync<L::CL>();  // bf16(dh) is complete; the slots are read
#pragma unroll
    for (int k = 0; k < L::HC; k += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ld_a(a[i], DHs + (bm * 32 + i * 16) * L::DHLD, L::DHLD, k);
#pragma unroll
      for (int jj = 0; jj < 3; ++jj) {
        uint32_t b[4];
        ld_b_nk(b, W1c, L::W1LD, bn * 48 + jj * 16, k);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(dx[i][2 * jj], a[i], b[0], b[1]);
          mma(dx[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      bf16* out = dxs + (size_t)(row0 + bm * 32 + i * 16 + g + hh * 8) * L::D +
                  d0 + bn * 48 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        *reinterpret_cast<uint32_t*>(out + j * 8) =
            pack2(dx[i][j][2 * hh], dx[i][j][2 * hh + 1]);
    }
}

// (b) The dW kernel's tiling. A block (a cluster of CL blocks) owns HW
// hidden columns of one expert over all of its tiles; block r of
// the cluster holds the columns [r DC, (r + 1) DC) of x, dy, W1[:, cols]'s
// rows and W2[cols, :]'s columns, and sums those rows of dW1[:, cols] and
// dW2[cols, :]^T. W1[:, cols] and W2[cols, :] stay in shared memory; the
// expert's rows come through a ring of NB stages of RS rows of x and dy
// (the block's DC columns). Per step: phase A, h and p of the RS rows
// over the block's DC (warp = product x K slice of DC / KS x 16-row tile x
// AN-column tile) into the scratch (Scratch); the epilogue adds a part's
// slots in order and takes bf16(dh) and bf16(gelu(h + b1)) into every block's
// tiles, the f32 dh's column sums (db1) in registers; the block that holds
// dy's columns [cb HW, (cb + 1) HW) sums them too (db2); phase B,
// dW1[:, cols] += x^T . bf16(dh) and dW2[cols, :]^T += dy^T . bf16(g) (8
// warps a product, 48 x 32 each of the DC x HW accumulator, f32 in
// registers). At the end both accumulators pass through shared memory to
// be stored as whole rows.
template <int DC_, int HW_, int RS_, int AN_, int KS_, int NB_, int CL_>
struct Dw {
  static constexpr int DC = DC_, HW = HW_, RS = RS_, AN = AN_, KS = KS_;
  static constexpr int NB = NB_, CL = CL_, D = DC * CL;
  using S = Scratch<CL, HW, RS>;
  static constexpr int XLD = DC + 8, W1LD = HW + 8, W2LD = DC + 8;
  static constexpr int GLD = HW + 8, OLD = HW + 4;
  static constexpr int STAGE = 2 * RS * XLD;  // a ring stage, elements
  static constexpr size_t W1 = (size_t)2 * NB * STAGE;
  static constexpr size_t W2 = W1 + 2 * DC * W1LD;
  static constexpr size_t SC = W2 + 2 * HW * W2LD;
  static constexpr size_t DH = SC + 4 * CL * KS * S::SLOT;
  static constexpr size_t G = DH + 2 * RS * GLD;
  static constexpr size_t SMEM = G + 2 * RS * GLD;
  static_assert(2 * KS * (RS / 16) * (HW / AN) == kTW && AN % 16 == 0,
                "phase A tiles");
  static_assert((DC / 48) * (HW / 32) == kTW / 2 && DC % 48 == 0,
                "phase B: 8 warps of 48 x 32 a product");
  static_assert(DC % (16 * KS) == 0 && 256 % RS == 0 && NB >= 2, "steps");
  static_assert(4 * DC * OLD <= W1 && 4 * kTC <= CL * KS * S::SLOT,
                "the output staging fits in the ring, the db sums' in the "
                "scratch");
  static_assert(W1 % 16 == 0 && W2 % 16 == 0 && SC % 16 == 0 &&
                    DH % 16 == 0 && G % 16 == 0,
                "16-byte aligned tiles");
  static_assert(SMEM <= ssmv::kMaxSmemBytes, "shared memory budget");
};

// Grid E * (H / HW) * CL, clusters of CL: cluster (e, cb) takes hidden
// columns [cb HW, (cb + 1) HW) over all the tiles of expert e, into dw1,
// dw2 (bf16) and db1, db2 (f32).
template <class L>
__global__ void __launch_bounds__(kTC, 1)
defer_dw_kernel(const bf16* __restrict__ xs, const bf16* __restrict__ dy,
                const bf16* __restrict__ w1, const float* __restrict__ b1,
                const bf16* __restrict__ w2,
                const int* __restrict__ e_of_tile, int n_tiles, int tile_rows,
                bf16* __restrict__ dw1, float* __restrict__ db1,
                bf16* __restrict__ dw2, float* __restrict__ db2, int H) {
  using S = typename L::S;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* W1s = reinterpret_cast<bf16*>(smem + L::W1);
  bf16* W2s = reinterpret_cast<bf16*>(smem + L::W2);
  float* SCs = reinterpret_cast<float*>(smem + L::SC);
  bf16* DHs = reinterpret_cast<bf16*>(smem + L::DH);
  bf16* Gs = reinterpret_cast<bf16*>(smem + L::G);
  const int rank = L::CL == 1 ? 0 : (int)cluster_rank();
  const int n_cb = H / L::HW, cluster = blockIdx.x / L::CL;
  const int cb = cluster % n_cb, e = cluster / n_cb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = cb * L::HW, d0 = rank * L::DC;

  // the expert's tiles: e_of_tile is nondecreasing, so they are the
  // [#tiles with e_of_tile < e, + #tiles with e_of_tile == e) range
  int first = 0, count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kTC) {
    const int t = t0 + tid;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }
  const int r_begin = first * tile_rows;
  const int n_steps = count * tile_rows / L::RS;
  if constexpr (L::CL > 1) cluster_sync();  // every block has started

  const bf16* w1e = w1 + ((size_t)e * L::D + d0) * H + c0;
  const bf16* w2e = w2 + ((size_t)e * H + c0) * L::D + d0;
  constexpr int V = L::DC / 8, VW = L::HW / 8;
  for (int i = tid; i < L::DC * VW; i += kTC) {  // W1[e][d0 + d][c0 + n]
    const int d = i / VW, v = i % VW * 8;
    cp_async16(W1s + d * L::W1LD + v, w1e + (size_t)d * H + v, true);
  }
  for (int i = tid; i < L::HW * V; i += kTC) {  // W2[e][c0 + n][d0 + k]
    const int n = i / V, v = i % V * 8;
    cp_async16(W2s + n * L::W2LD + v, w2e + (size_t)n * L::D + v, true);
  }
  const auto issue = [&](int t) {  // step t's x and dy rows, one group
    if (t < n_steps) {
      bf16* st = ring + (t % L::NB) * L::STAGE;
      const size_t row = (size_t)r_begin + (size_t)t * L::RS;
      for (int i = tid; i < L::RS * V; i += kTC) {
        const int r = i / V, v = i % V * 8;
        const size_t src = (row + r) * L::D + d0 + v;
        cp_async16(st + r * L::XLD + v, xs + src, true);
        cp_async16(st + (L::RS + r) * L::XLD + v, dy + src, true);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < L::NB - 1; ++t) issue(t);

  // phase A: warp = (product q, K slice ks, 16-row tile mi, AN columns ni)
  constexpr int TM = L::RS / 16, TN = L::HW / L::AN;
  const int q = warp >> 3;
  const int ks = (warp & 7) / (TM * TN), mi = (warp & 7) % (TM * TN) / TN;
  const int ni = (warp & 7) % TN;
  constexpr int KW = L::DC / L::KS;
  // epilogue: this thread's column pair of this block's part, first row
  constexpr int CP = S::COLS / 2, RSTEP = kTC / CP;
  const int ec = tid % CP * 2, er = tid / CP;
  const int gc = rank * S::COLS + ec;  // the pair's column among the HW
  const float2 bias =
      *reinterpret_cast<const float2*>(b1 + (size_t)e * H + c0 + gc);
  // db2: dy's columns [c0, c0 + HW) of D, in the block whose slice holds
  // them; this thread's pair of them and first row
  const bool has_db2 = c0 >= d0 && c0 < d0 + L::DC;
  constexpr int CP2 = L::HW / 2, RSTEP2 = kTC / CP2;
  const int ec2 = tid % CP2 * 2, er2 = tid / CP2;
  float db1s[2] = {0.f, 0.f}, db2s[2] = {0.f, 0.f};
  // phase B: this warp's 48 x 32 tile of dW1[:, cols] (q = 0) or of
  // dW2[cols, :]^T (q = 1)
  const int bm = (warp & 7) / (L::HW / 32), bn = (warp & 7) % (L::HW / 32);
  float acc[3][4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<L::NB - 2>();  // step t (and the weights) landed
    __syncthreads();             // ... for all; step t - 1 is done
    issue(t + L::NB - 1);        // into the stage step t - 1 used
    const bf16* Xt = ring + (t % L::NB) * L::STAGE;
    const bf16* DYt = Xt + L::RS * L::XLD;
    {
      float a2[L::AN / 8][4];
      if (q == 0)
        tile_product<true, L::AN>(a2, Xt + mi * 16 * L::XLD, L::XLD, W1s,
                                  L::W1LD, ni * L::AN, ks * KW,
                                  (ks + 1) * KW);
      else
        tile_product<false, L::AN>(a2, DYt + mi * 16 * L::XLD, L::XLD, W2s,
                                   L::W2LD, ni * L::AN, ks * KW,
                                   (ks + 1) * KW);
      put_partial<L::CL, L::HW, L::RS, L::AN>(SCs, rank * L::KS + ks, q,
                                              mi * 16, ni * L::AN, a2);
    }
    group_sync<L::CL>();  // the partial sums are in
#pragma unroll
    for (int r = er; r < L::RS; r += RSTEP) {
      float h[2], p[2];
      sum_slots<L::CL, L::HW, L::RS, L::CL * L::KS>(SCs, r, ec, h, p);
      float gv[2], dh[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float dg;
        gelu_pair(h[c] + (c ? bias.y : bias.x), &gv[c], &dg);
        dh[c] = p[c] * dg;
        db1s[c] += dh[c];
      }
      put_all<L::CL>(DHs + r * L::GLD + gc, pack2(dh[0], dh[1]));
      put_all<L::CL>(Gs + r * L::GLD + gc, pack2(gv[0], gv[1]));
    }
    if (has_db2) {
#pragma unroll
      for (int r = er2; r < L::RS; r += RSTEP2) {
        const __nv_bfloat162 y2 = *reinterpret_cast<const __nv_bfloat162*>(
            DYt + r * L::XLD + c0 - d0 + ec2);
        db2s[0] += __low2float(y2);
        db2s[1] += __high2float(y2);
      }
    }
    group_sync<L::CL>();  // bf16(dh) and bf16(g) complete; slots read
    const bf16* At = q ? DYt : Xt;
    const bf16* Bt = q ? Gs : DHs;
#pragma unroll
    for (int k = 0; k < L::RS; k += 16) {
      uint32_t a[3][4];
#pragma unroll
      for (int i = 0; i < 3; ++i) ld_a_t(a[i], At, L::XLD, k, bm * 48 + i * 16);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t b[4];
        ld_b_kn(b, Bt, L::GLD, k, bn * 32 + jj * 16);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          mma(acc[i][2 * jj], a[i], b[0], b[1]);
          mma(acc[i][2 * jj + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // dW: product q's DC x HW tile through shared memory (f32, over the
  // ring), then out as whole rows: dW1[e][d0 + m][c0 .. c0 + HW) (q = 0),
  // dW2[e][c0 + n][d0 .. d0 + DC) (q = 1)
  const int g = lane >> 2, tq = lane & 3;
  const size_t per_e = (size_t)L::D * H;  // one expert's dW1 or dW2
  float* ost = reinterpret_cast<float*>(smem);
#pragma unroll 1
  for (int qq = 0; qq < 2; ++qq) {
    __syncthreads();  // the ring (and the last product's staging) is free
    if (q == qq) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(
                ost + (bm * 48 + i * 16 + g + hh * 8) * L::OLD + bn * 32 +
                j * 8 + 2 * tq) =
                make_float2(acc[i][j][2 * hh], acc[i][j][2 * hh + 1]);
    }
    __syncthreads();
    bf16* ow = (qq ? dw2 : dw1) + (size_t)e * per_e;
    if (qq == 0) {  // rows m of DC, 4 columns a thread
      for (int i = tid; i < L::DC * (L::HW / 4); i += kTC) {
        const int m = i / (L::HW / 4), n = i % (L::HW / 4) * 4;
        const float4 v = *reinterpret_cast<const float4*>(ost + m * L::OLD + n);
        *reinterpret_cast<uint2*>(ow + (size_t)(d0 + m) * H + c0 + n) =
            make_uint2(pack2(v.x, v.y), pack2(v.z, v.w));
      }
    } else {  // rows n of HW, 4 columns m a thread
      for (int i = tid; i < L::HW * (L::DC / 4); i += kTC) {
        const int n = i / (L::DC / 4), m = i % (L::DC / 4) * 4;
        const float v0 = ost[m * L::OLD + n], v1 = ost[(m + 1) * L::OLD + n];
        const float v2 = ost[(m + 2) * L::OLD + n];
        const float v3 = ost[(m + 3) * L::OLD + n];
        *reinterpret_cast<uint2*>(ow + (size_t)(c0 + n) * L::D + d0 + m) =
            make_uint2(pack2(v0, v1), pack2(v2, v3));
      }
    }
  }

  // db1 (this block's part of the columns) and db2: the threads of a
  // column pair added in row order
  float* red = SCs;
  red[tid * 2] = db1s[0];
  red[tid * 2 + 1] = db1s[1];
  red[2 * kTC + tid * 2] = db2s[0];
  red[2 * kTC + tid * 2 + 1] = db2s[1];
  __syncthreads();
  if (tid < S::COLS) {
    float s1 = 0.f;
#pragma unroll 4
    for (int k = 0; k < RSTEP; ++k)
      s1 += red[(k * CP + tid / 2) * 2 + (tid & 1)];
    db1[(size_t)e * H + c0 + rank * S::COLS + tid] = s1;
  }
  if (has_db2 && tid < L::HW) {
    float s2 = 0.f;
#pragma unroll 4
    for (int k = 0; k < RSTEP2; ++k)
      s2 += red[2 * kTC + (k * CP2 + tid / 2) * 2 + (tid & 1)];
    db2[(size_t)e * L::D + c0 + tid] = s2;
  }
}

template <class K, typename... Args>
cudaError_t launch_cluster(K kernel, int grid, int cl, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kTC);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <class LG, class LW>
cudaError_t launch_tc(const void* xs, const void* dy, const void* w1,
                      const void* b1, const void* w2, const void* e_of_tile,
                      void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                      int Tp, int H, int E, int tile_rows,
                      cudaStream_t stream) {
  static_assert(LG::D == LW::D && LG::CL == LW::CL, "one width");
  if (H % LG::HC || H % LW::HW || tile_rows % LG::RS || tile_rows % LW::RS)
    return cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(xs);
  const bf16* d = static_cast<const bf16*>(dy);
  const bf16* u1 = static_cast<const bf16*>(w1);
  const bf16* u2 = static_cast<const bf16*>(w2);
  const float* c1 = static_cast<const float*>(b1);
  const int* eot = static_cast<const int*>(e_of_tile);
  cudaError_t err = launch_cluster(
      defer_dgrad_kernel<LG>, Tp / LG::RS * LG::CL, LG::CL, LG::SMEM, stream,
      x, d, u1, c1, u2, eot, static_cast<bf16*>(dxs), H, tile_rows);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)E * (H / LW::HW) * LW::CL;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(defer_dw_kernel<LW>, (int)grid, LW::CL, LW::SMEM,
                        stream, x, d, u1, c1, u2, eot, Tp / tile_rows,
                        tile_rows, static_cast<bf16*>(dw1),
                        static_cast<float*>(db1), static_cast<bf16*>(dw2),
                        static_cast<float*>(db2), H);
}

// The tilings the dispatch takes: Dgrad<DC, RS, HC, AN, KS, CL> and
// Dw<DC, HW, RS, AN, KS, NB, CL>
using Dgrad192 = Dgrad<192, 128, 32, 32, 1, 1>;
using Dgrad384 = Dgrad<384, 64, 32, 32, 2, 1>;
using Dgrad768 = Dgrad<384, 64, 32, 16, 1, 2>;
using Dw192 = Dw<192, 64, 32, 16, 1, 3, 1>;
using Dw384 = Dw<384, 32, 32, 16, 2, 2, 1>;
using Dw768 = Dw<384, 32, 32, 16, 2, 2, 2>;

// ---------------------------------------------------------------------------
// f32: the SIMT forms
// ---------------------------------------------------------------------------

// The SIMT deferred-dW kernel, beside the SIMT dgrad (f32 at every D):
// one block per (16-column hidden chunk, expert), the chunk's W1 (D x 17)
// and W2 (16 x D+1) columns on chip for the whole walk, the same
// flag-directed walk over the expert's tiles in 16-row steps (h and
// dy . W2^T recomputed, dh and g rounded to T), and dW1[:, chunk] and
// dW2[chunk, :] accumulated in registers (D / 8 a thread) with f32
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
  cudaError_t err = launch_dgrad_simt<T, D>(xs, dy, w1, b1, w2, e_of_tile,
                                            dxs, Tp, H, tile_rows, stream);
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


}  // namespace

// K8: xs, dy (Tp, D); w1 (E, D, H), b1 (E, H) f32, w2 (E, H, D); e_of_tile
// (Tp / tile_rows,) int32, nondecreasing; flags (Tp / tile_rows,) int32 from
// e_of_tile as _bwd_flags gives them, read in f32 only (bf16 takes null)
// -> dxs (Tp, D), dw1 (E, D, H), db1 (E, H) f32, dw2 (E, H, D), db2 (E, D)
// f32; xs, dy, w1, w2, dxs, dw1, dw2 of one activation dtype, bf16
// (is_bf16 = 1) or f32. All contiguous and 16-byte aligned; D is 192, 384
// or 768 (bf16 on the tensor cores, f32 in the SIMT form), H a multiple
// of 64 and at least D, tile_rows and Tp multiples of 256 in bf16 and of
// 64 in f32.
extern "C" int ssmv_expert_ffn_bwd_defer(
    const void* xs, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* e_of_tile, const void* flags, void* dxs,
    void* dw1, void* db1, void* dw2, void* db2, int Tp, int D, int H, int E,
    int tile_rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // H >= D: the first D / HW column blocks of each expert take db2
  if (Tp < kRows || Tp % kRows || H < 64 || H % 64 || H < D ||
      tile_rows % kRows || Tp % tile_rows || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
#define SSMV_TC_DEFER(DD)                                                  \
  if (D == DD)                                                             \
    return (int)launch_tc<Dgrad##DD, Dw##DD>(xs, dy, w1, b1, w2,           \
                                             e_of_tile, dxs, dw1, db1, dw2, \
                                             db2, Tp, H, E, tile_rows, s);
#define SSMV_SIMT_DEFER(DD)                                                \
  if (D == DD)                                                             \
    return (int)launch_simt<float, DD>(xs, dy, w1, b1, w2, e_of_tile,      \
                                       flags, dxs, dw1, db1, dw2, db2, Tp, \
                                       H, E, tile_rows, s);
  if (is_bf16) {
    SSMV_TC_DEFER(192)
    SSMV_TC_DEFER(384)
    SSMV_TC_DEFER(768)
  } else if (flags != nullptr) {
    SSMV_SIMT_DEFER(192)
    SSMV_SIMT_DEFER(384)
    SSMV_SIMT_DEFER(768)
  }
#undef SSMV_TC_DEFER
#undef SSMV_SIMT_DEFER
  return (int)cudaErrorInvalidValue;
}
