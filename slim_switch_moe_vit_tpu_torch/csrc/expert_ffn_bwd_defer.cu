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
// two kernels in either dtype. In bf16 both run on mma.sync m16n8k16 (bf16
// in, f32 sums; mma_sync.cuh) fed by cp.async, 16 warps a block:
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
// too. No kernel reads _bwd_flags' flags: every form takes all of its
// expert's rows in row order, the same sums over the same rows (the TPU's
// tile pairs only group them). The plain version still follows the flags
// (ops/fused_ffn.py::bwd_flags, held to JAX by the CPU tests).
//
// f32, at every D: the same two kernels on the tensor cores in split TF32
// (mma_tf32.cuh: three mma.sync.m16n8k8 a product on hi/lo TF32 parts),
// each k-step's three products summed into zeroed fragments and added to
// the accumulators on the CUDA cores (mma_group2_rn, mma_group_rn), as K3's
// and K4's f32 forms do: summed across all of k on the tensor cores, their
// error from the f64 function read 38-46x an f32 FMA chain's, and K8's
// sums are as long (K = D for h and p, H for dx, an expert's rows for dW).
// What bounds it: the function's 10 x D x H flops a row at the split-TF32
// rate, 164.9 TFLOP/s (0.531 ms at ViT-S, B = 32, Tp = 14,848); K8 takes
// 14. f32 doubles every tile, so the bf16 tilings do not fit (the dgrad's
// 64 resident rows of x and dy alone are 199 KB at D = 384):
//  (a) dgrad (DgradF32): K3's f32 forward with two A products. x and dy
//      stream in K1-deep slices beside the W1 and W2 slices of a hidden
//      chunk (x re-read per chunk from L2, not device memory); each warp
//      holds h and p of its 32 rows in registers, so gelu' runs on the C
//      fragments into an f32 dh tile; then dx += dh . W1[:, chunk]^T with
//      the chunk's W1 read once more, n-major, in K2-deep slices. dx's
//      sums stay in registers across all of H: 96 a thread of 8 warps at
//      BM = 64 and 32 rows at D = 384 and 768, 48 at 64 rows at D = 192.
//      No cluster.
//  (b) dW (DwF32): the bf16 kernel's structure with f32 tiles, in 8-warp
//      blocks. W1[:, cols] and W2[cols, :] stay resident (104 KB at D =
//      384, HW = 32), the rows come through a ring of 2 stages of 16 rows
//      (50 KB a stage at D = 384) or 32 rows (D = 192), and at D = 768 a
//      cluster of two splits D (384 columns a block, the D = 384 block's
//      layout). Phase A's warps split K into KS slices of 16 x 32 tiles
//      (an output of RS x HW is too small for 8 warps over all of K);
//      phase B's tiles are 96 x 32 of the dW accumulators (48 x 32 at
//      D = 192), 96 (48) sums a thread.
// What set the tilings (NVIDIA H100 80GB HBM3, 700 W; at the flagship's
// B = 32 layout, D = 384, unless named; scripts/ffn_f32_tilings.py times
// the losers below as its k8* variants, PERF.md names the runs): 8-warp
// dW blocks, 2.03 -> 1.75 ms (16 warps of 96 x 16 and 16 x 16 tiles split
// each fragment in more warps) and 13.9 -> 11.8 ms at D = 768; a 64-row
// dgrad block at D = 192, 1.50 -> 1.30 ms (128 rows: half the blocks, a
// last wave 5/8 full). Losers: 32-row dgrad blocks (1.92 ms against 1.42)
// or 32-column chunks (1.91); a cluster of two splitting D at 384 (dW
// 2.35 against 1.94, 16 warps both: the cluster barriers and distributed
// stores cost more than the halved row traffic saves) and of four at 768
// (15.8 against 13.6); phase A in 16 x 8 tiles over half of K (dW 2.34);
// k-steps unrolled (spills, or within 1%). What holds K8 at 0.16 of the
// bound where K4's f32 form reaches 0.28: it computes 14/10 of the flops
// the bound counts, its dW phase A products are small (16 or 32 rows by
// 32 columns over K = D, the same fragment split by every warp of a K
// slice), and each of its steps waits on two or three barriers.
#include "expert_ffn_dgrad.cuh"
#include "mma_sync.cuh"
#include "mma_tf32.cuh"

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
cudaError_t launch_cluster(K kernel, int grid, int threads, int cl,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
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
      defer_dgrad_kernel<LG>, Tp / LG::RS * LG::CL, kTC, LG::CL, LG::SMEM,
      stream,
      x, d, u1, c1, u2, eot, static_cast<bf16*>(dxs), H, tile_rows);
  if (err != cudaSuccess) return err;
  const long long grid = (long long)E * (H / LW::HW) * LW::CL;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(defer_dw_kernel<LW>, (int)grid, kTC, LW::CL, LW::SMEM,
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
// f32: split TF32 on the tensor cores (mma_tf32.cuh)
// ---------------------------------------------------------------------------

namespace tf = ssmv::tf32;

// n-tiles a swept group of the f32 products (mma_group2_rn)
constexpr int kGroupF32 = 2;

// (a) f32: the dgrad kernel's tiling, K3's f32 forward with two A products:
// BM rows a block (one expert), HC hidden columns a chunk, K1-deep A steps
// and K2-deep B steps through one ring of NS stages. An A step holds the x
// and dy slices (BM x K1, m-major), the W1 slice (K1 x HC, k-major) and the
// W2 slice (HC x K1, n-major: W2[chunk, :] is dy . W2^T's B); a B step the
// W1 slice (D x K2, n-major: dx's B is W1[:, chunk]^T). 8 warps WM x WN,
// each 32 rows of h and p (HN columns) and of dx (XN columns, all of H).
// Rows of m- and n-major tiles are 4 words past a multiple of 32, of
// k-major ones 8 past (mma_tf32.cuh).
template <int D_, int BM_, int HC_, int K1_, int K2_, int NS_>
struct DgradF32 {
  static constexpr int D = D_, BM = BM_, HC = HC_, K1 = K1_, K2 = K2_;
  static constexpr int NS = NS_, NT = 256;
  static constexpr int WM = BM / 32, WN = 8 / WM;  // the warp grid
  static constexpr int HN = HC / WN, XN = D / WN;  // a warp's h / p, dx columns
  static constexpr int XLD = K1 + 4, W1LD = HC + 8, WBLD = K2 + 4;
  static constexpr int DHLD = HC + 4;
  static constexpr int N1 = D / K1, N2 = HC / K2;  // A, B steps a chunk
  static constexpr int ASTAGE = 2 * BM * XLD + K1 * W1LD + HC * XLD;
  static constexpr int BSTAGE = D * WBLD;
  static constexpr int STAGE = ASTAGE > BSTAGE ? ASTAGE : BSTAGE;
  static constexpr int DH_OFF = NS * STAGE;
  static constexpr size_t SMEM = sizeof(float) * (DH_OFF + BM * DHLD);
  static_assert(BM % 32 == 0 && 8 % WM == 0 && HC % WN == 0 && D % WN == 0,
                "warp grid");
  static_assert(HN % 8 == 0 && XN % 8 == 0 && K1 % 8 == 0 && K2 % 8 == 0 &&
                    D % K1 == 0 && HC % K2 == 0 && HC % 32 == 0,
                "mma tiles");
  static_assert(256 % BM == 0, "rows of one layout tile");
  static_assert(NS >= 2 && SMEM <= ssmv::kMaxSmemBytes, "shared memory");
};

// (a) Grid Tp / BM: block b takes the layout rows [b BM, (b + 1) BM), all
// of one expert.
template <class L>
__global__ void __launch_bounds__(L::NT, 1)
defer_dgrad_f32_kernel(const float* __restrict__ xs,
                       const float* __restrict__ dy,
                       const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const int* __restrict__ e_of_tile,
                       float* __restrict__ dxs, int H, int tile_rows) {
  constexpr int D = L::D, BM = L::BM, HC = L::HC, NT = L::NT;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* DHs = smem + L::DH_OFF;
  const int row0 = blockIdx.x * BM;
  const int e = e_of_tile[row0 / tile_rows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xb = xs + (size_t)row0 * D;
  const float* dyb = dy + (size_t)row0 * D;
  const float* w1e = w1 + (size_t)e * D * H;
  const float* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;

  constexpr int SPC = L::N1 + L::N2;  // steps a chunk
  const int n_steps = H / HC * SPC;
  const auto issue = [&](int t) {  // step t into its stage, one group
    if (t < n_steps) {
      float* st = smem + (t % L::NS) * L::STAGE;
      const int c0 = t / SPC * HC, s = t % SPC;
      if (s < L::N1) {  // x, dy[:, k0 + k], W1[k0 + k, c0 + n], W2[c0 + n, k0 + k]
        const int k0 = s * L::K1;
        float* dyt = st + BM * L::XLD;
        float* w1t = dyt + BM * L::XLD;
        float* w2t = w1t + L::K1 * L::W1LD;
        each_vec4<BM, L::K1, NT>([&](int r, int c) {
          cp_async16(st + r * L::XLD + c, xb + (size_t)r * D + k0 + c, true);
          cp_async16(dyt + r * L::XLD + c, dyb + (size_t)r * D + k0 + c, true);
        });
        each_vec4<L::K1, HC, NT>([&](int k, int n) {
          cp_async16(w1t + k * L::W1LD + n,
                     w1e + (size_t)(k0 + k) * H + c0 + n, true);
        });
        each_vec4<HC, L::K1, NT>([&](int n, int k) {
          cp_async16(w2t + n * L::XLD + k,
                     w2e + (size_t)(c0 + n) * D + k0 + k, true);
        });
      } else {  // W1[d, k0 + k]
        const int k0 = c0 + (s - L::N1) * L::K2;
        each_vec4<D, L::K2, NT>([&](int d, int k) {
          cp_async16(st + d * L::WBLD + k, w1e + (size_t)d * H + k0 + k,
                     true);
        });
      }
    }
    cp_async_commit();
  };
  // step t's stage, once it has landed for every thread and step t - 1's
  // stage is free for step t + NS - 1
  const auto stage = [&](int t) {
    cp_async_wait<L::NS - 2>();
    __syncthreads();
    issue(t + L::NS - 1);
    return smem + (t % L::NS) * L::STAGE;
  };
  for (int s = 0; s < L::NS - 1; ++s) issue(s);

  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp % L::WM, wn = warp / L::WM;
  float dx[2][L::XN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::XN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) dx[i][j][c] = 0.f;
  int t = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < H; c0 += HC) {
    float h[2][L::HN / 8][4], p[2][L::HN / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < L::HN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) h[i][j][c] = p[i][j][c] = 0.f;
#pragma unroll 1
    for (int s = 0; s < L::N1; ++s, ++t) {  // h = x . W1, p = dy . W2^T
      const float* st = stage(t);
      const float* Xt = st + wm * 32 * L::XLD;  // this warp's rows
      const float* DYt = Xt + BM * L::XLD;
      const float* W1t = st + 2 * BM * L::XLD;
      const float* W2t = W1t + L::K1 * L::W1LD;
#pragma unroll 1  // fewer fragments in flight: no spills
      for (int kk = 0; kk < L::K1; kk += 8) {
        constexpr int J = tf::group_for(L::HN / 8, kGroupF32);
        tf::FragA a0, a1;
        tf::ld_a(a0, Xt, L::XLD, kk);
        tf::ld_a(a1, Xt + 16 * L::XLD, L::XLD, kk);
#pragma unroll
        for (int j0 = 0; j0 < L::HN / 8; j0 += J) {
          tf::FragB b[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            tf::ld_b_km(b[j], W1t, L::W1LD, kk, wn * L::HN + (j0 + j) * 8);
          tf::mma_group2_rn<J>(h[0], j0, a0, b, h[1], j0, a1, b);
        }
        tf::ld_a(a0, DYt, L::XLD, kk);
        tf::ld_a(a1, DYt + 16 * L::XLD, L::XLD, kk);
#pragma unroll
        for (int j0 = 0; j0 < L::HN / 8; j0 += J) {
          tf::FragB b[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            tf::ld_b_nk(b[j], W2t, L::XLD, wn * L::HN + (j0 + j) * 8, kk);
          tf::mma_group2_rn<J>(p[0], j0, a0, b, p[1], j0, a1, b);
        }
      }
    }
    // dh = p * gelu'(h + b1) into the dh tile: the next step's barrier
    // publishes it, and the readers of the last chunk's dh passed the
    // barriers of this chunk's A steps
#pragma unroll
    for (int j = 0; j < L::HN / 8; ++j) {
      const int col = wn * L::HN + j * 8 + 2 * tq;
      const float2 bias = *reinterpret_cast<const float2*>(b1e + c0 + col);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the m-tile
          float gv, dg0, dg1;
          gelu_pair(h[i][j][2 * hh] + bias.x, &gv, &dg0);
          gelu_pair(h[i][j][2 * hh + 1] + bias.y, &gv, &dg1);
          *reinterpret_cast<float2*>(
              DHs + (wm * 32 + i * 16 + g + hh * 8) * L::DHLD + col) =
              make_float2(p[i][j][2 * hh] * dg0, p[i][j][2 * hh + 1] * dg1);
        }
    }
#pragma unroll 1
    for (int s = 0; s < L::N2; ++s, ++t) {  // dx += dh . W1[:, chunk]^T
      const float* W1t = stage(t);
      const float* DH0 = DHs + wm * 32 * L::DHLD + s * L::K2;
#pragma unroll 1  // as the A steps
      for (int kk = 0; kk < L::K2; kk += 8) {
        constexpr int J = tf::group_for(L::XN / 8, kGroupF32);
        tf::FragA a0, a1;
        tf::ld_a(a0, DH0, L::DHLD, kk);
        tf::ld_a(a1, DH0 + 16 * L::DHLD, L::DHLD, kk);
#pragma unroll
        for (int j0 = 0; j0 < L::XN / 8; j0 += J) {
          tf::FragB b[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            tf::ld_b_nk(b[j], W1t, L::WBLD, wn * L::XN + (j0 + j) * 8, kk);
          tf::mma_group2_rn<J>(dx[0], j0, a0, b, dx[1], j0, a1, b);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < L::XN / 8; ++j) {
    const int col = wn * L::XN + j * 8 + 2 * tq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            dxs + (size_t)(row0 + wm * 32 + i * 16 + g + hh * 8) * D + col) =
            make_float2(dx[i][j][2 * hh], dx[i][j][2 * hh + 1]);
  }
}

// (b) f32: the dW kernel's tiling, the bf16 kernel's with f32 tiles. A block
// (a cluster of CL blocks) owns HW hidden columns of one expert; block r of
// the cluster holds the columns [r DC, (r + 1) DC) of x, dy, W1[:, cols]'s
// rows and W2[cols, :]'s columns. W1[:, cols] (k-major) and W2[cols, :]
// (n-major) stay in shared memory; the expert's rows come through a ring of
// NB stages of RS rows of x and dy (the block's DC columns, rows 8 words past
// a multiple of 32: phase A reads them as m-major A in ld_a_c's k order,
// with W1 through ld_b_kn and W2 through ld_b_nk_c in the same order, and
// phase B as k-major A through ld_a_km, both conflict-free). Per step:
// phase A, h and p of the RS rows over the block's DC (warp = product x K
// slice of DC / KS x 16-row tile x AN-column tile) into the scratch
// (Scratch); the epilogue adds a part's CL x KS slots in order and puts dh
// and g = gelu(h + b1), f32, into every block's tiles, the dh column sums
// (db1) and, in the block that holds dy's columns [cb HW, (cb + 1) HW), dy's
// (db2) in registers; phase B, dW1[:, cols] += x^T . dh and dW2[cols, :]^T
// += dy^T . g (half of the NT / 32 warps a product, BMW x BNW each of the
// DC x HW accumulator), stored from the registers at the end.
template <int DC_, int HW_, int RS_, int AN_, int KS_, int NB_, int CL_,
          int BMW_, int BNW_, int NT_>
struct DwF32 {
  static constexpr int DC = DC_, HW = HW_, RS = RS_, AN = AN_, KS = KS_;
  static constexpr int NB = NB_, CL = CL_, D = DC * CL;
  static constexpr int BMW = BMW_, BNW = BNW_, NT = NT_, NW = NT / 32;
  using S = Scratch<CL, HW, RS>;
  static constexpr int XLD = DC + 8, W1LD = HW + 4, W2LD = DC + 8;
  static constexpr int GLD = HW + 8;
  static constexpr int STAGE = 2 * RS * XLD;  // a ring stage, floats
  static constexpr int W1 = NB * STAGE, W2 = W1 + DC * W1LD;
  static constexpr int SC = W2 + HW * W2LD;
  static constexpr int DH = SC + CL * KS * S::SLOT, G = DH + RS * GLD;
  static constexpr size_t SMEM = sizeof(float) * (G + RS * GLD);
  static_assert(2 * KS * (RS / 16) * (HW / AN) == NW && AN % 8 == 0,
                "phase A: a tile a warp");
  static_assert((DC / BMW) * (HW / BNW) == NW / 2 && BMW % 16 == 0 &&
                    BNW % 8 == 0 && DC % BMW == 0 && HW % BNW == 0,
                "phase B: half of the warps a product");
  static_assert(DC % (8 * KS) == 0 && RS % 16 == 0 && 256 % RS == 0 &&
                    NB >= 2 && DC % HW == 0,
                "steps, and db2's columns in one block");
  static_assert(4 * NT <= CL * KS * S::SLOT,
                "the db sums' staging fits in the scratch");
  static_assert(SMEM <= ssmv::kMaxSmemBytes, "shared memory budget");
};

// acc = A[16 rows, k in [k0, k1)] . B[k, n0 + (0..AN)], each k-step's three
// products summed apart (mma_group_rn): A m-major in ld_a_c's k order, B
// k-major (kW1: W1's rows, ld_b_kn) or n-major (W2's rows, ld_b_nk_c)
template <bool kW1, int AN>
__device__ __forceinline__ void partial_f32(float (&acc)[AN / 8][4],
                                            const float* A, int lda,
                                            const float* B, int ldb, int n0,
                                            int k0, int k1) {
#pragma unroll
  for (int j = 0; j < AN / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  constexpr int J = tf::group_for(AN / 8, kGroupF32);
#pragma unroll 1
  for (int k = k0; k < k1; k += 8) {
    tf::FragA a;
    tf::ld_a_c(a, A, lda, k);
#pragma unroll
    for (int j0 = 0; j0 < AN / 8; j0 += J) {
      tf::FragB b[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        if (kW1)
          tf::ld_b_kn(b[j], B, ldb, k, n0 + (j0 + j) * 8);
        else
          tf::ld_b_nk_c(b[j], B, ldb, n0 + (j0 + j) * 8, k);
      }
      tf::mma_group_rn<J>(acc, j0, a, b);
    }
  }
}

// two floats to this offset of every block of the cluster
template <int CL>
__device__ __forceinline__ void put_all_f2(float* p, float a, float b) {
  if constexpr (CL == 1) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
#pragma unroll
    for (uint32_t q = 0; q < CL; ++q) st_cluster_f2(p, q, a, b);
  }
}

// (b) Grid E * (H / HW) * CL, clusters of CL: cluster (e, cb) takes hidden
// columns [cb HW, (cb + 1) HW) over all the rows of expert e.
template <class L>
__global__ void __launch_bounds__(L::NT, 1)
defer_dw_f32_kernel(const float* __restrict__ xs,
                    const float* __restrict__ dy,
                    const float* __restrict__ w1,
                    const float* __restrict__ b1,
                    const float* __restrict__ w2,
                    const int* __restrict__ e_of_tile, int n_tiles,
                    int tile_rows, float* __restrict__ dw1,
                    float* __restrict__ db1, float* __restrict__ dw2,
                    float* __restrict__ db2, int H) {
  using S = typename L::S;
  constexpr int DC = L::DC, HW = L::HW, RS = L::RS, CL = L::CL;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* W1s = smem + L::W1;
  float* W2s = smem + L::W2;
  float* SCs = smem + L::SC;
  float* DHs = smem + L::DH;
  float* Gs = smem + L::G;
  const int rank = CL == 1 ? 0 : (int)cluster_rank();
  const int n_cb = H / HW, cluster = blockIdx.x / CL;
  const int cb = cluster % n_cb, e = cluster / n_cb;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = cb * HW, d0 = rank * DC;

  // the expert's tiles: e_of_tile is nondecreasing, so they are the
  // [#tiles with e_of_tile < e, + #tiles with e_of_tile == e) range
  int first = 0, count = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += L::NT) {
    const int t = t0 + tid;
    const int et = t < n_tiles ? e_of_tile[t] : 0x7fffffff;
    first += __syncthreads_count(et < e);
    count += __syncthreads_count(et == e);
  }
  const int r_begin = first * tile_rows;
  const int n_steps = count * tile_rows / RS;
  if constexpr (CL > 1) cluster_sync();  // every block has started

  const float* w1e = w1 + ((size_t)e * L::D + d0) * H + c0;
  const float* w2e = w2 + ((size_t)e * H + c0) * L::D + d0;
  each_vec4<DC, HW, L::NT>([&](int d, int n) {  // W1[e][d0 + d][c0 + n]
    cp_async16(W1s + d * L::W1LD + n, w1e + (size_t)d * H + n, true);
  });
  each_vec4<HW, DC, L::NT>([&](int n, int k) {  // W2[e][c0 + n][d0 + k]
    cp_async16(W2s + n * L::W2LD + k, w2e + (size_t)n * L::D + k, true);
  });
  const auto issue = [&](int t) {  // step t's x and dy rows, one group
    if (t < n_steps) {
      float* st = smem + (t % L::NB) * L::STAGE;
      const size_t row = (size_t)r_begin + (size_t)t * RS;
      each_vec4<RS, DC, L::NT>([&](int r, int c) {
        const size_t src = (row + r) * L::D + d0 + c;
        cp_async16(st + r * L::XLD + c, xs + src, true);
        cp_async16(st + (RS + r) * L::XLD + c, dy + src, true);
      });
    }
    cp_async_commit();
  };
#pragma unroll
  for (int t = 0; t < L::NB - 1; ++t) issue(t);

  // phase A: warp = (product q, K slice ks, 16-row tile mi, AN columns ni)
  constexpr int TM = RS / 16, TN = HW / L::AN, KW = DC / L::KS;
  const int q = warp / (L::NW / 2), wq = warp % (L::NW / 2);
  const int ks = wq / (TM * TN), mi = wq % (TM * TN) / TN, ni = wq % TN;
  // epilogue: this thread's column pair of this block's part, first row
  constexpr int CP = S::COLS / 2, RSTEP = L::NT / CP;
  const int ec = tid % CP * 2, er = tid / CP;
  const int gc = rank * S::COLS + ec;  // the pair's column among the HW
  const float2 bias =
      *reinterpret_cast<const float2*>(b1 + (size_t)e * H + c0 + gc);
  // db2: dy's columns [c0, c0 + HW) of D, in the block whose slice holds
  // them; this thread's pair of them and first row
  const bool has_db2 = c0 >= d0 && c0 < d0 + DC;
  constexpr int CP2 = HW / 2, RSTEP2 = L::NT / CP2;
  const int ec2 = tid % CP2 * 2, er2 = tid / CP2;
  float db1s[2] = {0.f, 0.f}, db2s[2] = {0.f, 0.f};
  // phase B: this warp's BMW x BNW tile of dW1[:, cols] (q = 0) or of
  // dW2[cols, :]^T (q = 1)
  constexpr int MT = L::BMW / 16, NTL = L::BNW / 8, BWN = HW / L::BNW;
  const int bm = wq / BWN, bn = wq % BWN;
  float acc[MT][NTL][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<L::NB - 2>();  // step t (and the weights) landed
    __syncthreads();             // ... for all; step t - 1 is done
    issue(t + L::NB - 1);        // into the stage step t - 1 used
    const float* Xt = smem + (t % L::NB) * L::STAGE;
    const float* DYt = Xt + RS * L::XLD;
    {
      float a2[L::AN / 8][4];
      if (q == 0)
        partial_f32<true, L::AN>(a2, Xt + mi * 16 * L::XLD, L::XLD, W1s,
                                 L::W1LD, ni * L::AN, ks * KW, (ks + 1) * KW);
      else
        partial_f32<false, L::AN>(a2, DYt + mi * 16 * L::XLD, L::XLD, W2s,
                                  L::W2LD, ni * L::AN, ks * KW,
                                  (ks + 1) * KW);
      put_partial<CL, HW, RS, L::AN>(SCs, rank * L::KS + ks, q, mi * 16,
                                     ni * L::AN, a2);
    }
    group_sync<CL>();  // the partial sums are in
#pragma unroll 1
    for (int r = er; r < RS; r += RSTEP) {
      float h[2], p[2];
      sum_slots<CL, HW, RS, CL * L::KS>(SCs, r, ec, h, p);
      float gv[2], dh[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float dg;
        gelu_pair(h[c] + (c ? bias.y : bias.x), &gv[c], &dg);
        dh[c] = p[c] * dg;
        db1s[c] += dh[c];
      }
      put_all_f2<CL>(DHs + r * L::GLD + gc, dh[0], dh[1]);
      put_all_f2<CL>(Gs + r * L::GLD + gc, gv[0], gv[1]);
    }
    if (has_db2) {
#pragma unroll 1
      for (int r = er2; r < RS; r += RSTEP2) {
        const float2 y2 = *reinterpret_cast<const float2*>(
            DYt + r * L::XLD + c0 - d0 + ec2);
        db2s[0] += y2.x;
        db2s[1] += y2.y;
      }
    }
    group_sync<CL>();  // dh and g complete; the slots are read
    const float* At = q ? DYt : Xt;
    const float* Bt = q ? Gs : DHs;
#pragma unroll 1
    for (int k = 0; k < RS; k += 8) {
      tf::FragB b[NTL];
#pragma unroll
      for (int j = 0; j < NTL; ++j)
        tf::ld_b_km(b[j], Bt, L::GLD, k, bn * L::BNW + j * 8);
#pragma unroll
      for (int i = 0; i + 1 < MT; i += 2) {
        tf::FragA a0, a1;
        tf::ld_a_km(a0, At, L::XLD, k, bm * L::BMW + i * 16);
        tf::ld_a_km(a1, At, L::XLD, k, bm * L::BMW + i * 16 + 16);
        tf::mma_group2_rn<NTL>(acc[i], 0, a0, b, acc[i + 1], 0, a1, b);
      }
      if constexpr (MT % 2 == 1) {
        tf::FragA a;
        tf::ld_a_km(a, At, L::XLD, k, bm * L::BMW + (MT - 1) * 16);
        tf::mma_group_rn<NTL>(acc[MT - 1], 0, a, b);
      }
    }
  }
  cp_async_wait<0>();

  // dW1[e][d0 + m][c0 + n] (q = 0), dW2[e][c0 + n][d0 + m] (q = 1), from
  // the registers: each row segment of 8 floats is one 32-byte sector
  const int g = lane >> 2, tq = lane & 3;
  const size_t per_e = (size_t)L::D * H;  // one expert's dW1 or dW2
  float* ow = (q ? dw2 : dw1) + (size_t)e * per_e;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = d0 + bm * L::BMW + i * 16 + g + hh * 8;
        const int n = c0 + bn * L::BNW + j * 8 + 2 * tq;
        const float v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
        if (q == 0) {
          *reinterpret_cast<float2*>(ow + (size_t)m * H + n) =
              make_float2(v0, v1);
        } else {
          ow[(size_t)n * L::D + m] = v0;
          ow[(size_t)(n + 1) * L::D + m] = v1;
        }
      }

  // db1 (this block's part of the columns) and db2: the threads of a
  // column pair added in row order; the scratch is free (its last readers
  // passed the last step's second barrier)
  float* red = SCs;
  red[tid * 2] = db1s[0];
  red[tid * 2 + 1] = db1s[1];
  red[2 * L::NT + tid * 2] = db2s[0];
  red[2 * L::NT + tid * 2 + 1] = db2s[1];
  __syncthreads();
  if (tid < S::COLS) {
    float s1 = 0.f;
#pragma unroll 4
    for (int k = 0; k < RSTEP; ++k)
      s1 += red[(k * CP + tid / 2) * 2 + (tid & 1)];
    db1[(size_t)e * H + c0 + rank * S::COLS + tid] = s1;
  }
  if (has_db2 && tid < HW) {
    float s2 = 0.f;
#pragma unroll 4
    for (int k = 0; k < RSTEP2; ++k)
      s2 += red[2 * L::NT + (k * CP2 + tid / 2) * 2 + (tid & 1)];
    db2[(size_t)e * L::D + c0 + tid] = s2;
  }
}

template <class LG, class LW>
cudaError_t launch_f32(const void* xs, const void* dy, const void* w1,
                       const void* b1, const void* w2, const void* e_of_tile,
                       void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                       int Tp, int H, int E, int tile_rows,
                       cudaStream_t stream) {
  static_assert(LG::D == LW::D, "one width");
  if (H % LG::HC || H % LW::HW || tile_rows % LG::BM || tile_rows % LW::RS)
    return cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(xs);
  const float* d = static_cast<const float*>(dy);
  const float* u1 = static_cast<const float*>(w1);
  const float* u2 = static_cast<const float*>(w2);
  const float* c1 = static_cast<const float*>(b1);
  const int* eot = static_cast<const int*>(e_of_tile);
  auto dgrad = defer_dgrad_f32_kernel<LG>;
  cudaError_t err = cudaFuncSetAttribute(
      dgrad, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)LG::SMEM);
  if (err != cudaSuccess) return err;
  dgrad<<<Tp / LG::BM, LG::NT, LG::SMEM, stream>>>(
      x, d, u1, c1, u2, eot, static_cast<float*>(dxs), H, tile_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long grid = (long long)E * (H / LW::HW) * LW::CL;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch_cluster(defer_dw_f32_kernel<LW>, (int)grid, LW::NT, LW::CL,
                        LW::SMEM,
                        stream, x, d, u1, c1, u2, eot, Tp / tile_rows,
                        tile_rows, static_cast<float*>(dw1),
                        static_cast<float*>(db1), static_cast<float*>(dw2),
                        static_cast<float*>(db2), H);
}

// The f32 tilings the dispatch takes: DgradF32<D, BM, HC, K1, K2, NS> and
// DwF32<DC, HW, RS, AN, KS, NB, CL, BMW, BNW, NT>
using DgradF32_192 = DgradF32<192, 64, 64, 32, 32, 4>;
using DgradF32_384 = DgradF32<384, 64, 64, 32, 16, 4>;
using DgradF32_768 = DgradF32<768, 32, 64, 32, 16, 3>;
using DwF32_192 = DwF32<192, 32, 32, 32, 2, 2, 1, 48, 32, 256>;
using DwF32_384 = DwF32<384, 32, 16, 32, 4, 2, 1, 96, 32, 256>;
using DwF32_768 = DwF32<384, 32, 16, 32, 4, 2, 2, 96, 32, 256>;

}  // namespace

// K8: xs, dy (Tp, D); w1 (E, D, H), b1 (E, H) f32, w2 (E, H, D); e_of_tile
// (Tp / tile_rows,) int32, nondecreasing -> dxs (Tp, D), dw1 (E, D, H), db1
// (E, H) f32, dw2 (E, H, D), db2 (E, D) f32; xs, dy, w1, w2, dxs, dw1, dw2
// of one activation dtype, bf16 (is_bf16 = 1) or f32. All contiguous and
// 16-byte aligned; D is 192, 384 or 768 (bf16 on mma.sync m16n8k16, f32 in
// split TF32), H a multiple of 64 and at least D, tile_rows and Tp
// multiples of 256.
extern "C" int ssmv_expert_ffn_bwd_defer(
    const void* xs, const void* dy, const void* w1, const void* b1,
    const void* w2, const void* e_of_tile, void* dxs, void* dw1, void* db1,
    void* dw2, void* db2, int Tp, int D, int H, int E, int tile_rows,
    int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // H >= D: the first D / HW column blocks of each expert take db2
  if (Tp < kRows || Tp % kRows || H < 64 || H % 64 || H < D ||
      tile_rows % kRows || Tp % tile_rows || E < 1 || E > 65535)
    return (int)cudaErrorInvalidValue;
#define SSMV_DEFER(DD)                                                      \
  if (D == DD)                                                              \
    return (int)(is_bf16 ? launch_tc<Dgrad##DD, Dw##DD>                     \
                         : launch_f32<DgradF32_##DD, DwF32_##DD>)(          \
        xs, dy, w1, b1, w2, e_of_tile, dxs, dw1, db1, dw2, db2, Tp, H, E,   \
        tile_rows, s);
  SSMV_DEFER(192)
  SSMV_DEFER(384)
  SSMV_DEFER(768)
#undef SSMV_DEFER
  return (int)cudaErrorInvalidValue;
}
