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
// on the card an indexed row is D / 8 aligned 16-byte copies, so K9 is K3
// with each row's source address read from gather_idx (kGather).
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
// memory.
//
// bf16, at every D (192, 384, 768): one launch on the tensor cores
// (mma.sync m16n8k16, f32 sums; mma_sync.cuh). A block is two warp groups
// over BM rows of one expert (BM divides the 256-row layout tile), whose x
// tile it loads once into shared memory (K9: the rows' gather_idx entries
// read first, one per lane). H is streamed in chunks of HC hidden columns;
// for each chunk
//   the h group (4 warps):  h = x . W1[:, chunk] (K = D), b1 and the GELU
//                           on the C fragments in registers, g = bf16(...)
//                           into one of two bf16 g tiles in shared memory;
//   the y group (8 warps):  y += g . W2[chunk, :] (K = HC), y's f32 sums
//                           in registers across all of H.
// Each group streams its weight slices through its own cp.async ring
// (its own named barrier a step), and the g tiles pass between the groups
// on mbarriers, so the h group computes chunk c + 1 while the y group sums
// chunk c. What set the tiling (measured on the card; PERF.md):
//  - y's accumulator is BM x D f32 in registers, and a block's 8 y warps
//    (of 12, so 168 registers a thread) hold at most 96 a thread: BM x D
//    over the y warps of a cluster is at most 24,576.
//  - The expert weights stream from L2 once per row block: 4 D H bytes per
//    64 rows are 2 GB a call at ViT-S, B = 128. At D = 384 and 768 a
//    cluster of CL = 2 blocks shares BM rows (128 and 64): block r computes
//    the hidden columns [r HC / 2, (r + 1) HC / 2) of each chunk, stores
//    their g into both blocks' g tiles (distributed shared memory) and
//    sums y's columns [r D / 2, (r + 1) D / 2), so the two blocks read
//    each weight once per BM rows between them. D = 192 runs one block
//    of 64 rows (CL = 1: the cluster form measured slower there).
//  - The h group's work (h's products and the erf GELU) is the critical
//    path: taking out h's products saves more time than taking out y's.
//    What is left of shared memory goes to its ring: a third W1 stage
//    takes D = 768 from 1.27 to 1.00 ms.
// What holds it back from the bound: its data movement on chip. With no
// product and no GELU (copies, ldmatrix, barriers and the g handoff only)
// it takes 0.40 of its 0.70 ms at ViT-S, B = 128: mma.sync takes every
// operand through ldmatrix into registers, in warp tiles (32-64 x 32-48)
// as small as the register file that y fills allows.
//
// Arithmetic order, as the TPU kernel: h = x . W1 in f32 (+ b1 in f32), the
// exact erf GELU in f32 (erff), g rounded to bf16, y += g . W2 in f32, + b2,
// then one rounding to bf16; the f32 sums run in mma.sync's k order. The
// TPU kernel evaluates GELU for bf16 with an odd polynomial
// (fused_ffn.py:107-113, within 5.7e-4 of the exact GELU); that is a TPU
// VPU policy and is not ported, so the two differ by up to 5.7e-4 before
// the bf16 rounding of g.
//
// Layout padding slots gather token 0 (in both forms) and yield finite rows
// that the combine never reads.
//
// f32, at every D: one launch on the tensor cores in split TF32
// (mma_tf32.cuh), the kernel at the end of this file with the same three
// entry points; its note says what bounds it and how its plan differs.
#include "common.cuh"
#include "mma_sync.cuh"
#include "mma_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace ssmv::tc;

// The tensor-core tiling of one width D. A block is two warp groups: the
// h group (4 warps) loads the x tile and computes h and g, the y group (8
// warps) accumulates y. CL blocks (a thread-block cluster) share BM rows:
// block r of the cluster computes hidden columns [r HC / CL, (r + 1) HC /
// CL) of each HC-wide chunk and writes their g into every block of the
// cluster, and sums y's columns [r D / CL, (r + 1) D / CL) over the whole
// chunk, so each block streams 1 / CL of the expert's weights. K1 rows of
// W1 and KS2 rows of W2 a step, NS1 and NS2 ring stages; h's warp grid HWM
// x (4 / HWM), y's YWM x (8 / YWM).
// Shared memory: the x tile (BM x D), two g tiles (BM x HC), the W1 ring
// (K1 x HC / CL slices, k-major), the W2 ring (KS2 x D / CL slices,
// k-major), rows padded by 8 elements (mma_sync.cuh), and the g tiles'
// barriers.
template <int D_, int BM_, int HC_, int K1_, int KS2_, int NS1_, int NS2_,
          int HWM_, int YWM_, int CL_>
struct Tiling {
  static constexpr int D = D_, BM = BM_, HC = HC_, K1 = K1_, KS2 = KS2_;
  static constexpr int NS1 = NS1_, NS2 = NS2_, CL = CL_;
  static constexpr int HCL = HC / CL, DCL = D / CL;  // a block's columns
  static constexpr int NWH = 4, NWY = 8;             // the groups' warps
  static constexpr int NTH = 32 * NWH, NTY = 32 * NWY, NT = NTH + NTY;
  static constexpr int HWM = HWM_, HWN = NWH / HWM_;  // h's warp grid
  static constexpr int HM = BM / HWM, HN = HCL / HWN;  // a warp's h tile
  static constexpr int YWM = YWM_, YWN = NWY / YWM_;  // y's warp grid
  static constexpr int YM = BM / YWM, YN = DCL / YWN;  // a warp's y tile
  static constexpr int XLD = D + 8;     // x tile rows
  static constexpr int GLD = HC + 8;    // g tile rows
  static constexpr int W1LD = HCL + 8;  // W1 slice rows
  static constexpr int W2LD = DCL + 8;  // W2 slice rows
  static constexpr int N1 = D / K1, N2 = HC / KS2;  // W1, W2 steps a chunk
  static constexpr int G_OFF = BM * XLD;
  static constexpr int W1_OFF = G_OFF + 2 * BM * GLD;
  static constexpr int W2_OFF = W1_OFF + NS1 * K1 * W1LD;
  static constexpr int BAR_OFF = W2_OFF + NS2 * KS2 * W2LD;  // 4 x 8 bytes
  static constexpr size_t SMEM = sizeof(bf16) * BAR_OFF + 32;
  static_assert(NWH % HWM == 0 && NWY % YWM == 0 && HC % CL == 0 &&
                    D % CL == 0 && HCL % HWN == 0 && DCL % YWN == 0 &&
                    BM % HWM == 0 && BM % YWM == 0,
                "warp grids");
  static_assert(HM % 16 == 0 && HN % 16 == 0 && YM % 16 == 0 && YN % 16 == 0,
                "mma tiles");
  static_assert(D % K1 == 0 && K1 % 16 == 0 && HC % KS2 == 0 && KS2 % 16 == 0,
                "steps");
  static_assert(K1 * HCL / 8 % NTH == 0 && KS2 * DCL / 8 % NTY == 0,
                "whole copies a thread");
  static_assert(256 % BM == 0 && BM / NWH <= 32, "rows of one layout tile");
  static_assert(NS1 >= 2 && NS2 >= 2 && BAR_OFF % 8 == 0 &&
                    SMEM <= ssmv::kMaxSmemBytes,
                "shared memory");
};

// Named barriers of each group's ring (0 is __syncthreads)
constexpr int kBarH = 1, kBarY = 2;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The g tiles' handoff runs on mbarriers, each block's own, that every
// block of the cluster arrives on: full[b] (g tile b is written: each h
// thread of each block arrives) and free[b] (g tile b is read: each y
// thread of each block arrives).
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
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}
// arrive on the barrier at bar's offset in block `rank` of the cluster,
// releasing this thread's writes at cluster scope
__device__ __forceinline__ void mbar_arrive(const uint64_t* bar,
                                            uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::
          "r"(smem_u32(bar)), "r"(rank)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(const uint64_t* bar,
                                          uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// a 4-byte store to this offset of block `rank`'s shared memory
__device__ __forceinline__ void st_cluster(const void* local, uint32_t rank,
                                           uint32_t v) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " st.shared::cluster.u32 [ra], %2;\n}\n" ::"r"(smem_u32(local)),
      "r"(rank), "r"(v)
      : "memory");
}

__device__ __forceinline__ float gelu(float h) {
  return 0.5f * h * (1.f + erff(h * 0.70710678118654752f));
}

// The h group: the x tile once (K9: its rows' gather_idx entries read
// first), then per chunk c h = x . W1[:, this block's columns of the chunk]
// over the W1 ring and g = bf16(GELU(h + b1)) into g tile c % 2 of every
// block of the cluster, once they have read chunk c - 2 from it. Hidden
// columns at and past H are zero-filled (g = 0).
template <class L, bool kGather>
__device__ __forceinline__ void h_group(const bf16* __restrict__ xs,
                                        const long long* __restrict__ gidx,
                                        int row0, uint32_t rank,
                                        const bf16* __restrict__ w1e,
                                        const float* __restrict__ b1e, int H,
                                        bf16* smem, uint64_t* bars) {
  constexpr int D = L::D, BM = L::BM, HC = L::HC, XLD = L::XLD, GLD = L::GLD;
  constexpr int W1LD = L::W1LD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* Xs = smem;
  bf16* ring = smem + L::W1_OFF;
  {  // warp w copies rows w, w + 4, ...; lane i looks up the i-th first
    long long src = 0;
    if (lane < BM / L::NWH) {
      const int r = row0 + warp + L::NWH * lane;
      src = kGather ? gidx[r] : r;
    }
#pragma unroll 4
    for (int i = 0; i < BM / L::NWH; ++i) {
      const bf16* row = xs + __shfl_sync(0xffffffffu, src, i) * D;
      bf16* dst = Xs + (warp + L::NWH * i) * XLD;
      for (int v = lane * 8; v < D; v += 32 * 8) cp_async16(dst + v, row + v, true);
    }
  }
  const int cb = rank * L::HCL;  // this block's columns of a chunk
  const int n_steps = (H + HC - 1) / HC * L::N1;
  const auto issue = [&](int t) {  // W1[K1 j + k, c0 + cb + n] of step t
    if (t < n_steps) {
      constexpr int V = L::HCL / 8;
      bf16* st = ring + (t % L::NS1) * L::K1 * W1LD;
      const int c0 = t / L::N1 * HC + cb;
      const bf16* src = w1e + (size_t)(t % L::N1) * L::K1 * H + c0;
#pragma unroll
      for (int q = 0; q < L::K1 * V / L::NTH; ++q) {
        const int i = tid + q * L::NTH, k = i / V, n = i % V * 8;
        const bool ok = c0 + n < H;
        cp_async16(st + k * W1LD + n, ok ? src + (size_t)k * H + n : w1e, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < L::NS1 - 1; ++s) issue(s);

  const int g = lane >> 2, tq = lane & 3;
  const int hm0 = warp % L::HWM * L::HM, hn0 = warp / L::HWM * L::HN;
  int t = 0;
#pragma unroll 1
  for (int c = 0, c0 = 0; c0 < H; ++c, c0 += HC) {
    float acc[L::HM / 16][L::HN / 8][4];
#pragma unroll
    for (int i = 0; i < L::HM / 16; ++i)
#pragma unroll
      for (int j = 0; j < L::HN / 8; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
#pragma unroll 1
    for (int j = 0; j < L::N1; ++j, ++t) {
      cp_async_wait<L::NS1 - 2>();  // step t landed, for this thread
      bar_sync(kBarH, L::NTH);      // ... for the group; t - 1 is read
      issue(t + L::NS1 - 1);        // into the stage step t - 1 used
      const bf16* W1t = ring + (t % L::NS1) * L::K1 * W1LD;
#pragma unroll
      for (int kk = 0; kk < L::K1; kk += 16) {
        uint32_t a[L::HM / 16][4];
#pragma unroll
        for (int i = 0; i < L::HM / 16; ++i)
          ld_a(a[i], Xs + (hm0 + i * 16) * XLD, XLD, j * L::K1 + kk);
#pragma unroll
        for (int jj = 0; jj < L::HN / 16; ++jj) {
          uint32_t b[4];
          ld_b_kn(b, W1t, W1LD, kk, hn0 + jj * 16);
#pragma unroll
          for (int i = 0; i < L::HM / 16; ++i) {
            mma(acc[i][2 * jj], a[i], b[0], b[1]);
            mma(acc[i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    const int b = c & 1;
    if (c >= 2) mbar_wait(&bars[2 + b], (c / 2 - 1) & 1);  // c - 2 is read
    bf16* Gs = smem + L::G_OFF + b * BM * GLD;
#pragma unroll
    for (int jn = 0; jn < L::HN / 8; ++jn) {
      const int col = cb + hn0 + jn * 8 + 2 * tq;
      const float2 bias = c0 + col < H
                              ? *reinterpret_cast<const float2*>(b1e + c0 + col)
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < L::HM / 16; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {  // rows g and g + 8 of the m-tile
          const uint32_t v = pack2(gelu(acc[i][jn][2 * hh] + bias.x),
                                   gelu(acc[i][jn][2 * hh + 1] + bias.y));
          uint32_t* dst = reinterpret_cast<uint32_t*>(
              Gs + (hm0 + i * 16 + g + hh * 8) * GLD + col);
          if constexpr (L::CL == 1) {
            *dst = v;
          } else {
#pragma unroll
            for (uint32_t q = 0; q < L::CL; ++q) st_cluster(dst, q, v);
          }
        }
    }
#pragma unroll
    for (uint32_t q = 0; q < L::CL; ++q) mbar_arrive(&bars[b], q);
  }
  cp_async_wait<0>();
}

// The y group: per chunk c, once g tile c % 2 holds it, y[:, this block's
// columns] += g . W2[chunk, those columns] over the W2 ring; then y + b2,
// rounded once, to the rows' y.
template <class L>
__device__ __forceinline__ void y_group(int row0, uint32_t rank,
                                        const bf16* __restrict__ w2e,
                                        const float* __restrict__ b2e, int H,
                                        bf16* __restrict__ y, bf16* smem,
                                        uint64_t* bars) {
  constexpr int D = L::D, BM = L::BM, HC = L::HC, GLD = L::GLD;
  constexpr int W2LD = L::W2LD;
  const int tid = threadIdx.x - L::NTH, warp = tid >> 5, lane = tid & 31;
  bf16* ring = smem + L::W2_OFF;
  const int db = rank * L::DCL;  // this block's columns of y
  const int n_chunks = (H + HC - 1) / HC, n_steps = n_chunks * L::N2;
  const auto issue = [&](int t) {  // W2[c0 + KS2 j + k, db + n] of step t
    if (t < n_steps) {
      constexpr int V = L::DCL / 8;
      bf16* st = ring + (t % L::NS2) * L::KS2 * W2LD;
      const int k0 = t / L::N2 * HC + t % L::N2 * L::KS2;
#pragma unroll
      for (int q = 0; q < L::KS2 * V / L::NTY; ++q) {
        const int i = tid + q * L::NTY, k = i / V, n = i % V * 8;
        const bool ok = k0 + k < H;
        cp_async16(st + k * W2LD + n,
                   ok ? w2e + (size_t)(k0 + k) * D + db + n : w2e, ok);
      }
    }
    cp_async_commit();
  };
  for (int s = 0; s < L::NS2 - 1; ++s) issue(s);

  const int g = lane >> 2, tq = lane & 3;
  const int ym0 = warp % L::YWM * L::YM, yn0 = warp / L::YWM * L::YN;
  float acc[L::YM / 16][L::YN / 8][4];
#pragma unroll
  for (int i = 0; i < L::YM / 16; ++i)
#pragma unroll
    for (int j = 0; j < L::YN / 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  int t = 0;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    const int b = c & 1;
    mbar_wait(&bars[b], (c / 2) & 1);  // g of chunk c is written
    const bf16* Gs = smem + L::G_OFF + b * BM * GLD;
#pragma unroll 1
    for (int j = 0; j < L::N2; ++j, ++t) {
      cp_async_wait<L::NS2 - 2>();
      bar_sync(kBarY, L::NTY);
      issue(t + L::NS2 - 1);
      const bf16* W2t = ring + (t % L::NS2) * L::KS2 * W2LD;
#pragma unroll
      for (int kk = 0; kk < L::KS2; kk += 16) {
        uint32_t a[L::YM / 16][4];
#pragma unroll
        for (int i = 0; i < L::YM / 16; ++i)
          ld_a(a[i], Gs + (ym0 + i * 16) * GLD, GLD, j * L::KS2 + kk);
#pragma unroll
        for (int jj = 0; jj < L::YN / 16; ++jj) {
          uint32_t bb[4];
          ld_b_kn(bb, W2t, W2LD, kk, yn0 + jj * 16);
#pragma unroll
          for (int i = 0; i < L::YM / 16; ++i) {
            mma(acc[i][2 * jj], a[i], bb[0], bb[1]);
            mma(acc[i][2 * jj + 1], a[i], bb[2], bb[3]);
          }
        }
      }
    }
    // g tile b is read; the h groups wait for that only before chunk c + 2
    if (c + 2 < n_chunks) {
#pragma unroll
      for (uint32_t q = 0; q < L::CL; ++q) mbar_arrive(&bars[2 + b], q);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int jn = 0; jn < L::YN / 8; ++jn) {
    const int col = db + yn0 + jn * 8 + 2 * tq;
    const float2 bias = *reinterpret_cast<const float2*>(b2e + col);
#pragma unroll
    for (int i = 0; i < L::YM / 16; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(
            y + (size_t)(row0 + ym0 + i * 16 + g + hh * 8) * D + col) =
            pack2(acc[i][jn][2 * hh] + bias.x, acc[i][jn][2 * hh + 1] + bias.y);
  }
}

// kGather: row s of the layout is row gather_idx[s] of xs (K9); else row s.
// kPerm: block b is in step-order row block b, which lies in row tile
// tile_perm[step] of xs and y (K10).
template <class L, bool kGather, bool kPerm>
__global__ void __launch_bounds__(L::NT, 1)
expert_ffn_fwd_kernel(const bf16* __restrict__ xs,
                      const long long* __restrict__ gather_idx,
                      const int* __restrict__ tile_perm,
                      const bf16* __restrict__ w1,
                      const float* __restrict__ b1, const bf16* __restrict__ w2,
                      const float* __restrict__ b2,
                      const int* __restrict__ e_of_tile, bf16* __restrict__ y,
                      int H, int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const uint32_t rank = L::CL == 1 ? 0 : cluster_rank();
  const int step_row0 = blockIdx.x / L::CL * L::BM;
  const int e = e_of_tile[step_row0 / tile_rows];
  const int row0 = kPerm ? tile_perm[step_row0 / tile_rows] * tile_rows +
                               step_row0 % tile_rows
                         : step_row0;
  if (threadIdx.x < 2) {
    mbar_init(&bars[threadIdx.x], L::CL * L::NTH);      // full[b]
    mbar_init(&bars[2 + threadIdx.x], L::CL * L::NTY);  // free[b]
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every block's barriers are initialized
  if (threadIdx.x < L::NTH)
    h_group<L, kGather>(xs, gather_idx, row0, rank,
                        w1 + (size_t)e * L::D * H, b1 + (size_t)e * H, H,
                        smem, bars);
  else
    y_group<L>(row0, rank, w2 + (size_t)e * H * L::D, b2 + (size_t)e * L::D,
               H, y, smem, bars);
  cluster_sync();  // no block leaves while another may still reach it
}

template <class L, bool kGather, bool kPerm>
cudaError_t launch(const void* xs, const void* gather_idx,
                   const void* tile_perm, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* e_of_tile,
                   void* y, int Tp, int H, int tile_rows,
                   cudaStream_t stream) {
  if (Tp % L::BM || tile_rows % L::BM) return cudaErrorInvalidValue;
  auto kernel = expert_ffn_fwd_kernel<L, kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Tp / L::BM * L::CL);
  cfg.blockDim = dim3(L::NT);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = L::CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(xs),
      static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(e_of_tile),
      static_cast<bf16*>(y), H, tile_rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tilings the dispatch takes (see Tiling)
using Tiling192 = Tiling<192, 64, 128, 64, 32, 3, 3, 2, 2, 1>;
using Tiling384 = Tiling<384, 128, 128, 64, 32, 3, 2, 2, 2, 2>;
using Tiling768 = Tiling<768, 64, 256, 32, 16, 3, 3, 2, 1, 2>;

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores (mma_tf32.cuh)
// ---------------------------------------------------------------------------
//
// What bounds it: the same FLOPs, at the split-TF32 rate (three
// mma.sync.m16n8k8 a product, 494.7 / 3 = 164.9 TFLOP/s dense): 0.212 ms at
// ViT-S, B = 32 (Tp = 14,848). f32 doubles every shared tile against bf16,
// so the bf16 form's plan does not carry over: its resident x tile alone
// (128 x 384 at D = 384, 64 x 768 at D = 768) would take 196 KB of the
// 227 KB in f32. The f32 design instead:
//  - streams x with W1: a block's x rows are read in K1-deep slices beside
//    the W1 slices, once per hidden chunk, from L2 (x re-read costs L2
//    traffic, not device memory), through the same cp.async ring;
//  - keeps y's f32 sums in registers across all of H: a block of 8 warps
//    owns BM rows and all D columns, BM x D = 24,576 at every width (BM =
//    128, 64, 32 at D = 192, 384, 768), 32 x 96 a warp, 96 accumulators a
//    thread, which is why BM shrinks as D grows;
//  - computes each chunk's h = x . W1[:, chunk] over the same warp grid
//    (warp tiles 32 x HC / WN), b1 and the exact erf GELU on the C
//    fragments, g kept in f32 and stored to one shared tile, then y +=
//    g . W2[chunk, :] with the g tile as the A operand (ld_a) and the W2
//    slice k-major (ld_b_km). The warps that share a row strip split the
//    chunk's hidden columns, so no warp holds all of the g its y tile
//    needs: g passes through shared memory (a_from_c has no use here);
//  - sweeps each product's three mma over groups of 2 n-tiles for two
//    m-tiles at once (mma_group2_rn): 12 independent mma between dependent
//    ones, each A and B fragment loaded and split once per k-step, each
//    k-step's products summed into zeroed fragments and added to h and y
//    on the CUDA cores (the tensor cores' own f32 sums across all of k
//    read 45x an f32 FMA chain's error from the f64 function at K = H;
//    summed apart 1.1-1.4x, for ~18% more time).
// What holds it back from the bound (0.25 of it at D = 384 and 768, 0.21
// at 192, measured on the card): not the tiling (rows, chunk, step depths,
// ring stages and group sizes all time within 2-8% of each other): every
// mma takes its share of fragment loads, hi/lo splits and the CUDA-core
// adds from the same issue slots, and the h and y phases of a chunk run
// one after the other on the block's 8 warps, behind a barrier a step.
// The hidden activation stays out of device memory, as in the TPU kernel
// and the bf16 form. Arithmetic order: h in f32 (+ b1), GELU in f32, g in
// f32, y in f32 (+ b2); the products' f32 sums in the tensor cores' order.

namespace tf = ssmv::tf32;

// n-tiles a swept group of the f32 products (mma_group2_rn): its zeroed
// fragments take 8 J registers a thread beside y's 96 accumulators; 1, 2
// and 4 time alike (scripts/ffn_f32_tilings.py)
constexpr int kGroupF32 = 2;

// The f32 tiling of one width D: BM rows a block, HC hidden columns a
// chunk, K1-deep h steps and K2-deep y steps, NS ring stages. A stage holds
// an h step (the x slice, BM x K1 m-major, and the W1 slice, K1 x HC
// k-major) or a y step (the W2 slice, K2 x D k-major); the g tile (BM x
// HC) follows the ring. Rows of m-major tiles are 4 words past a multiple
// of 32, of k-major ones 8 past (mma_tf32.cuh).
template <int D_, int BM_, int HC_, int K1_, int K2_, int NS_>
struct TilingF32 {
  static constexpr int D = D_, BM = BM_, HC = HC_, K1 = K1_, K2 = K2_;
  static constexpr int NS = NS_, NT = 256;
  static constexpr int WM = BM / 32, WN = 8 / WM;  // the warp grid
  static constexpr int HN = HC / WN, YN = D / WN;  // a warp's h, y columns
  static constexpr int XLD = K1 + 4, W1LD = HC + 8, W2LD = D + 8;
  static constexpr int GLD = HC + 4;
  static constexpr int N1 = D / K1, N2 = HC / K2;  // h, y steps a chunk
  static constexpr int HSTAGE = BM * XLD + K1 * W1LD, YSTAGE = K2 * W2LD;
  static constexpr int STAGE = HSTAGE > YSTAGE ? HSTAGE : YSTAGE;
  static constexpr int G_OFF = NS * STAGE;
  static constexpr size_t SMEM = sizeof(float) * (G_OFF + BM * GLD);
  static constexpr int XV = K1 / 4, XRP = NT / XV, XQ = BM / XRP;
  static_assert(BM % 32 == 0 && 8 % WM == 0 && HC % WN == 0 && D % WN == 0,
                "warp grid");
  static_assert(HN % 8 == 0 && YN % 8 == 0 && K1 % 8 == 0 && K2 % 8 == 0 &&
                    D % K1 == 0 && HC % K2 == 0 && HC % 64 == 0,
                "mma tiles");
  static_assert(NT % XV == 0 && BM % XRP == 0 &&
                    K1 * HC / 4 % NT == 0 && K2 * D / 4 % NT == 0,
                "whole copies a thread");
  static_assert(256 % BM == 0, "rows of one layout tile");
  static_assert(NS >= 2 && SMEM <= ssmv::kMaxSmemBytes, "shared memory");
};

template <class L, bool kGather, bool kPerm>
__global__ void __launch_bounds__(L::NT, 1)
expert_ffn_fwd_f32_kernel(const float* __restrict__ xs,
                          const long long* __restrict__ gather_idx,
                          const int* __restrict__ tile_perm,
                          const float* __restrict__ w1,
                          const float* __restrict__ b1,
                          const float* __restrict__ w2,
                          const float* __restrict__ b2,
                          const int* __restrict__ e_of_tile,
                          float* __restrict__ y, int H, int tile_rows) {
  constexpr int D = L::D, BM = L::BM, HC = L::HC;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  float* Gs = smem + L::G_OFF;
  const int step_row0 = blockIdx.x * BM;
  const int e = e_of_tile[step_row0 / tile_rows];
  const int row0 = kPerm ? tile_perm[step_row0 / tile_rows] * tile_rows +
                               step_row0 % tile_rows
                         : step_row0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* w1e = w1 + (size_t)e * D * H;
  const float* w2e = w2 + (size_t)e * H * D;
  const float* b1e = b1 + (size_t)e * H;
  const float* b2e = b2 + (size_t)e * D;

  // this thread's x copies: rows xr + q XRP at column xc of each h step,
  // their sources (K9: gather_idx) looked up once
  const int xr = tid / L::XV, xc = tid % L::XV * 4;
  const float* xsrc[L::XQ];
#pragma unroll
  for (int q = 0; q < L::XQ; ++q) {
    const int r = xr + q * L::XRP;
    xsrc[q] = xs + (kGather ? (size_t)gather_idx[step_row0 + r]
                            : (size_t)(row0 + r)) * D + xc;
  }
  const int n_chunks = (H + HC - 1) / HC;
  const int n_steps = n_chunks * (L::N1 + L::N2);
  const auto issue = [&](int t) {  // step t into its stage, one group
    if (t < n_steps) {
      float* st = smem + (t % L::NS) * L::STAGE;
      const int c0 = t / (L::N1 + L::N2) * HC, s = t % (L::N1 + L::N2);
      if (s < L::N1) {  // x[:, k0 + k] and W1[k0 + k, c0 + n]
        const int k0 = s * L::K1;
#pragma unroll
        for (int q = 0; q < L::XQ; ++q)
          cp_async16(st + (xr + q * L::XRP) * L::XLD + xc, xsrc[q] + k0, true);
        constexpr int V = HC / 4;
        float* w1s = st + BM * L::XLD;
#pragma unroll
        for (int q = 0; q < L::K1 * V / L::NT; ++q) {
          const int i = tid + q * L::NT, k = i / V, n = i % V * 4;
          const bool ok = c0 + n < H;
          cp_async16(w1s + k * L::W1LD + n,
                     ok ? w1e + (size_t)(k0 + k) * H + c0 + n : w1e, ok);
        }
      } else {          // W2[k0 + k, n]
        const int k0 = c0 + (s - L::N1) * L::K2;
        constexpr int V = D / 4;
#pragma unroll
        for (int q = 0; q < L::K2 * V / L::NT; ++q) {
          const int i = tid + q * L::NT, k = i / V, n = i % V * 4;
          const bool ok = k0 + k < H;
          cp_async16(st + k * L::W2LD + n,
                     ok ? w2e + (size_t)(k0 + k) * D + n : w2e, ok);
        }
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
  float yacc[2][L::YN / 8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < L::YN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) yacc[i][j][c] = 0.f;
  int t = 0;
#pragma unroll 1
  for (int c0 = 0; c0 < H; c0 += HC) {
    float hacc[2][L::HN / 8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < L::HN / 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) hacc[i][j][c] = 0.f;
#pragma unroll 1
    for (int s = 0; s < L::N1; ++s, ++t) {  // h = x . W1[:, chunk]
      const float* st = stage(t);
      const float* Xs = st + (wm * 32) * L::XLD;  // this warp's rows
      const float* W1s = st + BM * L::XLD;
#pragma unroll 1  // unrolled, 80-330 bytes a thread spill
      for (int kk = 0; kk < L::K1; kk += 8) {
        tf::FragA a0, a1;
        tf::ld_a(a0, Xs, L::XLD, kk);
        tf::ld_a(a1, Xs + 16 * L::XLD, L::XLD, kk);
        constexpr int J = tf::group_for(L::HN / 8, kGroupF32);
#pragma unroll
        for (int j0 = 0; j0 < L::HN / 8; j0 += J) {
          tf::FragB b[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            tf::ld_b_km(b[j], W1s, L::W1LD, kk, wn * L::HN + (j0 + j) * 8);
          tf::mma_group2_rn<J>(hacc[0], j0, a0, b, hacc[1], j0, a1, b);
        }
      }
    }
    // g = GELU(h + b1) into the g tile (hidden columns at and past H: 0);
    // the next step's barrier publishes it, and the readers of the last
    // chunk's g passed the barriers of this chunk's h steps
#pragma unroll
    for (int j = 0; j < L::HN / 8; ++j) {
      const int col = wn * L::HN + j * 8 + 2 * tq;
      const float2 bias = c0 + col < H
                              ? *reinterpret_cast<const float2*>(b1e + c0 + col)
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)  // rows g and g + 8 of the m-tile
          *reinterpret_cast<float2*>(
              Gs + (wm * 32 + i * 16 + g + hh * 8) * L::GLD + col) =
              make_float2(gelu(hacc[i][j][2 * hh] + bias.x),
                          gelu(hacc[i][j][2 * hh + 1] + bias.y));
    }
#pragma unroll 1
    for (int s = 0; s < L::N2; ++s, ++t) {  // y += g . W2[chunk, :]
      const float* W2s = stage(t);
      const float* G0 = Gs + (wm * 32) * L::GLD + s * L::K2;
#pragma unroll 1  // as the h steps
      for (int kk = 0; kk < L::K2; kk += 8) {
        tf::FragA a0, a1;
        tf::ld_a(a0, G0, L::GLD, kk);
        tf::ld_a(a1, G0 + 16 * L::GLD, L::GLD, kk);
        constexpr int J = tf::group_for(L::YN / 8, kGroupF32);
#pragma unroll
        for (int j0 = 0; j0 < L::YN / 8; j0 += J) {
          tf::FragB b[J];
#pragma unroll
          for (int j = 0; j < J; ++j)
            tf::ld_b_km(b[j], W2s, L::W2LD, kk, wn * L::YN + (j0 + j) * 8);
          tf::mma_group2_rn<J>(yacc[0], j0, a0, b, yacc[1], j0, a1, b);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int j = 0; j < L::YN / 8; ++j) {
    const int col = wn * L::YN + j * 8 + 2 * tq;
    const float2 bias = *reinterpret_cast<const float2*>(b2e + col);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            y + (size_t)(row0 + wm * 32 + i * 16 + g + hh * 8) * D + col) =
            make_float2(yacc[i][j][2 * hh] + bias.x,
                        yacc[i][j][2 * hh + 1] + bias.y);
  }
}

template <class L, bool kGather, bool kPerm>
cudaError_t launch_f32(const void* xs, const void* gather_idx,
                       const void* tile_perm, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* e_of_tile,
                       void* y, int Tp, int H, int tile_rows,
                       cudaStream_t stream) {
  if (Tp % L::BM || tile_rows % L::BM) return cudaErrorInvalidValue;
  auto kernel = expert_ffn_fwd_f32_kernel<L, kGather, kPerm>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  kernel<<<Tp / L::BM, L::NT, L::SMEM, stream>>>(
      static_cast<const float*>(xs), static_cast<const long long*>(gather_idx),
      static_cast<const int*>(tile_perm), static_cast<const float*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(w2),
      static_cast<const float*>(b2), static_cast<const int*>(e_of_tile),
      static_cast<float*>(y), H, tile_rows);
  return cudaGetLastError();
}

// The f32 tilings the dispatch takes (see TilingF32)
using TilingF32_192 = TilingF32<192, 128, 64, 32, 32, 4>;
using TilingF32_384 = TilingF32<384, 64, 128, 32, 16, 4>;
using TilingF32_768 = TilingF32<768, 32, 256, 32, 16, 3>;

template <bool kGather, bool kPerm>
int dispatch(const void* xs, const void* gather_idx, const void* tile_perm,
             const void* w1, const void* b1, const void* w2, const void* b2,
             const void* e_of_tile, void* y, int Tp, int D, int H,
             int tile_rows, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Tp < 64 || Tp % 64 || H < 64 || H % 64 || tile_rows % 64 ||
      (kPerm && Tp % tile_rows))
    return (int)cudaErrorInvalidValue;
#define SSMV_TC_FWD(DD)                                                    \
  if (D == DD)                                                             \
    return (int)launch<Tiling##DD, kGather, kPerm>(                        \
        xs, gather_idx, tile_perm, w1, b1, w2, b2, e_of_tile, y, Tp, H,    \
        tile_rows, s);
#define SSMV_F32_FWD(DD)                                                   \
  if (D == DD)                                                             \
    return (int)launch_f32<TilingF32_##DD, kGather, kPerm>(                \
        xs, gather_idx, tile_perm, w1, b1, w2, b2, e_of_tile, y, Tp, H,    \
        tile_rows, s);
  if (is_bf16) {
    SSMV_TC_FWD(192)
    SSMV_TC_FWD(384)
    SSMV_TC_FWD(768)
  } else {
    SSMV_F32_FWD(192)
    SSMV_F32_FWD(384)
    SSMV_F32_FWD(768)
  }
#undef SSMV_TC_FWD
#undef SSMV_F32_FWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// K3: xs (Tp, D), w1 (E, D, H), w2 (E, H, D) of one activation dtype, bf16
// (is_bf16 = 1) or f32 (is_bf16 = 0); b1 (E, H) f32, b2 (E, D) f32,
// e_of_tile (Tp / tile_rows,) int32 -> y (Tp, D) in the activation dtype;
// all contiguous and 16-byte aligned. D is 192, 384 or 768 (bf16 on the
// tensor cores, f32 in split TF32 on them); H a multiple of 64; tile_rows
// and Tp multiples of 64 and of the width's block rows (bf16: 128 at
// D = 384, 64 at 192 and 768; f32: 128 at D = 192, 64 at 384, 32 at 768).
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
