// Split-TF32 tensor-core products for the f32 kernels: f32 operands on
// mma.sync.m16n8k8 (tf32 in, f32 sums) near f32 accuracy, with CUTLASS's
// OpMultiplyAddFastF32 split (cutlass/gemm/warp/mma_tensor_op_fast_f32.h:
// FastF32's defaults). Each f32 operand x is split into
//   hi = x rounded toward zero to tf32 (its 13 low bits cleared),
//   lo = x - hi rounded half an ulp up and truncated to tf32,
// and a product takes lo.hi + hi.lo, then hi.hi, into the f32 accumulator
// (three mma a k-step, ``mma_group``). hi holds x's top 11 significant
// bits and lo the next 11, so the dropped lo.lo term is under 2^-20 of the
// product: far inside the f32 kernels' limit (1e-4 + 1e-4 |ref|), which
// one TF32 product (2^-11) fails. Three integer or float operations a
// split; rounding both parts to nearest (cvt.rna.tf32.f32, the variant
// rna of scripts/attn_f32_tilings.py) takes more, measured 5-25% slower in
// K6 and K11 and only ~13% nearer the f64 function (PERF.md, "The f32
// forms"): the rest of K6's and K11's mean error from f64, 6-10x cuBLAS
// f32's, sits in the tensor cores' f32 sums (chip_smoke.F32_F64_RATIO).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k8", .tf32),
// g = lane / 4, t = lane % 4:
//   A (16 x 8, row-major): a0 = (g, t), a1 = (g+8, t), a2 = (g, t+4),
//     a3 = (g+8, t+4);
//   B (8 x 8, k x n): b0 = (k t, n g), b1 = (k t+4, n g);
//   C (16 x 8, f32): c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..2t+1).
// A C tile is not an A fragment: C holds columns (2t, 2t+1), A columns
// (t, t+4). The sum over k is free in its order, so a C tile becomes the
// A operand of the next product by relabelling k instead of moving data:
// A column t is the C tile's column 2t and A column t+4 its column 2t+1
// (``a_from_c``), and the B operand is read in the same order, rows
// k0 + 2t and k0 + 2t + 1 (``ld_b_kn``).
//
// Shared f32 tiles have rows of tile_ld(HD) = HD + 4 floats (HD a multiple
// of 32, so a row is 4 words past a multiple of the 32 banks): every
// fragment read below is a 32-bit load whose 32 lanes hit 32 distinct
// banks, g * 4 + t for A and n-major B, 2t * 4 + g for k-major B read in
// ``a_from_c``'s order; k-major tiles read in k's own order (``ld_a_km``,
// ``ld_b_km``) take rows 8 words past a multiple of 32 (t * 8 + g).
// (ldmatrix moves 16-bit elements and has no f32 transpose.)
#pragma once

#include <stdint.h>

namespace ssmv {
namespace tf32 {

__host__ __device__ constexpr int tile_ld(int hd) { return hd + 4; }

// the group size for a loop over n n-tiles: the largest gmax / 2^i that
// divides n (gmax a power of two)
__host__ __device__ constexpr int group_for(int n, int gmax) {
  int g = gmax;
  while (n % g) g /= 2;
  return g;
}

// x = hi + lo (to ~2^-21 of x), both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma1(float (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[j0 + j] += a . b[j] for a group of J n-tiles, the three products in
// sweeps over the group: J independent mma between the dependent ones (one
// accumulator's three products in a row would wait out the mma latency
// twice each)
template <int J, int NT>
__device__ __forceinline__ void mma_group(float (&c)[NT][4], int j0,
                                          const FragA& a,
                                          const FragB (&b)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) mma1(c[j0 + j], a.lo, b[j].hi);
#pragma unroll
  for (int j = 0; j < J; ++j) mma1(c[j0 + j], a.hi, b[j].lo);
#pragma unroll
  for (int j = 0; j < J; ++j) mma1(c[j0 + j], a.hi, b[j].hi);
}

// mma_group of two independent products, swept together: 2J independent
// mma between the dependent ones
template <int J, int NT1, int NT2>
__device__ __forceinline__ void mma_group2(float (&c1)[NT1][4], int j1,
                                           const FragA& a1,
                                           const FragB (&b1)[J],
                                           float (&c2)[NT2][4], int j2,
                                           const FragA& a2,
                                           const FragB (&b2)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    mma1(c1[j1 + j], a1.lo, b1[j].hi);
    mma1(c2[j2 + j], a2.lo, b2[j].hi);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    mma1(c1[j1 + j], a1.hi, b1[j].lo);
    mma1(c2[j2 + j], a2.hi, b2[j].lo);
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    mma1(c1[j1 + j], a1.hi, b1[j].hi);
    mma1(c2[j2 + j], a2.hi, b2[j].hi);
  }
}

// mma_group2 summed apart: this k-step's three products go into zeroed
// fragments on the tensor cores, which are then added to c1 and c2 on the
// CUDA cores, rounded to nearest. The tensor cores' f32 sums do not round
// to nearest (the PTX ISA leaves the accumulation's rounding to the
// implementation), so when c runs through every k-step their error grows
// with the number of k-steps: 45x an f32 FMA chain's from the f64 function
// at K = 1,536 (the expert FFN's y, measured on the card; PERF.md). Summed
// apart, c's long sum rounds as an FMA chain's, and the tensor cores' sums
// span 8 k each. For the long-K products (the expert FFN's).
template <int J, int NT1, int NT2>
__device__ __forceinline__ void mma_group2_rn(float (&c1)[NT1][4], int j1,
                                              const FragA& a1,
                                              const FragB (&b1)[J],
                                              float (&c2)[NT2][4], int j2,
                                              const FragA& a2,
                                              const FragB (&b2)[J]) {
  float t1[J][4], t2[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) t1[j][c] = t2[j][c] = 0.f;
  mma_group2<J>(t1, 0, a1, b1, t2, 0, a2, b2);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      c1[j1 + j][c] += t1[j][c];
      c2[j2 + j][c] += t2[j][c];
    }
}

// mma_group2_rn of one product (one m-tile)
template <int J, int NT>
__device__ __forceinline__ void mma_group_rn(float (&c)[NT][4], int j0,
                                             const FragA& a,
                                             const FragB (&b)[J]) {
  float t[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) t[j][q] = 0.f;
  mma_group<J>(t, 0, a, b);
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) c[j0 + j][q] += t[j][q];
}

// A fragment: rows [0, 16) x columns [k0, k0 + 8) of a row-major tile,
// each value times f before the split
__device__ __forceinline__ void ld_a(FragA& a, const float* tile, int ld,
                                     int k0, float f = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + t;
  split(p[0] * f, a.hi[0], a.lo[0]);
  split(p[8 * ld] * f, a.hi[1], a.lo[1]);
  split(p[4] * f, a.hi[2], a.lo[2]);
  split(p[8 * ld + 4] * f, a.hi[3], a.lo[3]);
}

// B fragment of the n-tile [n0, n0 + 8) over k in [k0, k0 + 8) from an
// n-major tile (row n holds B's column n: K for q . k^T), each value times
// f before the split
__device__ __forceinline__ void ld_b_nk(FragB& b, const float* tile, int ld,
                                        int n0, int k0, float f = 1.f) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (n0 + g) * ld + k0 + t;
  split(p[0] * f, b.hi[0], b.lo[0]);
  split(p[4] * f, b.hi[1], b.lo[1]);
}

// The same fragment from a k-major tile (row k holds B's row k: V for
// p . v), k relabelled to match ``a_from_c``: rows k0 + 2t and k0 + 2t + 1
__device__ __forceinline__ void ld_b_kn(FragB& b, const float* tile, int ld,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + 2 * t) * ld + n0 + g;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[ld], b.hi[1], b.lo[1]);
}

// The same fragment from an n-major tile, k relabelled as ``ld_a_c``
// relabels A: row n0 + g at columns k0 + 2t and k0 + 2t + 1, one 8-byte
// load (conflict-free where ld is 8 past a multiple of 32 words)
__device__ __forceinline__ void ld_b_nk_c(FragB& b, const float* tile, int ld,
                                          int n0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float2 v =
      *reinterpret_cast<const float2*>(tile + (n0 + g) * ld + k0 + 2 * t);
  split(v.x, b.hi[0], b.lo[0]);
  split(v.y, b.hi[1], b.lo[1]);
}

// The fragments of k-major tiles in k's own order (rows k0 + t and
// k0 + t + 4, as ``ld_a`` and ``ld_b_nk`` read columns): the operands of
// the expert FFN's products, where both sides of x^T . dh come from row
// slices and W1 and W2 are stored k-major. 32-bit loads, conflict-free
// where ld is 8 past a multiple of 32 words (bank 8t + g).
// A of rows [m0, m0 + 16) from a tile whose row k holds A's column k
__device__ __forceinline__ void ld_a_km(FragA& a, const float* tile, int ld,
                                        int k0, int m0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * ld + m0 + g;
  split(p[0], a.hi[0], a.lo[0]);
  split(p[8], a.hi[1], a.lo[1]);
  split(p[4 * ld], a.hi[2], a.lo[2]);
  split(p[4 * ld + 8], a.hi[3], a.lo[3]);
}
// B of the n-tile [n0, n0 + 8) from a tile whose row k holds B's row k
__device__ __forceinline__ void ld_b_km(FragB& b, const float* tile, int ld,
                                        int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + (k0 + t) * ld + n0 + g;
  split(p[0], b.hi[0], b.lo[0]);
  split(p[4 * ld], b.hi[1], b.lo[1]);
}

// the A fragment of an 8-deep k-step from the C tile of its 8 columns
__device__ __forceinline__ void a_from_c(FragA& a, const float (&c)[4]) {
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
}

// The A fragment of columns [k0, k0 + 8) of a row-major tile, k relabelled
// as ``a_from_c`` relabels a C tile (its B operand read by ``ld_b_kn``):
// rows g and g + 8 at columns k0 + 2t and k0 + 2t + 1, two 8-byte loads
// (conflict-free where ld is 8 past a multiple of 32 words)
__device__ __forceinline__ void ld_a_c(FragA& a, const float* tile, int ld,
                                       int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float* p = tile + g * ld + k0 + 2 * t;
  const float2 r0 = *reinterpret_cast<const float2*>(p);
  const float2 r1 = *reinterpret_cast<const float2*>(p + 8 * ld);
  const float c[4] = {r0.x, r0.y, r1.x, r1.y};
  a_from_c(a, c);
}

}  // namespace tf32
}  // namespace ssmv
