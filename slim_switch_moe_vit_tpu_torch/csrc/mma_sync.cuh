// Tensor-core and asynchronous-copy building blocks shared by the bf16
// kernels on mma.sync: the attention kernels (attn_mma.cuh: K5, K6, K11,
// K12) and the expert-FFN forward and backward (expert_ffn_fwd.cu: K3, K9's
// and K10's forward; expert_ffn_bwd.cu: K4, K9's and K10's backward).
// mma.sync m16n8k16 (bf16 in, f32 sums), ldmatrix fragment
// loads from shared memory (plain and transposing), and cp.async copies
// from global to shared memory with their commit groups.
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4:
//   A (16 x 16, row-major), 4 registers of 2 bf16: a0 = (g, 2t..2t+1),
//     a1 = (g+8, 2t..), a2 = (g, 8+2t..), a3 = (g+8, 8+2t..);
//   B (16 x 8), 2 registers: b0 = (k 2t..2t+1, n g), b1 = (k 8+2t.., n g);
//   C (16 x 8, f32), 4 floats: c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
// So the C tiles of two neighbouring 8-column n-tiles, rounded to bf16 and
// paired, are the A fragment of a 16-deep k-chunk (``pack_a``): a score
// tile feeds the next product from registers, with no shared-memory trip.
//
// Shared tiles are row-major bf16 with rows a multiple of 16 bytes whose
// stride, taken modulo 128 bytes, puts the eight 16-byte rows one ldmatrix
// phase reads in distinct bank groups (a row of n + 8 elements for n a
// multiple of 32). A tile is "m-major" (A) or "n-major" (B) when its row
// holds one row of A or one column of B, and "k-major" when its row holds
// one k: the transposing ldmatrix reads the fragments of a k-major tile.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ssmv {
namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid (src
// is then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero-filled when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += a . b (16 x 16 by 16 x 8, f32 sums)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the A fragment of a 16-deep k-chunk from the C tiles of its two n-tiles
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack2(c0[0], c0[1]);
  a[1] = pack2(c0[2], c0[3]);
  a[2] = pack2(c1[0], c1[1]);
  a[3] = pack2(c1[2], c1[3]);
}
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  pack_a(a, c[0], c[1]);
}

// the sum (or max) of the quad of lanes that holds a row of a C tile
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// A fragment: rows [0, 16) x columns [k0, k0 + 16) of an m-major tile
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int ld, int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldsm_x4(a, tile + ((lane & 7) + (j & 1) * 8) * ld + k0 + (j >> 1) * 8);
}

// the same A fragment of rows [m0, m0 + 16) from a k-major tile (row k
// holds A's column k: x^T for x^T . dh), through the transposing load
__device__ __forceinline__ void ld_a_t(uint32_t (&a)[4], const bf16* tile,
                                       int ld, int k0, int m0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldsm_x4_t(a, tile + (k0 + (lane & 7) + (j >> 1) * 8) * ld + m0 + (j & 1) * 8);
}

// B fragments of the n-tiles [n0, n0 + 8) (b[0], b[1]) and [n0 + 8, n0 + 16)
// (b[2], b[3]) over k in [k0, k0 + 16), from an n-major tile (row n holds
// B's column n: K for q . k^T)
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldsm_x4(b, tile + (n0 + (lane & 7) + (j >> 1) * 8) * ld + k0 + (j & 1) * 8);
}

// the same fragments from a k-major tile (row k holds B's row k: V for
// p . v), through the transposing load
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* tile,
                                        int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, j = lane >> 3;
  ldsm_x4_t(b, tile + (k0 + (lane & 7) + (j & 1) * 8) * ld + n0 + (j >> 1) * 8);
}

}  // namespace tc
}  // namespace ssmv
