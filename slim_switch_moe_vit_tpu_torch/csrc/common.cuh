// Shared helpers for the hand-written Hopper kernels.
//
// Every C entry point of this directory launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success), so the
// Python wrapper can raise right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace ssmv {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Write one 16x16 f32 WMMA accumulator as bf16 to rows [r0, r0+16) of a
// row-major global matrix ``dst`` (row stride ld, the tile's first column at
// dst), rows >= n_rows dropped. ``stg`` is the calling warp's own 16x16 f32
// staging tile in shared memory (32-byte aligned); every lane of the warp
// calls this.
template <typename Frag>
__device__ __forceinline__ void store_frag_bf16(const Frag& f, float* stg,
                                                __nv_bfloat16* dst, int ld,
                                                int r0, int n_rows) {
  const int lane = threadIdx.x & 31;
  nvcuda::wmma::store_matrix_sync(stg, f, 16, nvcuda::wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, c = (lane & 1) * 8;
  if (r0 + r < n_rows) {
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __float2bfloat16(stg[r * 16 + c + j]);
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld + c) =
        *reinterpret_cast<const uint4*>(v);
  }
  __syncwarp();
}

// The attention kernels' head-width instances: the smallest of 32, 64, 96
// and 128 that holds a head of d columns (the rest zero on chip), or 0
// beyond 128.
inline int head_instance(int d) {
  return d <= 0 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96
                                                  : d <= 128 ? 128 : 0;
}

// Largest dynamic shared memory one block may use on sm_90.
constexpr size_t kMaxSmemBytes = 232448;

// The SIMT forms of the expert-FFN kernels (f32 at every D, bf16 at
// D = 768): rows per block, the hidden chunk streamed through one weight
// buffer, and that buffer's elements (the W1 chunk in rows of kSHC + 1 or
// the W2 chunk in rows of d + 1, the larger, rounded up to 8).
constexpr int kSRows = 16;
constexpr int kSHC = 32;

__host__ __device__ constexpr size_t simt_wbuf(int d) {
  return (size_t)((d * (kSHC + 1) > kSHC * (d + 1) ? d * (kSHC + 1)
                                                   : kSHC * (d + 1)) + 7) /
         8 * 8;
}

}  // namespace ssmv
