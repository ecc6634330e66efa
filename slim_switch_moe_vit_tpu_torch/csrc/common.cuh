// Shared helpers for the hand-written Hopper kernels.
//
// Every C entry point of this directory launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success), so the
// Python wrapper can raise right after the launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The attention kernels' head-width instances: the smallest of 32, 64, 96
// and 128 that holds a head of d columns (the rest zero on chip), or 0
// beyond 128.
inline int head_instance(int d) {
  return d <= 0 ? 0 : d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96
                                                  : d <= 128 ? 128 : 0;
}

// Largest dynamic shared memory one block may use on sm_90.
constexpr size_t kMaxSmemBytes = 232448;

}  // namespace ssmv
