// Shared helpers for the hand-written Hopper kernels of the serving path.
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

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Largest dynamic shared memory one block may use on sm_90.
constexpr size_t kMaxSmemBytes = 232448;

}  // namespace ssmv
