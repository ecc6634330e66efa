// Floors of the card for the expert-FFN forward's design: the mma.sync rate
// on register operands, and the L2 -> shared memory rate of cp.async
// streaming (scripts/ffn_fwd_tilings.py --floors builds and times them).
#include "../slim_switch_moe_vit_tpu_torch/csrc/mma_sync.cuh"
using namespace ssmv::tc;

__global__ void __launch_bounds__(256, 1) mb_mma(float* out, int iters) {
  float acc[16][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u}, b0 = threadIdx.x, b1 = 5u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) mma(acc[j], a, b0, b1);
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  if (s == 1.2345f) out[threadIdx.x] = s;
}

// each block streams `bytes_per_block` bytes starting at src + (blockIdx % n_src) * bytes_per_block
// through a 3-stage ring of `stage` bytes (256 threads, 16 B each copy)
__global__ void __launch_bounds__(256, 1) mb_l2(const char* src, long long bytes_per_block, int n_src, int stage, float* out) {
  extern __shared__ __align__(128) char sm[];
  const char* base = src + (size_t)(blockIdx.x % n_src) * bytes_per_block;
  const int steps = bytes_per_block / stage;
  auto issue = [&](int t) {
    if (t < steps) {
      char* st = sm + (t % 3) * stage;
      for (int i = threadIdx.x * 16; i < stage; i += 256 * 16)
        cp_async16(st + i, base + (size_t)t * stage + i, true);
    }
    cp_async_commit();
  };
  issue(0); issue(1);
  float s = 0.f;
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<1>();
    __syncthreads();
    issue(t + 2);
    s += (float)sm[(t % 3) * stage + threadIdx.x];
  }
  if (s == 1.2345f) out[threadIdx.x] = s;
}

extern "C" int run_mb_mma(float* out, int blocks, int iters, void* s) {
  mb_mma<<<blocks, 256, 0, (cudaStream_t)s>>>(out, iters);
  return cudaGetLastError();
}
extern "C" int run_mb_l2(const void* src, long long bpb, int n_src, int stage, int blocks, float* out, void* s) {
  cudaFuncSetAttribute(mb_l2, cudaFuncAttributeMaxDynamicSharedMemorySize, 200 * 1024);
  mb_l2<<<blocks, 256, 200 * 1024, (cudaStream_t)s>>>((const char*)src, bpb, n_src, stage, out);
  return cudaGetLastError();
}
