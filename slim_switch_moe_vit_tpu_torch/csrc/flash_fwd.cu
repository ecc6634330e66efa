// Online-softmax attention forward over the packed qkv tensor (K11).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _flash_kernel (:35), reached through _flash_forward (:74) and
// flash_attention (:120). Input qkv (B, N, 3C) with q, k and v of head h
// at columns [h*64, h*64+64), [C + h*64, ...) and [2C + h*64, ...); output
// (B, N, C). q, k and v are read from the packed tensor by stride and the
// output is written in place of the JAX wrapper's transposes and its pads
// of N and d to the TPU's tile sizes (attention.py:77-107). bf16 only,
// head_dim 64, any N.
//
// What bounds it on the H100: at ViT lengths, device-memory bytes (qkv read
// once, the output written once: 0.023 ms at B = 128, N = 197) against two
// N x N x 64 products per (sample, head) on the tensor cores; neither
// N x N matrix touches device memory.
//
// Design: one block of 4 warps per (64-query tile, head, sample); each
// warp owns 16 query rows, its q fragments held in registers for the whole
// loop. K and V pass through shared memory in tiles of 64 rows (rows >= N
// are zero). Per tile:
//   S = q . k^T on the tensor cores (WMMA bf16 16x16x16, f32 sums), then
//   scaled by `scale` in f32; columns >= N set to -inf;
//   the online softmax in f32: m' = max(m, rowmax S), alpha = exp(m - m'),
//   P = exp(S - m'), l' = l*alpha + rowsum P, the f32 output accumulator
//   (in shared memory) scaled by alpha;
//   P rounded to bf16, acc += P . V on the tensor cores (f32 sums).
// At the end out = acc / max(l, 1e-30), rounded once to bf16.
// The JAX kernel keeps q*scale and P in f32 (attention.py:43, :60); P is
// rounded to bf16 here, as K5 and the JAX package's fused_mha do, so both
// tensor-core operands are bf16. For scale = 64^-1/2, a power of two,
// scaling q first or S after gives the same numbers.
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kHD = 64;         // head dim
constexpr int kT = 64;          // query rows per block, key rows per tile
constexpr int kThreads = 128;   // 4 warps, 16 query rows each
constexpr int kLD = kHD + 8;    // bf16 rows of Q, K, V, P
constexpr int kFLD = kHD + 4;   // f32 rows of S and the accumulator

constexpr size_t kQ = 0;
constexpr size_t kK = kQ + sizeof(bf16) * kT * kLD;
constexpr size_t kV = kK + sizeof(bf16) * kT * kLD;
constexpr size_t kP = kV + sizeof(bf16) * kT * kLD;
constexpr size_t kS = kP + sizeof(bf16) * kT * kLD;
constexpr size_t kO = kS + sizeof(float) * kT * kFLD;
constexpr size_t kSmem = kO + sizeof(float) * kT * kFLD;

// rows [r0, r0 + kT) of one head's 64 columns starting at src (row stride
// C3), rows >= N zero, into a kLD-strided bf16 tile
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int N, int C3) {
  constexpr int V8 = kHD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < kT * V8; i += kThreads) {
    const int r = i / V8, v = i % V8, n = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (n < N) val = *reinterpret_cast<const uint4*>(src + (size_t)n * C3 + v * 8);
    *reinterpret_cast<uint4*>(dst + r * kLD + v * 8) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
                 int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + kQ);
  bf16* Ks = reinterpret_cast<bf16*>(smem + kK);
  bf16* Vs = reinterpret_cast<bf16*>(smem + kV);
  bf16* Ps = reinterpret_cast<bf16*>(smem + kP);
  float* S = reinterpret_cast<float*>(smem + kS);
  float* O = reinterpret_cast<float*>(smem + kO);

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kHD, C3 = 3 * C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * N * C3 + h * kHD;

  load_tile(Qs, base, q0, N, C3);
  for (int i = threadIdx.x; i < kT * kFLD; i += kThreads) O[i] = 0.f;
  __syncthreads();

  const int w0 = warp * 16;  // this warp's first row in the tile
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kHD / 16];
#pragma unroll
  for (int kd = 0; kd < kHD / 16; ++kd)
    wmma::load_matrix_sync(qf[kd], Qs + w0 * kLD + kd * 16, kLD);

  // softmax bookkeeping: lane owns row w0 + lane/2, columns [half*32, +32)
  const int r = w0 + (lane >> 1), c0 = (lane & 1) * 32;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();  // every warp is done with the last K and V tiles
    load_tile(Ks, base + C, k0, N, C3);
    load_tile(Vs, base + 2 * C, k0, N, C3);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kd = 0; kd < kHD / 16; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * kLD + kd * 16, kLD);
        wmma::mma_sync(s, qf[kd], kf, s);
      }
      wmma::store_matrix_sync(S + w0 * kFLD + j * 16, s, kFLD,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float* srow = S + r * kFLD + c0;
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float v = k0 + c0 + c < N ? srow[c] * scale : -CUDART_INF_F;
      srow[c] = v;
      tmax = fmaxf(tmax, v);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);  // finite: column k0 < N is valid
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
    bf16* prow = Ps + r * kLD + c0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - m_new);  // masked columns give 0
      psum += p;
      prow[c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = O + r * kFLD + c0;
#pragma unroll
    for (int c = 0; c < 32; ++c) orow[c] *= alpha;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < kHD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, O + w0 * kFLD + j * 16, kFLD,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + w0 * kLD + kk * 16, kLD);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kLD + j * 16, kLD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(O + w0 * kFLD + j * 16, acc, kFLD,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int n = q0 + r;
  if (n < N) {
    const float linv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = O + r * kFLD + c0;
    bf16* dst = out + ((size_t)b * N + n) * C + h * kHD + c0;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      __align__(16) bf16 vals[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        vals[e] = __float2bfloat16(orow[v * 8 + e] * linv);
      *reinterpret_cast<uint4*>(dst + v * 8) =
          *reinterpret_cast<const uint4*>(vals);
    }
  }
}

}  // namespace

// qkv (B, N, 3*H*64) bf16 -> out (B, N, H*64) bf16, both contiguous and
// 16-byte aligned.
extern "C" int ssmv_flash_fwd(const void* qkv, void* out, int B, int N, int H,
                              int head_dim, float scale, void* stream) {
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || head_dim != kHD)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kT - 1) / kT, H, B);
  flash_fwd_kernel<<<grid, kThreads, kSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, scale);
  return (int)cudaGetLastError();
}
