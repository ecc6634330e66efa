// Multi-head attention forward over the packed qkv tensor (K5).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_kernel (:168), reached through _mha_fwd_call (:279) and fused_mha
// (:296). Input qkv is (B, N, 3C) with q of head h at columns [h*d, h*d+d),
// k at [C + h*d, ...) and v at [2C + h*d, ...); the output is (B, N, C),
// ready for the proj GEMM. No host-side transposes or padding.
//
// What bounds it on the H100: at ViT lengths (N = 197, d = 64) the whole
// score matrix of one (sample, head) pair fits on chip, so device-memory
// traffic is only qkv in and o out (~1 MB per sample at ViT-S); the work is
// the two N x N x d products. This first kernel does them with f32 FMAs on
// the CUDA cores (no tensor cores), so it is bound by shared-memory loads and
// FMA throughput, not by bytes. Tensor-core (wgmma / mma.sync) products are later
// work.
//
// Design: one block per (64-row q tile, head, sample), 256 threads. K (stored
// transposed) and V of that head live in shared memory for all N rows, rows
// >= N zero-filled; the 64 x NP score tile stays in shared memory in f32, so
// the softmax is exact over all N columns (no online rescaling). The
// arithmetic keeps the TPU kernel's order (attention.py:186-200):
//   1. q is scaled in f32 before the QK^T product,
//   2. score columns >= N are set to -inf,
//   3. p = exp(s - max) in f32, the row sum taken from that f32 p,
//   4. p rounded to the activation dtype for the PV product (f32 sums),
//   5. the output scaled by 1/sum afterwards.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kQT = 64;        // q rows per block
constexpr int kThreads = 256;  // 8 warps
constexpr int kColChunk = 128; // score columns per register pass (16 lanes x 8)

__host__ __device__ constexpr int q_ld(int hd) { return hd + 4; }
__host__ __device__ constexpr int s_ld(int np) { return np + 4; }

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int NP,
               int H, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * HD;
  const int C3 = 3 * C;
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int QLD = q_ld(HD);
  const int SLD = s_ld(NP);

  float* Qs = reinterpret_cast<float*>(smem_raw);  // kQT x QLD, scaled q
  float* S = Qs + kQT * QLD;                       // kQT x SLD, scores then p
  float* linv = S + kQT * SLD;                     // kQT
  T* Kt = reinterpret_cast<T*>(linv + kQT);        // HD x NP, k transposed
  T* Vs = Kt + HD * NP;                            // NP x HD

  const T* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x;

  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int n = q0 + r;
    Qs[r * QLD + c] =
        n < N ? ssmv::to_f32(base[(size_t)n * C3 + h * HD + c]) * scale : 0.f;
  }
  for (int i = tid; i < NP * HD; i += kThreads) {
    const int n = i / HD, c = i % HD;
    T kv = ssmv::from_f32<T>(0.f), vv = ssmv::from_f32<T>(0.f);
    if (n < N) {
      const T* row = base + (size_t)n * C3 + h * HD + c;
      kv = row[C];
      vv = row[2 * C];
    }
    Kt[c * NP + n] = kv;
    Vs[n * HD + c] = vv;  // pad rows zero: 0 * garbage can never reach o
  }
  __syncthreads();

  // Scores: thread (rg, cl) owns rows rg*4..rg*4+3 and columns cl + 16*j.
  const int rg = tid >> 4, cl = tid & 15;
  for (int cb = 0; cb < NP; cb += kColChunk) {
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < HD; ++kk) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * QLD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = cb + cl + 16 * j;
        const float kv = c < NP ? ssmv::to_f32(Kt[kk * NP + c]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(qv[i], kv, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb + cl + 16 * j;
      if (c < NP) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          S[(rg * 4 + i) * SLD + c] = c < N ? acc[i][j] : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  // Softmax numerator: each warp takes kQT / 8 rows.
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < kQT / 8; ++rr) {
    const int r = warp * (kQT / 8) + rr;
    float* srow = S + r * SLD;
    float m = -CUDART_INF_F;
    for (int c = lane; c < NP; c += 32) m = fmaxf(m, srow[c]);
    m = ssmv::warp_max(m);
    float l = 0.f;
    for (int c = lane; c < NP; c += 32) {
      const float p = expf(srow[c] - m);  // masked columns give exactly 0
      l += p;
      srow[c] = ssmv::to_f32(ssmv::from_f32<T>(p));
    }
    l = ssmv::warp_sum(l);
    if (lane == 0) linv[r] = 1.f / l;
  }
  __syncthreads();

  // o = p . v, then scaled by 1/sum; thread (rg, cl) owns rows rg*4.. and
  // columns cl + 16*j.
  constexpr int CJ = HD / 16;
  float o[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[i][j] = 0.f;
  for (int n = 0; n < NP; ++n) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = S[(rg * 4 + i) * SLD + n];
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const float vv = ssmv::to_f32(Vs[n * HD + cl + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int n = q0 + r;
    if (n < N) {
      const float li = linv[r];
      T* orow = out + ((size_t)b * N + n) * C + h * HD;
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        orow[cl + 16 * j] = ssmv::from_f32<T>(o[i][j] * li);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H,
                   float scale, cudaStream_t stream) {
  const int NP = (N + 15) / 16 * 16;
  const size_t smem = sizeof(float) * (size_t)(kQT * q_ld(HD) + kQT * s_ld(NP) + kQT) +
                      sizeof(T) * 2 * (size_t)HD * NP;
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kQT - 1) / kQT, H, B);
  mha_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, NP, H, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, N, 3*H*head_dim) -> out (B, N, H*head_dim), both contiguous, of
// bf16 (is_bf16 = 1) or f32 (is_bf16 = 0). head_dim is 64, the width of
// every DeiT/ViT model of the package.
extern "C" int ssmv_mha_fwd(const void* qkv, void* out, int B, int N, int H,
                            int head_dim, float scale, int is_bf16,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || head_dim != 64)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16, 64>(qkv, out, B, N, H, scale, s)
              : launch<float, 64>(qkv, out, B, N, H, scale, s);
  return (int)err;
}
