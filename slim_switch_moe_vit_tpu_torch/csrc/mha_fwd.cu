// Multi-head attention forward over the packed qkv tensor (K5).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_kernel (:168), reached through _mha_fwd_call (:279) and fused_mha
// (:296). Input qkv is (B, N, 3C) with q of head h at columns [h*d, h*d+d),
// k at [C + h*d, ...) and v at [2C + h*d, ...); the output is (B, N, C),
// ready for the proj GEMM. No host-side transposes or padding. N <= 1024,
// the lengths the JAX package runs its kernel at (models/vit.py:50-59).
//
// What bounds it on the H100: at ViT lengths (N = 197, d = 64) the whole
// score row of a query fits on chip, so device-memory traffic is qkv in and
// o out (~1 MB per sample at ViT-S, K and V re-read once per query tile);
// the work is the two N x N x d products. This first kernel does them with
// f32 FMAs on the CUDA cores (no tensor cores), so it is bound by
// shared-memory loads and FMA throughput, not by bytes. Tensor-core
// (wgmma / mma.sync) products are later work.
//
// Design: one block per (QT-row q tile, head, sample), 256 threads. K and V
// of the head stream through one shared-memory buffer in tiles of 128 rows
// (rows >= N zero-filled): first K (stored transposed) for the scores, then
// V for the PV product. The QT x NP score tile stays in shared memory in
// f32, so the softmax is exact over all N columns (no online rescaling).
// QT is 64 where that tile fits (NP <= 704 in f32, 768 in bf16) and 32
// beyond, up to N = 1024. The arithmetic keeps the TPU kernel's order
// (attention.py:186-200):
//   1. q is scaled in f32 before the QK^T product,
//   2. score columns >= N are set to -inf,
//   3. p = exp(s - max) in f32, the row sum taken from that f32 p,
//   4. p rounded to the activation dtype for the PV product (f32 sums),
//   5. the output scaled by 1/sum afterwards.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kColChunk = 128; // score columns per register pass (16 lanes x 8)
                               // and K / V rows per shared-memory tile
constexpr int kMaxN = 1024;

__host__ __device__ constexpr int q_ld(int hd) { return hd + 4; }
__host__ __device__ constexpr int s_ld(int np) { return np + 4; }

__host__ __device__ constexpr size_t smem_bytes(int qt, int hd, int np,
                                                size_t tsize) {
  return sizeof(float) * ((size_t)qt * q_ld(hd) + (size_t)qt * s_ld(np) + qt) +
         tsize * (size_t)kColChunk * hd;
}
static_assert(smem_bytes(32, 64, kMaxN, 4) <= ssmv::kMaxSmemBytes,
              "K5 must take N = 1024 at 32 query rows");

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int NP,
               int H, float scale) {
  constexpr int RPT = QT / 16;  // score / PV rows a thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * HD;
  const int C3 = 3 * C;
  const int q0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int QLD = q_ld(HD);
  const int SLD = s_ld(NP);

  float* Qs = reinterpret_cast<float*>(smem_raw);  // QT x QLD, scaled q
  float* S = Qs + QT * QLD;                        // QT x SLD, scores then p
  float* linv = S + QT * SLD;                      // QT
  T* Tile = reinterpret_cast<T*>(linv + QT);       // HD x 128 K^T, 128 x HD V

  const T* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x;

  for (int i = tid; i < QT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int n = q0 + r;
    Qs[r * QLD + c] =
        n < N ? ssmv::to_f32(base[(size_t)n * C3 + h * HD + c]) * scale : 0.f;
  }

  // Scores: thread (rg, cl) owns rows rg*RPT.. and columns cb + cl + 16*j
  // of each 128-column K tile.
  const int rg = tid >> 4, cl = tid & 15;
  for (int cb = 0; cb < NP; cb += kColChunk) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kColChunk * HD; i += kThreads) {
      const int n = i / HD, c = i % HD;
      T kv = ssmv::from_f32<T>(0.f);
      if (cb + n < N) kv = base[(size_t)(cb + n) * C3 + C + h * HD + c];
      Tile[c * kColChunk + n] = kv;
    }
    __syncthreads();
    float acc[RPT][8];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int kk = 0; kk < HD; ++kk) {
      float qv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * QLD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = ssmv::to_f32(Tile[kk * kColChunk + cl + 16 * j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(qv[i], kv, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = cb + cl + 16 * j;
      if (c < NP) {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          S[(rg * RPT + i) * SLD + c] = c < N ? acc[i][j] : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  // Softmax numerator: each warp takes QT / 8 rows.
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < QT / 8; ++rr) {
    const int r = warp * (QT / 8) + rr;
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

  // o = p . v over 128-row V tiles, then scaled by 1/sum; thread (rg, cl)
  // owns rows rg*RPT.. and columns cl + 16*j.
  constexpr int CJ = HD / 16;
  float o[RPT][CJ];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[i][j] = 0.f;
  for (int cb = 0; cb < NP; cb += kColChunk) {
    __syncthreads();  // p is complete; the last tile's readers are done
    for (int i = tid; i < kColChunk * HD; i += kThreads) {
      const int n = i / HD, c = i % HD;
      T vv = ssmv::from_f32<T>(0.f);  // pad rows zero: 0 * garbage never
      if (cb + n < N) vv = base[(size_t)(cb + n) * C3 + 2 * C + h * HD + c];
      Tile[n * HD + c] = vv;          // reaches o
    }
    __syncthreads();
    const int nt = min(kColChunk, NP - cb);
    for (int n = 0; n < nt; ++n) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = S[(rg * RPT + i) * SLD + cb + n];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = ssmv::to_f32(Tile[n * HD + cl + 16 * j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
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

template <typename T, int HD, int QT>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H,
                   float scale, cudaStream_t stream) {
  const int NP = (N + 15) / 16 * 16;
  const size_t smem = smem_bytes(QT, HD, NP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_kernel<T, HD, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QT - 1) / QT, H, B);
  mha_fwd_kernel<T, HD, QT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, NP, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, void* out, int B, int N, int H,
                     float scale, cudaStream_t s) {
  const int NP = (N + 15) / 16 * 16;
  if (smem_bytes(64, 64, NP, sizeof(T)) <= ssmv::kMaxSmemBytes)
    return launch<T, 64, 64>(qkv, out, B, N, H, scale, s);
  return launch<T, 64, 32>(qkv, out, B, N, H, scale, s);
}

}  // namespace

// qkv (B, N, 3*H*head_dim) -> out (B, N, H*head_dim), both contiguous, of
// bf16 (is_bf16 = 1) or f32 (is_bf16 = 0). head_dim is 64, the width of
// every model of the port; N <= 1024.
extern "C" int ssmv_mha_fwd(const void* qkv, void* out, int B, int N, int H,
                            int head_dim, float scale, int is_bf16,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || head_dim != 64 ||
      N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(qkv, out, B, N, H, scale, s)
              : dispatch<float>(qkv, out, B, N, H, scale, s);
  return (int)err;
}
