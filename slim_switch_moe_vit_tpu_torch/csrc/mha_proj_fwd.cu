// Multi-head attention forward with the output projection folded in (K12).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_proj_kernel (:335), reached through _mha_proj_fwd_call (:377)
// and fused_mha_proj (:393):
//   y = sum over heads h of bf16(softmax(q_h k_h^T * scale) v_h) . Wp[h] + bp
// over the packed qkv (B, N, 3C), with Wp[h] = Wp[h*d : (h+1)*d, :] (Wp is
// (C, C), in qkv's dtype; bp (C,) f32) and y (B, N, C) in qkv's dtype.
//
// What bounds it on the H100: per (sample, head) pair the work and traffic
// of K5 (mha_fwd.cu), plus the proj product (2 N C^2 flops a sample); the
// (B, N, C) attention output never goes to device memory. Like K5, this
// first kernel does every product with f32 FMAs on the CUDA cores, so it is
// bound by shared-memory loads and FMA throughput.
//
// Design: K5 runs one block per (query tile, head, sample); the fold has to
// sum over the heads, so K12 runs one block per (query tile, sample) that
// loops over the heads. Each head runs K5's body on the tile (q scaled in
// f32, K^T and V of the head in shared memory for all N rows, the exact
// softmax over the whole score row, p rounded to the activation dtype for
// the PV product, the output scaled by 1/sum), rounds o_h to the activation
// dtype as the TPU kernel does (attention.py:364), and adds o_h . Wp[h]
// into an f32 (rows x C) accumulator held in registers (QT / 8 rows x
// C / 32 columns a thread, at most 48). The query tile is sized by C so
// that the accumulator fits: QT = 64 rows for C <= 192, 32 for C <= 384,
// 16 for C <= 768. Wp is read from device memory through the cache (each
// block reads all of it once a head). Shared memory is K5's layout at
// QT <= 64 rows, so K12 takes N up to that layout's caps at 64 rows (416
// in bf16, 272 in f32; ssmv_mha_proj_max_n).
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kHD = 64;        // head dim
constexpr int kColChunk = 128; // score columns per register pass
constexpr int kQLD = kHD + 4;

__host__ __device__ constexpr size_t smem_bytes(int qt, int np, size_t tsize) {
  return sizeof(float) * ((size_t)qt * kQLD + (size_t)qt * (np + 4) + qt) +
         tsize * 2 * (size_t)kHD * np;
}

// QT query rows a block; NJ = the most C / 32 columns a thread accumulates
template <typename T, int QT>
__global__ void __launch_bounds__(kThreads, 1)
mha_proj_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ wp,
                    const float* __restrict__ bp, T* __restrict__ y, int N,
                    int NP, int H, float scale) {
  constexpr int RPT = QT / 16;         // score / PV rows a thread
  constexpr int YR = QT / 8;           // y rows a thread
  constexpr int NJ = 24 * 16 / QT;     // y column groups a thread, at most
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = H * kHD, C3 = 3 * C;
  const int nj = C / 32;
  const int q0 = blockIdx.x * QT;
  const int b = blockIdx.y;
  const int SLD = NP + 4;

  float* Qs = reinterpret_cast<float*>(smem_raw);  // QT x kQLD; then o_h
  float* S = Qs + QT * kQLD;                       // QT x SLD
  float* linv = S + QT * SLD;                      // QT
  T* Kt = reinterpret_cast<T*>(linv + QT);         // kHD x NP
  T* Vs = Kt + kHD * NP;                           // NP x kHD

  const T* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 4, cl = tid & 15;

  float yacc[YR][NJ];
#pragma unroll
  for (int i = 0; i < YR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) yacc[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the last head's readers of Qs (o_h), Kt, Vs are done
    for (int i = tid; i < QT * kHD; i += kThreads) {
      const int r = i / kHD, c = i % kHD;
      const int n = q0 + r;
      Qs[r * kQLD + c] =
          n < N ? ssmv::to_f32(base[(size_t)n * C3 + h * kHD + c]) * scale
                : 0.f;
    }
    for (int i = tid; i < NP * kHD; i += kThreads) {
      const int n = i / kHD, c = i % kHD;
      T kv = ssmv::from_f32<T>(0.f), vv = ssmv::from_f32<T>(0.f);
      if (n < N) {
        const T* row = base + (size_t)n * C3 + h * kHD + c;
        kv = row[C];
        vv = row[2 * C];
      }
      Kt[c * NP + n] = kv;
      Vs[n * kHD + c] = vv;
    }
    __syncthreads();

    // scores: thread (rg, cl) owns rows rg*RPT.. and columns cl + 16*j
    for (int cb = 0; cb < NP; cb += kColChunk) {
      float acc[RPT][8];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int kk = 0; kk < kHD; ++kk) {
        float qv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) qv[i] = Qs[(rg * RPT + i) * kQLD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = cb + cl + 16 * j;
          const float kv = c < NP ? ssmv::to_f32(Kt[kk * NP + c]) : 0.f;
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

    // softmax numerator: each warp takes QT / 8 rows
    for (int rr = 0; rr < QT / 8; ++rr) {
      const int r = warp * (QT / 8) + rr;
      float* srow = S + r * SLD;
      float m = -CUDART_INF_F;
      for (int c = lane; c < NP; c += 32) m = fmaxf(m, srow[c]);
      m = ssmv::warp_max(m);
      float l = 0.f;
      for (int c = lane; c < NP; c += 32) {
        const float p = expf(srow[c] - m);
        l += p;
        srow[c] = ssmv::to_f32(ssmv::from_f32<T>(p));
      }
      l = ssmv::warp_sum(l);
      if (lane == 0) linv[r] = 1.f / l;
    }
    __syncthreads();

    // o_h = p . v scaled by 1/sum, rounded to T, into Qs (q is no longer read)
    {
      float o[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
      for (int n = 0; n < NP; ++n) {
        float pv[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) pv[i] = S[(rg * RPT + i) * SLD + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float vv = ssmv::to_f32(Vs[n * kHD + cl + 16 * j]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = rg * RPT + i;
        const float li = linv[r];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Qs[r * kQLD + cl + 16 * j] =
              ssmv::to_f32(ssmv::from_f32<T>(o[i][j] * li));
      }
    }
    __syncthreads();

    // y += o_h . Wp[h]: thread (warp, lane) owns rows warp + 8 i and
    // columns lane + 32 j
    const T* wph = wp + (size_t)h * kHD * C;
    for (int k = 0; k < kHD; ++k) {
      float ov[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) ov[i] = Qs[(warp + 8 * i) * kQLD + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const float wv = ssmv::to_f32(wph[(size_t)k * C + lane + 32 * j]);
#pragma unroll
          for (int i = 0; i < YR; ++i) yacc[i][j] = fmaf(ov[i], wv, yacc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < YR; ++i) {
    const int n = q0 + warp + 8 * i;
    if (n < N) {
      T* yrow = y + ((size_t)b * N + n) * C;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (j < nj) {
          const int c = lane + 32 * j;
          yrow[c] = ssmv::from_f32<T>(yacc[i][j] + bp[c]);
        }
      }
    }
  }
}

// The largest N taken: the layout at 64 query rows must fit (the caps of
// K5's whole-row layout, 416 in bf16 and 272 in f32).
int max_n(size_t tsize) {
  int np = 16;
  while (smem_bytes(64, np + 16, tsize) <= ssmv::kMaxSmemBytes) np += 16;
  return np;
}

template <typename T, int QT>
cudaError_t launch(const void* qkv, const void* wp, const void* bp, void* y,
                   int B, int N, int H, float scale, cudaStream_t stream) {
  const int NP = (N + 15) / 16 * 16;
  if (N > max_n(sizeof(T))) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(QT, NP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mha_proj_fwd_kernel<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + QT - 1) / QT, B);
  mha_proj_fwd_kernel<T, QT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(y), N, NP, H, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* wp, const void* bp, void* y,
                     int B, int N, int H, float scale, cudaStream_t s) {
  const int C = H * kHD;
  if (C <= 192) return launch<T, 64>(qkv, wp, bp, y, B, N, H, scale, s);
  if (C <= 384) return launch<T, 32>(qkv, wp, bp, y, B, N, H, scale, s);
  return launch<T, 16>(qkv, wp, bp, y, B, N, H, scale, s);
}

}  // namespace

// qkv (B, N, 3C), wp (C, C) of qkv's dtype, bp (C,) f32 -> y (B, N, C) of
// qkv's dtype, bf16 (is_bf16 = 1) or f32; C = H * 64 <= 768;
// N <= ssmv_mha_proj_max_n(is_bf16). All contiguous.
extern "C" int ssmv_mha_proj_fwd(const void* qkv, const void* wp,
                                 const void* bp, void* y, int B, int N, int H,
                                 int head_dim, float scale, int is_bf16,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || head_dim != kHD ||
      H * kHD > 768)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(qkv, wp, bp, y, B, N, H, scale, s)
              : dispatch<float>(qkv, wp, bp, y, B, N, H, scale, s);
  return (int)err;
}

extern "C" int ssmv_mha_proj_max_n(int is_bf16) {
  return max_n(is_bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
}
