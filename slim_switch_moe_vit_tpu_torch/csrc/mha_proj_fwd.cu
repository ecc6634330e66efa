// Multi-head attention forward with the output projection folded in (K12).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_proj_kernel (:335), reached through _mha_proj_fwd_call (:377)
// and fused_mha_proj (:393):
//   y = sum over heads h of T(softmax(q_h k_h^T * scale) v_h) . Wp[h] + bp
// over the packed qkv (B, N, 3C), with Wp[h] = Wp[h*d : (h+1)*d, :] (Wp is
// (C, C), in qkv's dtype T; bp (C,) f32) and y (B, N, C) in T. N <= 1024,
// C <= 1280, head_dim d <= 128 (on the smallest instance HD in {32, 64,
// 96, 128} >= d).
//
// What bounds it on the H100: per (sample, head) pair the work and traffic
// of K5 (mha_fwd.cu), plus the proj product (2 N C^2 flops a sample); the
// (B, N, C) attention output never goes to device memory. This kernel does
// every product with f32 FMAs on the CUDA cores, so it is bound by
// shared-memory loads and FMA throughput. It is an op on no model path, as
// in the JAX package; correct and simple first.
//
// Design: the fold sums over the heads, so one block runs per (query tile,
// sample) and loops over the heads. Each head runs the SIMT attention of
// mha_simt.cuh on the tile (q scaled in f32, K and V streamed through one
// 128-row shared tile, the exact softmax over the whole score row held in
// shared memory, p rounded to T for the PV product, the output scaled by
// 1/sum), rounds o_h to T as the TPU kernel does (attention.py:364), and
// adds o_h . Wp[h] into an f32 (rows x C) accumulator held in registers:
// thread (warp, lane) owns rows warp + 8 i and columns lane + 32 j, the C
// columns tiled over the lanes (at most 80 accumulators a thread). The
// query tile is 64 rows for C <= 320, 32 for C <= 640 and 16 above (up to
// C = 1280), smaller wherever its score tile does not fit in shared
// memory. Wp is
// read from device memory through the cache (each block reads all of it
// once a head).
#include "mha_simt.cuh"

namespace {

namespace sm = ssmv::simt;

constexpr int kMaxN = 1024;
constexpr int kMaxC = 1280;
constexpr int kYCols = 640;  // QT * NJ: y rows a thread (QT / 8) x NJ = 80

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(sm::kThreads, 1)
mha_proj_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ wp,
                    const float* __restrict__ bp, T* __restrict__ y, int N,
                    int NP, int H, int d, float scale) {
  constexpr int RPT = QT / 16, CJ = HD / 16;  // o rows and columns a thread
  constexpr int YR = QT / 8;                  // y rows a thread
  constexpr int NJ = kYCols / QT;             // y column groups, at most
  constexpr int QLD = sm::q_ld(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const sm::Smem<T> L = sm::carve<T>(smem_raw, QT, HD, NP);
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int nj = (C + 31) / 32;
  const int q0 = blockIdx.x * QT, b = blockIdx.y;
  const T* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 4, cl = tid & 15;

  float yacc[YR][NJ];
#pragma unroll
  for (int i = 0; i < YR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) yacc[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the last head's readers of Qs (o_h) are done
    float o[RPT][CJ];
    sm::head_attention<T, HD, QT>(base + (size_t)h * d, C3, C, N, NP, q0, d,
                                  scale, L, o);
    // o_h rounded to T, into Qs (no thread reads q after the score pass)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const float li = L.linv[r];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        L.Qs[r * QLD + cl + 16 * j] = ssmv::to_f32(ssmv::from_f32<T>(o[i][j] * li));
    }
    __syncthreads();

    // y += o_h . Wp[h]
    const T* wph = wp + (size_t)h * d * C;
    for (int k = 0; k < d; ++k) {
      float ov[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) ov[i] = L.Qs[(warp + 8 * i) * QLD + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          const float wv = ssmv::to_f32(wph[(size_t)k * C + c]);
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
        const int c = lane + 32 * j;
        if (j < nj && c < C) yrow[c] = ssmv::from_f32<T>(yacc[i][j] + bp[c]);
      }
    }
  }
}

template <typename T, int HD, int QT>
cudaError_t launch(const void* qkv, const void* wp, const void* bp, void* y,
                   int B, int N, int NP, int H, int d, float scale,
                   cudaStream_t stream) {
  const size_t smem = sm::smem_bytes(QT, HD, NP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mha_proj_fwd_kernel<T, HD, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mha_proj_fwd_kernel<T, HD, QT><<<dim3((N + QT - 1) / QT, B), sm::kThreads,
                                   smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(y), N, NP, H, d, scale);
  return cudaGetLastError();
}
static_assert(sm::smem_bytes(16, 128, kMaxN, 4) <= ssmv::kMaxSmemBytes,
              "K12 must take N = 1024 at head_dim 128 in f32");

// the largest query tile whose y accumulator holds C columns (QT / 8 rows x
// kYCols / QT groups of 32 a thread) and whose score tile fits
template <typename T, int HD>
cudaError_t dispatch(const void* qkv, const void* wp, const void* bp, void* y,
                     int B, int N, int H, int d, float scale, cudaStream_t s) {
  const int NP = (N + 15) / 16 * 16, C = H * d;
  auto fits = [&](int qt) {
    return C <= kYCols / qt * 32 &&
           sm::smem_bytes(qt, HD, NP, sizeof(T)) <= ssmv::kMaxSmemBytes;
  };
  if (fits(64)) return launch<T, HD, 64>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
  if (fits(32)) return launch<T, HD, 32>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
  return launch<T, HD, 16>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* wp, const void* bp, void* y,
                     int B, int N, int H, int d, float scale, cudaStream_t s) {
  switch (ssmv::head_instance(d)) {
    case 32: return dispatch<T, 32>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 64: return dispatch<T, 64>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 96: return dispatch<T, 96>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 128: return dispatch<T, 128>(qkv, wp, bp, y, B, N, H, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// qkv (B, N, 3C), wp (C, C) of qkv's dtype, bp (C,) f32 -> y (B, N, C) of
// qkv's dtype, bf16 (is_bf16 = 1) or f32; C = H * head_dim <= 1280,
// head_dim <= 128, N <= 1024. All contiguous.
extern "C" int ssmv_mha_proj_fwd(const void* qkv, const void* wp,
                                 const void* bp, void* y, int B, int N, int H,
                                 int head_dim, float scale, int is_bf16,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || N > kMaxN ||
      H * head_dim > kMaxC)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(qkv, wp, bp, y, B, N, H, head_dim,
                                        scale, s)
              : dispatch<float>(qkv, wp, bp, y, B, N, H, head_dim, scale, s);
  return (int)err;
}
