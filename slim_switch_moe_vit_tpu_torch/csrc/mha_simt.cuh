// The SIMT attention of one head over a query tile, shared by the f32
// forms of K5 (mha_fwd.cu) and K12 (mha_proj_fwd.cu).
//
// 256 threads; QT query rows (16, 32 or 64), head width HD (a multiple of
// 16; the head's d <= HD columns are read, the rest are zero). K and V
// stream through one shared tile of kColChunk rows (rows >= N zero). The
// QT x NP f32 score tile stays in shared memory, so the softmax is exact
// over all N columns (no online rescaling), in the TPU kernel's order
// (attention.py:186-200):
//   1. q is scaled in f32 before the QK^T product (f32 FMAs),
//   2. score columns >= N are set to -inf,
//   3. p = exp(s - max) in f32, the row sum taken from that f32 p,
//   4. p rounded to T for the PV product (f32 sums),
//   5. the output scaled by 1/sum afterwards (by the caller, from linv).
#pragma once

#include <math_constants.h>

#include "common.cuh"

namespace ssmv {
namespace simt {

constexpr int kThreads = 256;  // 8 warps
constexpr int kColChunk = 128; // score columns per register pass (16 lanes
                               // x 8) and K / V rows per shared tile

__host__ __device__ constexpr int q_ld(int hd) { return hd + 4; }
__host__ __device__ constexpr int s_ld(int np) { return np + 4; }

// shared bytes: Qs (QT x q_ld f32), S (QT x s_ld f32), linv (QT f32), the
// K / V tile (kColChunk x HD of T)
__host__ __device__ constexpr size_t smem_bytes(int qt, int hd, int np,
                                                size_t tsize) {
  return sizeof(float) * ((size_t)qt * q_ld(hd) + (size_t)qt * s_ld(np) + qt) +
         tsize * (size_t)kColChunk * hd;
}

template <typename T>
struct Smem {
  float* Qs;    // QT x q_ld(HD)
  float* S;     // QT x s_ld(NP)
  float* linv;  // QT
  T* Tile;      // HD x kColChunk (K^T) or kColChunk x HD (V)
};

template <typename T>
__device__ __forceinline__ Smem<T> carve(unsigned char* raw, int qt, int hd,
                                         int np) {
  Smem<T> s;
  s.Qs = reinterpret_cast<float*>(raw);
  s.S = s.Qs + qt * q_ld(hd);
  s.linv = s.S + qt * s_ld(np);
  s.Tile = reinterpret_cast<T*>(s.linv + qt);
  return s;
}

// o[i][j] (unnormalized) of row rg * RPT + i and column cl + 16 j of the
// tile, thread (rg, cl) = (tid / 16, tid % 16); linv[r] = 1 / sum of row r.
// base: the sample's row 0 at the head's q column (k at +C, v at +2C), row
// stride C3. The caller syncs the block before it reuses Qs, S or Tile.
template <typename T, int HD, int QT>
__device__ __forceinline__ void head_attention(const T* base, size_t C3, int C,
                                               int N, int NP, int q0, int d,
                                               float scale, const Smem<T>& sm,
                                               float (&o)[QT / 16][HD / 16]) {
  constexpr int RPT = QT / 16;  // score / PV rows a thread
  constexpr int CJ = HD / 16;   // PV columns a thread
  constexpr int QLD = q_ld(HD);
  const int SLD = s_ld(NP);
  const int tid = threadIdx.x;

  for (int i = tid; i < QT * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const int n = q0 + r;
    sm.Qs[r * QLD + c] =
        n < N && c < d ? to_f32(base[(size_t)n * C3 + c]) * scale : 0.f;
  }

  // scores: thread (rg, cl) owns rows rg*RPT.. and columns cb + cl + 16*j
  const int rg = tid >> 4, cl = tid & 15;
  for (int cb = 0; cb < NP; cb += kColChunk) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kColChunk * HD; i += kThreads) {
      const int n = i / HD, c = i % HD;
      T kv = from_f32<T>(0.f);
      if (cb + n < N && c < d) kv = base[(size_t)(cb + n) * C3 + C + c];
      sm.Tile[c * kColChunk + n] = kv;
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
      for (int i = 0; i < RPT; ++i) qv[i] = sm.Qs[(rg * RPT + i) * QLD + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = to_f32(sm.Tile[kk * kColChunk + cl + 16 * j]);
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
          sm.S[(rg * RPT + i) * SLD + c] = c < N ? acc[i][j] : -CUDART_INF_F;
      }
    }
  }
  __syncthreads();

  // softmax numerator: each warp takes QT / 8 rows
  const int warp = tid >> 5, lane = tid & 31;
  for (int rr = 0; rr < QT / 8; ++rr) {
    const int r = warp * (QT / 8) + rr;
    float* srow = sm.S + r * SLD;
    float m = -CUDART_INF_F;
    for (int c = lane; c < NP; c += 32) m = fmaxf(m, srow[c]);
    m = warp_max(m);
    float l = 0.f;
    for (int c = lane; c < NP; c += 32) {
      const float p = expf(srow[c] - m);  // masked columns give exactly 0
      l += p;
      srow[c] = to_f32(from_f32<T>(p));
    }
    l = warp_sum(l);
    if (lane == 0) sm.linv[r] = 1.f / l;
  }

  // o = p . v over kColChunk-row V tiles (pad rows zero: 0 * garbage never
  // reaches o)
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[i][j] = 0.f;
  for (int cb = 0; cb < NP; cb += kColChunk) {
    __syncthreads();  // p is complete; the last tile's readers are done
    for (int i = tid; i < kColChunk * HD; i += kThreads) {
      const int n = i / HD, c = i % HD;
      T vv = from_f32<T>(0.f);
      if (cb + n < N && c < d) vv = base[(size_t)(cb + n) * C3 + 2 * C + c];
      sm.Tile[n * HD + c] = vv;
    }
    __syncthreads();
    const int nt = min(kColChunk, NP - cb);
    for (int n = 0; n < nt; ++n) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sm.S[(rg * RPT + i) * SLD + cb + n];
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float vv = to_f32(sm.Tile[n * HD + cl + 16 * j]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) o[i][j] = fmaf(pv[i], vv, o[i][j]);
      }
    }
  }
}

}  // namespace simt
}  // namespace ssmv
