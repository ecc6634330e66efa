// Multi-head attention backward over the packed qkv tensor (K6).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_bwd_kernel (:203), reached through _fused_mha_bwd (:312). Inputs are
// qkv (B, N, 3C) and the output cotangent do (B, N, C); the output d(qkv)
// (B, N, 3C) is written in the packed layout, dq at columns [h*d, h*d+d),
// dk at [C + h*d, ...), dv at [2C + h*d, ...). bf16 only, head_dim 64.
//
// What bounds it on the H100: at ViT lengths the whole backward of one
// (sample, head) pair fits on chip, so device memory sees qkv and do read
// once and d(qkv) written once (~1.6 MB per sample at ViT-S); the work is
// five N x N x d products (19.1 GFLOP per ViT-S layer at B = 128). So it is
// operation-bound, and every product runs on the tensor cores (WMMA bf16
// 16x16x16, f32 accumulation).
//
// Design: one block per (head, sample), 256 threads, the softmax recomputed.
// K and V of the pair sit in shared memory for all N rows (NP = N rounded up
// to 16, pad rows zero). Query rows are taken 16 at a time; a full 16 x NP
// f32 score tile and its do.v^T twin fit in shared memory, so each row's
// softmax is exact over all N columns. dq of the 16 rows is complete within
// the step and written out; dK and dV (2 x NP x 64 f32) are summed over the
// steps in WMMA accumulator fragments spread over the 8 warps (13 fragments
// a warp at NP = 208), and written once at the end. This is the "one block
// per (sample, head), accumulators split across the warps' registers" way
// out: nothing is saved by the forward and no second pass is needed.
//
// Arithmetic, in the JAX kernel's order (attention.py:213-253):
//   s = scale * (q . k^T), f32 sums; columns >= N set to -inf. The JAX
//     kernel scales q first; for scale = 64^-1/2 = 0.125, a power of two,
//     the two are the same numbers;
//   e = exp(s - m), e_bf = bf16(e), linv = 1 / sum(e) from the f32 e;
//   dv = e_bf^T . bf16(do * linv);
//   dp_s = (do . v^T) * (linv * scale): the JAX kernel forms the f32 product
//     (do * linv * scale) . v^T; the row factor is taken out of the product
//     here so both operands stay exact bf16 on the tensor cores (no extra
//     rounding, only another f32 summation order);
//   ds = bf16(e * dp_s - e * linv * rowsum(e * dp_s));
//   dq = ds . k, dk = ds^T . q (q unscaled); each rounded once to bf16.
// Pad rows >= N of q, k, v and do are zero, as in the JAX kernel.
#include <math_constants.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kHD = 64;          // head dim
constexpr int kQB = 16;          // query rows per step
constexpr int kThreads = 256;    // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLD = kHD + 8;     // bf16 rows of K, V, q, do, do*linv
constexpr int kMaxRowTiles = 13; // NP <= 208: 13 dK/dV fragments a warp
constexpr int kAccPerWarp = (2 * kMaxRowTiles * (kHD / 16) + kWarps - 1) / kWarps;

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

struct Layout {
  int NP, SLD, ELD;
  size_t K, V, Q, dO, dOl, S, P, E, DS, stage, bytes;
  __host__ __device__ explicit Layout(int np) : NP(np) {
    SLD = np + 4;  // f32 score rows
    ELD = np + 8;  // bf16 e / ds rows
    K = 0;
    V = align128(K + sizeof(bf16) * np * kLD);
    Q = align128(V + sizeof(bf16) * np * kLD);
    dO = align128(Q + sizeof(bf16) * kQB * kLD);
    dOl = align128(dO + sizeof(bf16) * kQB * kLD);
    S = align128(dOl + sizeof(bf16) * kQB * kLD);
    P = align128(S + sizeof(float) * kQB * SLD);
    E = align128(P + sizeof(float) * kQB * SLD);
    DS = align128(E + sizeof(bf16) * kQB * ELD);
    stage = align128(DS + sizeof(bf16) * kQB * ELD);
    bytes = stage + sizeof(float) * kWarps * 256;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
               bf16* __restrict__ dqkv, int N, int NP, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L(NP);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.V);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.Q);
  bf16* dOs = reinterpret_cast<bf16*>(smem + L.dO);
  bf16* dOl = reinterpret_cast<bf16*>(smem + L.dOl);
  float* S = reinterpret_cast<float*>(smem + L.S);
  float* P = reinterpret_cast<float*>(smem + L.P);
  bf16* Eb = reinterpret_cast<bf16*>(smem + L.E);
  bf16* DSb = reinterpret_cast<bf16*>(smem + L.DS);

  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * kHD, C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* stg = reinterpret_cast<float*>(smem + L.stage) + warp * 256;
  const bf16* base = qkv + (size_t)b * N * C3 + h * kHD;
  const bf16* dobase = dout + (size_t)b * N * C + h * kHD;
  bf16* dbase = dqkv + (size_t)b * N * C3 + h * kHD;
  constexpr int V8 = kHD / 8;  // 16-byte vectors per head row
  const uint4 zero = make_uint4(0, 0, 0, 0);

  for (int i = tid; i < NP * V8; i += kThreads) {
    const int n = i / V8, v = i % V8;
    uint4 kv = zero, vv = zero;
    if (n < N) {
      const bf16* row = base + (size_t)n * C3 + v * 8;
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(Ks + n * kLD + v * 8) = kv;
    *reinterpret_cast<uint4*>(Vs + n * kLD + v * 8) = vv;
  }

  // dV (tiles 0 .. RT*4-1) and dK (the next RT*4) accumulators; warp w owns
  // flat tiles w, w + 8, ...
  const int RT = NP / 16;
  const int n_acc = 2 * RT * (kHD / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kAccPerWarp];
#pragma unroll
  for (int j = 0; j < kAccPerWarp; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int q0 = 0; q0 < NP; q0 += kQB) {
    __syncthreads();  // last step's readers of Qs, dOs, dOl, Eb, DSb are done
    for (int i = tid; i < kQB * V8; i += kThreads) {
      const int r = i / V8, v = i % V8, n = q0 + r;
      uint4 qv = zero, dv = zero;
      if (n < N) {
        qv = *reinterpret_cast<const uint4*>(base + (size_t)n * C3 + v * 8);
        dv = *reinterpret_cast<const uint4*>(dobase + (size_t)n * C + v * 8);
      }
      *reinterpret_cast<uint4*>(Qs + r * kLD + v * 8) = qv;
      *reinterpret_cast<uint4*>(dOs + r * kLD + v * 8) = dv;
    }
    __syncthreads();

    // S = q . k^T and P = do . v^T, one 16x16 column tile per job
    for (int job = warp; job < 2 * RT; job += kWarps) {
      const bool is_s = job < RT;
      const int n0 = (is_s ? job : job - RT) * 16;
      const bf16* A = is_s ? Qs : dOs;
      const bf16* Bm = is_s ? Ks : Vs;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bm;
      wmma::fill_fragment(f, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHD; kk += 16) {
        wmma::load_matrix_sync(a, A + kk, kLD);
        wmma::load_matrix_sync(bm, Bm + n0 * kLD + kk, kLD);
        wmma::mma_sync(f, a, bm, f);
      }
      wmma::store_matrix_sync((is_s ? S : P) + n0, f, L.SLD,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // softmax rows and ds: each warp takes kQB / 8 rows
    for (int rr = 0; rr < kQB / kWarps; ++rr) {
      const int r = warp * (kQB / kWarps) + rr;
      float* srow = S + r * L.SLD;
      float* prow = P + r * L.SLD;
      float m = -CUDART_INF_F;
      for (int c = lane; c < NP; c += 32) {
        const float s = c < N ? srow[c] * scale : -CUDART_INF_F;
        srow[c] = s;
        m = fmaxf(m, s);
      }
      m = ssmv::warp_max(m);
      float l = 0.f;
      for (int c = lane; c < NP; c += 32) {
        const float e = expf(srow[c] - m);  // masked columns give exactly 0
        srow[c] = e;
        l += e;
      }
      const float linv = 1.f / ssmv::warp_sum(l);
      const float ls = linv * scale;
      float delta = 0.f;
      for (int c = lane; c < NP; c += 32) {
        const float e = srow[c];
        const float edp = e * (prow[c] * ls);
        prow[c] = edp;
        delta += edp;
        Eb[r * L.ELD + c] = __float2bfloat16(e);
      }
      const float ldelta = linv * ssmv::warp_sum(delta);
      for (int c = lane; c < NP; c += 32)
        DSb[r * L.ELD + c] = __float2bfloat16(prow[c] - srow[c] * ldelta);
      for (int c = lane; c < kHD; c += 32)
        dOl[r * kLD + c] =
            __float2bfloat16(__bfloat162float(dOs[r * kLD + c]) * linv);
    }
    __syncthreads();

    // dV += e_bf^T . (do*linv), dK += ds^T . q, over this step's 16 rows
#pragma unroll
    for (int j = 0; j < kAccPerWarp; ++j) {
      const int t = warp + j * kWarps;
      if (t < n_acc) {
        const bool is_v = t < RT * (kHD / 16);
        const int tt = is_v ? t : t - RT * (kHD / 16);
        const int n0 = (tt / (kHD / 16)) * 16, c0 = (tt % (kHD / 16)) * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, (is_v ? Eb : DSb) + n0, L.ELD);
        wmma::load_matrix_sync(bm, (is_v ? dOl : Qs) + c0, kLD);
        wmma::mma_sync(acc[j], a, bm, acc[j]);
      }
    }
    // dq = ds . k for this step's rows: warps 0-3, one 16-column tile each
    if (warp < kHD / 16) {
      const int c0 = warp * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
      wmma::fill_fragment(f, 0.f);
      for (int kk = 0; kk < NP; kk += 16) {
        wmma::load_matrix_sync(a, DSb + kk, L.ELD);
        wmma::load_matrix_sync(bm, Ks + kk * kLD + c0, kLD);
        wmma::mma_sync(f, a, bm, f);
      }
      ssmv::store_frag_bf16(f, stg, dbase + c0, C3, q0, N);
    }
  }

#pragma unroll
  for (int j = 0; j < kAccPerWarp; ++j) {
    const int t = warp + j * kWarps;
    if (t < n_acc) {
      const bool is_v = t < RT * (kHD / 16);
      const int tt = is_v ? t : t - RT * (kHD / 16);
      const int n0 = (tt / (kHD / 16)) * 16, c0 = (tt % (kHD / 16)) * 16;
      ssmv::store_frag_bf16(acc[j], stg, dbase + (is_v ? 2 * C : C) + c0, C3,
                            n0, N);
    }
  }
}

}  // namespace

// qkv (B, N, 3*H*64) and do (B, N, H*64) bf16 -> dqkv (B, N, 3*H*64) bf16,
// all contiguous and 16-byte aligned; N <= 208.
extern "C" int ssmv_mha_bwd(const void* qkv, const void* dout, void* dqkv,
                            int B, int N, int H, int head_dim, float scale,
                            void* stream) {
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || head_dim != kHD ||
      N > 16 * kMaxRowTiles)
    return (int)cudaErrorInvalidValue;
  const int NP = (N + 15) / 16 * 16;
  const Layout L(NP);
  if (L.bytes > ssmv::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_kernel<<<dim3(H, B), kThreads, L.bytes,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), N, NP, H, scale);
  return (int)cudaGetLastError();
}
