// Multi-head attention backward over the packed qkv tensor (K6).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_bwd_kernel (:203), reached through _fused_mha_bwd (:312). Inputs are
// qkv (B, N, 3C) and the output cotangent do (B, N, C); the output d(qkv)
// (B, N, 3C) is written in the packed layout, dq at columns [h*d, h*d+d),
// dk at [C + h*d, ...), dv at [2C + h*d, ...). Up to N = 208: bf16 on the
// tensor cores, f32 in the SIMT form below; beyond, up to N = 1024, the
// long form at the end of this file (both dtypes); head_dim 64.
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

// The f32 form: the WMMA bf16 fragments do not apply, and single-pass TF32
// would keep 10 mantissa bits, so every product is an f32 FMA on the CUDA
// cores, with the same structure: one block per (head, sample), the
// softmax recomputed 16 query rows a step with the whole score row on chip,
// dq written per step, dK and dV summed over the steps in registers (thread
// t owns rows t / 16 + 16 i, i < 13, and columns 4 (t % 16) .. + 3 of
// each: 104 accumulators) and written once. The arithmetic is the bf16
// form's with every rounding to the activation dtype the identity: s =
// scale * (q . k^T), e = exp(s - m), linv = 1 / sum(e), dv = e^T . (do *
// linv), dp_s = (do . v^T) * (linv * scale), ds = e * dp_s - e * linv *
// rowsum(e * dp_s), dq = ds . k, dk = ds^T . q. N <= 208 (13 row tiles of
// accumulators; 147,584 bytes of shared memory at N = 208).
constexpr int kF32LD = kHD + 1;  // f32 rows of K and V (conflict-free)

struct LayoutF32 {
  int NP, SLD;
  size_t K, V, Q, dO, dOl, S, P, bytes;
  __host__ __device__ explicit LayoutF32(int np) : NP(np) {
    SLD = np + 4;
    K = 0;
    V = K + sizeof(float) * np * kF32LD;
    Q = V + sizeof(float) * np * kF32LD;
    dO = align128(Q + sizeof(float) * kQB * kHD);
    dOl = align128(dO + sizeof(float) * kQB * kHD);
    S = align128(dOl + sizeof(float) * kQB * kHD);
    P = align128(S + sizeof(float) * kQB * SLD);
    bytes = P + sizeof(float) * kQB * SLD;
  }
};

__global__ void __launch_bounds__(kThreads, 1)
mha_bwd_f32_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ dout, float* __restrict__ dqkv,
                   int N, int NP, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32 L(NP);
  float* Ks = reinterpret_cast<float*>(smem + L.K);
  float* Vs = reinterpret_cast<float*>(smem + L.V);
  float* Qs = reinterpret_cast<float*>(smem + L.Q);
  float* dOs = reinterpret_cast<float*>(smem + L.dO);
  float* dOl = reinterpret_cast<float*>(smem + L.dOl);
  float* S = reinterpret_cast<float*>(smem + L.S);
  float* P = reinterpret_cast<float*>(smem + L.P);

  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * kHD, C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + (size_t)b * N * C3 + h * kHD;
  const float* dobase = dout + (size_t)b * N * C + h * kHD;
  float* dbase = dqkv + (size_t)b * N * C3 + h * kHD;

  for (int i = tid; i < NP * kHD; i += kThreads) {
    const int n = i / kHD, c = i % kHD;
    float kv = 0.f, vv = 0.f;
    if (n < N) {
      kv = base[(size_t)n * C3 + C + c];
      vv = base[(size_t)n * C3 + 2 * C + c];
    }
    Ks[n * kF32LD + c] = kv;
    Vs[n * kF32LD + c] = vv;
  }

  const int RT = NP / 16;
  const int an = tid >> 4, ac = (tid & 15) * 4;  // accumulator rows / columns
  float dk[kMaxRowTiles][4], dv[kMaxRowTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxRowTiles; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dk[i][q] = dv[i][q] = 0.f;

  for (int q0 = 0; q0 < NP; q0 += kQB) {
    __syncthreads();  // last step's readers of Qs, dOs, dOl, S, P are done
    for (int i = tid; i < kQB * kHD; i += kThreads) {
      const int r = i / kHD, c = i % kHD, n = q0 + r;
      Qs[i] = n < N ? base[(size_t)n * C3 + c] : 0.f;
      dOs[i] = n < N ? dobase[(size_t)n * C + c] : 0.f;
    }
    __syncthreads();

    {  // S = q . k^T and P = do . v^T: thread (r, cs) takes columns cs + 16 m
      const int r = tid >> 4, cs = tid & 15;
      for (int n = cs; n < NP; n += 16) {
        float sv = 0.f, pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < kHD; ++c) {
          sv = fmaf(Qs[r * kHD + c], Ks[n * kF32LD + c], sv);
          pv = fmaf(dOs[r * kHD + c], Vs[n * kF32LD + c], pv);
        }
        S[r * L.SLD + n] = n < N ? sv * scale : -CUDART_INF_F;
        P[r * L.SLD + n] = pv;
      }
    }
    __syncthreads();

    // softmax rows and ds: each warp takes kQB / 8 rows; e into S, ds into P
    for (int rr = 0; rr < kQB / kWarps; ++rr) {
      const int r = warp * (kQB / kWarps) + rr;
      float* srow = S + r * L.SLD;
      float* prow = P + r * L.SLD;
      float m = -CUDART_INF_F;
      for (int c = lane; c < NP; c += 32) m = fmaxf(m, srow[c]);
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
        const float edp = srow[c] * (prow[c] * ls);
        prow[c] = edp;
        delta += edp;
      }
      const float ldelta = linv * ssmv::warp_sum(delta);
      for (int c = lane; c < NP; c += 32) prow[c] -= srow[c] * ldelta;
      for (int c = lane; c < kHD; c += 32) dOl[r * kHD + c] = dOs[r * kHD + c] * linv;
    }
    __syncthreads();

    // dV += e^T . (do*linv), dK += ds^T . q over this step's 16 rows
    for (int r = 0; r < kQB; ++r) {
      const float4 ov = *reinterpret_cast<const float4*>(dOl + r * kHD + ac);
      const float4 qv = *reinterpret_cast<const float4*>(Qs + r * kHD + ac);
      const float o4[4] = {ov.x, ov.y, ov.z, ov.w};
      const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kMaxRowTiles; ++i) {
        if (i < RT) {
          const int n = an + 16 * i;
          const float e = S[r * L.SLD + n], ds = P[r * L.SLD + n];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            dv[i][q] = fmaf(e, o4[q], dv[i][q]);
            dk[i][q] = fmaf(ds, q4[q], dk[i][q]);
          }
        }
      }
    }
    {  // dq = ds . k for this step's rows: thread (r, 4 columns)
      const int r = tid >> 4;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int n = 0; n < NP; ++n) {
        const float ds = P[r * L.SLD + n];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[q] = fmaf(ds, Ks[n * kF32LD + ac + q], acc[q]);
      }
      if (q0 + r < N) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dbase[(size_t)(q0 + r) * C3 + ac + q] = acc[q];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowTiles; ++i) {
    const int n = an + 16 * i;
    if (i < RT && n < N) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dbase[(size_t)n * C3 + C + ac + q] = dk[i][q];
        dbase[(size_t)n * C3 + 2 * C + ac + q] = dv[i][q];
      }
    }
  }
}

// The long form, for 208 < N <= 1024 in either dtype, where the (head,
// sample) block's dK / dV and whole-K, V tiles no longer fit on chip. Two
// kernels, both SIMT f32 FMAs, in the arithmetic above (every rounding to
// the activation dtype where the bf16 form rounds), with no atomics:
//   rows: one block per (16 query rows, head, sample). K and V stream
//     through shared memory in tiles of 64 rows to fill the whole 16 x NP
//     score row s and its twin do . v^T; the row's softmax and ds are exact
//     over all N columns; dq = ds . k from a second pass over the K tiles.
//     It writes the row's statistics (m, linv, linv * rowsum(e * dp_s)) to
//     the f32 workspace `stats` (B, H, N, 3).
//   cols: one block per (64 key rows, head, sample), those rows' K and V in
//     shared memory, dK and dV of them summed in registers (thread t owns
//     key rows t / 16 + 16 i, i < 4, and columns 4 (t % 16) .. + 3) over
//     16-row query steps. Each step recomputes s and do . v^T for its
//     16 x 64 block with the same f32 FMA chains as `rows`, and e and ds
//     from the saved statistics, so they equal the `rows` kernel's.
constexpr int kLongMaxN = 1024;
constexpr int kKT = 64;  // key rows per tile

struct LayoutRows {
  int SLD = 0;
  size_t Q = 0, dO = 0, S = 0, P = 0, K = 0, V = 0, bytes = 0;
  __host__ __device__ constexpr explicit LayoutRows(int np) {
    SLD = np + 4;
    Q = 0;
    dO = Q + sizeof(float) * kQB * kHD;
    S = dO + sizeof(float) * kQB * kHD;
    P = S + sizeof(float) * kQB * SLD;
    K = P + sizeof(float) * kQB * SLD;
    V = K + sizeof(float) * kKT * kF32LD;
    bytes = V + sizeof(float) * kKT * kF32LD;
  }
};
static_assert(LayoutRows(kLongMaxN).bytes <= ssmv::kMaxSmemBytes,
              "the long K6 must take N = 1024");

// rows [r0, r0 + kKT) of one head's K and V (row stride C3), rows >= N
// zero, into kF32LD-strided f32 tiles
template <typename T>
__device__ __forceinline__ void load_kv_tile(float* Ks, float* Vs,
                                             const T* base, int r0, int N,
                                             int C, int C3) {
  for (int i = threadIdx.x; i < kKT * kHD; i += kThreads) {
    const int n = i / kHD, c = i % kHD;
    float kv = 0.f, vv = 0.f;
    if (r0 + n < N) {
      const T* row = base + (size_t)(r0 + n) * C3 + c;
      kv = ssmv::to_f32(row[C]);
      vv = ssmv::to_f32(row[2 * C]);
    }
    Ks[n * kF32LD + c] = kv;
    Vs[n * kF32LD + c] = vv;
  }
}

// rows [q0, q0 + kQB) of q and do, rows >= N zero, into kHD-strided tiles
template <typename T>
__device__ __forceinline__ void load_q_do(float* Qs, float* dOs,
                                          const T* base, const T* dobase,
                                          int q0, int N, int C, int C3) {
  for (int i = threadIdx.x; i < kQB * kHD; i += kThreads) {
    const int r = i / kHD, c = i % kHD, n = q0 + r;
    Qs[i] = n < N ? ssmv::to_f32(base[(size_t)n * C3 + c]) : 0.f;
    dOs[i] = n < N ? ssmv::to_f32(dobase[(size_t)n * C + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_bwd_rows_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    T* __restrict__ dqkv, float* __restrict__ stats, int N,
                    int NP, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutRows L(NP);
  float* Qs = reinterpret_cast<float*>(smem + L.Q);
  float* dOs = reinterpret_cast<float*>(smem + L.dO);
  float* S = reinterpret_cast<float*>(smem + L.S);
  float* P = reinterpret_cast<float*>(smem + L.P);
  float* Ks = reinterpret_cast<float*>(smem + L.K);
  float* Vs = reinterpret_cast<float*>(smem + L.V);

  const int q0 = blockIdx.x * kQB, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kHD, C3 = 3 * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* base = qkv + (size_t)b * N * C3 + h * kHD;
  const T* dobase = dout + (size_t)b * N * C + h * kHD;
  T* dbase = dqkv + (size_t)b * N * C3 + h * kHD;

  load_q_do(Qs, dOs, base, dobase, q0, N, C, C3);
  const int r = tid >> 4, cs = tid & 15;  // S / P: row r, columns cs + 16 j
  for (int k0 = 0; k0 < NP; k0 += kKT) {
    __syncthreads();  // the last tile's readers are done
    load_kv_tile(Ks, Vs, base, k0, N, C, C3);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) {
      const int n = cs + 16 * j;
      float sv = 0.f, pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kHD; ++c) {
        sv = fmaf(Qs[r * kHD + c], Ks[n * kF32LD + c], sv);
        pv = fmaf(dOs[r * kHD + c], Vs[n * kF32LD + c], pv);
      }
      if (k0 + n < NP) {
        S[r * L.SLD + k0 + n] = k0 + n < N ? sv * scale : -CUDART_INF_F;
        P[r * L.SLD + k0 + n] = pv;
      }
    }
  }
  __syncthreads();

  // softmax rows and ds (rounded to T): each warp takes kQB / 8 rows
  for (int rr = 0; rr < kQB / kWarps; ++rr) {
    const int row = warp * (kQB / kWarps) + rr;
    float* srow = S + row * L.SLD;
    float* prow = P + row * L.SLD;
    float m = -CUDART_INF_F;
    for (int c = lane; c < NP; c += 32) m = fmaxf(m, srow[c]);
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
      const float edp = srow[c] * (prow[c] * ls);
      prow[c] = edp;
      delta += edp;
    }
    const float ldelta = linv * ssmv::warp_sum(delta);
    for (int c = lane; c < NP; c += 32)
      prow[c] = ssmv::to_f32(ssmv::from_f32<T>(prow[c] - srow[c] * ldelta));
    const int n = q0 + row;
    if (lane == 0 && n < N) {
      float* st = stats + (((size_t)b * H + h) * N + n) * 3;
      st[0] = m;
      st[1] = linv;
      st[2] = ldelta;
    }
  }

  // dq = ds . k: thread (r, 4 columns), a second pass over the K tiles
  const int ac = cs * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < NP; k0 += kKT) {
    __syncthreads();  // ds is complete; the last tile's readers are done
    load_kv_tile(Ks, Vs, base, k0, N, C, C3);
    __syncthreads();
    const int nt = min(kKT, NP - k0);
    for (int n = 0; n < nt; ++n) {
      const float ds = P[r * L.SLD + k0 + n];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = fmaf(ds, Ks[n * kF32LD + ac + q], acc[q]);
    }
  }
  if (q0 + r < N) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      dbase[(size_t)(q0 + r) * C3 + ac + q] = ssmv::from_f32<T>(acc[q]);
  }
}

constexpr size_t kColsSmem =
    sizeof(float) * (3 * kQB * kHD + 2 * kKT * kF32LD + 2 * kQB * (kKT + 1) +
                     kQB * 3);

template <typename T>
__global__ void __launch_bounds__(kThreads)
mha_bwd_cols_kernel(const T* __restrict__ qkv, const T* __restrict__ dout,
                    T* __restrict__ dqkv, const float* __restrict__ stats,
                    int N, int H, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // kQB x kHD
  float* dOs = Qs + kQB * kHD;                 // kQB x kHD
  float* dOl = dOs + kQB * kHD;                // kQB x kHD
  float* Ks = dOl + kQB * kHD;                 // kKT x kF32LD
  float* Vs = Ks + kKT * kF32LD;               // kKT x kF32LD
  float* E = Vs + kKT * kF32LD;                // kQB x (kKT + 1)
  float* DS = E + kQB * (kKT + 1);             // kQB x (kKT + 1)
  float* St = DS + kQB * (kKT + 1);            // kQB x 3

  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * kHD, C3 = 3 * C;
  const int tid = threadIdx.x;
  const T* base = qkv + (size_t)b * N * C3 + h * kHD;
  const T* dobase = dout + (size_t)b * N * C + h * kHD;
  T* dbase = dqkv + (size_t)b * N * C3 + h * kHD;
  const float* sbase = stats + ((size_t)b * H + h) * N * 3;

  load_kv_tile(Ks, Vs, base, k0, N, C, C3);
  const int r = tid >> 4, cs = tid & 15;   // s / p: row r, columns cs + 16 j
  const int an = tid >> 4, ac = cs * 4;    // dK / dV rows an + 16 i, 4 cols
  float dk[kKT / 16][4], dv[kKT / 16][4];
#pragma unroll
  for (int i = 0; i < kKT / 16; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) dk[i][q] = dv[i][q] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kQB) {
    __syncthreads();  // the last step's readers are done
    load_q_do(Qs, dOs, base, dobase, q0, N, C, C3);
    for (int i = tid; i < kQB * 3; i += kThreads)
      St[i] = q0 + i / 3 < N ? sbase[(size_t)q0 * 3 + i] : 0.f;
    __syncthreads();

    const bool row_ok = q0 + r < N;
    const float m = St[r * 3], linv = St[r * 3 + 1], ldelta = St[r * 3 + 2];
    const float ls = linv * scale;
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) {
      const int n = cs + 16 * j;
      float sv = 0.f, pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < kHD; ++c) {
        sv = fmaf(Qs[r * kHD + c], Ks[n * kF32LD + c], sv);
        pv = fmaf(dOs[r * kHD + c], Vs[n * kF32LD + c], pv);
      }
      float e = 0.f, ds = 0.f;
      if (row_ok && k0 + n < N) {
        e = expf(sv * scale - m);
        const float edp = e * (pv * ls);
        ds = ssmv::to_f32(ssmv::from_f32<T>(edp - e * ldelta));
      }
      E[r * (kKT + 1) + n] = ssmv::to_f32(ssmv::from_f32<T>(e));
      DS[r * (kKT + 1) + n] = ds;
    }
    for (int i = tid; i < kQB * kHD; i += kThreads)
      dOl[i] = ssmv::to_f32(ssmv::from_f32<T>(dOs[i] * St[(i / kHD) * 3 + 1]));
    __syncthreads();

    // dV += e^T . (do*linv), dK += ds^T . q over this step's 16 rows
    for (int rr = 0; rr < kQB; ++rr) {
      const float4 ov = *reinterpret_cast<const float4*>(dOl + rr * kHD + ac);
      const float4 qv = *reinterpret_cast<const float4*>(Qs + rr * kHD + ac);
      const float o4[4] = {ov.x, ov.y, ov.z, ov.w};
      const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < kKT / 16; ++i) {
        const int n = an + 16 * i;
        const float e = E[rr * (kKT + 1) + n], ds = DS[rr * (kKT + 1) + n];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dv[i][q] = fmaf(e, o4[q], dv[i][q]);
          dk[i][q] = fmaf(ds, q4[q], dk[i][q]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kKT / 16; ++i) {
    const int n = k0 + an + 16 * i;
    if (n < N) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dbase[(size_t)n * C3 + C + ac + q] = ssmv::from_f32<T>(dk[i][q]);
        dbase[(size_t)n * C3 + 2 * C + ac + q] = ssmv::from_f32<T>(dv[i][q]);
      }
    }
  }
}

template <typename T>
cudaError_t launch_long(const void* qkv, const void* dout, void* dqkv,
                        float* stats, int B, int N, int H, float scale,
                        cudaStream_t s) {
  const int NP = (N + 15) / 16 * 16;
  const LayoutRows L(NP);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_rows_kernel<T><<<dim3((N + kQB - 1) / kQB, H, B), kThreads,
                           L.bytes, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), stats, N, NP, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_cols_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kColsSmem);
  if (err != cudaSuccess) return err;
  mha_bwd_cols_kernel<T><<<dim3((N + kKT - 1) / kKT, H, B), kThreads,
                           kColsSmem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(dout),
      static_cast<T*>(dqkv), stats, N, H, scale);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, N, 3*H*64) and do (B, N, H*64) -> dqkv (B, N, 3*H*64), all bf16
// (is_bf16 = 1) or all f32, contiguous and 16-byte aligned; N <= 1024.
// stats is an f32 workspace of B*H*N*3 elements, used for N > 208.
extern "C" int ssmv_mha_bwd(const void* qkv, const void* dout, void* dqkv,
                            void* stats, int B, int N, int H, int head_dim,
                            float scale, int is_bf16, void* stream) {
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || head_dim != kHD ||
      N > kLongMaxN)
    return (int)cudaErrorInvalidValue;
  const int NP = (N + 15) / 16 * 16;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N > 16 * kMaxRowTiles) {
    float* st = static_cast<float*>(stats);
    return (int)(is_bf16 ? launch_long<bf16>(qkv, dout, dqkv, st, B, N, H,
                                             scale, s)
                         : launch_long<float>(qkv, dout, dqkv, st, B, N, H,
                                              scale, s));
  }
  if (!is_bf16) {
    const LayoutF32 L(NP);
    if (L.bytes > ssmv::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        mha_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
    mha_bwd_f32_kernel<<<dim3(H, B), kThreads, L.bytes, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(dout),
        static_cast<float*>(dqkv), N, NP, H, scale);
    return (int)cudaGetLastError();
  }
  const Layout L(NP);
  if (L.bytes > ssmv::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  mha_bwd_kernel<<<dim3(H, B), kThreads, L.bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), N, NP, H, scale);
  return (int)cudaGetLastError();
}
