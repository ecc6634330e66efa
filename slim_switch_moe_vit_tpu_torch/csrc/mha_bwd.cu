// Multi-head attention backward over the packed qkv tensor (K6).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_bwd_kernel (:203), reached through _fused_mha_bwd (:312). Inputs are
// qkv (B, N, 3C) and the output cotangent do (B, N, C); the output d(qkv)
// (B, N, 3C) is written in the packed layout, dq at columns [h*d, h*d+d),
// dk at [C + h*d, ...), dv at [2C + h*d, ...). N <= 1024; head_dim
// d <= 128 on the smallest instance HD in {32, 64, 96, 128} >= d, columns
// d..HD-1 zero on chip (zero columns of dq, dk and dv, never written).
//
// What bounds it on the H100: bytes. qkv and do are read once and d(qkv)
// written once (135 MB at B = 128, N = 197, C = 384: 0.040 ms at 3.35
// TB/s) against five N x N x d products (19.1 GFLOP, 0.019 ms at the bf16
// tensor-core peak). The PR 2-6 kernels ran one block per (head, sample)
// on WMMA with S and P round-tripping shared memory (N <= 208), and SIMT
// f32 FMAs beyond, 15x their bound.
//
// Design (bf16): two kernels, no atomics, deterministic, the same for every
// N. Both run 4 warps of 16 rows over 64-row tiles that stream through a
// 2-stage cp.async ring, with q.k^T, do.v^T and the gradient products on
// mma.sync.m16n8k16 (bf16 in, f32 sums), S, dp, e and ds in registers; a
// score C tile rounded to bf16 is the A operand of the next product.
//   rows: one block per (64-query tile, head, sample), the warp's q and do
//     fragments in registers, three passes over the K / V tiles: (1) the
//     exact row max m of S = (q.k^T) * scale (K only); (2) e = exp(S - m),
//     l = sum e, and sum e . (do.v^T); (3) ds and dq += ds . k in
//     registers. It writes dq once and saves (m, linv, linv * delta_s) per
//     row into the f32 workspace `stats` (B, H, N, 3).
//   cols: one block per (64-key tile, head, sample), the warp's k and v
//     fragments in registers; per query tile it recomputes S^T and e from
//     the saved m, forms bf16(do * linv) in shared memory, and sums
//     dv += e_bf^T . bf16(do * linv) and dk += ds^T . q in registers, then
//     dp_s^T and ds^T; dk and dv are written once.
// Each pass recomputes q.k^T rather than keeping a row of S on chip: the
// products cost ~0.004 ms a layer at B = 128, below the byte bound.
//
// Arithmetic, in the JAX kernel's order (attention.py:213-253):
//   S = (q . k^T) * scale, f32 sums of the bf16 q and k; columns >= N are
//     -inf. The JAX kernel scales q in f32 first: at d = 64 the scale is a
//     power of two and the two are the same numbers, at other d they
//     differ by f32 rounding;
//   m the exact row max; e = exp(S - m) in f32, e_bf = bf16(e),
//     linv = 1 / sum(e) from the f32 e;
//   dv = e_bf^T . bf16(do * linv);
//   dp_s = (do . v^T) * (linv * scale): the JAX kernel forms the f32 product
//     (do * linv * scale) . v^T; the row factor is taken out of the product
//     so both operands stay exact bf16 (only another f32 summation order);
//   delta_s = rowsum(e * dp_s), taken as (linv * scale) * rowsum(e * (do .
//     v^T)) in pass 2, before linv is known (the row factor out of the sum
//     as out of the product);
//   ds = bf16(e * dp_s - e * linv * delta_s);
//   dq = ds . k, dk = ds^T . q (q unscaled); each rounded once to bf16.
// Pad rows >= N of q, k, v and do are zero, as in the JAX kernel.
//
// f32 keeps the SIMT forms (exact f32 FMAs; the tensor cores have no exact
// f32 product): one block per (head, sample) at N <= 208 and d <= 64, and
// beyond, two kernels (rows, cols) in the design above with the score row
// in shared memory.
#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using namespace ssmv::attn;

constexpr int kMaxN = 1024;

template <int HD>
struct Bwd {
  static constexpr int LD = tile_ld(HD);
  static constexpr int NST = 2;  // ring stages
  static constexpr size_t kTile = tile_bytes(HD);
  static constexpr size_t kStat = sizeof(float) * kT * 3;
  // Q, dO, the K and V rings
  static constexpr size_t rows_bytes = kTile * (2 + 2 * NST);
  // K, V, bf16(do * linv), the Q and dO rings, the stats ring
  static constexpr size_t cols_bytes = kTile * (3 + 2 * NST) + kStat * NST;
};

// S (2 n-tiles of 16 keys at kc) = a . k^T from an n-major tile
template <int HD>
__device__ __forceinline__ void qk16(float (&s)[2][4],
                                     const uint32_t (&a)[HD / 16][4],
                                     const bf16* tile, int kc) {
  constexpr int LD = tile_ld(HD);
#pragma unroll
  for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd) {
    uint32_t b[4];
    ld_b_nk(b, tile, LD, kc * 16, kd * 16);
    mma(s[0], a[kd], b[0], b[1]);
    mma(s[1], a[kd], b[2], b[3]);
  }
}

// acc (16 x HD) += a (16 x 16) . rows [kc * 16, +16) of a k-major tile
template <int HD>
__device__ __forceinline__ void acc16(float (&acc)[HD / 8][4],
                                      const uint32_t (&a)[4], const bf16* tile,
                                      int kc) {
  constexpr int LD = tile_ld(HD);
#pragma unroll
  for (int nd = 0; nd < HD / 16; ++nd) {
    uint32_t b[4];
    ld_b_kn(b, tile, LD, kc * 16, nd * 16);
    mma(acc[2 * nd], a, b[0], b[1]);
    mma(acc[2 * nd + 1], a, b[2], b[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_rows_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                  bf16* __restrict__ dqkv, float* __restrict__ stats, int N,
                  int H, int d, float scale, int vec) {
  constexpr int LD = Bwd<HD>::LD, NST = Bwd<HD>::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kT * LD;
  bf16* Ks = dOs + kT * LD;
  bf16* Vs = Ks + NST * kT * LD;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const bf16* dob = dout + (size_t)b * N * C + (size_t)h * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;
  const int T = 3 * nkt;  // passes: row max (K); l and delta (K, V); dq

  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST, kt = t % nkt;
      load_rows<HD>(Ks + st * kT * LD, base + C, C3, kt * kT, N, d, vec);
      if (t >= nkt)
        load_rows<HD>(Vs + st * kT * LD, base + 2 * C, C3, kt * kT, N, d, vec);
    }
    cp_async_commit();
  };
  load_rows<HD>(Qs, base, C3, q0, N, d, vec);  // join tile 0's group
  load_rows<HD>(dOs, dob, C, q0, N, d, vec);
  for (int s = 0; s < NST - 1; ++s) issue(s);

  uint32_t qa[HD / 16][4], da[HD / 16][4];
  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float sedp[2] = {0.f, 0.f}, ls[2] = {0.f, 0.f}, ldl[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    issue(t + NST - 1);
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        ld_a(qa[kd], Qs + warp * 16 * LD, LD, kd * 16);
        ld_a(da[kd], dOs + warp * 16 * LD, LD, kd * 16);
      }
    }
    const int pass = t / nkt, k0 = (t % nkt) * kT;
    const bf16* Kt = Ks + (t % NST) * kT * LD;
    const bf16* Vt = Vs + (t % NST) * kT * LD;
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      float s[2][4];
      qk16<HD>(s, qa, Kt, kc);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + kc * 16 + j * 8 + 2 * tq + (e & 1);
          s[j][e] = col < N ? s[j][e] * scale : -CUDART_INF_F;
        }
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
          m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
        }
        continue;
      }
      float dp[2][4];
      qk16<HD>(dp, da, Vt, kc);  // do . v^T (V pad rows zero)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float ee = expf(s[j][e] - m[i]);  // masked columns give 0
          if (pass == 1) {
            l[i] += ee;
            sedp[i] += ee * dp[j][e];
          } else {
            s[j][e] = ee * (dp[j][e] * ls[i]) - ee * ldl[i];  // ds
          }
        }
      if (pass == 2) {
        uint32_t dsa[4];
        pack_a(dsa, s);
        acc16<HD>(dq, dsa, Kt, kc);
      }
    }
    if (t == nkt - 1) {  // the quad of lanes holding a row share its max
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
    }
    if (t == 2 * nkt - 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        for (int o = 1; o <= 2; o <<= 1) {
          l[i] += __shfl_xor_sync(0xffffffffu, l[i], o);
          sedp[i] += __shfl_xor_sync(0xffffffffu, sedp[i], o);
        }
        const float linv = 1.f / l[i];
        ls[i] = linv * scale;
        ldl[i] = linv * (ls[i] * sedp[i]);
        const int n = q0 + warp * 16 + g + 8 * i;
        if (tq == 0 && n < N) {
          float* st = stats + (((size_t)b * H + h) * N + n) * 3;
          st[0] = m[i];
          st[1] = linv;
          st[2] = ldl[i];
        }
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<HD>(dq, one, Qs + warp * 16 * LD,
                 dqkv + (size_t)b * N * C3 + (size_t)h * d, C3,
                 q0 + warp * 16, N, d, vec);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_cols_bf16(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                  bf16* __restrict__ dqkv, const float* __restrict__ stats,
                  int N, int H, int d, float scale, int vec) {
  constexpr int LD = Bwd<HD>::LD, NST = Bwd<HD>::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kT * LD;
  bf16* dOl = Vs + kT * LD;
  bf16* Qr = dOl + kT * LD;
  bf16* dOr = Qr + NST * kT * LD;
  float* Str = reinterpret_cast<float*>(dOr + NST * kT * LD);

  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const bf16* dob = dout + (size_t)b * N * C + (size_t)h * d;
  const float* sb = stats + ((size_t)b * H + h) * N * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int T = (N + kT - 1) / kT;  // query tiles

  // query tile t: q, do and the rows' (m, linv, linv * delta_s), rows >= N
  // zero (so e = 1 there meets zero q and do and adds nothing)
  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST;
      load_rows<HD>(Qr + st * kT * LD, base, C3, t * kT, N, d, vec);
      load_rows<HD>(dOr + st * kT * LD, dob, C, t * kT, N, d, vec);
      for (int i = threadIdx.x; i < kT * 3; i += kThreads) {
        const bool ok = t * kT + i / 3 < N;
        cp_async4(Str + st * kT * 3 + i, ok ? sb + (size_t)t * kT * 3 + i : sb,
                  ok);
      }
    }
    cp_async_commit();
  };
  load_rows<HD>(Ks, base + C, C3, k0, N, d, vec);  // join tile 0's group
  load_rows<HD>(Vs, base + 2 * C, C3, k0, N, d, vec);
  for (int s = 0; s < NST - 1; ++s) issue(s);

  uint32_t ka[HD / 16][4], va[HD / 16][4];
  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t-1
    issue(t + NST - 1);
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        ld_a(ka[kd], Ks + warp * 16 * LD, LD, kd * 16);
        ld_a(va[kd], Vs + warp * 16 * LD, LD, kd * 16);
      }
    }
    const bf16* Qt = Qr + (t % NST) * kT * LD;
    const bf16* dOt = dOr + (t % NST) * kT * LD;
    const float* St = Str + (t % NST) * kT * 3;
    for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dOl[r * LD + c] =
          __float2bfloat16(__bfloat162float(dOt[r * LD + c]) * St[r * 3 + 1]);
    }
    __syncthreads();
#pragma unroll
    for (int qc = 0; qc < kT / 16; ++qc) {  // 16 queries at a time
      float s[2][4], dp[2][4];
      qk16<HD>(s, ka, Qt, qc);   // S^T = k . q^T
      qk16<HD>(dp, va, dOt, qc); // dp^T = v . do^T
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* st = St + (qc * 16 + j * 8 + 2 * tq + (e & 1)) * 3;
          const float ee = expf(s[j][e] * scale - st[0]);
          s[j][e] = ee;
          dp[j][e] = ee * (dp[j][e] * (st[1] * scale)) - ee * st[2];  // ds
        }
      uint32_t ea[4], dsa[4];
      pack_a(ea, s);
      pack_a(dsa, dp);
      acc16<HD>(dv, ea, dOl, qc);
      acc16<HD>(dk, dsa, Qt, qc);
    }
  }
  // the warp's own k and v rows are free (their fragments are in registers)
  const float one[2] = {1.f, 1.f};
  bf16* dst = dqkv + (size_t)b * N * C3 + (size_t)h * d;
  store_rows<HD>(dk, one, Ks + warp * 16 * LD, dst + C, C3, k0 + warp * 16, N,
                 d, vec);
  store_rows<HD>(dv, one, Vs + warp * 16 * LD, dst + 2 * C, C3,
                 k0 + warp * 16, N, d, vec);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, const void* dout, void* dqkv,
                        float* stats, int B, int N, int H, int d, float scale,
                        cudaStream_t s) {
  const dim3 grid((N + kT - 1) / kT, H, B);
  const int vec = d % 8 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_rows_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Bwd<HD>::rows_bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_rows_bf16<HD><<<grid, kThreads, Bwd<HD>::rows_bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), stats, N, H, d, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_cols_bf16<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Bwd<HD>::cols_bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_cols_bf16<HD><<<grid, kThreads, Bwd<HD>::cols_bytes, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dqkv), stats, N, H, d, scale, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the SIMT forms
// ---------------------------------------------------------------------------
//
// The short form, N <= 208 and d <= 64: one block per (head, sample), 256
// threads, the softmax recomputed 16 query rows a step with the whole
// score row on chip, dq written per step, dK and dV summed over the steps
// in registers (thread t owns rows t / 16 + 16 i, i < 13, and columns
// t % 16 + 16 q, q < HD / 16: 2 x 13 x 4 accumulators at HD = 64) and
// written once. The arithmetic is the bf16 form's with every rounding to
// the activation dtype the identity: s = scale * (q . k^T), e = exp(s - m),
// linv = 1 / sum(e), dv = e^T . (do * linv), dp_s = (do . v^T) * (linv *
// scale), ds = e * dp_s - e * linv * rowsum(e * dp_s), dq = ds . k,
// dk = ds^T . q (147,584 bytes of shared memory at N = 208, HD = 64).
constexpr int kQB = 16;          // query rows per step
constexpr int kSThreads = 256;   // 8 warps
constexpr int kSWarps = kSThreads / 32;
constexpr int kMaxRowTiles = 13; // N <= 208
constexpr int kKT = 64;          // key rows per tile of the long form

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

template <int HD>
struct LayoutF32 {
  int SLD;
  size_t K, V, Q, dO, dOl, S, P, bytes;
  __host__ __device__ explicit LayoutF32(int np) {
    SLD = np + 4;
    K = 0;
    V = K + sizeof(float) * np * (HD + 1);
    Q = V + sizeof(float) * np * (HD + 1);
    dO = align128(Q + sizeof(float) * kQB * HD);
    dOl = align128(dO + sizeof(float) * kQB * HD);
    S = align128(dOl + sizeof(float) * kQB * HD);
    P = align128(S + sizeof(float) * kQB * SLD);
    bytes = P + sizeof(float) * kQB * SLD;
  }
};

// rows [r0, r0 + R) of a head's d columns (row stride ld) into an
// lds-strided f32 tile of HD columns, rows >= N and columns >= d zero
template <int HD>
__device__ __forceinline__ void load_f32(float* dst, int lds, const float* src,
                                         size_t ld, int r0, int R, int N,
                                         int d) {
  for (int i = threadIdx.x; i < R * HD; i += kSThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * lds + c] = r0 + r < N && c < d ? src[(size_t)(r0 + r) * ld + c] : 0.f;
  }
}

template <int HD>
__global__ void __launch_bounds__(kSThreads, 1)
mha_bwd_f32_kernel(const float* __restrict__ qkv,
                   const float* __restrict__ dout, float* __restrict__ dqkv,
                   int N, int NP, int H, int d, float scale) {
  constexpr int KLD = HD + 1, CPT = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutF32<HD> L(NP);
  float* Ks = reinterpret_cast<float*>(smem + L.K);
  float* Vs = reinterpret_cast<float*>(smem + L.V);
  float* Qs = reinterpret_cast<float*>(smem + L.Q);
  float* dOs = reinterpret_cast<float*>(smem + L.dO);
  float* dOl = reinterpret_cast<float*>(smem + L.dOl);
  float* S = reinterpret_cast<float*>(smem + L.S);
  float* P = reinterpret_cast<float*>(smem + L.P);

  const int h = blockIdx.x, b = blockIdx.y;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* dobase = dout + (size_t)b * N * C + (size_t)h * d;
  float* dbase = dqkv + (size_t)b * N * C3 + (size_t)h * d;

  load_f32<HD>(Ks, KLD, base + C, C3, 0, NP, N, d);
  load_f32<HD>(Vs, KLD, base + 2 * C, C3, 0, NP, N, d);

  const int RT = NP / 16;
  const int an = tid >> 4, cs = tid & 15;  // accumulator rows / columns
  float dk[kMaxRowTiles][CPT], dv[kMaxRowTiles][CPT];
#pragma unroll
  for (int i = 0; i < kMaxRowTiles; ++i)
#pragma unroll
    for (int q = 0; q < CPT; ++q) dk[i][q] = dv[i][q] = 0.f;

  for (int q0 = 0; q0 < NP; q0 += kQB) {
    __syncthreads();  // last step's readers of Qs, dOs, dOl, S, P are done
    load_f32<HD>(Qs, HD, base, C3, q0, kQB, N, d);
    load_f32<HD>(dOs, HD, dobase, C, q0, kQB, N, d);
    __syncthreads();

    {  // S = q . k^T and P = do . v^T: thread (r, cs) takes columns cs + 16 m
      const int r = tid >> 4;
      for (int n = cs; n < NP; n += 16) {
        float sv = 0.f, pv = 0.f;
#pragma unroll 8
        for (int c = 0; c < HD; ++c) {
          sv = fmaf(Qs[r * HD + c], Ks[n * KLD + c], sv);
          pv = fmaf(dOs[r * HD + c], Vs[n * KLD + c], pv);
        }
        S[r * L.SLD + n] = n < N ? sv * scale : -CUDART_INF_F;
        P[r * L.SLD + n] = pv;
      }
    }
    __syncthreads();

    // softmax rows and ds: each warp takes kQB / 8 rows; e into S, ds into P
    for (int rr = 0; rr < kQB / kSWarps; ++rr) {
      const int r = warp * (kQB / kSWarps) + rr;
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
      for (int c = lane; c < HD; c += 32) dOl[r * HD + c] = dOs[r * HD + c] * linv;
    }
    __syncthreads();

    // dV += e^T . (do*linv), dK += ds^T . q over this step's 16 rows
    for (int r = 0; r < kQB; ++r) {
      float o4[CPT], q4[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        o4[q] = dOl[r * HD + cs + 16 * q];
        q4[q] = Qs[r * HD + cs + 16 * q];
      }
#pragma unroll
      for (int i = 0; i < kMaxRowTiles; ++i) {
        if (i < RT) {
          const int n = an + 16 * i;
          const float e = S[r * L.SLD + n], ds = P[r * L.SLD + n];
#pragma unroll
          for (int q = 0; q < CPT; ++q) {
            dv[i][q] = fmaf(e, o4[q], dv[i][q]);
            dk[i][q] = fmaf(ds, q4[q], dk[i][q]);
          }
        }
      }
    }
    {  // dq = ds . k for this step's rows: thread (r, columns cs + 16 q)
      const int r = tid >> 4;
      float acc[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
      for (int n = 0; n < NP; ++n) {
        const float ds = P[r * L.SLD + n];
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          acc[q] = fmaf(ds, Ks[n * KLD + cs + 16 * q], acc[q]);
      }
      if (q0 + r < N) {
#pragma unroll
        for (int q = 0; q < CPT; ++q)
          if (cs + 16 * q < d) dbase[(size_t)(q0 + r) * C3 + cs + 16 * q] = acc[q];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kMaxRowTiles; ++i) {
    const int n = an + 16 * i;
    if (i < RT && n < N) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = cs + 16 * q;
        if (c < d) {
          dbase[(size_t)n * C3 + C + c] = dk[i][q];
          dbase[(size_t)n * C3 + 2 * C + c] = dv[i][q];
        }
      }
    }
  }
}

// The long form, for N > 208 or d > 64: two kernels with no atomics, in
// the arithmetic above:
//   rows: one block per (16 query rows, head, sample). K and V stream
//     through shared memory in tiles of 64 rows to fill the whole 16 x NP
//     score row s and its twin do . v^T; the row's softmax and ds are exact
//     over all N columns; dq = ds . k from a second pass over the K tiles.
//     It writes the row's statistics (m, linv, linv * rowsum(e * dp_s)) to
//     the f32 workspace `stats` (B, H, N, 3).
//   cols: one block per (64 key rows, head, sample), those rows' K and V in
//     shared memory, dK and dV of them summed in registers (thread t owns
//     key rows t / 16 + 16 i, i < 4, and columns (t % 16) * HD / 16 ..
//     + HD / 16 - 1) over
//     16-row query steps. Each step recomputes s and do . v^T for its
//     16 x 64 block with the same f32 FMA chains as `rows`, and e and ds
//     from the saved statistics, so they equal the `rows` kernel's.
template <int HD>
struct LayoutRows {
  int SLD = 0;
  size_t Q = 0, dO = 0, S = 0, P = 0, K = 0, V = 0, bytes = 0;
  __host__ __device__ constexpr explicit LayoutRows(int np) {
    SLD = np + 4;
    Q = 0;
    dO = Q + sizeof(float) * kQB * HD;
    S = dO + sizeof(float) * kQB * HD;
    P = S + sizeof(float) * kQB * SLD;
    K = P + sizeof(float) * kQB * SLD;
    V = K + sizeof(float) * kKT * (HD + 1);
    bytes = V + sizeof(float) * kKT * (HD + 1);
  }
};
static_assert(LayoutRows<128>(kMaxN).bytes <= ssmv::kMaxSmemBytes,
              "the long K6 must take N = 1024 at head_dim 128");

template <int HD>
__global__ void __launch_bounds__(kSThreads)
mha_bwd_rows_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                 float* __restrict__ dqkv, float* __restrict__ stats, int N,
                 int NP, int H, int d, float scale) {
  constexpr int KLD = HD + 1, CPT = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const LayoutRows<HD> L(NP);
  float* Qs = reinterpret_cast<float*>(smem + L.Q);
  float* dOs = reinterpret_cast<float*>(smem + L.dO);
  float* S = reinterpret_cast<float*>(smem + L.S);
  float* P = reinterpret_cast<float*>(smem + L.P);
  float* Ks = reinterpret_cast<float*>(smem + L.K);
  float* Vs = reinterpret_cast<float*>(smem + L.V);

  const int q0 = blockIdx.x * kQB, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* dobase = dout + (size_t)b * N * C + (size_t)h * d;
  float* dbase = dqkv + (size_t)b * N * C3 + (size_t)h * d;

  load_f32<HD>(Qs, HD, base, C3, q0, kQB, N, d);
  load_f32<HD>(dOs, HD, dobase, C, q0, kQB, N, d);
  const int r = tid >> 4, cs = tid & 15;  // S / P: row r, columns cs + 16 j
  for (int k0 = 0; k0 < NP; k0 += kKT) {
    __syncthreads();  // the last tile's readers are done
    load_f32<HD>(Ks, KLD, base + C, C3, k0, kKT, N, d);
    load_f32<HD>(Vs, KLD, base + 2 * C, C3, k0, kKT, N, d);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kKT / 16; ++j) {
      const int n = cs + 16 * j;
      float sv = 0.f, pv = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) {
        sv = fmaf(Qs[r * HD + c], Ks[n * KLD + c], sv);
        pv = fmaf(dOs[r * HD + c], Vs[n * KLD + c], pv);
      }
      if (k0 + n < NP) {
        S[r * L.SLD + k0 + n] = k0 + n < N ? sv * scale : -CUDART_INF_F;
        P[r * L.SLD + k0 + n] = pv;
      }
    }
  }
  __syncthreads();

  // softmax rows and ds: each warp takes kQB / 8 rows
  for (int rr = 0; rr < kQB / kSWarps; ++rr) {
    const int row = warp * (kQB / kSWarps) + rr;
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
    for (int c = lane; c < NP; c += 32) prow[c] -= srow[c] * ldelta;
    const int n = q0 + row;
    if (lane == 0 && n < N) {
      float* st = stats + (((size_t)b * H + h) * N + n) * 3;
      st[0] = m;
      st[1] = linv;
      st[2] = ldelta;
    }
  }

  // dq = ds . k: thread (r, columns cs + 16 q), a second pass over K tiles
  float acc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
  for (int k0 = 0; k0 < NP; k0 += kKT) {
    __syncthreads();  // ds is complete; the last tile's readers are done
    load_f32<HD>(Ks, KLD, base + C, C3, k0, kKT, N, d);
    __syncthreads();
    const int nt = min(kKT, NP - k0);
    for (int n = 0; n < nt; ++n) {
      const float ds = P[r * L.SLD + k0 + n];
#pragma unroll
      for (int q = 0; q < CPT; ++q)
        acc[q] = fmaf(ds, Ks[n * KLD + cs + 16 * q], acc[q]);
    }
  }
  if (q0 + r < N) {
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      if (cs + 16 * q < d) dbase[(size_t)(q0 + r) * C3 + cs + 16 * q] = acc[q];
  }
}

__host__ __device__ constexpr size_t cols_f32_bytes(int hd) {
  return sizeof(float) * (3 * kQB * hd + 2 * kKT * (hd + 1) +
                          2 * kQB * (kKT + 1) + kQB * 3);
}

template <int HD>
__global__ void __launch_bounds__(kSThreads)
mha_bwd_cols_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                 float* __restrict__ dqkv, const float* __restrict__ stats,
                 int N, int H, int d, float scale) {
  constexpr int KLD = HD + 1, CPT = HD / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // kQB x HD
  float* dOs = Qs + kQB * HD;                  // kQB x HD
  float* dOl = dOs + kQB * HD;                 // kQB x HD
  float* Ks = dOl + kQB * HD;                  // kKT x KLD
  float* Vs = Ks + kKT * KLD;                  // kKT x KLD
  float* E = Vs + kKT * KLD;                   // kQB x (kKT + 1)
  float* DS = E + kQB * (kKT + 1);             // kQB x (kKT + 1)
  float* St = DS + kQB * (kKT + 1);            // kQB x 3

  const int k0 = blockIdx.x * kKT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int tid = threadIdx.x;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* dobase = dout + (size_t)b * N * C + (size_t)h * d;
  float* dbase = dqkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* sbase = stats + ((size_t)b * H + h) * N * 3;

  load_f32<HD>(Ks, KLD, base + C, C3, k0, kKT, N, d);
  load_f32<HD>(Vs, KLD, base + 2 * C, C3, k0, kKT, N, d);
  const int r = tid >> 4, cs = tid & 15;  // s / p: row r, columns cs + 16 j;
                                          // dK / dV rows r + 16 i
  float dk[kKT / 16][CPT], dv[kKT / 16][CPT];
#pragma unroll
  for (int i = 0; i < kKT / 16; ++i)
#pragma unroll
    for (int q = 0; q < CPT; ++q) dk[i][q] = dv[i][q] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kQB) {
    __syncthreads();  // the last step's readers are done
    load_f32<HD>(Qs, HD, base, C3, q0, kQB, N, d);
    load_f32<HD>(dOs, HD, dobase, C, q0, kQB, N, d);
    for (int i = tid; i < kQB * 3; i += kSThreads)
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
      for (int c = 0; c < HD; ++c) {
        sv = fmaf(Qs[r * HD + c], Ks[n * KLD + c], sv);
        pv = fmaf(dOs[r * HD + c], Vs[n * KLD + c], pv);
      }
      float e = 0.f, ds = 0.f;
      if (row_ok && k0 + n < N) {
        e = expf(sv * scale - m);
        const float edp = e * (pv * ls);
        ds = edp - e * ldelta;
      }
      E[r * (kKT + 1) + n] = e;
      DS[r * (kKT + 1) + n] = ds;
    }
    for (int i = tid; i < kQB * HD; i += kSThreads)
      dOl[i] = dOs[i] * St[(i / HD) * 3 + 1];
    __syncthreads();

    // dV += e^T . (do*linv), dK += ds^T . q over this step's 16 rows;
    // thread cs owns the columns cs * CPT .. + CPT - 1, read as pairs
    for (int rr = 0; rr < kQB; ++rr) {
      float o4[CPT], q4[CPT];
#pragma unroll
      for (int q = 0; q < CPT; q += 2) {
        const float2 ov =
            *reinterpret_cast<const float2*>(dOl + rr * HD + cs * CPT + q);
        const float2 qv =
            *reinterpret_cast<const float2*>(Qs + rr * HD + cs * CPT + q);
        o4[q] = ov.x, o4[q + 1] = ov.y, q4[q] = qv.x, q4[q + 1] = qv.y;
      }
#pragma unroll
      for (int i = 0; i < kKT / 16; ++i) {
        const int n = r + 16 * i;
        const float e = E[rr * (kKT + 1) + n], ds = DS[rr * (kKT + 1) + n];
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          dv[i][q] = fmaf(e, o4[q], dv[i][q]);
          dk[i][q] = fmaf(ds, q4[q], dk[i][q]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kKT / 16; ++i) {
    const int n = k0 + r + 16 * i;
    if (n < N) {
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c = cs * CPT + q;
        if (c < d) {
          dbase[(size_t)n * C3 + C + c] = dk[i][q];
          dbase[(size_t)n * C3 + 2 * C + c] = dv[i][q];
        }
      }
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* qkv, const void* dout, void* dqkv,
                       float* stats, int B, int N, int H, int d, float scale,
                       cudaStream_t s) {
  const int NP = (N + 15) / 16 * 16;
  const float* q = static_cast<const float*>(qkv);
  const float* o = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  if constexpr (HD <= 64) {
    if (N <= 16 * kMaxRowTiles) {
      const LayoutF32<HD> L(NP);
      cudaError_t err = cudaFuncSetAttribute(
          mha_bwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)L.bytes);
      if (err != cudaSuccess) return err;
      mha_bwd_f32_kernel<HD><<<dim3(H, B), kSThreads, L.bytes, s>>>(
          q, o, dq, N, NP, H, d, scale);
      return cudaGetLastError();
    }
  }
  const LayoutRows<HD> L(NP);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_rows_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_rows_f32<HD><<<dim3((N + kQB - 1) / kQB, H, B), kSThreads, L.bytes,
                         s>>>(q, o, dq, stats, N, NP, H, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_cols_f32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)cols_f32_bytes(HD));
  if (err != cudaSuccess) return err;
  mha_bwd_cols_f32<HD><<<dim3((N + kKT - 1) / kKT, H, B), kSThreads,
                         cols_f32_bytes(HD), s>>>(q, o, dq, stats, N, H, d,
                                                  scale);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* qkv, const void* dout, void* dqkv, float* st,
                   int B, int N, int H, int d, float scale, int is_bf16,
                   cudaStream_t s) {
  return is_bf16 ? launch_bf16<HD>(qkv, dout, dqkv, st, B, N, H, d, scale, s)
                 : launch_f32<HD>(qkv, dout, dqkv, st, B, N, H, d, scale, s);
}

}  // namespace

// qkv (B, N, 3*H*head_dim) and do (B, N, H*head_dim) -> dqkv (B, N,
// 3*H*head_dim), all bf16 (is_bf16 = 1) or all f32, contiguous and 16-byte
// aligned; head_dim <= 128, N <= 1024. stats is an f32 workspace of
// B*H*N*3 elements (the rows kernel's per-row statistics).
extern "C" int ssmv_mha_bwd(const void* qkv, const void* dout, void* dqkv,
                            void* stats, int B, int N, int H, int head_dim,
                            float scale, int is_bf16, void* stream) {
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  const int d = head_dim;
  switch (ssmv::head_instance(d)) {
    case 32: return (int)launch<32>(qkv, dout, dqkv, st, B, N, H, d, scale, is_bf16, s);
    case 64: return (int)launch<64>(qkv, dout, dqkv, st, B, N, H, d, scale, is_bf16, s);
    case 96: return (int)launch<96>(qkv, dout, dqkv, st, B, N, H, d, scale, is_bf16, s);
    case 128: return (int)launch<128>(qkv, dout, dqkv, st, B, N, H, d, scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
