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
// f32 (split TF32, mma_tf32.cuh): the same two kernels with the f32
// arithmetic (e, dp_s and ds stay f32, nothing rounds to an activation
// dtype; q scaled in f32 first, as the JAX kernel does) for every N <= 1024
// and head instance. Every product takes three tf32
// mma.sync.m16n8k8 a k-step (lo.hi + hi.lo, then hi.hi), swept over groups
// of up to 8 n-tiles and over two products at once, so 16 independent
// mma separate the dependent ones; the operands are split as they are
// read from shared memory (f32 rows of HD + 4 floats, every fragment read
// a conflict-free 32-bit load); ds and e * linv are split into the A
// operand of the next product straight from their C tiles, k relabelled
// (the B rows read as k0 + 2t and k0 + 2t + 1). The rows kernel takes the
// statistics in one online pass (the running max, l and sum e . (do .
// v^T) rescaled as the max moves) and ds and dq in a second; the cols
// kernel keeps QC queries' S^T and dp^T in registers beside dK and dV
// (QC = 64 at HD <= 64, 32 at 96, 16 at 128). 8-row tiles past N and
// warps whose 16 rows lie past N skip their products. What bounds it: the
// mma pipe's latency with two blocks of 4 warps an SM (~200 registers a
// thread), and the split's conversions (every operand re-split by each
// warp that reads it); at 0.09-0.11 of the bound of three TF32 products
// (PERF.md).
#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using namespace ssmv::attn;
namespace tf = ssmv::tf32;

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
// f32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

// the n-tiles a tf32 mma_group sweeps (4 measured slower)
constexpr int kF32Group = 8;

template <int HD>
struct BwdF32 {
  static constexpr int LD = tf::tile_ld(HD);
  static constexpr int NST = 2;  // ring stages
  static constexpr size_t kTile = sizeof(float) * kT * LD;
  static constexpr size_t kStat = sizeof(float) * kT * 3;
  // Q, dO, the K and V rings
  static constexpr size_t rows_bytes = kTile * (2 + 2 * NST);
  // K, V, the Q and dO rings, the stats ring
  static constexpr size_t cols_bytes = kTile * (2 + 2 * NST) + kStat * NST;
  // queries a cols step: its S^T and dp^T tiles in registers beside the
  // warp's dK and dV (2 x HD / 2 floats a thread; 32 at HD <= 64 measured
  // slower)
  static constexpr int QC = HD <= 64 ? 64 : HD <= 96 ? 32 : 16;
};
static_assert(BwdF32<128>::cols_bytes <= ssmv::kMaxSmemBytes,
              "the f32 K6 must take head_dim 128");

// s[j] = (A1 * fa) . (B1 * fb)^T and dp[j] = A2 . B2^T over HD for the
// 8-column n-tiles [n0 + 8j, +8), j < nv: A from the warp's 16 rows of the
// row-major tiles A1 and A2, B from the n-major tiles B1 and B2
template <int HD, int NT>
__device__ __forceinline__ void two_products(float (&s)[NT][4],
                                             float (&dp)[NT][4],
                                             const float* A1, float fa,
                                             const float* B1, float fb,
                                             const float* A2, const float* B2,
                                             int n0, int nv) {
  constexpr int LD = tf::tile_ld(HD), G = tf::group_for(NT, kF32Group);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  for (int kd = 0; kd < HD / 8; ++kd) {
    tf::FragA a1, a2;
    tf::ld_a(a1, A1, LD, kd * 8, fa);
    tf::ld_a(a2, A2, LD, kd * 8);
#pragma unroll
    for (int jg = 0; jg < NT; jg += G) {
      if (jg < nv) {
        tf::FragB b1[G], b2[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          tf::ld_b_nk(b1[j], B1, LD, n0 + (jg + j) * 8, kd * 8, fb);
          tf::ld_b_nk(b2[j], B2, LD, n0 + (jg + j) * 8, kd * 8);
        }
        tf::mma_group2(s, jg, a1, b1, dp, jg, a2, b2);
      }
    }
  }
}

// acc[n] += a . the B fragments of the HD / 8 n-tiles of a k-major tile at
// k-step k0 (its rows relabelled as a_from_c's)
template <int HD>
__device__ __forceinline__ void acc_kn(float (&acc)[HD / 8][4],
                                       const tf::FragA& a, const float* tile,
                                       int k0) {
  constexpr int LD = tf::tile_ld(HD), GD = tf::group_for(HD / 8, kF32Group);
#pragma unroll
  for (int ng = 0; ng < HD / 8; ng += GD) {
    tf::FragB b[GD];
#pragma unroll
    for (int i = 0; i < GD; ++i) tf::ld_b_kn(b[i], tile, LD, k0, (ng + i) * 8);
    tf::mma_group(acc, ng, a, b);
  }
}

// acc_kn of two products swept together (the cols kernel's dv and dk)
template <int HD>
__device__ __forceinline__ void acc_kn2(float (&acc1)[HD / 8][4],
                                        const tf::FragA& a1,
                                        const float* tile1,
                                        float (&acc2)[HD / 8][4],
                                        const tf::FragA& a2,
                                        const float* tile2, int k0) {
  constexpr int LD = tf::tile_ld(HD), GD = tf::group_for(HD / 8, kF32Group);
#pragma unroll
  for (int ng = 0; ng < HD / 8; ng += GD) {
    tf::FragB b1[GD], b2[GD];
#pragma unroll
    for (int i = 0; i < GD; ++i) {
      tf::ld_b_kn(b1[i], tile1, LD, k0, (ng + i) * 8);
      tf::ld_b_kn(b2[i], tile2, LD, k0, (ng + i) * 8);
    }
    tf::mma_group2(acc1, ng, a1, b1, acc2, ng, a2, b2);
  }
}

// rows: one block per (64-query tile, head, sample), 4 warps of 16 rows.
// Two passes over the K and V tiles: (1) S = (q * scale) . k^T and
// do . v^T, the row max m, l = sum e and sum e . (do . v^T) online, each
// rescaled by exp(m - m') when the max moves (the flash forward's
// recurrence); (2) the same products, ds and dq += ds . k. It writes dq
// once and (m, linv, linv * delta_s) per row into `stats`.
template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_rows_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                 float* __restrict__ dqkv, float* __restrict__ stats, int N,
                 int H, int d, float scale, int vec) {
  constexpr int LD = BwdF32<HD>::LD, NST = BwdF32<HD>::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + kT * LD;
  float* Ks = dOs + kT * LD;
  float* Vs = Ks + NST * kT * LD;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* dob = dout + (size_t)b * N * C + (size_t)h * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;
  const int T = 2 * nkt;  // passes: the row statistics; ds and dq
  const bool live = q0 + warp * 16 < N;  // else the warp keeps pace only
  const float* Qw = Qs + warp * 16 * LD;
  const float* dOw = dOs + warp * 16 * LD;

  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST, kt = t % nkt;
      load_rows_f32<HD>(Ks + st * kT * LD, base + C, C3, kt * kT, N, d, vec);
      load_rows_f32<HD>(Vs + st * kT * LD, base + 2 * C, C3, kt * kT, N, d,
                        vec);
    }
    cp_async_commit();
  };
  load_rows_f32<HD>(Qs, base, C3, q0, N, d, vec);  // join tile 0's group
  load_rows_f32<HD>(dOs, dob, C, q0, N, d, vec);
  for (int s = 0; s < NST - 1; ++s) issue(s);

  float dq[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
  float sedp[2] = {0.f, 0.f}, ls[2] = {0.f, 0.f}, ldl[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    issue(t + NST - 1);
    if (live) {
      const int k0 = (t % nkt) * kT;
      const float* Kt = Ks + (t % NST) * kT * LD;
      const float* Vt = Vs + (t % NST) * kT * LD;
      const int nv = min(kT / 8, (N - k0 + 7) / 8);  // n-tiles with a key < N
      float s[kT / 8][4], dp[kT / 8][4];
      two_products<HD, kT / 8>(s, dp, Qw, scale, Kt, 1.f, dOw, Vt, 0, nv);
#pragma unroll
      for (int j = 0; j < kT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + j * 8 + 2 * tq + (e & 1);
          if (col >= N) s[j][e] = -CUDART_INF_F;
        }
      if (t < nkt) {
        float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {
          mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
          mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
        }
        float alpha[2], le[2] = {0.f, 0.f}, sd[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float m_new = fmaxf(m[i], quad_max(mt[i]));  // finite: k0 < N
          alpha[i] = expf(m[i] - m_new);  // 0 on the first tile
          m[i] = m_new;
        }
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float ee = expf(s[j][e] - m[i]);  // masked columns give 0
            le[i] += ee;
            sd[i] += ee * dp[j][e];
          }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l[i] = l[i] * alpha[i] + le[i];
          sedp[i] = sedp[i] * alpha[i] + sd[i];
        }
      } else {
#pragma unroll
        for (int j = 0; j < kT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            const float ee = expf(s[j][e] - m[i]);
            s[j][e] = ee * (dp[j][e] * ls[i]) - ee * ldl[i];  // ds
          }
#pragma unroll
        for (int j = 0; j < kT / 8; ++j) {  // dq += ds . k, 8 keys a k-step
          if (j < nv) {
            tf::FragA dsa;
            tf::a_from_c(dsa, s[j]);
            acc_kn<HD>(dq, dsa, Kt, j * 8);
          }
        }
      }
    }
    if (t == nkt - 1) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = quad_sum(l[i]);
        sedp[i] = quad_sum(sedp[i]);
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
  store_rows_f32<HD>(dq, one, Qs + warp * 16 * LD,
                     dqkv + (size_t)b * N * C3 + (size_t)h * d, C3,
                     q0 + warp * 16, N, d, vec);
}

// cols: one block per (64-key tile, head, sample), 4 warps of 16 key rows;
// per query tile and QC-query step it recomputes S^T = k . (q * scale)^T
// and dp^T = v . do^T, e = exp(S^T - m) from the saved m (0 for keys past
// N), ds^T = e * (dp^T * linv * scale) - e * (linv * delta_s), and sums
// dv += (e * linv)^T-rows . do and dk += ds^T . q in registers; dk and dv
// are written once.
template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_bwd_cols_f32(const float* __restrict__ qkv, const float* __restrict__ dout,
                 float* __restrict__ dqkv, const float* __restrict__ stats,
                 int N, int H, int d, float scale, int vec) {
  constexpr int LD = BwdF32<HD>::LD, NST = BwdF32<HD>::NST;
  constexpr int QC = BwdF32<HD>::QC, NQ = QC / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + kT * LD;
  float* Qr = Vs + kT * LD;
  float* dOr = Qr + NST * kT * LD;
  float* Str = dOr + NST * kT * LD;

  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const float* dob = dout + (size_t)b * N * C + (size_t)h * d;
  const float* sb = stats + ((size_t)b * H + h) * N * 3;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int T = (N + kT - 1) / kT;  // query tiles
  const bool live = k0 + warp * 16 < N;
  const bool key_ok[2] = {k0 + warp * 16 + g < N, k0 + warp * 16 + g + 8 < N};
  const float* Kw = Ks + warp * 16 * LD;
  const float* Vw = Vs + warp * 16 * LD;

  // query tile t: q, do and the rows' (m, linv, linv * delta_s), rows >= N
  // zero (so e = 1 there meets zero q, do and linv and adds nothing)
  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST;
      load_rows_f32<HD>(Qr + st * kT * LD, base, C3, t * kT, N, d, vec);
      load_rows_f32<HD>(dOr + st * kT * LD, dob, C, t * kT, N, d, vec);
      for (int i = threadIdx.x; i < kT * 3; i += kThreads) {
        const bool ok = t * kT + i / 3 < N;
        cp_async4(Str + st * kT * 3 + i, ok ? sb + (size_t)t * kT * 3 + i : sb,
                  ok);
      }
    }
    cp_async_commit();
  };
  load_rows_f32<HD>(Ks, base + C, C3, k0, N, d, vec);  // join tile 0's group
  load_rows_f32<HD>(Vs, base + 2 * C, C3, k0, N, d, vec);
  for (int s = 0; s < NST - 1; ++s) issue(s);

  float dk[HD / 8][4], dv[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t-1
    issue(t + NST - 1);
    if (!live) continue;
    const float* Qt = Qr + (t % NST) * kT * LD;
    const float* dOt = dOr + (t % NST) * kT * LD;
    const float* St = Str + (t % NST) * kT * 3;
    const int nvq = min(kT / 8, (N - t * kT + 7) / 8);  // n-tiles, a query < N
    for (int qc = 0; qc < kT; qc += QC) {
      const int nv = min(NQ, nvq - qc / 8);
      if (nv <= 0) break;
      float s[NQ][4], dp[NQ][4];
      two_products<HD, NQ>(s, dp, Kw, 1.f, Qt, scale, Vw, dOt, qc, nv);
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* st = St + (qc + j * 8 + 2 * tq + (e & 1)) * 3;
          const float ee = key_ok[e >> 1] ? expf(s[j][e] - st[0]) : 0.f;
          dp[j][e] = ee * (dp[j][e] * (st[1] * scale)) - ee * st[2];  // ds
          s[j][e] = ee * st[1];  // e * linv
        }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {  // 8 queries a k-step
        if (j < nv) {
          tf::FragA ea, dsa;
          tf::a_from_c(ea, s[j]);
          tf::a_from_c(dsa, dp[j]);
          acc_kn2<HD>(dv, ea, dOt, dk, dsa, Qt, qc + j * 8);
        }
      }
    }
  }
  // the warp's own k and v rows are free (no other warp reads them)
  const float one[2] = {1.f, 1.f};
  float* dst = dqkv + (size_t)b * N * C3 + (size_t)h * d;
  store_rows_f32<HD>(dk, one, Ks + warp * 16 * LD, dst + C, C3,
                     k0 + warp * 16, N, d, vec);
  store_rows_f32<HD>(dv, one, Vs + warp * 16 * LD, dst + 2 * C, C3,
                     k0 + warp * 16, N, d, vec);
}

template <int HD>
cudaError_t launch_f32(const void* qkv, const void* dout, void* dqkv,
                       float* stats, int B, int N, int H, int d, float scale,
                       cudaStream_t s) {
  const dim3 grid((N + kT - 1) / kT, H, B);
  const int vec = d % 4 == 0;
  const float* q = static_cast<const float*>(qkv);
  const float* o = static_cast<const float*>(dout);
  float* dq = static_cast<float*>(dqkv);
  cudaError_t err = cudaFuncSetAttribute(
      mha_bwd_rows_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BwdF32<HD>::rows_bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_rows_f32<HD><<<grid, kThreads, BwdF32<HD>::rows_bytes, s>>>(
      q, o, dq, stats, N, H, d, scale, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mha_bwd_cols_f32<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)BwdF32<HD>::cols_bytes);
  if (err != cudaSuccess) return err;
  mha_bwd_cols_f32<HD><<<grid, kThreads, BwdF32<HD>::cols_bytes, s>>>(
      q, o, dq, stats, N, H, d, scale, vec);
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
