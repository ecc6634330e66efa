// Multi-head attention forward over the packed qkv tensor (K5).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_kernel (:168), reached through _mha_fwd_call (:279) and fused_mha
// (:296). Input qkv is (B, N, 3C) with q of head h at columns [h*d, h*d+d),
// k at [C + h*d, ...) and v at [2C + h*d, ...); the output is (B, N, C),
// ready for the proj GEMM. No host-side transposes or padding. N <= 1024,
// the lengths the JAX package runs its kernel at (models/vit.py:50-59);
// head_dim d <= 128, run on the smallest instance HD in {32, 64, 96, 128}
// >= d with columns d..HD-1 zero on chip (they add nothing to q.k^T and
// their o columns are never written).
//
// What bounds it on the H100: bytes. qkv is read once and o written once
// (77 MB at B = 128, N = 197, C = 384: 0.023 ms at 3.35 TB/s) against two
// N x N x d products (7.6 GFLOP, 0.008 ms at the bf16 tensor-core peak) and
// N x N exponentials. The PR 1-6 kernel took both products as f32 FMAs on
// the CUDA cores with the score tile in shared memory, 42x its bound.
//
// Design (bf16): one block per (64-query tile, head, sample), 4 warps of 16
// query rows. Each warp's q fragments are loaded once with ldmatrix and
// stay in registers. K and V tiles of 64 rows pass through a ring of
// shared-memory stages filled by cp.async (3 stages at HD <= 64, 2 above;
// pad rows zero), read by stride from the packed layout. The products are
// mma.sync.m16n8k16 (bf16 in, f32 sums), S in registers. The softmax takes
// the exact row maximum before any exponent, by a first pass over the K
// tiles that computes only row maxima; the second pass recomputes
// S = q.k^T (the same instructions, so the same values) and forms
// e = exp(S - m) in f32 in registers, sums l from that f32 e, and packs e
// rounded to bf16 straight from the S accumulators into the A operand of
// e.V. o is scaled by 1/l and written once, through the warp's own rows of
// the q tile, in 16-byte stores (d % 8 == 0; scalar stores otherwise).
// The recomputed q.k^T costs ~0.004 ms a layer at B = 128 on the tensor
// cores, below the byte bound.
//
// Arithmetic, in the JAX kernel's order (attention.py:186-200) but for the
// scale: S = (q.k^T) * scale with f32 sums of the bf16 q and k (the JAX
// kernel scales q in f32 first: at d = 64 the scale is a power of two and
// the two are the same numbers, at other d they differ by f32 rounding);
// columns >= N are -inf; m the exact row max; e = exp(S - m) in f32, l the
// sum of that f32 e; e rounded to bf16 for e.V (f32 sums); o = (e.V) / l.
//
// The f32 form keeps the SIMT design of mha_simt.cuh (exact f32 FMAs: the
// tensor cores have no exact f32 product), 64 query rows a block where the
// score tile fits and 32 beyond, q scaled in f32 first as the JAX kernel.
#include "attn_mma.cuh"
#include "mha_simt.cuh"

namespace {

using namespace ssmv::attn;

constexpr int kMaxN = 1024;

template <int HD>
struct Fwd {
  static constexpr int LD = tile_ld(HD);
  static constexpr int NST = HD <= 64 ? 3 : 2;  // K / V ring stages
  static constexpr size_t kTile = tile_bytes(HD);
  static constexpr size_t bytes = kTile * (1 + 2 * NST);  // Q, K ring, V ring
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_fwd_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int N, int H, int d, float scale, int vec) {
  constexpr int LD = Fwd<HD>::LD, NST = Fwd<HD>::NST;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kT * LD;
  bf16* Vs = Ks + NST * kT * LD;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;
  const int T = 2 * nkt;  // pass 1: K tiles (row maxima); pass 2: K and V

  // tile t of the sequence into its stage, as one commit group (empty past
  // the end, so the group count stays uniform)
  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST, kt = t < nkt ? t : t - nkt;
      load_rows<HD>(Ks + st * kT * LD, base + C, C3, kt * kT, N, d, vec);
      if (t >= nkt)
        load_rows<HD>(Vs + st * kT * LD, base + 2 * C, C3, kt * kT, N, d, vec);
    }
    cp_async_commit();
  };
  load_rows<HD>(Qs, base, C3, q0, N, d, vec);  // joins tile 0's group
  for (int s = 0; s < NST - 1; ++s) issue(s);

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();  // tile t (and q) landed, for this thread
    __syncthreads();           // ... for every thread; tile t-1 is done
    issue(t + NST - 1);        // into the stage tile t-1 used
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        ld_a(qa[kd], Qs + warp * 16 * LD, LD, kd * 16);
    }
    const bool pass2 = t >= nkt;
    const int k0 = (pass2 ? t - nkt : t) * kT;
    const bf16* Kt = Ks + (t % NST) * kT * LD;
    const bf16* Vt = Vs + (t % NST) * kT * LD;
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {  // 16 keys at a time
      float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        uint32_t kb[4];
        ld_b_nk(kb, Kt, LD, kc * 16, kd * 16);
        mma(s[0], qa[kd], kb[0], kb[1]);
        mma(s[1], qa[kd], kb[2], kb[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + kc * 16 + j * 8 + 2 * tq + (e & 1);
          s[j][e] = col < N ? s[j][e] * scale : -CUDART_INF_F;
        }
      if (!pass2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          m[0] = fmaxf(m[0], fmaxf(s[j][0], s[j][1]));
          m[1] = fmaxf(m[1], fmaxf(s[j][2], s[j][3]));
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e >> 1]);  // masked columns give 0
          l[e >> 1] += s[j][e];
        }
      uint32_t pa[4];
      pack_a(pa, s);
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t vb[4];
        ld_b_kn(vb, Vt, LD, kc * 16, nd * 16);
        mma(o[2 * nd], pa, vb[0], vb[1]);
        mma(o[2 * nd + 1], pa, vb[2], vb[3]);
      }
    }
    if (t == nkt - 1) {  // the quad of lanes holding a row share its max
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
    }
  }
  float linv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    linv[i] = 1.f / l[i];
  }
  // the warp's own q rows are free (its fragments are in registers)
  store_rows<HD>(o, linv, Qs + warp * 16 * LD,
                 out + (size_t)b * N * C + (size_t)h * d, C, q0 + warp * 16,
                 N, d, vec);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int N, int H, int d,
                        float scale, cudaStream_t s) {
  const size_t smem = Fwd<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mha_fwd_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mha_fwd_bf16_kernel<HD><<<dim3((N + kT - 1) / kT, H, B), kThreads, smem,
                            s>>>(static_cast<const bf16*>(qkv),
                                 static_cast<bf16*>(out), N, H, d, scale,
                                 int(d % 8 == 0));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the SIMT form
// ---------------------------------------------------------------------------

template <int HD, int QT>
__global__ void __launch_bounds__(ssmv::simt::kThreads)
mha_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                   int N, int NP, int H, int d, float scale) {
  namespace sm = ssmv::simt;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const sm::Smem<float> L = sm::carve<float>(smem_raw, QT, HD, NP);
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  float o[QT / 16][HD / 16];
  sm::head_attention<float, HD, QT>(qkv + (size_t)b * N * C3 + (size_t)h * d,
                                    C3, C, N, NP, q0, d, scale, L, o);
  const int rg = threadIdx.x >> 4, cl = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < QT / 16; ++i) {
    const int r = rg * (QT / 16) + i, n = q0 + r;
    if (n < N) {
      const float li = L.linv[r];
      float* orow = out + ((size_t)b * N + n) * C + (size_t)h * d;
#pragma unroll
      for (int j = 0; j < HD / 16; ++j)
        if (cl + 16 * j < d) orow[cl + 16 * j] = o[i][j] * li;
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* qkv, void* out, int B, int N, int H, int d,
                       float scale, cudaStream_t s) {
  namespace sm = ssmv::simt;
  const int NP = (N + 15) / 16 * 16;
  const bool wide = sm::smem_bytes(64, HD, NP, 4) <= ssmv::kMaxSmemBytes;
  const size_t smem = sm::smem_bytes(wide ? 64 : 32, HD, NP, 4);
  auto kernel = wide ? mha_fwd_f32_kernel<HD, 64> : mha_fwd_f32_kernel<HD, 32>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int qt = wide ? 64 : 32;
  kernel<<<dim3((N + qt - 1) / qt, H, B), sm::kThreads, smem, s>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, NP, H, d,
      scale);
  return cudaGetLastError();
}
static_assert(ssmv::simt::smem_bytes(32, 128, kMaxN, 4) <= ssmv::kMaxSmemBytes,
              "K5's f32 form must take N = 1024 at head_dim 128");

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H, int d,
                   float scale, int is_bf16, cudaStream_t s) {
  return is_bf16 ? launch_bf16<HD>(qkv, out, B, N, H, d, scale, s)
                 : launch_f32<HD>(qkv, out, B, N, H, d, scale, s);
}

}  // namespace

// qkv (B, N, 3*H*head_dim) -> out (B, N, H*head_dim), both contiguous and
// 16-byte aligned, of bf16 (is_bf16 = 1) or f32 (is_bf16 = 0);
// head_dim <= 128, N <= 1024.
extern "C" int ssmv_mha_fwd(const void* qkv, void* out, int B, int N, int H,
                            int head_dim, float scale, int is_bf16,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535 || N > kMaxN)
    return (int)cudaErrorInvalidValue;
  switch (ssmv::head_instance(head_dim)) {
    case 32: return (int)launch<32>(qkv, out, B, N, H, head_dim, scale, is_bf16, s);
    case 64: return (int)launch<64>(qkv, out, B, N, H, head_dim, scale, is_bf16, s);
    case 96: return (int)launch<96>(qkv, out, B, N, H, head_dim, scale, is_bf16, s);
    case 128: return (int)launch<128>(qkv, out, B, N, H, head_dim, scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
