// Online-softmax attention forward over the packed qkv tensor (K11).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _flash_kernel (:35), reached through _flash_forward (:74) and
// flash_attention (:120). Input qkv (B, N, 3C) with q, k and v of head h
// at columns [h*d, h*d+d), [C + h*d, ...) and [2C + h*d, ...); output
// (B, N, C). q, k and v are read from the packed tensor by stride and the
// output is written in place of the JAX wrapper's transposes and its pads
// of N and d to the TPU's tile sizes (attention.py:77-107). bf16 and f32,
// head_dim d <= 128 on the smallest instance HD in {32, 64, 96, 128} >= d
// (columns d..HD-1 zero on chip, never written), any N.
//
// What bounds it on the H100: at ViT lengths, device-memory bytes (qkv read
// once, the output written once: 0.023 ms at B = 128, N = 197) against two
// N x N x d products per (sample, head) on the tensor cores (0.008 ms
// there); neither N x N matrix touches device memory. The WMMA form this
// replaces kept S, P and the f32 output accumulator in shared memory,
// walked S and rescaled the accumulator in scalar loops, loaded and stored
// the accumulator once per head-column group in every key tile, and loaded
// K and V in a single stage behind a full wait: 12x its bound.
//
// Design (bf16), on the parts of attn_mma.cuh that K5 is built from, in
// one pass over the keys (the JAX kernel's online softmax, where K5 takes
// a first pass for the exact row max): one block per (64-query tile, head,
// sample), 4 warps of 16 query rows. Each warp's q fragments are loaded
// once with ldmatrix and stay in registers. K and V tiles of 64 rows pass
// together through a ring of shared-memory stages filled by cp.async
// (3 stages at HD <= 64, 2 above; pad rows zero), read by stride from the
// packed layout, so the next tile's copies overlap this tile's products.
// Per tile, everything in registers:
//   S = q . k^T on mma.sync.m16n8k16 (f32 sums), times `scale`; columns
//   >= N set to -inf;
//   m' = max(m, rowmax S), the quad of lanes holding a row reduced by
//   shfl_xor; alpha = exp(m - m'); P = exp(S - m') in f32;
//   l' = l * alpha + rowsum P, summed from the f32 P (each lane keeps its
//   columns' part; the quad's parts are added at the end);
//   the f32 output accumulator (HD / 2 floats a thread) scaled by alpha;
//   P rounded to bf16 straight from the S accumulators as the A operand of
//   P . V, the V fragments loaded by the transposing ldmatrix.
// At the end out = acc / max(l, 1e-30), rounded once to bf16 and written
// through the warp's own rows of the q tile in 16-byte stores (d % 8 == 0;
// scalar stores otherwise).
// The JAX kernel keeps q*scale and P in f32 (attention.py:43, :60); P is
// rounded to bf16 here, as K5 and the JAX package's fused_mha do, so both
// tensor-core operands are bf16. For scale = 64^-1/2, a power of two,
// scaling q first or S after gives the same numbers; at other d they
// differ by f32 rounding.
//
// The f32 form is one kernel with K5's (``fwd_f32_kernel`` below, on
// ``head_fwd_f32`` of attn_mma.cuh; K5 launches it through ``fwd_f32``):
// split TF32 on the tensor cores (mma_tf32.cuh) with the
// bf16 form's structure and the JAX kernel's f32 choices, q scaled in f32
// first and P kept in f32, both split into hi + lo TF32 parts at the read.
// What bounds it: the mma pipe's latency and the split's conversions
// (every K and V operand re-split by each of the 4 warps that read it).
#include <math_constants.h>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using namespace ssmv::attn;

// K / V ring stages: 3 up to HD = 64, 2 above; the layout is head_fwd's
template <int HD>
constexpr int kStages = HD <= 64 ? 3 : 2;
template <int HD>
using Flash = Fwd<HD, kStages<HD>>;

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
                 int H, int d, float scale, int vec) {
  constexpr int LD = Flash<HD>::LD, NST = kStages<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kT * LD;
  bf16* Vs = Ks + NST * kT * LD;

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const bf16* base = qkv + (size_t)b * N * C3 + (size_t)h * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;

  // K and V tile t into stage t % NST, as one commit group (empty past the
  // end, so the group count stays uniform)
  auto issue = [&](int t) {
    if (t < nkt) {
      const int st = t % NST;
      load_rows<HD>(Ks + st * kT * LD, base + C, C3, t * kT, N, d, vec);
      load_rows<HD>(Vs + st * kT * LD, base + 2 * C, C3, t * kT, N, d, vec);
    }
    cp_async_commit();
  };
  load_rows<HD>(Qs, base, C3, q0, N, d, vec);  // joins tile 0's group
  for (int s = 0; s < NST - 1; ++s) issue(s);

  uint32_t qa[HD / 16][4];
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of the warp's 16: the running max (the quad's), and
  // this lane's part of the running sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<NST - 2>();  // tile t (and q) landed, for this thread
    __syncthreads();           // ... for every thread; tile t-1 is done
    issue(t + NST - 1);        // into the stage tile t-1 used
    if (t == 0) {
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd)
        ld_a(qa[kd], Qs + warp * 16 * LD, LD, kd * 16);
    }
    const int k0 = t * kT;
    const bf16* Kt = Ks + (t % NST) * kT * LD;
    const bf16* Vt = Vs + (t % NST) * kT * LD;

    float s[kT / 8][4];  // the tile's 8 n-tiles of 8 keys
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd)
#pragma unroll
      for (int kc = 0; kc < kT / 16; ++kc) {
        uint32_t kb[4];
        ld_b_nk(kb, Kt, LD, kc * 16, kd * 16);
        mma(s[2 * kc], qa[kd], kb[0], kb[1]);
        mma(s[2 * kc + 1], qa[kd], kb[2], kb[3]);
      }
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * tq + (e & 1);
        s[j][e] = col < N ? s[j][e] * scale : -CUDART_INF_F;
        mt[e >> 1] = fmaxf(mt[e >> 1], s[j][e]);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mt[i]));  // finite: k0 < N
      alpha[i] = expf(m[i] - m_new);                     // 0 on the first tile
      m[i] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);  // masked columns give 0
        ls[e >> 1] += s[j][e];
      }
    l[0] = l[0] * alpha[0] + ls[0];
    l[1] = l[1] * alpha[1] + ls[1];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {  // P . V, 16 keys at a time
      uint32_t pa[4];
      pack_a(pa, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int nd = 0; nd < HD / 16; ++nd) {
        uint32_t vb[4];
        ld_b_kn(vb, Vt, LD, kc * 16, nd * 16);
        mma(o[2 * nd], pa, vb[0], vb[1]);
        mma(o[2 * nd + 1], pa, vb[2], vb[3]);
      }
    }
  }
  const float linv[2] = {1.f / fmaxf(quad_sum(l[0]), 1e-30f),
                         1.f / fmaxf(quad_sum(l[1]), 1e-30f)};
  // the warp's own q rows are free (its fragments are in registers)
  store_rows<HD>(o, linv, Qs + warp * 16 * LD,
                 out + (size_t)b * N * C + (size_t)h * d, C, q0 + warp * 16,
                 N, d, vec);
}

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores, K5's and K11's one kernel
// ---------------------------------------------------------------------------

// one block per (64-query tile, head, sample) runs ``head_fwd_f32`` and
// writes o * linv through the warp's own rows of the q tile
template <int HD>
__global__ void __launch_bounds__(kThreads)
fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N,
               int H, int d, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int warp = threadIdx.x >> 5;
  float o[HD / 8][4], linv[2];
  head_fwd_f32<HD>(qkv + (size_t)b * N * C3 + (size_t)h * d, C3, C, N, q0, d,
                   scale, vec, Qs, threadIdx.x, [] { __syncthreads(); }, o,
                   linv);
  // the warp's own q rows are free (no other warp reads them)
  store_rows_f32<HD>(o, linv, Qs + warp * 16 * ssmv::tf32::tile_ld(HD),
                     out + (size_t)b * N * C + (size_t)h * d, C,
                     q0 + warp * 16, N, d, vec);
}

template <int HD>
cudaError_t launch_f32(const float* qkv, float* out, int B, int N, int H,
                       int d, float scale, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_bytes<HD>());
  if (err != cudaSuccess) return err;
  fwd_f32_kernel<HD><<<dim3((N + kT - 1) / kT, H, B), kThreads,
                       f32_bytes<HD>(), s>>>(qkv, out, N, H, d, scale,
                                             int(d % 4 == 0));
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H, int d,
                   float scale, int is_bf16, cudaStream_t s) {
  const dim3 grid((N + kT - 1) / kT, H, B);
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Flash<HD>::bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<HD><<<grid, kThreads, Flash<HD>::bytes, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, d, scale,
        int(d % 8 == 0));
    return cudaGetLastError();
  }
  return launch_f32<HD>(static_cast<const float*>(qkv),
                        static_cast<float*>(out), B, N, H, d, scale, s);
}

}  // namespace

cudaError_t ssmv::attn::fwd_f32(const float* qkv, float* out, int B, int N,
                                int H, int d, float scale, cudaStream_t s) {
  switch (ssmv::head_instance(d)) {
    case 32: return launch_f32<32>(qkv, out, B, N, H, d, scale, s);
    case 64: return launch_f32<64>(qkv, out, B, N, H, d, scale, s);
    case 96: return launch_f32<96>(qkv, out, B, N, H, d, scale, s);
    case 128: return launch_f32<128>(qkv, out, B, N, H, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// qkv (B, N, 3*H*head_dim) -> out (B, N, H*head_dim), both bf16
// (is_bf16 = 1) or f32, contiguous and 16-byte aligned; head_dim <= 128.
extern "C" int ssmv_flash_fwd(const void* qkv, void* out, int B, int N, int H,
                              int head_dim, float scale, int is_bf16,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = head_dim;
  switch (ssmv::head_instance(d)) {
    case 32: return (int)launch<32>(qkv, out, B, N, H, d, scale, is_bf16, s);
    case 64: return (int)launch<64>(qkv, out, B, N, H, d, scale, is_bf16, s);
    case 96: return (int)launch<96>(qkv, out, B, N, H, d, scale, is_bf16, s);
    case 128: return (int)launch<128>(qkv, out, B, N, H, d, scale, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
