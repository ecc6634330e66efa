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
// N x N x d products per (sample, head) on the tensor cores; neither
// N x N matrix touches device memory.
//
// Design (bf16): one block of 4 warps per (64-query tile, head, sample);
// each warp owns 16 query rows, its q fragments held in registers for the
// whole loop. K and V pass through shared memory in tiles of 64 rows (rows
// >= N are zero). Per tile:
//   S = q . k^T on the tensor cores (WMMA bf16 16x16x16, f32 sums), then
//   scaled by `scale` in f32; columns >= N set to -inf;
//   the online softmax in f32: m' = max(m, rowmax S), alpha = exp(m - m'),
//   P = exp(S - m'), l' = l*alpha + rowsum P, the f32 output accumulator
//   (in shared memory) scaled by alpha;
//   P rounded to bf16, acc += P . V on the tensor cores (f32 sums).
// At the end out = acc / max(l, 1e-30), rounded once to bf16.
// The JAX kernel keeps q*scale and P in f32 (attention.py:43, :60); P is
// rounded to bf16 here, as K5 and the JAX package's fused_mha do, so both
// tensor-core operands are bf16. For scale = 64^-1/2, a power of two,
// scaling q first or S after gives the same numbers; at other d they
// differ by f32 rounding.
//
// The f32 form keeps the JAX kernel's order on the CUDA cores (the tensor
// cores have no exact f32 product): one block of 256 threads per (32-query
// tile, head, sample), 8 threads a query row; q scaled in f32 first; per
// 64-key tile s = q . k^T, m' = max(m, rowmax s), p = exp(s - m'),
// alpha = exp(m - m'), l' = l * alpha + rowsum p, acc' = acc * alpha + p . v
// (p in f32); out = acc / max(l, 1e-30).
#include <math_constants.h>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using namespace nvcuda;
using ssmv::attn::bf16;
using ssmv::attn::kThreads;  // 4 warps, 16 query rows each
using ssmv::attn::kT;        // query rows per block, key rows per tile

constexpr int kPLD = kT + 8;    // bf16 rows of P
constexpr int kSLD = kT + 4;    // f32 rows of S

template <int HD>
struct Flash {
  static constexpr int LD = ssmv::attn::tile_ld(HD);  // rows of Q, K, V
  static constexpr int OLD = HD + 4;  // f32 rows of the accumulator
  static constexpr size_t Q = 0;
  static constexpr size_t K = Q + sizeof(bf16) * kT * LD;
  static constexpr size_t V = K + sizeof(bf16) * kT * LD;
  static constexpr size_t P = V + sizeof(bf16) * kT * LD;
  static constexpr size_t S = P + sizeof(bf16) * kT * kPLD;
  static constexpr size_t O = S + sizeof(float) * kT * kSLD;
  static constexpr size_t bytes = O + sizeof(float) * kT * OLD;
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N,
                 int H, int d, float scale, int vec) {
  using L = Flash<HD>;
  constexpr int LD = L::LD, OLD = L::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L::K);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::V);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::P);
  float* S = reinterpret_cast<float*>(smem + L::S);
  float* O = reinterpret_cast<float*>(smem + L::O);

  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * N * C3 + (size_t)h * d;

  ssmv::attn::load_rows<HD>(Qs, base, C3, q0, N, d, vec);
  ssmv::attn::cp_async_commit();
  for (int i = threadIdx.x; i < kT * OLD; i += kThreads) O[i] = 0.f;
  ssmv::attn::cp_async_wait<0>();
  __syncthreads();

  const int w0 = warp * 16;  // this warp's first row in the tile
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)
    wmma::load_matrix_sync(qf[kd], Qs + w0 * LD + kd * 16, LD);

  // softmax bookkeeping: lane owns row w0 + lane/2, key columns
  // [half*32, +32) and accumulator columns [half*HD/2, +HD/2)
  const int r = w0 + (lane >> 1), c0 = (lane & 1) * 32;
  const int oc0 = (lane & 1) * (HD / 2);
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();  // every warp is done with the last K and V tiles
    ssmv::attn::load_rows<HD>(Ks, base + C, C3, k0, N, d, vec);
    ssmv::attn::load_rows<HD>(Vs, base + 2 * C, C3, k0, N, d, vec);
    ssmv::attn::cp_async_commit();
    ssmv::attn::cp_async_wait<0>();
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kT / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kd = 0; kd < HD / 16; ++kd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LD + kd * 16, LD);
        wmma::mma_sync(s, qf[kd], kf, s);
      }
      wmma::store_matrix_sync(S + w0 * kSLD + j * 16, s, kSLD,
                              wmma::mem_row_major);
    }
    __syncwarp();

    float* srow = S + r * kSLD + c0;
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float v = k0 + c0 + c < N ? srow[c] * scale : -CUDART_INF_F;
      srow[c] = v;
      tmax = fmaxf(tmax, v);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m, tmax);  // finite: column k0 < N is valid
    const float alpha = expf(m - m_new);  // 0 on the first tile
    float psum = 0.f;
    bf16* prow = Ps + r * kPLD + c0;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - m_new);  // masked columns give 0
      psum += p;
      prow[c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * alpha + psum;
    m = m_new;
    float* orow = O + r * OLD + oc0;
#pragma unroll
    for (int c = 0; c < HD / 2; ++c) orow[c] *= alpha;
    __syncwarp();

#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, O + w0 * OLD + j * 16, OLD,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + w0 * kPLD + kk * 16, kPLD);
        wmma::load_matrix_sync(vf, Vs + kk * 16 * LD + j * 16, LD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(O + w0 * OLD + j * 16, acc, OLD,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int n = q0 + r;
  if (n < N) {
    const float linv = 1.f / fmaxf(l, 1e-30f);
    const float* orow = O + r * OLD + oc0;
    bf16* dst = out + ((size_t)b * N + n) * C + (size_t)h * d + oc0;
    if (vec && oc0 < d) {  // d % 8 == 0: whole 16-byte vectors below d
#pragma unroll
      for (int v = 0; v < HD / 16; ++v) {
        if (oc0 + v * 8 < d) {
          __align__(16) bf16 vals[8];
#pragma unroll
          for (int e = 0; e < 8; ++e)
            vals[e] = __float2bfloat16(orow[v * 8 + e] * linv);
          *reinterpret_cast<uint4*>(dst + v * 8) =
              *reinterpret_cast<const uint4*>(vals);
        }
      }
    } else if (!vec) {
      for (int c = 0; c < HD / 2 && oc0 + c < d; ++c)
        dst[c] = __float2bfloat16(orow[c] * linv);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the SIMT form
// ---------------------------------------------------------------------------

constexpr int kFQ = 32;          // query rows per block
constexpr int kFThreads = 256;   // 8 threads a row
constexpr int kFKLD = kT + 1;    // f32 rows of p

template <int HD>
__host__ __device__ constexpr size_t f32_bytes() {
  return sizeof(float) * ((size_t)kFQ * HD + (size_t)kT * (HD + 1) +
                          (size_t)kT * HD + (size_t)kFQ * kFKLD);
}

template <int HD>
__global__ void __launch_bounds__(kFThreads)
flash_fwd_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out,
                     int N, int H, int d, float scale) {
  constexpr int KLD = HD + 1, CPT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);  // kFQ x HD, q * scale
  float* Ks = Qs + kFQ * HD;                       // kT x KLD
  float* Vs = Ks + kT * KLD;                       // kT x HD
  float* Ps = Vs + kT * HD;                        // kFQ x kFKLD

  const int q0 = blockIdx.x * kFQ, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int tid = threadIdx.x, row = tid >> 3, sub = tid & 7;
  const float* base = qkv + (size_t)b * N * C3 + (size_t)h * d;

  for (int i = tid; i < kFQ * HD; i += kFThreads) {
    const int r = i / HD, c = i % HD, n = q0 + r;
    Qs[i] = n < N && c < d ? base[(size_t)n * C3 + c] * scale : 0.f;
  }
  float acc[CPT];  // columns sub + 8 q
#pragma unroll
  for (int q = 0; q < CPT; ++q) acc[q] = 0.f;
  float m = -CUDART_INF_F, l = 0.f;

  for (int k0 = 0; k0 < N; k0 += kT) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < kT * HD; i += kFThreads) {
      const int r = i / HD, c = i % HD, n = k0 + r;
      const bool ok = n < N && c < d;
      Ks[r * KLD + c] = ok ? base[(size_t)n * C3 + C + c] : 0.f;
      Vs[r * HD + c] = ok ? base[(size_t)n * C3 + 2 * C + c] : 0.f;
    }
    __syncthreads();
    float s[kT / 8];  // key columns sub + 8 j
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const int col = sub + 8 * j;
      float v = 0.f;
#pragma unroll 8
      for (int c = 0; c < HD; ++c) v = fmaf(Qs[row * HD + c], Ks[col * KLD + c], v);
      s[j] = k0 + col < N ? v : -CUDART_INF_F;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);  // finite: column k0 < N is valid
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) {
      const float p = expf(s[j] - m_new);  // masked columns give 0
      psum += p;
      Ps[row * kFKLD + sub + 8 * j] = p;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    const float alpha = expf(m - m_new);  // 0 on the first tile
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // the row's 8 threads share a warp
    const int nt = min(kT, N - k0);
    float pv[CPT];
#pragma unroll
    for (int q = 0; q < CPT; ++q) pv[q] = 0.f;
    for (int n = 0; n < nt; ++n) {
      const float p = Ps[row * kFKLD + n];
#pragma unroll
      for (int q = 0; q < CPT; ++q) pv[q] = fmaf(p, Vs[n * HD + sub + 8 * q], pv[q]);
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) acc[q] = acc[q] * alpha + pv[q];
  }

  const int n = q0 + row;
  if (n < N) {
    const float linv = 1.f / fmaxf(l, 1e-30f);
    float* dst = out + ((size_t)b * N + n) * C + (size_t)h * d;
#pragma unroll
    for (int q = 0; q < CPT; ++q)
      if (sub + 8 * q < d) dst[sub + 8 * q] = acc[q] * linv;
  }
}

template <int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H, int d,
                   float scale, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Flash<HD>::bytes);
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<HD><<<dim3((N + kT - 1) / kT, H, B), kThreads,
                           Flash<HD>::bytes, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, d, scale,
        int(d % 8 == 0));
    return cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)f32_bytes<HD>());
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<HD><<<dim3((N + kFQ - 1) / kFQ, H, B), kFThreads,
                             f32_bytes<HD>(), s>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, H, d, scale);
  return cudaGetLastError();
}

}  // namespace

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
