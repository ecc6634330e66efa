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
// query rows, running the head body ``head_fwd`` of attn_mma.cuh (which
// K12 shares). Each warp's q fragments are loaded once with ldmatrix and
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
// The f32 form: the JAX kernel with T = f32 (``p.astype(T)`` the
// identity) computes K11's function up to the order of the softmax, so it
// runs K11's f32 kernel (``fwd_f32`` of attn_mma.cuh, whose kernel runs
// ``head_fwd_f32``: 64-query blocks of 4 warps, split TF32
// on the tensor cores, q scaled in f32 first, P kept in f32), whose
// softmax is online where the JAX kernel takes the exact row max first
// (attention.py:195): the same function, within f32 rounding.
#include "attn_mma.cuh"
#include "common.cuh"

namespace {

using namespace ssmv::attn;

constexpr int kMaxN = 1024;

// K / V ring stages: 3 up to HD = 64, 2 above
template <int HD>
constexpr int kStages = HD <= 64 ? 3 : 2;

template <int HD>
__global__ void __launch_bounds__(kThreads)
mha_fwd_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                    int N, int H, int d, float scale, int vec) {
  constexpr int LD = tile_ld(HD);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int warp = threadIdx.x >> 5;
  float o[HD / 8][4], linv[2];
  head_fwd<HD, kStages<HD>>(qkv + (size_t)b * N * C3 + (size_t)h * d, C3, C,
                            N, q0, d, scale, vec, Qs, threadIdx.x,
                            [] { __syncthreads(); }, o, linv);
  // the warp's own q rows are free (its fragments are in registers)
  store_rows<HD>(o, linv, Qs + warp * 16 * LD,
                 out + (size_t)b * N * C + (size_t)h * d, C, q0 + warp * 16,
                 N, d, vec);
}

template <int HD>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int N, int H, int d,
                        float scale, cudaStream_t s) {
  const size_t smem = Fwd<HD, kStages<HD>>::bytes;
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
  if (!is_bf16)
    return (int)ssmv::attn::fwd_f32(static_cast<const float*>(qkv),
                                    static_cast<float*>(out), B, N, H,
                                    head_dim, scale, s);
  switch (ssmv::head_instance(head_dim)) {
    case 32: return (int)launch_bf16<32>(qkv, out, B, N, H, head_dim, scale, s);
    case 64: return (int)launch_bf16<64>(qkv, out, B, N, H, head_dim, scale, s);
    case 96: return (int)launch_bf16<96>(qkv, out, B, N, H, head_dim, scale, s);
    case 128: return (int)launch_bf16<128>(qkv, out, B, N, H, head_dim, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
