// Row gather and its transpose, the row scatter-add (K13).
//
// Replace the Pallas kernels slim_switch_moe_vit_tpu/ops/gather_pallas.py
// _gather_kernel (:43) and _scatter_add_kernel (:72), reached through
// _gather_impl (:117) / gather_rows (:161) and _scatter_add_impl (:144) /
// scatter_add_rows (:179):
//   gather:      out[i] = x[idx[i]]                 x (N, D) -> out (M, D)
//   scatter-add: out[r] = sum over i with idx[i] = r of g[i]
//                                                   g (M, D) -> out (R, D)
//
// What bounds them on the H100: bytes. Each moves its rows once (the
// gather reads M rows and writes M; the scatter-add reads M rows and writes
// R), with no arithmetic to speak of. The TPU kernels extract rows from
// aligned 8-row tiles with masked sublane reductions because Mosaic needs
// provably aligned dynamic slices; the card reads any row at any address,
// so both are plain row copies here.
//
// Gather: one warp per output row, the row moved in 16-byte vectors when
// the row's bytes are a multiple of 16 (every row then starts 16-byte
// aligned), and element by element otherwise (the scalar tail). It copies
// bits, so it takes any 2- or 4-byte element type.
//
// Scatter-add: deterministic, with no atomics. The wrapper prepares the
// indices (as the JAX wrapper pads them): a stable sort of idx gives the
// sources of every destination row in index order (`order`) and the start
// of each row's run (`row_ptr`, R + 1 entries). One warp per destination
// row then sums its sources in index order in f32, each lane its columns
// (16-byte vectors where a row's bytes are a multiple of 16, as the
// gather), and rounds once to g's dtype. In f32 this is the index-order
// sum of np.add.at bit for bit; in bf16 the TPU kernel rounds after every
// add (its accumulator is g's dtype), so the two may differ by the
// roundings of the partial sums (a divergence by design, bounded by its
// test).
// Indices outside [0, R) belong to no row and add nowhere.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 16;  // source rows loaded ahead by the scatter-add

template <typename E, typename I>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const E* __restrict__ x, const I* __restrict__ idx,
                   E* __restrict__ out, long long M, int D, int vec) {
  const long long i = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= M) return;
  const int lane = threadIdx.x & 31;
  const E* src = x + (size_t)idx[i] * D;
  E* dst = out + (size_t)i * D;
  int done = 0;
  if (vec) {
    constexpr int kPer = 16 / sizeof(E);  // elements a 16-byte vector
    const int nv = D / kPer;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int v = lane; v < nv; v += 32) d4[v] = s4[v];
    done = nv * kPer;
  }
  for (int c = done + lane; c < D; c += 32) dst[c] = src[c];
}

// Eight bf16 or four f32 values of a 16-byte vector, added into acc.
template <typename T>
__device__ __forceinline__ void add_vec(const uint4& raw, float* acc) {
  constexpr int kPer = 16 / sizeof(T);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] += ssmv::to_f32(v[j]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_rows_kernel(const T* __restrict__ g,
                        const long long* __restrict__ order,
                        const long long* __restrict__ row_ptr,
                        T* __restrict__ out, long long R, int D, int vec) {
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= R) return;
  const int lane = threadIdx.x & 31;
  const long long s0 = row_ptr[r], s1 = row_ptr[r + 1];
  T* dst = out + (size_t)r * D;
  int done = 0;
  if (vec) {  // each lane a 16-byte vector of columns, the sources in order
    constexpr int kPer = 16 / sizeof(T);
    const int nv = D / kPer;
    for (int v = lane; v < nv; v += 32) {
      float acc[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
      long long s = s0;
      // a hot row (the layout's padding slots all name one token) is a
      // long chain: kUnroll loads in flight, then their adds in order
      for (; s + kUnroll <= s1; s += kUnroll) {
        uint4 raw[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          raw[u] = reinterpret_cast<const uint4*>(
              g + (size_t)order[s + u] * D)[v];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add_vec<T>(raw[u], acc);
      }
      for (; s < s1; ++s)
        add_vec<T>(reinterpret_cast<const uint4*>(g + (size_t)order[s] * D)[v],
                   acc);
      __align__(16) T packed[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) packed[j] = ssmv::from_f32<T>(acc[j]);
      reinterpret_cast<uint4*>(dst)[v] = *reinterpret_cast<const uint4*>(packed);
    }
    done = nv * kPer;
  }
  for (int c = done + lane; c < D; c += 32) {  // the scalar tail
    float acc = 0.f;
    for (long long s = s0; s < s1; ++s)
      acc += ssmv::to_f32(g[(size_t)order[s] * D + c]);
    dst[c] = ssmv::from_f32<T>(acc);
  }
}

template <typename E>
cudaError_t launch_gather(const void* x, const void* idx, int idx_is_i64,
                          void* out, long long M, int D, cudaStream_t s) {
  const int vec = ((size_t)D * sizeof(E)) % 16 == 0;
  const unsigned blocks = (unsigned)((M + kWarps - 1) / kWarps);
  if (idx_is_i64)
    gather_rows_kernel<E, long long><<<blocks, kThreads, 0, s>>>(
        static_cast<const E*>(x), static_cast<const long long*>(idx),
        static_cast<E*>(out), M, D, vec);
  else
    gather_rows_kernel<E, int><<<blocks, kThreads, 0, s>>>(
        static_cast<const E*>(x), static_cast<const int*>(idx),
        static_cast<E*>(out), M, D, vec);
  return cudaGetLastError();
}

}  // namespace

// x (N, D) with 2- or 4-byte elements (elem_bytes), idx (M,) int64
// (idx_is_i64 = 1) or int32, each in [0, N) -> out (M, D); contiguous,
// 16-byte aligned. M >= 1.
extern "C" int ssmv_gather_rows(const void* x, const void* idx,
                                int idx_is_i64, void* out, long long M, int D,
                                int elem_bytes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || D < 1 || (M + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (elem_bytes == 2)
    return (int)launch_gather<uint16_t>(x, idx, idx_is_i64, out, M, D, s);
  if (elem_bytes == 4)
    return (int)launch_gather<uint32_t>(x, idx, idx_is_i64, out, M, D, s);
  return (int)cudaErrorInvalidValue;
}

// g (M, D) bf16 (is_bf16 = 1) or f32; order (M,) int64, the sources sorted
// stably by destination; row_ptr (R + 1,) int64, row r's sources at
// order[row_ptr[r] : row_ptr[r + 1]] -> out (R, D) of g's dtype, every row
// written (zero where no source lands). Contiguous, 16-byte aligned.
extern "C" int ssmv_scatter_add_rows(const void* g, const void* order,
                                     const void* row_ptr, void* out,
                                     long long R, int D, int is_bf16,
                                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || D < 1 || (R + kWarps - 1) / kWarps > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((R + kWarps - 1) / kWarps);
  const int vec = ((size_t)D * (is_bf16 ? 2 : 4)) % 16 == 0;
  if (is_bf16)
    scatter_add_rows_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g),
        static_cast<const long long*>(order),
        static_cast<const long long*>(row_ptr),
        static_cast<__nv_bfloat16*>(out), R, D, vec);
  else
    scatter_add_rows_kernel<float><<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const long long*>(order),
        static_cast<const long long*>(row_ptr), static_cast<float*>(out), R,
        D, vec);
  return (int)cudaGetLastError();
}
