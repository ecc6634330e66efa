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
// of each row's run (`row_ptr`, R + 1 entries). Each row's sources are
// added in index order in f32 and the sum is rounded once to g's dtype. In
// f32 this is the index-order sum of np.add.at bit for bit; in bf16 the
// TPU kernel rounds after every add (its accumulator is g's dtype), so the
// two may differ by the roundings of the partial sums (a divergence by
// design, bounded by its test). Indices outside [0, R) belong to no row and
// add nowhere.
//
// What bounds the scatter-add is the latency of its loads, not their
// bytes, wherever one row has many sources: the dropless layout's padding
// slots all name token 0, so one destination row takes ~2,000 of the
// ~52,000 sources. The sum may not be split (partial sums would add in
// another order), so the chain of adds stays in index order and only the
// loads are made parallel. Two kernels on the caller's stream, each
// writing the rows the other skips:
//  - short rows (at most long_row sources; the flagship's other rows have
//    0-2): one block per run of kRunRows consecutive rows. Its threads read
//    the run's row_ptr entries and its sources' indices (up to kIdxCache)
//    into shared memory in coalesced loads, so no load of g waits on its
//    index; then each thread sums units of the run, a unit being one row's
//    16-byte vector of columns (or one column, the scalar tail, where a
//    row's bytes are not a multiple of 16), kUnroll loads in flight.
//  - long rows (more than long_row sources, decided on the device from
//    row_ptr): one block per 128-byte column slab of a long row (the
//    blocks of its run of kThreads rows, one long row after another), so
//    a hot row's slabs stream on several SMs at once. The block stages the
//    row's source indices in shared memory (kIdxChunk at a time, in one
//    coalesced pass), then streams the source rows' slabs through a
//    4-stage cp.async ring of kLRows rows a stage; 32 threads each own 4
//    bytes of the slab (2 bf16 or 1 f32 columns) and add the staged rows
//    in index order from shared memory.
#include <cstdint>

#include "common.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;     // source rows loaded ahead, short rows
constexpr int kRunRows = 32;   // destination rows a block, short rows
constexpr int kIdxCache = 1024;  // a run's source indices staged
constexpr int kLRows = 64;    // source rows a ring stage, long rows
constexpr int kLStages = 4;
constexpr int kSlab = 128;    // bytes of each source row a block streams
constexpr int kIdxChunk = 4096;  // a long row's source indices staged
constexpr int kLCopies = kLRows * (kSlab / 16) / kThreads;  // a thread's
constexpr size_t kRingBytes = (size_t)kLStages * kLRows * kSlab;
constexpr size_t kLongSmem = kRingBytes + sizeof(long long) * kIdxChunk;

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

// The sum of one unit of a row (a 16-byte vector of columns with kVec, else
// one column) over the sources [a, b), src(s) giving source s's row of g,
// in index order in f32, rounded once into dst[u].
template <typename T, bool kVec, typename Src>
__device__ __forceinline__ void sum_unit(const T* __restrict__ g, Src src,
                                         long long a, long long b, T* dst,
                                         int D, int u) {
  if (kVec) {
    constexpr int kPer = 16 / sizeof(T);
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    long long s = a;
    for (; s + kUnroll <= b; s += kUnroll) {  // kUnroll loads in flight,
      uint4 raw[kUnroll];                    // then their adds in order
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        raw[q] = reinterpret_cast<const uint4*>(g + (size_t)src(s + q) * D)[u];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) add_vec<T>(raw[q], acc);
    }
    for (; s < b; ++s)
      add_vec<T>(reinterpret_cast<const uint4*>(g + (size_t)src(s) * D)[u],
                 acc);
    __align__(16) T packed[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) packed[j] = ssmv::from_f32<T>(acc[j]);
    reinterpret_cast<uint4*>(dst)[u] = *reinterpret_cast<const uint4*>(packed);
  } else {
    float acc = 0.f;
    for (long long s = a; s < b; ++s)
      acc += ssmv::to_f32(g[(size_t)src(s) * D + u]);
    dst[u] = ssmv::from_f32<T>(acc);
  }
}

// Short rows: block b takes rows [b * kRunRows, + kRunRows) and skips those
// of more than long_row sources. The run's row_ptr entries and (up to
// kIdxCache of) its sources' indices are staged in shared memory by
// coalesced loads; then each thread sums units (row, vector) of the run.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
scatter_add_short_kernel(const T* __restrict__ g,
                         const long long* __restrict__ order,
                         const long long* __restrict__ row_ptr,
                         T* __restrict__ out, long long R, int D,
                         long long long_row) {
  __shared__ long long rp[kRunRows + 1];
  __shared__ long long idx[kIdxCache];
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kRunRows;
  const int nr = (int)(R - r0 < kRunRows ? R - r0 : kRunRows);
  if (tid <= nr) rp[tid] = row_ptr[r0 + tid];
  __syncthreads();
  const long long s0 = rp[0], n_src = rp[nr] - s0;
  const bool staged = n_src <= kIdxCache;
  if (staged)
    for (int k = tid; k < n_src; k += kThreads) idx[k] = order[s0 + k];
  __syncthreads();
  const int nu = kVec ? D / (16 / (int)sizeof(T)) : D;  // units a row
  for (int w = tid; w < nr * nu; w += kThreads) {
    const int i = w / nu, u = w % nu;
    const long long a = rp[i], b = rp[i + 1];
    if (b - a > long_row) continue;  // the long-row kernel's
    T* dst = out + (size_t)(r0 + i) * D;
    if (staged)
      sum_unit<T, kVec>(g, [&](long long s) { return idx[s - s0]; }, a, b,
                        dst, D, u);
    else
      sum_unit<T, kVec>(g, [&](long long s) { return order[s]; }, a, b, dst,
                        D, u);
  }
}

// One 4-byte word of a staged source row, added into acc (2 bf16 or 1 f32).
template <typename T>
__device__ __forceinline__ void add_word(uint32_t w, float* acc);
template <>
__device__ __forceinline__ void add_word<__nv_bfloat16>(uint32_t w,
                                                        float* acc) {
  acc[0] += __uint_as_float(w << 16);
  acc[1] += __uint_as_float(w & 0xffff0000u);
}
template <>
__device__ __forceinline__ void add_word<float>(uint32_t w, float* acc) {
  acc[0] += __uint_as_float(w);
}

// Long rows: block (b, c) takes the rows of [b * kThreads, + kThreads)
// with more than long_row sources, one after another, and of each the
// bytes [c * kSlab, + kSlab) of every source row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scatter_add_long_kernel(const T* __restrict__ g,
                        const long long* __restrict__ order,
                        const long long* __restrict__ row_ptr,
                        T* __restrict__ out, long long R, int D, int vec,
                        long long long_row) {
  extern __shared__ __align__(16) unsigned char ring[];
  long long* idx_s = reinterpret_cast<long long*>(ring + kRingBytes);
  __shared__ int list[kThreads];
  __shared__ int warp_n[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long rr = base + tid;
  const bool is_long = rr < R && row_ptr[rr + 1] - row_ptr[rr] > long_row;
  // the block's long rows, in row order
  const unsigned bal = __ballot_sync(0xffffffffu, is_long);
  if (lane == 0) warp_n[warp] = __popc(bal);
  __syncthreads();
  int pos = __popc(bal & ((1u << lane) - 1)), n_long = 0;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? warp_n[w] : 0;
    n_long += warp_n[w];
  }
  if (is_long) list[pos] = tid;
  __syncthreads();

  constexpr int kPer = 4 / sizeof(T);  // values of a thread's 4-byte word
  const int rb = D * (int)sizeof(T);   // bytes of a row
  const int c0 = blockIdx.y * kSlab;
  const int sb = rb - c0 < kSlab ? rb - c0 : kSlab;  // this slab's bytes
  const int nv = sb / 16;
  for (int l = 0; l < n_long; ++l) {
    const long long r = base + list[l];
    const long long a = row_ptr[r], b = row_ptr[r + 1];
    T* dst = out + (size_t)r * D;
    if (!vec) {  // a row of bytes that are not a multiple of 16: by column
      if (blockIdx.y == 0)
        for (int c = tid; c < D; c += kThreads) {
          float acc = 0.f;
          for (long long s = a; s < b; ++s)
            acc += ssmv::to_f32(g[(size_t)order[s] * D + c]);
          dst[c] = ssmv::from_f32<T>(acc);
        }
      continue;
    }
    float acc[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
    for (long long ca = a; ca < b; ca += kIdxChunk) {
      const int n = (int)(b - ca < kIdxChunk ? b - ca : kIdxChunk);
      __syncthreads();  // the last chunk's copies and adds are done
      for (int k = tid; k < n; k += kThreads) idx_s[k] = order[ca + k];
      __syncthreads();
      const int nst = (n + kLRows - 1) / kLRows;
      auto issue = [&](int t) {  // stage t's source rows, one commit group
        if (t < nst) {
          unsigned char* st = ring + (size_t)(t % kLStages) * kLRows * kSlab;
#pragma unroll
          for (int q = 0; q < kLCopies; ++q) {
            const int i = tid + q * kThreads, row = i / nv, v = i % nv;
            if (row < kLRows && t * kLRows + row < n)
              ssmv::tc::cp_async16(
                  st + row * kSlab + v * 16,
                  reinterpret_cast<const unsigned char*>(g) +
                      (size_t)idx_s[t * kLRows + row] * rb + c0 + v * 16,
                  true);
          }
        }
        ssmv::tc::cp_async_commit();
      };
      for (int t = 0; t < kLStages - 1; ++t) issue(t);
      for (int t = 0; t < nst; ++t) {
        ssmv::tc::cp_async_wait<kLStages - 2>();
        __syncthreads();
        issue(t + kLStages - 1);
        if (4 * tid < sb) {  // this thread's word of the stage's rows, in order
          const unsigned char* st =
              ring + (size_t)(t % kLStages) * kLRows * kSlab + 4 * tid;
          const int rows = n - t * kLRows < kLRows ? n - t * kLRows : kLRows;
          for (int k = 0; k < rows; ++k)
            add_word<T>(*reinterpret_cast<const uint32_t*>(st + k * kSlab),
                        acc);
        }
      }
      ssmv::tc::cp_async_wait<0>();
    }
    __syncthreads();  // the ring is free for the next row
    if (4 * tid < sb) {
      T* d = reinterpret_cast<T*>(reinterpret_cast<unsigned char*>(dst) + c0 +
                                  4 * tid);
#pragma unroll
      for (int j = 0; j < kPer; ++j) d[j] = ssmv::from_f32<T>(acc[j]);
    }
  }
}

template <typename T>
cudaError_t launch_scatter(const void* g, const void* order,
                           const void* row_ptr, void* out, long long R, int D,
                           long long long_row, cudaStream_t s) {
  const int vec = ((size_t)D * sizeof(T)) % 16 == 0;
  const unsigned runs = (unsigned)((R + kRunRows - 1) / kRunRows);
  auto kernel = vec ? scatter_add_short_kernel<T, true>
                    : scatter_add_short_kernel<T, false>;
  kernel<<<runs, kThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const long long*>(order),
      static_cast<const long long*>(row_ptr), static_cast<T*>(out), R, D,
      long_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(scatter_add_long_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kLongSmem);
  if (err != cudaSuccess) return err;
  const int slabs = (int)((D * sizeof(T) + kSlab - 1) / kSlab);
  scatter_add_long_kernel<T><<<dim3((unsigned)((R + kThreads - 1) / kThreads),
                                    slabs),
                               kThreads, kLongSmem, s>>>(
      static_cast<const T*>(g), static_cast<const long long*>(order),
      static_cast<const long long*>(row_ptr), static_cast<T*>(out), R, D, vec,
      long_row);
  return cudaGetLastError();
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
// written (zero where no source lands); rows of more than long_row >= 0
// sources by the long-row kernel, the rest by the short-row kernel.
// Contiguous, 16-byte aligned.
extern "C" int ssmv_scatter_add_rows(const void* g, const void* order,
                                     const void* row_ptr, void* out,
                                     long long R, int D, long long long_row,
                                     int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R < 1 || D < 1 || long_row < 0 ||
      (R + kRunRows - 1) / kRunRows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return (int)launch_scatter<__nv_bfloat16>(g, order, row_ptr, out, R, D,
                                              long_row, s);
  return (int)launch_scatter<float>(g, order, row_ptr, out, R, D, long_row, s);
}
