// LayerNorm backward, one launch: K1c (plain and add forms) and K2b.
//
// Replaces the Pallas kernels of slim_switch_moe_vit_tpu/ops/fused_ln.py
//   _bwd_kernel (:159) behind _bwd (:191, the call at :195): the backward
//     of fused_ln (_ln_bwd :253) and of fused_add_ln (_add_ln_bwd :232,
//     with the stream's own cotangent du_out added);
//   _bwd_kernel_slim (:273) behind _sum_ln_bwd (:326, the call at :330):
//     the backward of fused_sum_ln, u = a + b recomputed.
// Per row of D, with u = a (+ b, rounded to the activation dtype first):
//   mean, var = the f32 mean of u and of d * d (d = u - mean)
//   xhat = d * rstd, rstd = rsqrt(var + eps); dyg = dy * gamma
//   du = (dyg - mean(dyg) - xhat * mean(dyg * xhat)) * rstd (+ du_out),
//        rounded once to u's dtype
//   dgamma = sum over rows of dy * xhat, dbeta = sum of dy (f32)
//
// What bounds it on the H100: device-memory bytes. It does ~10 FLOP an
// element against the card's ~295 FLOP a byte, so the aim is to keep
// enough bytes in flight, move each byte once, and keep the launch's fixed
// cost (start, and the cross-block sum at the end) small:
//  - A persistent grid (two blocks an SM up to D = 512, else one; each of
//    kWarps consumer warps and one producer warp) walks tiles of R
//    consecutive rows, strided by the grid. R rows of a tensor are one
//    contiguous span, so the producer's one elected thread fetches a tile
//    with one 1-D bulk copy (cp.async.bulk, the TMA's plain form) per
//    tensor into a ring of `stages` tiles in shared memory, every copy of
//    a stage arriving on the stage's mbarrier; the consumer warps release
//    a stage on a second mbarrier. No thread spends registers or
//    instructions on addresses, and the producer starts before gamma is
//    read.
//  - A warp per row: each lane owns the same columns for the whole kernel
//    (8-byte vectors at lane + 32 j), reads them from the ring, takes the
//    four row statistics with warp shuffles in f32, keeps dy * gamma in
//    registers, and stores du straight from registers in 8-byte vectors.
//  - dgamma and dbeta in the same launch, in a fixed order, with no float
//    atomics: each lane sums its columns over its warp's rows in f32
//    registers; each warp stores its sums as a row of shared memory and the
//    block adds them in warp order into one f32 partial row; the last
//    block of each group of `group` (about sqrt(grid)) consecutive blocks
//    adds its group's rows in block order, and the last group adds the
//    group rows in group order and writes dgamma and dbeta. "Last" is an
//    integer ticket: one acquire-release atomic a block after its barrier,
//    as a cooperative grid sync does, not a fence a thread. The last block
//    of each level resets its ticket, so the int32 tickets, zeroed once
//    when the wrapper allocates them, need no memset launch. The result is
//    bit-identical from call to call on a card (the order depends on the
//    grid, so on the SM count).
//
// Forms (template LOAD): kRing above, wherever a row's bytes are a multiple
// of 16 (then every span of the 16-byte-aligned tensors is aligned, as the
// bulk copy needs); kScalar where they are not (odd D): the same kernel
// with no ring, each warp reading its row element by element straight from
// device memory (plain loads). Two forms are design probes, built only by
// scripts/ln_bwd_tilings.py (-DSSMV_LN_BWD_PROBES): kPrefetch (each warp
// loads its next row's 8-byte vectors into registers before it computes
// the current one, no shared memory) and the ring with 16 lanes a row.
//
// Coverage: bf16 and f32, any row count, D from 1 to kMaxD = 2048 on
// compile-time instances of E = 4 ... 64 elements a lane, each D on the
// smallest that holds it (from E = 40, D > 1,024, registers spill). The
// forms are runtime flags (b for K2b, du_out for K1c's add form), uniform
// over the block.
//
// Design probes (scripts/ln_bwd_tilings.py, the add form, bf16, T = 25,216
// rows, D = 384, ms; NVIDIA H100 80GB HBM3, 700.00 W; the byte bound is
// 0.0231, the card's streaming floor for the same bytes 0.0279, addcmul):
//   ring, 32 lanes a row        R = 8    R = 16   R = 32
//     1 block an SM,  2 stages  0.0408   0.0388   0.0399
//                     3 stages  0.0398   0.0394   0.0425
//                     4 stages  0.0402   0.0402   0.0426
//     2 blocks an SM, 2 stages  0.0364   0.0392   0.0409   <- kept
//                     3 stages  0.0386   0.0404   0.0404
//                     4 stages  0.0387   0.0406   0.0405
//   ring, 16 lanes a row, 2 stages, 1 block an SM: 0.0499, 0.0389, 0.0394
//     (2 blocks an SM: its 146 registers let one block in: 0.0587 ...)
//   register prefetch, no ring: 0.0909 (1 block an SM), 0.0758 (2)
// The kept configuration's phases (its %globaltimer stamps): the first
// stage lands 2.6 us after entry, the rows stream at the card's floor to
// 26.1 us, the cross-block sum takes the last 7.2 us. The first draft read
// 0.0530 with a 20 us fixed cost: every thread fenced before the tickets
// (7 us) and the warps added their sums in turn into one row, each add
// waiting on the last (6 us).
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;                 // consumer warps of a block
constexpr int kThreads = 32 * (kWarps + 1);  // + the producer warp
constexpr int kMaxStages = 8;
constexpr int kHeader = 256;  // full and empty barriers, the ticket flag
constexpr int kMaxD = 2048;
constexpr int kMaxGroups = 64;  // tickets: kMaxGroups groups + the last
// the phases a probe times (%globaltimer ns, thread 0 of each block): entry,
// barriers and gamma ready, warp 0's first stage arrived, rows done, the
// warps' sums added, the partial row written and the group ticket taken,
// the group row written and the last ticket taken, dgamma/dbeta written
constexpr int kStamps = 8;

enum Load { kRing = 0, kPrefetch = 1, kScalar = 2 };

struct Args {
  const void* a;    // u (K1c) or a (K2b)
  const void* b;    // K2b's b, or null
  const void* dy;
  const void* duo;  // K1c add form's du_out, or null
  void* du;
  const float* gamma;
  float* part;   // (grid + groups) x 2D f32 partial rows
  int* tickets;  // kMaxGroups + 1, zero between launches
  float* sums;   // [dgamma | dbeta]
  long long* stamps;  // a probe's per-block phase times (kStamps), or null
  long long rows;
  int D, R, stages, group;
  float eps;
};

__device__ __forceinline__ void stamp(const Args& p, int k) {
  if (p.stamps != nullptr && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    p.stamps[(size_t)blockIdx.x * kStamps + k] = t;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t tx) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(tx)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) global -> shared,
// completing on bar's transaction count
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <typename T, int V>
struct __align__(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void to_f(const Vec<T, V>& x, float (&f)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) f[k] = ssmv::to_f32(x.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void ld_f(const T* p, float (&f)[V]) {
  to_f(*reinterpret_cast<const Vec<T, V>*>(p), f);
}

// A row read through pointers (the ring in shared memory, or device memory
// in the scalar form); column c is the first of a lane's V.
template <typename T, int V>
struct PtrRow {
  const T *u, *b, *dy, *duo;
  __device__ void get_u(int, int c, float (&f)[V]) const { ld_f<T, V>(u + c, f); }
  __device__ void get_b(int, int c, float (&f)[V]) const { ld_f<T, V>(b + c, f); }
  __device__ void get_dy(int, int c, float (&f)[V]) const { ld_f<T, V>(dy + c, f); }
  __device__ void get_duo(int, int c, float (&f)[V]) const { ld_f<T, V>(duo + c, f); }
};

// A row held in registers (the prefetch form): vector j of each tensor.
template <typename T, int NV, int V>
struct RegRow {
  Vec<T, V> u[NV], b[NV], dy[NV], duo[NV];
  __device__ void get_u(int j, int, float (&f)[V]) const { to_f(u[j], f); }
  __device__ void get_b(int j, int, float (&f)[V]) const { to_f(b[j], f); }
  __device__ void get_dy(int j, int, float (&f)[V]) const { to_f(dy[j], f); }
  __device__ void get_duo(int j, int, float (&f)[V]) const { to_f(duo[j], f); }
};

// a sum over the L lanes of a team (L = 32: the warp; 16: each half)
template <int L>
__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One row by one team of L lanes: du to du_row, dy * xhat and dy added to
// the lane's column sums. Team lane `cl` owns columns (cl + L j) * V + k,
// k < V. Every lane of the warp calls it (the shuffles span the warp); a
// team with no row (`valid` false) reads and writes nothing and adds 0.
template <typename T, int NV, int V, int L, typename Row>
__device__ __forceinline__ void row_bwd(const Row& src, const float* gam,
                                        T* du_row, int D, float eps, bool hb,
                                        bool hduo, int cl, bool valid,
                                        float (&accg)[NV * V],
                                        float (&accb)[NV * V]) {
  float x[NV * V];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * L + cl) * V;
    float f[V];
    if (valid && c < D) {
      src.get_u(j, c, f);
      if (hb) {  // the forward's sum, rounded to the activation dtype
        float g[V];
        src.get_b(j, c, g);
#pragma unroll
        for (int k = 0; k < V; ++k)
          f[k] = ssmv::to_f32(ssmv::from_f32<T>(f[k] + g[k]));
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) f[k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      x[j * V + k] = f[k];
      s += f[k];
    }
  }
  const float mean = team_sum<L>(s) / D;
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const bool ok = (j * L + cl) * V < D;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float d = ok ? x[j * V + k] - mean : 0.f;
      x[j * V + k] = d;
      ss += d * d;
    }
  }
  const float rstd = rsqrtf(team_sum<L>(ss) / D + eps);
  float s1 = 0.f, s2 = 0.f, dyg[NV * V];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * L + cl) * V;
    if (valid && c < D) {
      float dy[V], g[V];
      src.get_dy(j, c, dy);
      to_f(*reinterpret_cast<const Vec<float, V>*>(gam + c), g);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float xh = x[j * V + k] * rstd;
        dyg[j * V + k] = dy[k] * g[k];
        x[j * V + k] = xh;
        s1 += dyg[j * V + k];
        s2 += dyg[j * V + k] * xh;
        accg[j * V + k] += dy[k] * xh;
        accb[j * V + k] += dy[k];
      }
    }
  }
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) {  // the two sums' shuffles interleaved
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float m1 = s1 / D, m2 = s2 / D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * L + cl) * V;
    if (valid && c < D) {
      float o[V];
      if (hduo) src.get_duo(j, c, o);
      Vec<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float du = (dyg[j * V + k] - m1 - x[j * V + k] * m2) * rstd;
        if (hduo) du += o[k];
        out.v[k] = ssmv::from_f32<T>(du);
      }
      *reinterpret_cast<Vec<T, V>*>(du_row + c) = out;
    }
  }
}

template <typename T, int NV, int V>
__device__ __forceinline__ void load_row(RegRow<T, NV, V>& r, const Args& p,
                                         long long row, bool hb, bool hduo,
                                         int lane) {
  const size_t off = (size_t)row * p.D;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int c = (j * 32 + lane) * V;
    if (c < p.D) {
      r.u[j] = *reinterpret_cast<const Vec<T, V>*>(
          static_cast<const T*>(p.a) + off + c);
      if (hb)
        r.b[j] = *reinterpret_cast<const Vec<T, V>*>(
            static_cast<const T*>(p.b) + off + c);
      r.dy[j] = *reinterpret_cast<const Vec<T, V>*>(
          static_cast<const T*>(p.dy) + off + c);
      if (hduo)
        r.duo[j] = *reinterpret_cast<const Vec<T, V>*>(
            static_cast<const T*>(p.duo) + off + c);
    }
  }
}

// the tensors of a ring stage, in slot order: u (or a), b, dy, du_out
__host__ __device__ inline int n_slots(bool hb, bool hduo) {
  return 2 + (hb ? 1 : 0) + (hduo ? 1 : 0);
}

__host__ __device__ inline size_t gamma_bytes(int D) {
  return ((size_t)D * 4 + 127) / 128 * 128;
}

// One thread's ticket after the block's barrier, one acquire-release atomic
// at gpu scope: the block's writes (ordered before this thread by the
// barrier) are released with it, and the writes of the blocks that took
// their tickets before are acquired (one ordering point a block, as in a
// cooperative grid sync, not a fence a thread)
__device__ __forceinline__ int ticket(int* t) {
  int v;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(v)
               : "l"(t)
               : "memory");
  return v;
}

// out[i] = sum over q < n of rows[q * W + i] in order, for i < W, by the
// block's threads, N columns a thread (N = 4 where W is a multiple of 4),
// up to 16 loads a thread in flight
template <int N>
__device__ __forceinline__ void ordered_sums(const float* rows, int n, int W,
                                             float* out) {
  using VecN = Vec<float, N>;
  for (int i = threadIdx.x * N; i < W; i += kThreads * N) {
    float s[N] = {};
    for (int q0 = 0; q0 < n; q0 += 16) {
      VecN v[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (q0 + u < n) {
          const float* src = rows + (size_t)(q0 + u) * W + i;
          if constexpr (N == 4) {
            const float4 f = __ldcg(reinterpret_cast<const float4*>(src));
            v[u].v[0] = f.x, v[u].v[1] = f.y, v[u].v[2] = f.z, v[u].v[3] = f.w;
          } else {
            v[u].v[0] = __ldcg(src);
          }
        }
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (q0 + u < n) {
#pragma unroll
          for (int k = 0; k < N; ++k) s[k] += v[u].v[k];
        }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) out[i + k] = s[k];
  }
}

__device__ __forceinline__ void ordered_sums(const float* rows, int n, int W,
                                             float* out) {
  if (W % 4 == 0)
    ordered_sums<4>(rows, n, W, out);
  else
    ordered_sums<1>(rows, n, W, out);
}

// E elements a lane, L lanes a row (the ring only; the other forms 32).
// Up to E = 16 (D <= 512) two blocks fit an SM (at most 112 registers).
template <typename T, int E, int LOAD, int L>
__global__ void __launch_bounds__(kThreads, E <= 16 ? 2 : 1)
ln_bwd_kernel(const Args p) {
  constexpr int V = LOAD == kScalar ? 1 : 8 / (int)sizeof(T);
  constexpr int NV = E / V;
  constexpr int RPW = 32 / L;  // rows a warp takes at once
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* flag = reinterpret_cast<int*>(empty + kMaxStages);
  float* gam = reinterpret_cast<float*>(smem + kHeader);
  unsigned char* ring = smem + kHeader + gamma_bytes(p.D);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cl = lane % L;
  const bool hb = p.b != nullptr, hduo = p.duo != nullptr;
  const int D = p.D;
  const int nw = LOAD == kRing ? kWarps : kWarps + 1;  // consumer warps
  const size_t span = (size_t)p.R * D * sizeof(T);     // a slot of a stage
  const size_t stage_bytes = span * n_slots(hb, hduo);
  const long long ntiles = (p.rows + p.R - 1) / p.R;

  stamp(p, 0);
  if (LOAD == kRing && threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // gamma into shared memory by the consumer warps, while the producer
  // starts the ring
  if (warp < nw) {
    for (int i = threadIdx.x; i < D; i += 32 * nw) gam[i] = p.gamma[i];
    asm volatile("bar.sync 1, %0;\n" ::"r"(32 * nw) : "memory");
  }
  stamp(p, 1);

  float accg[E], accb[E];
#pragma unroll
  for (int i = 0; i < E; ++i) accg[i] = accb[i] = 0.f;

  if constexpr (LOAD == kRing) {
    if (warp == kWarps) {  // the producer
      if (lane == 0) {
        const T* src[4] = {static_cast<const T*>(p.a),
                           static_cast<const T*>(p.b),
                           static_cast<const T*>(p.dy),
                           static_cast<const T*>(p.duo)};
        int k = 0;
        for (long long tile = blockIdx.x; tile < ntiles;
             tile += gridDim.x, ++k) {
          const int s = k % p.stages;
          if (k >= p.stages) mbar_wait(&empty[s], ((k / p.stages) - 1) & 1);
          const long long r0 = tile * p.R;
          const int nr = (int)min((long long)p.R, p.rows - r0);
          const uint32_t bytes = (uint32_t)((size_t)nr * D * sizeof(T));
          mbar_expect_tx(&full[s], bytes * n_slots(hb, hduo));
          unsigned char* dst = ring + s * stage_bytes;
          for (int t = 0; t < 4; ++t) {
            if (src[t] == nullptr) continue;
            bulk_g2s(dst, src[t] + r0 * D, bytes, &full[s]);
            dst += span;
          }
        }
      }
    } else {
      const int sdy = hb ? 2 : 1;
      const size_t slot = (size_t)p.R * D;
      int k = 0;
      for (long long tile = blockIdx.x; tile < ntiles;
           tile += gridDim.x, ++k) {
        const int s = k % p.stages;
        mbar_wait(&full[s], (k / p.stages) & 1);
        if (k == 0) stamp(p, 2);
        const T* base = reinterpret_cast<const T*>(ring + s * stage_bytes);
        const long long r0 = tile * p.R;
        const int nr = (int)min((long long)p.R, p.rows - r0);
        for (int rb = warp * RPW; rb < nr; rb += kWarps * RPW) {
          const int r = rb + lane / L;
          const size_t o = (size_t)r * D;
          PtrRow<T, V> row{base + o, base + slot + o, base + sdy * slot + o,
                           base + (sdy + 1) * slot + o};
          row_bwd<T, NV, V, L>(row, gam,
                               static_cast<T*>(p.du) + (r0 + r) * D, D,
                               p.eps, hb, hduo, cl, r < nr, accg, accb);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
      }
    }
  } else if constexpr (LOAD == kScalar) {
    const long long stride = (long long)gridDim.x * nw;
    for (long long r = (long long)blockIdx.x * nw + warp; r < p.rows;
         r += stride) {
      const size_t o = (size_t)r * D;
      PtrRow<T, V> row{static_cast<const T*>(p.a) + o,
                       hb ? static_cast<const T*>(p.b) + o : nullptr,
                       static_cast<const T*>(p.dy) + o,
                       hduo ? static_cast<const T*>(p.duo) + o : nullptr};
      row_bwd<T, NV, V, L>(row, gam, static_cast<T*>(p.du) + o, D, p.eps,
                           hb, hduo, cl, true, accg, accb);
    }
  } else {  // kPrefetch
    const long long stride = (long long)gridDim.x * nw;
    long long r = (long long)blockIdx.x * nw + warp;
    RegRow<T, NV, V> cur, nxt;
    if (r < p.rows) load_row(cur, p, r, hb, hduo, lane);
    for (; r < p.rows; r += stride) {
      if (r + stride < p.rows) load_row(nxt, p, r + stride, hb, hduo, lane);
      row_bwd<T, NV, V, L>(cur, gam, static_cast<T*>(p.du) + (size_t)r * D,
                           D, p.eps, hb, hduo, cl, true, accg, accb);
      cur = nxt;
    }
  }
  if constexpr (L < 32) {  // the warp's teams' sums, in team order
#pragma unroll
    for (int i = 0; i < E; ++i) {
#pragma unroll
      for (int o = L; o < 32; o <<= 1) {
        const float g = __shfl_down_sync(0xffffffffu, accg[i], o);
        const float b = __shfl_down_sync(0xffffffffu, accb[i], o);
        if ((lane & (2 * o - 1)) < o) {
          accg[i] += g;
          accb[i] += b;
        }
      }
    }
  }

  // the block's warps' column sums, in warp order, into one partial row
  __syncwarp();     // the producer warp's lanes together again
  __syncthreads();  // every stage consumed: the ring is free
  stamp(p, 3);
  // each warp's sums into its own row of shared memory, then every column
  // added over the warps in warp order
  const int W = 2 * D;
  float* red = reinterpret_cast<float*>(ring);  // nw rows of W
  if (warp < nw && lane < L) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int c = (j * L + cl) * V + k;
        if (c < D) {
          red[(size_t)warp * W + c] = accg[j * V + k];
          red[(size_t)warp * W + D + c] = accb[j * V + k];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < W; i += kThreads) {
    float v[kWarps + 1];
#pragma unroll
    for (int w = 0; w <= kWarps; ++w)
      v[w] = w < nw ? red[(size_t)w * W + i] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int w = 1; w <= kWarps; ++w)
      if (w < nw) sum += v[w];
    p.part[(size_t)blockIdx.x * W + i] = sum;
  }
  stamp(p, 4);

  // the last block of the group adds the group's rows in block order
  const int grid = gridDim.x, G = p.group;
  const int g = blockIdx.x / G, ng = (grid + G - 1) / G;
  const int g0 = g * G, gn = min(G, grid - g0);
  __syncthreads();
  if (threadIdx.x == 0) *flag = ticket(&p.tickets[g]) == gn - 1;
  __syncthreads();
  stamp(p, 5);
  if (!*flag) return;
  float* gpart = p.part + (size_t)grid * W;
  ordered_sums(p.part + (size_t)g0 * W, gn, W, gpart + (size_t)g * W);
  // the last group adds the groups' rows in group order
  __syncthreads();
  if (threadIdx.x == 0) {
    p.tickets[g] = 0;
    *flag = ticket(&p.tickets[kMaxGroups]) == ng - 1;
  }
  __syncthreads();
  stamp(p, 6);
  if (!*flag) return;
  ordered_sums(gpart, ng, W, p.sums);
  if (threadIdx.x == 0) p.tickets[kMaxGroups] = 0;
  __syncthreads();
  stamp(p, 7);
}

template <typename T, int E, int LOAD, int L>
cudaError_t launch(const Args& p, int grid, size_t smem, cudaStream_t st) {
  static bool raised[64] = {};  // per device: the shared-memory limit set
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !raised[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        ln_bwd_kernel<T, E, LOAD, L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ssmv::kMaxSmemBytes);
    if (e != cudaSuccess) return e;
    raised[dev] = true;
  }
  ln_bwd_kernel<T, E, LOAD, L><<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

// the smallest instance of E elements a lane that holds D over L lanes
template <typename T, int LOAD, int L>
cudaError_t dispatch_e(const Args& p, int grid, size_t smem,
                       cudaStream_t st) {
  const int e = (p.D + L - 1) / L;
  if constexpr (LOAD == kRing && L == 32) {
    if (e <= 4) return launch<T, 4, LOAD, L>(p, grid, smem, st);
    if (e <= 8) return launch<T, 8, LOAD, L>(p, grid, smem, st);
    if (e <= 12) return launch<T, 12, LOAD, L>(p, grid, smem, st);
    if (e <= 16) return launch<T, 16, LOAD, L>(p, grid, smem, st);
    if (e <= 24) return launch<T, 24, LOAD, L>(p, grid, smem, st);
    if (e <= 32) return launch<T, 32, LOAD, L>(p, grid, smem, st);
    if (e <= 40) return launch<T, 40, LOAD, L>(p, grid, smem, st);
    if (e <= 48) return launch<T, 48, LOAD, L>(p, grid, smem, st);
    return launch<T, 64, LOAD, L>(p, grid, smem, st);
  } else if constexpr (LOAD == kScalar) {  // a coverage form: few instances
    if (e <= 4) return launch<T, 4, LOAD, L>(p, grid, smem, st);
    if (e <= 8) return launch<T, 8, LOAD, L>(p, grid, smem, st);
    if (e <= 16) return launch<T, 16, LOAD, L>(p, grid, smem, st);
    if (e <= 32) return launch<T, 32, LOAD, L>(p, grid, smem, st);
    return launch<T, 64, LOAD, L>(p, grid, smem, st);
  } else {
#ifdef SSMV_LN_BWD_PROBES  // scripts/ln_bwd_tilings.py's own build
    if constexpr (LOAD == kPrefetch) {  // D = 384's instance
      if (e > 8 && e <= 12) return launch<T, 12, LOAD, L>(p, grid, smem, st);
    } else {  // the ring with 16 lanes a row, D <= 768
      if (e <= 12) return launch<T, 12, LOAD, L>(p, grid, smem, st);
      if (e <= 24) return launch<T, 24, LOAD, L>(p, grid, smem, st);
      if (e <= 48) return launch<T, 48, LOAD, L>(p, grid, smem, st);
    }
#endif
    return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch(const Args& p, int grid, int form, int team, size_t smem,
                     cudaStream_t st) {
  if (form == kRing)
    return team == 16 ? dispatch_e<T, kRing, 16>(p, grid, smem, st)
                      : dispatch_e<T, kRing, 32>(p, grid, smem, st);
  if (form == kPrefetch)
    return dispatch_e<T, kPrefetch, 32>(p, grid, smem, st);
  return dispatch_e<T, kScalar, 32>(p, grid, smem, st);
}

}  // namespace

// du, and [dgamma | dbeta] into sums (2D f32), D <= kMaxD. form: 0 the
// ring (rows of a multiple of 16 bytes), 1 the register-prefetch probe (D
// in 257..384), 2 the scalar form; team: lanes a row (16 a probe). part
// holds (grid + ceil(grid / group)) rows of 2D f32; tickets kMaxGroups + 1
// int32s, zero before the launch (and after it); stamps null, or a probe's
// kStamps int64s a block.
extern "C" int ssmv_ln_bwd(const void* a, const void* b, const void* dy,
                           const void* duo, void* du, const void* gamma,
                           void* part, void* tickets, void* sums,
                           void* stamps, long long rows, int D, int is_bf16,
                           float eps, int grid, int stages, int rows_per_stage,
                           int group, int form, int team, void* stream) {
  const size_t item = is_bf16 ? 2 : 4;
  const bool hb = b != nullptr, hduo = duo != nullptr;
  if (rows < 1 || D < 1 || D > kMaxD || grid < 1 || group < 1 ||
      (grid + group - 1) / group > kMaxGroups || form < kRing ||
      form > kScalar || (form == kRing && (D * item) % 16 != 0) ||
      stages < 1 || stages > kMaxStages || rows_per_stage < 1 ||
      (team != 32 && (team != 16 || form != kRing || D > 16 * 48)))
    return (int)cudaErrorInvalidValue;
  const size_t ring = form == kRing ? (size_t)stages * rows_per_stage * D *
                                          item * n_slots(hb, hduo)
                                    : 0;
  const size_t scratch = (size_t)(kWarps + 1) * 8 * D;  // the warps' sums
  const size_t smem = kHeader + gamma_bytes(D) + (ring > scratch ? ring : scratch);
  if (smem > ssmv::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  Args p{a, b, dy, duo, du, static_cast<const float*>(gamma),
         static_cast<float*>(part), static_cast<int*>(tickets),
         static_cast<float*>(sums), static_cast<long long*>(stamps), rows, D,
         rows_per_stage, stages, group, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<bf16>(p, grid, form, team, smem, st)
                       : dispatch<float>(p, grid, form, team, smem, st));
}
