// The attention kernels' shared parts (K5, K6, K11, K12), built on
// mma_sync.cuh's tensor-core and cp.async helpers: head tiles loaded from
// and stored to the packed layout (bf16, and f32 for the split-TF32 forms
// on mma_tf32.cuh), ``head_fwd``, the exact-softmax bf16 attention of one
// head over a 64-row query tile that K5 writes out and K12 feeds to its
// output projection, and ``head_fwd_f32``, the online-softmax f32
// attention that K5 and K11 write out (one kernel, ``fwd_f32_kernel``) and
// K12 feeds to its projection.
#pragma once

#include <math_constants.h>

#include "mma_sync.cuh"
#include "mma_tf32.cuh"

namespace ssmv {
namespace attn {

using namespace ssmv::tc;
using ssmv::tc::bf16;

constexpr int kT = 64;        // query rows a block, key rows a tile
constexpr int kThreads = 128; // 4 warps of 16 rows

// bf16 rows of a head tile in shared memory: HD + 8 elements, so the eight
// 16-byte rows one ldmatrix phase reads fall in distinct bank groups
__host__ __device__ constexpr int tile_ld(int hd) { return hd + 8; }
__host__ __device__ constexpr size_t tile_bytes(int hd) {
  return sizeof(bf16) * kT * tile_ld(hd);
}

// K12 runs a block as 1-3 teams of kThreads threads (one head each at a
// time): a team's barrier is the named barrier team + 1 (__syncthreads is
// barrier 0)
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(kThreads) : "memory");
}

// Rows [r0, r0 + kT) of a head's d columns (src: the head's first column of
// row 0, row stride ld elements) into a tile_ld(HD)-strided shared tile, by
// the kThreads threads of ranks tid (threadIdx.x by default); rows >=
// n_rows and columns >= d are zero. With vec (d % 8 == 0, so every
// row starts 16-byte aligned) by cp.async in the caller's commit group;
// otherwise by plain loads and stores, complete when the call returns.
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int n_rows, int d,
                                          bool vec, int tid) {
  constexpr int LD = tile_ld(HD);
  if (vec) {
    constexpr int V = HD / 8;  // 16-byte vectors a row
    for (int i = tid; i < kT * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 8;
      const bool ok = r0 + r < n_rows && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * ld + c : src,
                 ok);
    }
  } else {
    for (int i = tid; i < kT * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * LD + c] = r0 + r < n_rows && c < d
                            ? src[(size_t)(r0 + r) * ld + c]
                            : __float2bfloat16(0.f);
    }
  }
}
template <int HD>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          size_t ld, int r0, int n_rows, int d,
                                          bool vec) {
  load_rows<HD>(dst, src, ld, r0, n_rows, d, vec, threadIdx.x);
}

// Write a warp's 16 x HD f32 accumulator (HD / 8 C tiles), times the row
// factors f[0] (row g) and f[1] (row g + 8), as bf16 to rows [r0, r0 + 16)
// of a global head block (dst: the head's first column of row 0, row stride
// ld), rows >= n_rows and columns >= d dropped. The rows pass through
// ``stage``, the warp's own 16 rows of a tile_ld(HD)-strided shared tile,
// and leave in 16-byte stores where d % 8 == 0.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 8][4],
                                           const float (&f)[2], bf16* stage,
                                           bf16* dst, size_t ld, int r0,
                                           int n_rows, int d, bool vec) {
  constexpr int LD = tile_ld(HD);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(stage + g * LD + c) =
        pack2(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<uint32_t*>(stage + (g + 8) * LD + c) =
        pack2(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncwarp();
  if (vec) {
    constexpr int V = HD / 8;
    for (int i = lane; i < 16 * V; i += 32) {
      const int r = i / V, c = (i % V) * 8;
      if (r0 + r < n_rows && c < d)
        *reinterpret_cast<uint4*>(dst + (size_t)(r0 + r) * ld + c) =
            *reinterpret_cast<const uint4*>(stage + r * LD + c);
    }
  } else {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD, c = i % HD;
      if (r0 + r < n_rows && c < d)
        dst[(size_t)(r0 + r) * ld + c] = stage[r * LD + c];
    }
  }
  __syncwarp();
}

// The f32 forms' head tiles (the split-TF32 kernels on mma_tf32.cuh): rows
// of tf32::tile_ld(HD) floats, loaded as load_rows loads bf16 ones, with
// vec where d % 4 == 0 (16-byte cp.async).
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t ld, int r0, int n_rows,
                                              int d, bool vec, int tid) {
  constexpr int LD = tf32::tile_ld(HD);
  if (vec) {
    constexpr int V = HD / 4;  // 16-byte vectors a row
    for (int i = tid; i < kT * V; i += kThreads) {
      const int r = i / V, c = (i % V) * 4;
      const bool ok = r0 + r < n_rows && c < d;
      cp_async16(dst + r * LD + c, ok ? src + (size_t)(r0 + r) * ld + c : src,
                 ok);
    }
  } else {
    for (int i = tid; i < kT * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      dst[r * LD + c] =
          r0 + r < n_rows && c < d ? src[(size_t)(r0 + r) * ld + c] : 0.f;
    }
  }
}
template <int HD>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              size_t ld, int r0, int n_rows,
                                              int d, bool vec) {
  load_rows_f32<HD>(dst, src, ld, r0, n_rows, d, vec, threadIdx.x);
}

// store_rows for the f32 forms: the warp's 16 x HD f32 accumulator times
// the row factors, through its own 16 rows of a tf32::tile_ld(HD)-strided
// tile, to rows [r0, r0 + 16) of a global f32 head block
template <int HD>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[HD / 8][4],
                                               const float (&f)[2],
                                               float* stage, float* dst,
                                               size_t ld, int r0, int n_rows,
                                               int d, bool vec) {
  constexpr int LD = tf32::tile_ld(HD);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int c = j * 8 + 2 * t;
    *reinterpret_cast<float2*>(stage + g * LD + c) =
        make_float2(acc[j][0] * f[0], acc[j][1] * f[0]);
    *reinterpret_cast<float2*>(stage + (g + 8) * LD + c) =
        make_float2(acc[j][2] * f[1], acc[j][3] * f[1]);
  }
  __syncwarp();
  if (vec) {
    constexpr int V = HD / 4;
    for (int i = lane; i < 16 * V; i += 32) {
      const int r = i / V, c = (i % V) * 4;
      if (r0 + r < n_rows && c < d)
        *reinterpret_cast<float4*>(dst + (size_t)(r0 + r) * ld + c) =
            *reinterpret_cast<const float4*>(stage + r * LD + c);
    }
  } else {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD, c = i % HD;
      if (r0 + r < n_rows && c < d)
        dst[(size_t)(r0 + r) * ld + c] = stage[r * LD + c];
    }
  }
  __syncwarp();
}

// Shared-memory layout of ``head_fwd``: the q tile, then NST K and NST V
// stages, each kT rows of tile_ld(HD) bf16.
template <int HD, int NST>
struct Fwd {
  static constexpr int LD = tile_ld(HD);
  static constexpr size_t bytes = tile_bytes(HD) * (1 + 2 * NST);
};

// The attention of one head over the block's query rows [q0, q0 + kT), by
// 4 warps of 16 rows (K5's body; K12 runs it once per head, in teams):
// the threads of ranks tid in [0, kThreads), whose barrier is sync().
// base: the sample's row 0 at the head's q column (k at +C, v at +2C), row
// stride C3; smem: Fwd<HD, NST>::bytes. Returns the warp's unnormalized
// f32 o = e.V (rows g and g + 8 of its 16, HD / 8 C tiles) and
// linv = 1 / rowsum(e) for rows g and g + 8, every lane of a quad holding
// its rows' values. On return the warp's own 16 rows of the q tile (smem)
// are free.
//
// q's fragments are loaded once by ldmatrix and stay in registers. K and
// V tiles of kT rows stream through a ring of NST stages filled by
// cp.async (pad rows zero), one commit group a tile, so the next tiles'
// copies overlap this tile's products. The first pass over the K tiles
// computes only the exact row maxima m; the second recomputes
// S = (q.k^T) * scale (the same instructions, so the same values), forms
// e = exp(S - m) in f32 in registers, sums l from that f32 e, and packs e
// rounded to bf16 straight from the S accumulators into the A operand of
// e.V (f32 sums). Columns >= N are -inf before the max.
template <int HD, int NST, typename Sync>
__device__ __forceinline__ void head_fwd(const bf16* base, size_t C3, int C,
                                         int N, int q0, int d, float scale,
                                         bool vec, bf16* smem, int tid,
                                         Sync sync, float (&o)[HD / 8][4],
                                         float (&linv)[2]) {
  constexpr int LD = tile_ld(HD);
  bf16* Qs = smem;
  bf16* Ks = Qs + kT * LD;
  bf16* Vs = Ks + NST * kT * LD;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;
  const int T = 2 * nkt;  // pass 1: K tiles (row maxima); pass 2: K and V

  // tile t of the sequence into its stage, as one commit group (empty past
  // the end, so the group count stays uniform)
  auto issue = [&](int t) {
    if (t < T) {
      const int st = t % NST, kt = t < nkt ? t : t - nkt;
      load_rows<HD>(Ks + st * kT * LD, base + C, C3, kt * kT, N, d, vec, tid);
      if (t >= nkt)
        load_rows<HD>(Vs + st * kT * LD, base + 2 * C, C3, kt * kT, N, d, vec,
                      tid);
    }
    cp_async_commit();
  };
  sync();  // a previous call's readers of the stages are done
  load_rows<HD>(Qs, base, C3, q0, N, d, vec, tid);  // joins tile 0's group
  for (int s = 0; s < NST - 1; ++s) issue(s);

  uint32_t qa[HD / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < T; ++t) {
    cp_async_wait<NST - 2>();  // tile t (and q) landed, for this thread
    sync();                    // ... for every thread; tile t-1 is done
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
      m[0] = quad_max(m[0]);
      m[1] = quad_max(m[1]);
    }
  }
  linv[0] = 1.f / quad_sum(l[0]);
  linv[1] = 1.f / quad_sum(l[1]);
}

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores (mma_tf32.cuh)
// ---------------------------------------------------------------------------

// Shared-memory layout of ``head_fwd_f32``: the q tile, then kF32Stages K
// and kF32Stages V stages, each kT rows of tf32::tile_ld(HD) floats.
constexpr int kF32Stages = 2;
// n-tiles a tf32 mma_group sweeps (8 measured slower here, where it is
// faster in K6)
constexpr int kF32Group = 4;
template <int HD>
__host__ __device__ constexpr size_t f32_bytes() {
  return sizeof(float) * kT * tf32::tile_ld(HD) * (1 + 2 * kF32Stages);
}

// The f32 attention of one head over the query rows [q0, q0 + kT), by 4
// warps of 16 rows, in one pass over the keys with the JAX flash kernel's
// online softmax (attention.py:35-72; in f32 K5's function up to the
// order of the softmax): the threads of ranks tid in [0, kThreads), whose
// barrier is sync(). base, C3, C and the return values as ``head_fwd``'s
// (o unnormalized, linv = 1 / max(rowsum, 1e-30)); smem: f32_bytes<HD>().
// The caller syncs before a second call reuses smem. On return the warp's
// own 16 rows of the q tile are free.
//
// K and V tiles of kT rows pass together through a ring of kF32Stages
// stages filled by cp.async (pad rows zero), one commit group a tile. q is
// scaled in f32 first (attention.py:43) and split into hi + lo as it is
// read from shared memory; S = (q*scale) . k^T and P . V each take three
// tf32 mma.sync.m16n8k8 a k-step (lo.hi + hi.lo, then hi.hi; swept over
// groups of kF32Group n-tiles), f32 sums; per tile m' = max(m, rowmax S)
// (columns >= N -inf), alpha = exp(m - m'), P = exp(S - m') in f32,
// l' = l * alpha + rowsum P, o scaled by alpha; P stays f32 (attention.py
// :60) and is split as the A operand of P . V straight from the S
// accumulators, k relabelled (``a_from_c``, the V rows read as k0 + 2t and
// k0 + 2t + 1). A key tile's 8-key n-tiles past N and a warp's 16 rows past
// N skip their products (such a warp returns o = 0).
template <int HD, typename Sync>
__device__ __forceinline__ void head_fwd_f32(const float* base, size_t C3,
                                             int C, int N, int q0, int d,
                                             float scale, bool vec,
                                             float* smem, int tid, Sync sync,
                                             float (&o)[HD / 8][4],
                                             float (&linv)[2]) {
  constexpr int LD = tf32::tile_ld(HD), NST = kF32Stages;
  constexpr int GS = tf32::group_for(kT / 8, kF32Group);
  constexpr int GD = tf32::group_for(HD / 8, kF32Group);
  float* Qs = smem;
  float* Ks = Qs + kT * LD;
  float* Vs = Ks + NST * kT * LD;
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int nkt = (N + kT - 1) / kT;
  // a warp whose 16 query rows all lie past N only keeps the block's pace
  const bool live = q0 + warp * 16 < N;
  const float* Qw = Qs + warp * 16 * LD;

  // K and V tile t into stage t % NST, as one commit group (empty past the
  // end, so the group count stays uniform)
  auto issue = [&](int t) {
    if (t < nkt) {
      const int st = t % NST;
      load_rows_f32<HD>(Ks + st * kT * LD, base + C, C3, t * kT, N, d, vec,
                        tid);
      load_rows_f32<HD>(Vs + st * kT * LD, base + 2 * C, C3, t * kT, N, d,
                        vec, tid);
    }
    cp_async_commit();
  };
  load_rows_f32<HD>(Qs, base, C3, q0, N, d, vec, tid);  // joins tile 0's group
  for (int s = 0; s < NST - 1; ++s) issue(s);

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  // rows g and g + 8 of the warp's 16: the running max (the quad's), and
  // this lane's part of the running sum
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};

  for (int t = 0; t < nkt; ++t) {
    cp_async_wait<NST - 2>();  // tile t (and q) landed, for this thread
    sync();                    // ... for every thread; tile t-1 is done
    issue(t + NST - 1);        // into the stage tile t-1 used
    if (!live) continue;
    const int k0 = t * kT;
    const float* Kt = Ks + (t % NST) * kT * LD;
    const float* Vt = Vs + (t % NST) * kT * LD;
    // the 8-key n-tiles holding a key < N
    const int nv = min(kT / 8, (N - k0 + 7) / 8);

    float s[kT / 8][4];
#pragma unroll
    for (int j = 0; j < kT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    for (int kd = 0; kd < HD / 8; ++kd) {
      tf32::FragA qa;
      tf32::ld_a(qa, Qw, LD, kd * 8, scale);  // q scaled in f32 first
#pragma unroll
      for (int jg = 0; jg < kT / 8; jg += GS) {
        if (jg < nv) {
          tf32::FragB kb[GS];
#pragma unroll
          for (int j = 0; j < GS; ++j)
            tf32::ld_b_nk(kb[j], Kt, LD, (jg + j) * 8, kd * 8);
          tf32::mma_group(s, jg, qa, kb);
        }
      }
    }
    float mt[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * tq + (e & 1);
        s[j][e] = col < N ? s[j][e] : -CUDART_INF_F;
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
    for (int j = 0; j < kT / 8; ++j) {  // P . V, 8 keys a k-step, P in f32
      if (j < nv) {
        tf32::FragA pa;
        tf32::a_from_c(pa, s[j]);
#pragma unroll
        for (int ng = 0; ng < HD / 8; ng += GD) {
          tf32::FragB vb[GD];
#pragma unroll
          for (int i = 0; i < GD; ++i)
            tf32::ld_b_kn(vb[i], Vt, LD, j * 8, (ng + i) * 8);
          tf32::mma_group(o, ng, pa, vb);
        }
      }
    }
  }
  linv[0] = 1.f / fmaxf(quad_sum(l[0]), 1e-30f);
  linv[1] = 1.f / fmaxf(quad_sum(l[1]), 1e-30f);
}

// The f32 forward of K5 and K11, one kernel for the one f32 function of
// the two TPU kernels (``fwd_f32_kernel``, defined once, in flash_fwd.cu):
// qkv (B, N, 3 H d) -> out (B, N, H d), f32, contiguous and 16-byte
// aligned, d <= 128; the caller checks the rest of its own caps.
cudaError_t fwd_f32(const float* qkv, float* out, int B, int N, int H, int d,
                    float scale, cudaStream_t s);

}  // namespace attn
}  // namespace ssmv
