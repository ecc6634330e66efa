// Multi-head attention forward with the output projection folded in (K12).
//
// Replaces the Pallas kernel slim_switch_moe_vit_tpu/ops/attention.py
// _mha_fwd_proj_kernel (:335), reached through _mha_proj_fwd_call (:377)
// and fused_mha_proj (:393):
//   y = sum over heads h of T(softmax(q_h k_h^T * scale) v_h) . Wp[h] + bp
// over the packed qkv (B, N, 3C), with Wp[h] = Wp[h*d : (h+1)*d, :] (Wp is
// (C, C), in qkv's dtype T; bp (C,) f32) and y (B, N, C) in T. N <= 1024,
// C <= 1280, head_dim d <= 128 (on the smallest instance HD in {32, 64,
// 96, 128} >= d).
//
// What bounds it on the H100: per (sample, head) the work and traffic of
// K5 (mha_fwd.cu), plus the projection (2 N C^2 flops a sample); the
// (B, N, C) attention output never goes to device memory, so the bytes are
// qkv, Wp and bp read once and y written once. At ViT-S (B = 128, N = 197)
// that is 0.023 ms of bytes against 0.015 ms of bf16 tensor-core work. The
// SIMT form this replaces took every product as an f32 FMA, kept the whole
// score row in shared memory (16-64 query rows and one block an SM), read
// Wp from device memory as scalars in every block for every head, and ran
// 74 blocks at N = 577, C = 1024, B = 2: 70-490x its bound.
//
// Design (bf16). A block takes 64 query rows of one sample and a group of
// consecutive heads, in 1-3 teams of 4 warps of 16 rows:
//   1. The teams take the group's heads in turn. Each head runs K5's head
//      body (``head_fwd`` of attn_mma.cuh: mma.sync with S in registers,
//      K / V through the team's cp.async ring, the exact row max from a
//      first pass), and its output o_h = (e . v_h) * linv, rounded to bf16
//      as the JAX kernel rounds it (attention.py:364), goes into the
//      block's o tile in shared memory (64 rows x the group's columns):
//      never to device memory.
//   2. Then one tile GEMM, y_g = o . Wp[group's rows, :], on mma.sync: the
//      teams take y's 64-column chunks in turn, each streaming its chunks'
//      Wp tiles (64 k-rows x 64 columns) from L2 through a cp.async ring in
//      the shared memory its heads' stages used; a warp keeps its 16 x 64
//      chunk of y in registers (32 floats a thread) and writes it when its
//      k-rows are done.
// The teams exist for occupancy: the o tile is per block, so one team a
// block would leave 4-8 warps an SM where the head body, latency-bound as
// in K5, wants 12; a team's barrier is its own named barrier. The host
// takes the most teams (up to 3, at most one a head) whose stages fit
// beside the o tile.
// What still bounds it (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the
// attention phase runs at K5's speed, the projection phase at several
// times F.linear's time for the same product, as every block re-reads its
// rows of Wp from L2 (151 MB at ViT-S, B = 128); a 6-stage Wp ring and
// wgmma (the team is a warpgroup) were no faster.
//
// Enough blocks at small B: one block per (64-row tile, sample) gives 20
// blocks at N = 577, B = 2 for 132 SMs, each walking 16 heads in turn. So
// the heads are split into groups, as few as give at least one block per
// SM (and whose o tile fits in shared memory: at C = 1280 a 64-row o tile
// alone is 160 KB); with more than one group, each block writes its f32
// partial y_g to a workspace and a second kernel adds the groups in order,
// then bp, and rounds once. Splitting the heads, rather than y's columns
// over blocks that each recompute every head's attention, keeps the
// attention (the larger part of the work at N = 577) done once; the
// workspace costs 4 bytes a head group per element of y, read back once,
// and exists only where the batch is too small to fill the card. No
// atomics: every sum has one order, whatever the schedule.
//
// Arithmetic: the head body's (the scale after q.k^T, e rounded to bf16
// for e.V, f32 sums, o_h = (e.V) * linv rounded to bf16), then y = o . Wp
// with f32 sums over all of a group's columns (the JAX kernel sums a
// per-head f32 partial per head: the same sum in another order), the
// groups' partials added in group order, bp added in f32 and y rounded
// once.
//
// The f32 form (split TF32 on the tensor cores, mma_tf32.cuh) has the bf16
// form's structure: the teams take the group's heads in turn, each head
// runs the f32 head body of K5 and K11 (``head_fwd_f32`` of attn_mma.cuh:
// the online softmax, q scaled in f32 first, P in f32), and its o_h * linv
// stays f32 (the JAX kernel rounds it to T, the identity here) in the
// block's f32 o tile in shared memory, never in device memory; then
// y_g = o . Wp[group's rows, :] in split TF32 (three mma.sync.m16n8k8 a
// k-step, the A operand read from the o tile with k relabelled, ``ld_a_c``,
// and the B operand to match, ``ld_b_kn``), Wp's k-rows streaming from L2
// through a cp.async ring in f32. A 64-row f32 o tile takes 100 KB at
// C = 384 and 322 KB at C = 1280, against 227 KB, so the heads split into
// groups wherever the tile does not fit beside a team's stages (87 KB at
// head_dim 64), as wherever B leaves SMs idle; the groups share the bf16
// form's workspace and its second kernel, and every sum keeps one order
// (bit-identical from call to call).
#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"

namespace {

constexpr int kMaxN = 1024;
// C up to vit_huge's 1280, the widest model of either zoo and the widest
// the kernels are tested at; no tile bounds C (the heads split into
// groups wherever the o tile does not fit)
constexpr int kMaxC = 1280;

// ---------------------------------------------------------------------------
// bf16: the tensor-core form
// ---------------------------------------------------------------------------

namespace at = ssmv::attn;
using at::bf16;
using at::kT;

constexpr int kNC = 64;        // y columns a chunk (a warp's 16 x 64 in registers)
constexpr int kWLD = kNC + 8;  // bf16 rows of a Wp tile
constexpr int kWStages = 3;    // the Wp ring
constexpr int kStages = 2;     // the head body's K / V ring

// bf16 row stride of the o tile for kg columns: a multiple of 16 (the
// GEMM's k steps) plus 8, so ldmatrix's 8 rows fall in distinct bank groups
__host__ __device__ constexpr int o_ld(int kg) { return (kg + 15) / 16 * 16 + 8; }

// a team's shared memory: the head body's stages, then the Wp ring in the
// same bytes
template <int HD>
__host__ __device__ constexpr size_t team_bytes() {
  return at::Fwd<HD, kStages>::bytes > sizeof(bf16) * kWStages * kT * kWLD
             ? at::Fwd<HD, kStages>::bytes
             : sizeof(bf16) * kWStages * kT * kWLD;
}

// the o tile for kg columns, then nt teams' stages
template <int HD>
__host__ __device__ constexpr size_t proj_smem_bytes(int kg, int nt) {
  return sizeof(bf16) * kT * o_ld(kg) + nt * team_bytes<HD>();
}

// grid (query tiles, head groups, B), NT teams of 4 warps. part: null with
// one group (y written here, bp added), else the (groups, B, N, C) f32
// workspace of the partials.
template <int HD, int NT>
__global__ void __launch_bounds__(NT * at::kThreads)
mha_proj_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ wp,
                     const float* __restrict__ bp, bf16* __restrict__ y,
                     float* __restrict__ part, int N, int H, int d, int hpg,
                     float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kT, gi = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int h0 = gi * hpg, nh = min(hpg, H - h0), kg = nh * d;
  const int OLD = o_ld(hpg * d);
  const int team = threadIdx.x / at::kThreads, tid = threadIdx.x % at::kThreads;
  bf16* Os = reinterpret_cast<bf16*>(smem);
  // the team's stages: the heads' Q / K / V, then the Wp tiles
  bf16* ring = reinterpret_cast<bf16*>(smem + sizeof(bf16) * kT * OLD +
                                       team * team_bytes<HD>());
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  bf16* Ow = Os + warp * 16 * OLD;  // the warp's 16 rows

  // the GEMM's last k step reads columns [kg, 16-multiple): zero, so that
  // 0 times the zero-filled Wp rows there adds nothing
  const int kg16 = (kg + 15) / 16 * 16;
  if (team == 0)
    for (int i = lane; i < 16 * (kg16 - kg); i += 32)
      Ow[(i / (kg16 - kg)) * OLD + kg + i % (kg16 - kg)] = __float2bfloat16(0.f);

  // the teams take the group's heads in turn
  const bf16* base = qkv + (size_t)b * N * C3;
  for (int hl = team; hl < nh; hl += NT) {
    float o[HD / 8][4], linv[2];
    at::head_fwd<HD, kStages>(base + (size_t)(h0 + hl) * d, C3, C, N, q0, d,
                              scale, vec, ring, tid,
                              [team] { at::team_sync(team); }, o, linv);
    // o_h rounded to bf16 into the warp's rows, columns [hl*d, hl*d + d)
    bf16* dst = Ow + hl * d;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = j * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float f = linv[r];
        bf16* p = dst + (g + 8 * r) * OLD + c;
        if (c + 1 < d && !(d & 1)) {  // an even column: one 4-byte pair
          *reinterpret_cast<uint32_t*>(p) =
              at::pack2(o[j][2 * r] * f, o[j][2 * r + 1] * f);
        } else {
          if (c < d) p[0] = __float2bfloat16(o[j][2 * r] * f);
          if (c + 1 < d) p[1] = __float2bfloat16(o[j][2 * r + 1] * f);
        }
      }
    }
  }
  __syncthreads();  // the o tile is complete, and every team's stages free

  // y_g = o . Wp[h0*d + k, c]: the teams take y's 64-column chunks in
  // turn; a team streams its chunks' Wp tiles (kT k-rows x kNC columns) in
  // the order (chunk, k tile), one commit group each
  const int nk = (kg + kT - 1) / kT, ncc = (C + kNC - 1) / kNC;
  const int T = (ncc - team + NT - 1) / NT * nk;  // this team's tiles
  const bool wvec = C % 8 == 0;  // every Wp row starts 16-byte aligned
  const bf16* wg = wp + (size_t)h0 * d * C;
  auto issue = [&](int t) {
    if (t < T) {
      const int c0 = (team + NT * (t / nk)) * kNC, k0 = (t % nk) * kT;
      bf16* dst = ring + (t % kWStages) * kT * kWLD;
      if (wvec) {
        for (int i = tid; i < kT * (kNC / 8); i += at::kThreads) {
          const int r = i / (kNC / 8), c = (i % (kNC / 8)) * 8;
          const bool ok = k0 + r < kg && c0 + c < C;
          at::cp_async16(dst + r * kWLD + c,
                         ok ? wg + (size_t)(k0 + r) * C + c0 + c : wg, ok);
        }
      } else {
        for (int i = tid; i < kT * kNC; i += at::kThreads) {
          const int r = i / kNC, c = i % kNC;
          dst[r * kWLD + c] = k0 + r < kg && c0 + c < C
                                    ? wg[(size_t)(k0 + r) * C + c0 + c]
                                    : __float2bfloat16(0.f);
        }
      }
    }
    at::cp_async_commit();
  };
  for (int s = 0; s < kWStages - 1; ++s) issue(s);

  float acc[kNC / 8][4];
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int t = 0; t < T; ++t) {
    at::cp_async_wait<kWStages - 2>();  // tile t landed, for this thread
    at::team_sync(team);                // ... for the team; t-1 is done
    issue(t + kWStages - 1);            // into the stage tile t-1 used
    const int cc = team + NT * (t / nk), kt = t % nk;
    const bf16* W = ring + (t % kWStages) * kT * kWLD;
#pragma unroll
    for (int kc = 0; kc < kT / 16; ++kc) {
      const int k = kt * kT + kc * 16;
      if (k < kg) {
        uint32_t a[4];
        at::ld_a(a, Ow, OLD, k);
#pragma unroll
        for (int np = 0; np < kNC / 16; ++np) {
          uint32_t wb[4];
          at::ld_b_kn(wb, W, kWLD, kc * 16, np * 16);
          at::mma(acc[2 * np], a, wb[0], wb[1]);
          at::mma(acc[2 * np + 1], a, wb[2], wb[3]);
        }
      }
    }
    if (kt == nk - 1) {  // the chunk's sums are complete: write them
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int c = cc * kNC + j * 8 + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = q0 + warp * 16 + g + 8 * r;
          if (n >= N) continue;
          const size_t off = ((size_t)b * N + n) * C + c;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          if (part == nullptr) {
            if (c + 1 < C && !(C & 1)) {
              *reinterpret_cast<uint32_t*>(y + off) =
                  at::pack2(v0 + bp[c], v1 + bp[c + 1]);
            } else {
              if (c < C) y[off] = __float2bfloat16(v0 + bp[c]);
              if (c + 1 < C) y[off + 1] = __float2bfloat16(v1 + bp[c + 1]);
            }
          } else {
            float* pp = part + (size_t)gi * gridDim.z * N * C + off;
            if (c + 1 < C && !(C & 1)) {
              *reinterpret_cast<float2*>(pp) = make_float2(v0, v1);
            } else {
              if (c < C) pp[0] = v0;
              if (c + 1 < C) pp[1] = v1;
            }
          }
        }
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: split TF32 on the tensor cores
// ---------------------------------------------------------------------------

namespace tf = ssmv::tf32;

// f32 rows of a Wp tile: 4 words past a multiple of 32, so ld_b_kn's reads
// (rows k0 + 2t and k0 + 2t + 1, column n0 + g) are conflict-free
constexpr int kF32WLD = kNC + 4;
// n-tiles of a y chunk one tf32 mma_group sweeps
constexpr int kProjGroup = 8;

// f32 row stride of the o tile for kg columns: 8 words past a multiple of
// 32, so ld_a_c's 8-byte reads and the heads' 8-byte writes (row g, column
// 2t) are conflict-free
__host__ __device__ constexpr int o_ld_f32(int kg) {
  return (kg + 31) / 32 * 32 + 8;
}

// a team's shared memory: the head body's stages, then the Wp ring in the
// same bytes
template <int HD>
__host__ __device__ constexpr size_t team_bytes_f32() {
  return at::f32_bytes<HD>() > sizeof(float) * kWStages * kT * kF32WLD
             ? at::f32_bytes<HD>()
             : sizeof(float) * kWStages * kT * kF32WLD;
}

// the f32 o tile for kg columns, then nt teams' stages
template <int HD>
__host__ __device__ constexpr size_t proj_smem_bytes_f32(int kg, int nt) {
  return sizeof(float) * kT * o_ld_f32(kg) + nt * team_bytes_f32<HD>();
}

// The bf16 kernel's structure in split TF32: grid (query tiles, head
// groups, B), NT teams of 4 warps; part as the bf16 kernel's.
template <int HD, int NT>
__global__ void __launch_bounds__(NT * at::kThreads)
mha_proj_f32_kernel(const float* __restrict__ qkv,
                    const float* __restrict__ wp, const float* __restrict__ bp,
                    float* __restrict__ y, float* __restrict__ part, int N,
                    int H, int d, int hpg, float scale, int vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int q0 = blockIdx.x * kT, gi = blockIdx.y, b = blockIdx.z;
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int h0 = gi * hpg, nh = min(hpg, H - h0), kg = nh * d;
  const int OLD = o_ld_f32(hpg * d);
  const int team = threadIdx.x / at::kThreads, tid = threadIdx.x % at::kThreads;
  float* Os = reinterpret_cast<float*>(smem);
  // the team's stages: the heads' Q / K / V, then the Wp tiles
  float* ring = reinterpret_cast<float*>(smem + sizeof(float) * kT * OLD +
                                         team * team_bytes_f32<HD>());
  const int warp = tid >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  float* Ow = Os + warp * 16 * OLD;  // the warp's 16 rows
  // a warp whose 16 rows all lie past N only keeps its team's pace
  const bool live = q0 + warp * 16 < N;

  // the GEMM's last k step reads columns [kg, 8-multiple): zero, so that
  // 0 times the zero-filled Wp rows there adds nothing
  const int kg8 = (kg + 7) / 8 * 8;
  if (team == 0)
    for (int i = lane; i < 16 * (kg8 - kg); i += 32)
      Ow[(i / (kg8 - kg)) * OLD + kg + i % (kg8 - kg)] = 0.f;

  // the teams take the group's heads in turn; o_h * linv stays f32 (the
  // JAX kernel's rounding to T, attention.py:364, is the identity here)
  const float* base = qkv + (size_t)b * N * C3;
  for (int hl = team; hl < nh; hl += NT) {
    float o[HD / 8][4], linv[2];
    at::team_sync(team);  // the last head's readers of the stages are done
    at::head_fwd_f32<HD>(base + (size_t)(h0 + hl) * d, C3, C, N, q0, d, scale,
                         vec, ring, tid, [team] { at::team_sync(team); }, o,
                         linv);
    float* dst = Ow + hl * d;  // the warp's rows, columns [hl*d, hl*d + d)
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = j * 8 + 2 * tq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float f = linv[r];
        float* p = dst + (g + 8 * r) * OLD + c;
        if (c + 1 < d && !(d & 1)) {  // an even column: one 8-byte pair
          *reinterpret_cast<float2*>(p) =
              make_float2(o[j][2 * r] * f, o[j][2 * r + 1] * f);
        } else {
          if (c < d) p[0] = o[j][2 * r] * f;
          if (c + 1 < d) p[1] = o[j][2 * r + 1] * f;
        }
      }
    }
  }
  __syncthreads();  // the o tile is complete, and every team's stages free

  // y_g = o . Wp[h0*d + k, c] in split TF32: the teams take y's 64-column
  // chunks in turn; a team streams its chunks' Wp tiles (kT k-rows x kNC
  // columns, f32) in the order (chunk, k tile), one commit group each. The
  // A operand is read with k relabelled (ld_a_c), the B operand to match
  // (ld_b_kn).
  const int nk = (kg + kT - 1) / kT, ncc = (C + kNC - 1) / kNC;
  const int T = (ncc - team + NT - 1) / NT * nk;  // this team's tiles
  const bool wvec = C % 4 == 0;  // every Wp row starts 16-byte aligned
  const float* wg = wp + (size_t)h0 * d * C;
  auto issue = [&](int t) {
    if (t < T) {
      const int c0 = (team + NT * (t / nk)) * kNC, k0 = (t % nk) * kT;
      float* dst = ring + (t % kWStages) * kT * kF32WLD;
      if (wvec) {
        for (int i = tid; i < kT * (kNC / 4); i += at::kThreads) {
          const int r = i / (kNC / 4), c = (i % (kNC / 4)) * 4;
          const bool ok = k0 + r < kg && c0 + c < C;
          at::cp_async16(dst + r * kF32WLD + c,
                         ok ? wg + (size_t)(k0 + r) * C + c0 + c : wg, ok);
        }
      } else {
        for (int i = tid; i < kT * kNC; i += at::kThreads) {
          const int r = i / kNC, c = i % kNC;
          dst[r * kF32WLD + c] = k0 + r < kg && c0 + c < C
                                     ? wg[(size_t)(k0 + r) * C + c0 + c]
                                     : 0.f;
        }
      }
    }
    at::cp_async_commit();
  };
  for (int s = 0; s < kWStages - 1; ++s) issue(s);

  float acc[kNC / 8][4];
#pragma unroll
  for (int j = 0; j < kNC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int t = 0; t < T; ++t) {
    at::cp_async_wait<kWStages - 2>();  // tile t landed, for this thread
    at::team_sync(team);                // ... for the team; t-1 is done
    issue(t + kWStages - 1);            // into the stage tile t-1 used
    if (!live) continue;
    const int cc = team + NT * (t / nk), kt = t % nk;
    const float* W = ring + (t % kWStages) * kT * kF32WLD;
#pragma unroll
    for (int ks = 0; ks < kT / 8; ++ks) {
      const int k = kt * kT + ks * 8;
      if (k < kg) {
        tf::FragA a;
        tf::ld_a_c(a, Ow, OLD, k);
#pragma unroll
        for (int jg = 0; jg < kNC / 8; jg += kProjGroup) {
          tf::FragB wb[kProjGroup];
#pragma unroll
          for (int i = 0; i < kProjGroup; ++i)
            tf::ld_b_kn(wb[i], W, kF32WLD, ks * 8, (jg + i) * 8);
          tf::mma_group(acc, jg, a, wb);
        }
      }
    }
    if (kt == nk - 1) {  // the chunk's sums are complete: write them
#pragma unroll
      for (int j = 0; j < kNC / 8; ++j) {
        const int c = cc * kNC + j * 8 + 2 * tq;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = q0 + warp * 16 + g + 8 * r;
          if (n >= N) continue;
          const size_t off = ((size_t)b * N + n) * C + c;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          float* dst = part == nullptr
                           ? y + off
                           : part + (size_t)gi * gridDim.z * N * C + off;
          const float b0 = part == nullptr && c < C ? bp[c] : 0.f;
          const float b1 = part == nullptr && c + 1 < C ? bp[c + 1] : 0.f;
          if (c + 1 < C && !(C & 1)) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0 + b0, v1 + b1);
          } else {
            if (c < C) dst[0] = v0 + b0;
            if (c + 1 < C) dst[1] = v1 + b1;
          }
        }
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// both forms: the groups' sum, and how a shape is cut
// ---------------------------------------------------------------------------

// y = the groups' partials summed in group order, + bp, rounded once to T
template <typename T>
__global__ void mha_proj_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ bp,
                                       T* __restrict__ y, size_t M, int C,
                                       int G) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int g = 1; g < G; ++g) v += part[(size_t)g * M + i];
    y[i] = ssmv::from_f32<T>(v + bp[i % C]);
  }
}

constexpr int kMaxTeams = 3;
// The teams the plan first tries to fit beside the o tile when it picks
// the heads a block takes (then fewer, down to one). f32: 2, as a block
// then runs 8 warps that hide one another's mma latency, where one team
// of a larger group runs 4 (ViT-S eval at B = 128: groups of 3 heads in 2
// teams 0.6154 ms, of 6 heads in one team 0.7539; NVIDIA H100 80GB HBM3,
// 700 W, scripts/attn_f32_tilings.py); bf16: 1, its stages small enough
// that one team's plan leaves room for more.
template <typename T>
constexpr int kPlanTeams = std::is_same_v<T, float> ? 2 : 1;

// How a shape is cut: heads a block (hpg) and teams a block (nt).
struct Plan {
  int hpg, nt;
};

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes(int kg, int nt) {
  if constexpr (std::is_same_v<T, float>)
    return proj_smem_bytes_f32<HD>(kg, nt);
  else
    return proj_smem_bytes<HD>(kg, nt);
}

template <typename T, int HD, int NT>
cudaError_t launch_plan(const void* qkv, const void* wp, const void* bp,
                        void* y, void* part, int B, int N, int H, int d,
                        int hpg, float scale, cudaStream_t s) {
  const int G = (H + hpg - 1) / hpg;
  if ((G > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, HD>(hpg * d, NT);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  void (*kernel)(const T*, const T*, const float*, T*, float*, int, int, int,
                 int, float, int);
  if constexpr (std::is_same_v<T, float>)
    kernel = mha_proj_f32_kernel<HD, NT>;
  else
    kernel = mha_proj_bf16_kernel<HD, NT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // 16-byte q / k / v rows: bf16 d % 8 == 0, f32 d % 4 == 0
  const int vec = d % (16 / (int)sizeof(T)) == 0;
  kernel<<<dim3((N + kT - 1) / kT, G, B), NT * at::kThreads, smem, s>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(y),
      static_cast<float*>(part), N, H, d, hpg, scale, vec);
  if (G == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t M = (size_t)B * N * H * d;
  const int blocks = (int)((M + 255) / 256 < 4096 ? (M + 255) / 256 : 4096);
  mha_proj_reduce_kernel<T><<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(bp),
      static_cast<T*>(y), M, H * d, G);
  return cudaGetLastError();
}

// hpg: the most heads a block (so the fewest groups and the least
// workspace) that still give every SM a block and whose o tile fits in
// shared memory beside kPlanTeams<T> teams, or failing that fewer; nt:
// the most teams, up to 3 and one a head, that fit beside it.
template <typename T, int HD>
cudaError_t plan(int B, int N, int H, int d, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((N + kT - 1) / kT) * B;
  int hpg = 1;
  for (int mt = kPlanTeams<T>; mt >= 1 && hpg == 1; --mt)
    for (int h = H; h > 1; --h)
      if (tiles * ((H + h - 1) / h) >= sms &&
          smem_bytes<T, HD>(h * d, mt) <= ssmv::kMaxSmemBytes) {
        hpg = h;
        break;
      }
  int nt = 1;
  while (nt < kMaxTeams && nt < hpg &&
         smem_bytes<T, HD>(hpg * d, nt + 1) <= ssmv::kMaxSmemBytes)
    ++nt;
  *p = {hpg, nt};
  return cudaSuccess;
}
static_assert(proj_smem_bytes<128>(128, 1) <= ssmv::kMaxSmemBytes,
              "K12's bf16 form must take one head of 128 a block");
static_assert(proj_smem_bytes_f32<128>(128, 1) <= ssmv::kMaxSmemBytes,
              "K12's f32 form must take one head of 128 a block");

template <typename T, int HD>
cudaError_t plan_and_launch(const void* qkv, const void* wp, const void* bp,
                            void* y, void* part, int B, int N, int H, int d,
                            float scale, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan<T, HD>(B, N, H, d, &p);
  if (err != cudaSuccess) return err;
  switch (p.nt) {
    case 1: return launch_plan<T, HD, 1>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    case 2: return launch_plan<T, HD, 2>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    case 3: return launch_plan<T, HD, 3>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t plan_and_launch(const void* qkv, const void* wp, const void* bp,
                            void* y, void* part, int B, int N, int H, int d,
                            float scale, cudaStream_t s) {
  switch (ssmv::head_instance(d)) {
    case 32: return plan_and_launch<T, 32>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 64: return plan_and_launch<T, 64>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 96: return plan_and_launch<T, 96>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 128: return plan_and_launch<T, 128>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// the head groups of a form at this shape on the current device
template <typename T>
cudaError_t groups(int B, int N, int H, int d, int* G) {
  Plan p;
  cudaError_t err;
  switch (ssmv::head_instance(d)) {
    case 32: err = plan<T, 32>(B, N, H, d, &p); break;
    case 64: err = plan<T, 64>(B, N, H, d, &p); break;
    case 96: err = plan<T, 96>(B, N, H, d, &p); break;
    case 128: err = plan<T, 128>(B, N, H, d, &p); break;
    default: return cudaErrorInvalidValue;
  }
  *G = (H + p.hpg - 1) / p.hpg;
  return err;
}
}  // namespace

// The f32 workspace ssmv_mha_proj_fwd needs, in units of B * N * C floats:
// the number of head groups of the form (bf16: is_bf16 = 1, or f32) at
// this shape (0 where there is one group, which needs none), or -1 where
// the device cannot be read.
extern "C" int ssmv_mha_proj_groups(int B, int N, int H, int head_dim,
                                    int is_bf16) {
  int G = 0;
  const cudaError_t err = is_bf16 ? groups<bf16>(B, N, H, head_dim, &G)
                                  : groups<float>(B, N, H, head_dim, &G);
  if (err != cudaSuccess) return -1;
  return G > 1 ? G : 0;
}

// qkv (B, N, 3C), wp (C, C) of qkv's dtype, bp (C,) f32 -> y (B, N, C) of
// qkv's dtype, bf16 (is_bf16 = 1) or f32; C = H * head_dim <= 1280,
// head_dim <= 128, N <= 1024. All contiguous. part: the f32 workspace of
// ssmv_mha_proj_groups' size, null where that is 0.
extern "C" int ssmv_mha_proj_fwd(const void* qkv, const void* wp,
                                 const void* bp, void* y, void* part, int B,
                                 int N, int H, int head_dim, float scale,
                                 int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || N < 1 || H < 1 || B > 65535 || N > kMaxN ||
      H * head_dim > kMaxC)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? plan_and_launch<bf16>(qkv, wp, bp, y, part, B, N, H,
                                               head_dim, scale, s)
                       : plan_and_launch<float>(qkv, wp, bp, y, part, B, N,
                                                H, head_dim, scale, s));
}
