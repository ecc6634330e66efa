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
// The f32 form keeps the SIMT design of mha_simt.cuh (exact f32 FMAs: the
// tensor cores have no exact f32 product): one block per (query tile,
// sample) loops over the heads; each head's exact softmax over its score
// row in shared memory (q scaled in f32 first, as the JAX kernel), o_h
// added times Wp[h] into an f32 (rows x C) accumulator in registers: thread
// (warp, lane) owns rows warp + 8 i and columns lane + 32 j. The query tile
// is 64 rows for C <= 320, 32 for C <= 640 and 16 above (up to C = 1280),
// smaller wherever its score tile does not fit in shared memory; Wp is
// read through the cache.
#include "attn_mma.cuh"
#include "mha_simt.cuh"

namespace {

namespace sm = ssmv::simt;

constexpr int kMaxN = 1024;
constexpr int kMaxC = 1280;
constexpr int kYCols = 640;  // QT * NJ: y rows a thread (QT / 8) x NJ = 80

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

// y = the groups' partials summed in group order, + bp, rounded once
__global__ void mha_proj_reduce_kernel(const float* __restrict__ part,
                                       const float* __restrict__ bp,
                                       bf16* __restrict__ y, size_t M, int C,
                                       int G) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < M;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int g = 1; g < G; ++g) v += part[(size_t)g * M + i];
    y[i] = __float2bfloat16(v + bp[i % C]);
  }
}

constexpr int kMaxTeams = 3;

// How a shape is cut: heads a block (hpg) and teams a block (nt).
struct Plan {
  int hpg, nt;
};

template <int HD, int NT>
cudaError_t launch_plan(const void* qkv, const void* wp, const void* bp,
                        void* y, void* part, int B, int N, int H, int d,
                        int hpg, float scale, cudaStream_t s) {
  const int G = (H + hpg - 1) / hpg;
  if ((G > 1) != (part != nullptr)) return cudaErrorInvalidValue;
  const size_t smem = proj_smem_bytes<HD>(hpg * d, NT);
  if (smem > ssmv::kMaxSmemBytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mha_proj_bf16_kernel<HD, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mha_proj_bf16_kernel<HD, NT><<<dim3((N + kT - 1) / kT, G, B),
                                 NT * at::kThreads, smem, s>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(wp),
      static_cast<const float*>(bp), static_cast<bf16*>(y),
      static_cast<float*>(part), N, H, d, hpg, scale, int(d % 8 == 0));
  if (G == 1) return cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t M = (size_t)B * N * H * d;
  const int blocks = (int)((M + 255) / 256 < 4096 ? (M + 255) / 256 : 4096);
  mha_proj_reduce_kernel<<<blocks, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(bp),
      static_cast<bf16*>(y), M, H * d, G);
  return cudaGetLastError();
}

// hpg: the most heads a block (so the fewest groups and the least
// workspace) that still give every SM a block and whose o tile fits in
// shared memory beside one team; nt: the most teams, up to 3 and one a
// head, that fit beside it.
template <int HD>
cudaError_t plan(int B, int N, int H, int d, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long tiles = (long)((N + kT - 1) / kT) * B;
  int hpg = 1;
  for (int h = H; h > 1; --h)
    if (tiles * ((H + h - 1) / h) >= sms &&
        proj_smem_bytes<HD>(h * d, 1) <= ssmv::kMaxSmemBytes) {
      hpg = h;
      break;
    }
  int nt = 1;
  while (nt < kMaxTeams && nt < hpg &&
         proj_smem_bytes<HD>(hpg * d, nt + 1) <= ssmv::kMaxSmemBytes)
    ++nt;
  *p = {hpg, nt};
  return cudaSuccess;
}
static_assert(proj_smem_bytes<128>(128, 1) <= ssmv::kMaxSmemBytes,
              "K12's bf16 form must take one head of 128 a block");

template <int HD>
cudaError_t plan_and_launch(const void* qkv, const void* wp, const void* bp,
                            void* y, void* part, int B, int N, int H, int d,
                            float scale, cudaStream_t s) {
  Plan p;
  const cudaError_t err = plan<HD>(B, N, H, d, &p);
  if (err != cudaSuccess) return err;
  switch (p.nt) {
    case 1: return launch_plan<HD, 1>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    case 2: return launch_plan<HD, 2>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    case 3: return launch_plan<HD, 3>(qkv, wp, bp, y, part, B, N, H, d, p.hpg, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// the head groups of the bf16 form at this shape on the current device
template <int HD>
cudaError_t groups(int B, int N, int H, int d, int* G) {
  Plan p;
  const cudaError_t err = plan<HD>(B, N, H, d, &p);
  *G = (H + p.hpg - 1) / p.hpg;
  return err;
}

// ---------------------------------------------------------------------------
// f32: the SIMT form
// ---------------------------------------------------------------------------

template <typename T, int HD, int QT>
__global__ void __launch_bounds__(sm::kThreads, 1)
mha_proj_fwd_kernel(const T* __restrict__ qkv, const T* __restrict__ wp,
                    const float* __restrict__ bp, T* __restrict__ y, int N,
                    int NP, int H, int d, float scale) {
  constexpr int RPT = QT / 16, CJ = HD / 16;  // o rows and columns a thread
  constexpr int YR = QT / 8;                  // y rows a thread
  constexpr int NJ = kYCols / QT;             // y column groups, at most
  constexpr int QLD = sm::q_ld(HD);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const sm::Smem<T> L = sm::carve<T>(smem_raw, QT, HD, NP);
  const int C = H * d;
  const size_t C3 = 3 * (size_t)C;
  const int nj = (C + 31) / 32;
  const int q0 = blockIdx.x * QT, b = blockIdx.y;
  const T* base = qkv + (size_t)b * N * C3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = tid >> 4, cl = tid & 15;

  float yacc[YR][NJ];
#pragma unroll
  for (int i = 0; i < YR; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) yacc[i][j] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the last head's readers of Qs (o_h) are done
    float o[RPT][CJ];
    sm::head_attention<T, HD, QT>(base + (size_t)h * d, C3, C, N, NP, q0, d,
                                  scale, L, o);
    // o_h rounded to T, into Qs (no thread reads q after the score pass)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = rg * RPT + i;
      const float li = L.linv[r];
#pragma unroll
      for (int j = 0; j < CJ; ++j)
        L.Qs[r * QLD + cl + 16 * j] = ssmv::to_f32(ssmv::from_f32<T>(o[i][j] * li));
    }
    __syncthreads();

    // y += o_h . Wp[h]
    const T* wph = wp + (size_t)h * d * C;
    for (int k = 0; k < d; ++k) {
      float ov[YR];
#pragma unroll
      for (int i = 0; i < YR; ++i) ov[i] = L.Qs[(warp + 8 * i) * QLD + k];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) {
          const float wv = ssmv::to_f32(wph[(size_t)k * C + c]);
#pragma unroll
          for (int i = 0; i < YR; ++i) yacc[i][j] = fmaf(ov[i], wv, yacc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < YR; ++i) {
    const int n = q0 + warp + 8 * i;
    if (n < N) {
      T* yrow = y + ((size_t)b * N + n) * C;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = lane + 32 * j;
        if (j < nj && c < C) yrow[c] = ssmv::from_f32<T>(yacc[i][j] + bp[c]);
      }
    }
  }
}

template <typename T, int HD, int QT>
cudaError_t launch(const void* qkv, const void* wp, const void* bp, void* y,
                   int B, int N, int NP, int H, int d, float scale,
                   cudaStream_t stream) {
  const size_t smem = sm::smem_bytes(QT, HD, NP, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      mha_proj_fwd_kernel<T, HD, QT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  mha_proj_fwd_kernel<T, HD, QT><<<dim3((N + QT - 1) / QT, B), sm::kThreads,
                                   smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(wp),
      static_cast<const float*>(bp), static_cast<T*>(y), N, NP, H, d, scale);
  return cudaGetLastError();
}
static_assert(sm::smem_bytes(16, 128, kMaxN, 4) <= ssmv::kMaxSmemBytes,
              "K12 must take N = 1024 at head_dim 128 in f32");

// the largest query tile whose y accumulator holds C columns (QT / 8 rows x
// kYCols / QT groups of 32 a thread) and whose score tile fits
template <typename T, int HD>
cudaError_t dispatch(const void* qkv, const void* wp, const void* bp, void* y,
                     int B, int N, int H, int d, float scale, cudaStream_t s) {
  const int NP = (N + 15) / 16 * 16, C = H * d;
  auto fits = [&](int qt) {
    return C <= kYCols / qt * 32 &&
           sm::smem_bytes(qt, HD, NP, sizeof(T)) <= ssmv::kMaxSmemBytes;
  };
  if (fits(64)) return launch<T, HD, 64>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
  if (fits(32)) return launch<T, HD, 32>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
  return launch<T, HD, 16>(qkv, wp, bp, y, B, N, NP, H, d, scale, s);
}

template <typename T>
cudaError_t dispatch(const void* qkv, const void* wp, const void* bp, void* y,
                     int B, int N, int H, int d, float scale, cudaStream_t s) {
  switch (ssmv::head_instance(d)) {
    case 32: return dispatch<T, 32>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 64: return dispatch<T, 64>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 96: return dispatch<T, 96>(qkv, wp, bp, y, B, N, H, d, scale, s);
    case 128: return dispatch<T, 128>(qkv, wp, bp, y, B, N, H, d, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The f32 workspace ssmv_mha_proj_fwd needs, in units of B * N * C floats:
// the number of head groups of the bf16 form (0 where there is one group,
// or in f32, which needs none), or -1 where the device cannot be read.
extern "C" int ssmv_mha_proj_groups(int B, int N, int H, int head_dim,
                                    int is_bf16) {
  if (!is_bf16) return 0;
  int G = 0;
  cudaError_t err;
  switch (ssmv::head_instance(head_dim)) {
    case 32: err = groups<32>(B, N, H, head_dim, &G); break;
    case 64: err = groups<64>(B, N, H, head_dim, &G); break;
    case 96: err = groups<96>(B, N, H, head_dim, &G); break;
    case 128: err = groups<128>(B, N, H, head_dim, &G); break;
    default: return -1;
  }
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
  if (!is_bf16)
    return part ? (int)cudaErrorInvalidValue
                : (int)dispatch<float>(qkv, wp, bp, y, B, N, H, head_dim,
                                       scale, s);
  const int d = head_dim;
  switch (ssmv::head_instance(d)) {
    case 32: return (int)plan_and_launch<32>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 64: return (int)plan_and_launch<64>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 96: return (int)plan_and_launch<96>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    case 128: return (int)plan_and_launch<128>(qkv, wp, bp, y, part, B, N, H, d, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
