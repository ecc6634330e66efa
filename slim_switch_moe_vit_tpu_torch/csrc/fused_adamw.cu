// One-pass AdamW + EMA update over every parameter of a model (K7).
//
// Replaces the Pallas kernels slim_switch_moe_vit_tpu/ops/fused_adamw.py
// _kernel (:50) and _kernel_no_ema (:71), reached through _leaf_update
// (:78) and fused_adamw_ema (:129). The math is the JAX kernel's (optax's
// scale_by_adam -> add_decayed_weights -> per-group lr), per element:
//   mu'  = b1*mu + (1-b1)*g              nu' = b2*nu + (1-b2)*g*g
//   u    = (mu'*bc1) / (sqrt(nu'*bc2) + eps)     bc = 1/(1-b^t)
//   u   += wd*p                          (leaves whose wd flag is set)
//   p'   = p - lr*u                      (lr_gate for gate leaves)
//   ema' = d*ema + (1-d)*p'              (when an EMA is kept)
// p, mu, nu and ema are written in place.
//
// What bounds it on the H100: device-memory bytes. Per f32 parameter it
// reads p, g, mu, nu, ema and writes p, mu, nu, ema: 36 bytes for ~15
// FLOP, far below the card's ~20 FLOP per byte in f32. So the design moves
// each byte once, in 16-byte vectors: one launch for the whole model (a
// multi-tensor launch, as the TPU kernel's grid over one leaf becomes a
// table of chunks over every leaf). The TPU kernel's 1024-lane row layout
// and its plain-math fallback for leaves that do not fill whole rows are
// TPU layout rules; this kernel takes every leaf.
//
// The table (built by ops/fused_adamw.py): one row per chunk of at most
// CHUNK elements of one leaf,
// seven int64s: the addresses of the chunk's p, g, mu, nu and ema (0 when
// no EMA is kept), its length, and its flags (bit 0: decay, bit 1: gate
// lr). One block per chunk; each thread takes float4 vectors where all
// five addresses are 16-byte aligned and elements one by one otherwise and
// for the tail.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Chunk {
  long long p, g, mu, nu, ema, n, flags;
};

// 1-b1, 1-b2 and 1-decay are rounded to f32 from their double values, as
// the JAX package's Python-float constants are (1.f - 0.9f is not 0.1f).
struct Hyper {
  float lr_base, lr_gate, bc1, bc2, b1, b2, eps, wd, decay, c1, c2, cd;
};

__device__ __forceinline__ void update(float& p, float g, float& mu, float& nu,
                                       float* ema, float lr, float wd,
                                       const Hyper& h) {
  mu = h.b1 * mu + h.c1 * g;
  nu = h.b2 * nu + h.c2 * (g * g);
  float u = (mu * h.bc1) / (sqrtf(nu * h.bc2) + h.eps);
  if (wd != 0.f) u = u + wd * p;
  p = p - lr * u;
  if (ema) *ema = h.decay * *ema + h.cd * p;
}

__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const Chunk* __restrict__ table, Hyper h) {
  const Chunk c = table[blockIdx.x];
  float* p = reinterpret_cast<float*>(c.p);
  const float* g = reinterpret_cast<const float*>(c.g);
  float* mu = reinterpret_cast<float*>(c.mu);
  float* nu = reinterpret_cast<float*>(c.nu);
  float* ema = reinterpret_cast<float*>(c.ema);
  const long long n = c.n;
  const float lr = (c.flags & 2) ? h.lr_gate : h.lr_base;
  const float wd = (c.flags & 1) ? h.wd : 0.f;
  const bool aligned = ((c.p | c.g | c.mu | c.nu | c.ema) & 15) == 0;
  long long done = 0;
  if (aligned) {
    const long long n4 = n / 4;
    for (long long i = threadIdx.x; i < n4; i += kThreads) {
      float4 pv = reinterpret_cast<float4*>(p)[i];
      const float4 gv = reinterpret_cast<const float4*>(g)[i];
      float4 mv = reinterpret_cast<float4*>(mu)[i];
      float4 vv = reinterpret_cast<float4*>(nu)[i];
      if (ema) {
        float4 ev = reinterpret_cast<float4*>(ema)[i];
        update(pv.x, gv.x, mv.x, vv.x, &ev.x, lr, wd, h);
        update(pv.y, gv.y, mv.y, vv.y, &ev.y, lr, wd, h);
        update(pv.z, gv.z, mv.z, vv.z, &ev.z, lr, wd, h);
        update(pv.w, gv.w, mv.w, vv.w, &ev.w, lr, wd, h);
        reinterpret_cast<float4*>(ema)[i] = ev;
      } else {
        update(pv.x, gv.x, mv.x, vv.x, nullptr, lr, wd, h);
        update(pv.y, gv.y, mv.y, vv.y, nullptr, lr, wd, h);
        update(pv.z, gv.z, mv.z, vv.z, nullptr, lr, wd, h);
        update(pv.w, gv.w, mv.w, vv.w, nullptr, lr, wd, h);
      }
      reinterpret_cast<float4*>(p)[i] = pv;
      reinterpret_cast<float4*>(mu)[i] = mv;
      reinterpret_cast<float4*>(nu)[i] = vv;
    }
    done = n4 * 4;
  }
  for (long long i = done + threadIdx.x; i < n; i += kThreads) {
    float pv = p[i], mv = mu[i], vv = nu[i];
    update(pv, g[i], mv, vv, ema ? ema + i : nullptr, lr, wd, h);
    p[i] = pv;
    mu[i] = mv;
    nu[i] = vv;
  }
}

}  // namespace

// table: n_chunks rows of seven int64s on the device (see above). The
// hyperparameters come by value; bc1 = 1/(1-b1^t), bc2 = 1/(1-b2^t), and
// one_m_* are 1-b1, 1-b2 and 1-ema_decay in double.
extern "C" int ssmv_fused_adamw(const void* table, int n_chunks, float lr_base,
                                float lr_gate, float bc1, float bc2, float b1,
                                float b2, float eps, float weight_decay,
                                float ema_decay, double one_m_b1,
                                double one_m_b2, double one_m_decay,
                                void* stream) {
  if (n_chunks < 1) return (int)cudaErrorInvalidValue;
  const Hyper h{lr_base, lr_gate, bc1, bc2, b1, b2, eps, weight_decay,
                ema_decay, (float)one_m_b1, (float)one_m_b2,
                (float)one_m_decay};
  fused_adamw_kernel<<<n_chunks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Chunk*>(table), h);
  return (int)cudaGetLastError();
}
