"""Time tilings of the bf16 expert-FFN forward (K3, and K9's and K10's
forward forms) on the card against its plain version.

Builds ``csrc/expert_ffn_fwd.cu`` once more with one extra C entry point
per entry of ``TILINGS`` (the ``Tiling`` template's arguments and a probe
that takes parts out, 0 for none; probes are timed only), and times each on
the
flagship's dropless layout at B = 128 (D = 384, H = 1536, 8 experts), at
D = 192 (H = 768) on the same tokens, and on
moe_base_patch16_224_expert32's layout at B = 32 (D = 768, H = 3072, 32
experts), with its max |d| from the plain version and its mean |d| from
the exact f32 function over the plain version's. A dense cuBLAS
yardstick (two ``torch.matmul`` and ``F.gelu`` with one expert's weights
on the same rows) is printed beside each width. ``--floors`` first times
``scripts/card_floors.cu``: the ``mma.sync`` rate and the L2 -> shared
memory rate of ``cp.async`` streaming. Usage, on a machine with one GPU:

    python3 scripts/ffn_fwd_tilings.py [--floors] [name ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import _build  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import moe  # noqa: E402

# name: (Tiling<D, BM, HC, K1, KS2, NS1, NS2, HWM, YWM, CL>, probe: the
# sum of 1 (no y products), 2 (no h products), 4 (no weight copies) and 8
# (GELU as the identity))
TILINGS = {
    "v384_cl1": ("384, 64, 128, 64, 32, 3, 3, 2, 1, 1", 0),
    "v384_cl2": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 0),
    "v384_cl2_ns22": ("384, 128, 128, 64, 32, 2, 2, 2, 2, 2", 0),
    "v384_cl2_hc64": ("384, 128, 64, 64, 32, 4, 4, 4, 2, 2", 0),
    "v384_cl2_noy": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 1),
    "v384_cl2_noh": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 2),
    "v384_cl2_nocopy": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 4),
    "v384_cl2_nogelu": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 8),
    "v384_cl2_noy_nogelu": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 9),
    "v384_cl2_nomma": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 3),
    "v384_cl2_nomma_nogelu": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 11),
    "v384_cl2_ldsm_only": ("384, 128, 128, 64, 32, 3, 2, 2, 2, 2", 15),
    "v192_cl1": ("192, 64, 128, 64, 32, 3, 3, 2, 2, 1", 0),
    "v192_cl2": ("192, 128, 128, 64, 64, 2, 2, 2, 4, 2", 0),
    "v768_cl1": ("768, 32, 256, 32, 16, 3, 3, 1, 1, 1", 0),
    "v768_cl2": ("768, 64, 256, 32, 16, 3, 3, 2, 1, 2", 0),
    "v768_cl2_ns23": ("768, 64, 256, 32, 16, 2, 3, 2, 1, 2", 0),
    "v768_cl2_k1_16": ("768, 64, 256, 16, 16, 6, 3, 2, 1, 2", 0),
    "v768_cl2_hc192": ("768, 64, 192, 32, 16, 5, 3, 2, 1, 2", 0),
    "v768_cl2_hc192b": ("768, 64, 192, 32, 16, 4, 4, 2, 1, 2", 0),
    "v384_cl2_hc96": ("384, 128, 96, 64, 32, 4, 3, 4, 2, 2", 0),
}
CSRC = os.path.join(ROOT, "slim_switch_moe_vit_tpu_torch", "csrc")
OUT = os.path.join(_build.BUILD_ROOT, "tilings")


def _source() -> str:
    """The kernel source with a probe template argument and the entry
    points of TILINGS."""
    src = open(os.path.join(CSRC, "expert_ffn_fwd.cu")).read()
    src = src[:src.index('extern "C"')]

    def sub(a, b):
        nonlocal src
        if src.count(a) != 1:
            raise RuntimeError(f"the kernel source changed: {a!r}")
        src = src.replace(a, b)
    sub("template <class L, bool kGather>\n__device__ __forceinline__ "
        "void h_group(", "template <class L, bool kGather, int kProbe>\n"
        "__device__ __forceinline__ void h_group(")
    sub("template <class L>\n__device__ __forceinline__ void y_group(",
        "template <class L, int kProbe>\n__device__ __forceinline__ void "
        "y_group(")
    sub("h_group<L, kGather>(", "h_group<L, kGather, kProbe>(")
    sub("y_group<L>(", "y_group<L, kProbe>(")
    sub("template <class L, bool kGather, bool kPerm>\n__global__",
        "template <class L, bool kGather, bool kPerm, int kProbe>\n__global__")
    sub("template <class L, bool kGather, bool kPerm>\ncudaError_t launch(",
        "template <class L, bool kGather, bool kPerm, int kProbe = 0>\n"
        "cudaError_t launch(")
    sub("expert_ffn_fwd_kernel<L, kGather, kPerm>;",
        "expert_ffn_fwd_kernel<L, kGather, kPerm, kProbe>;")
    for acc, b, bit in (("acc", "b", 2), ("acc", "bb", 1)):
        sub(f"            mma({acc}[i][2 * jj], a[i], {b}[0], {b}[1]);\n"
            f"            mma({acc}[i][2 * jj + 1], a[i], {b}[2], {b}[3]);",
            f"            if (!(kProbe & {bit})) {{\n"
            f"              mma({acc}[i][2 * jj], a[i], {b}[0], {b}[1]);\n"
            f"              mma({acc}[i][2 * jj + 1], a[i], {b}[2], {b}[3]);"
            "\n            }")
    sub("pack2(gelu(acc[i][jn][2 * hh] + bias.x),\n"
        "                                   gelu(acc[i][jn][2 * hh + 1] + "
        "bias.y));",
        "(kProbe & 8) ? pack2(acc[i][jn][2 * hh] + bias.x, acc[i][jn][2 * hh"
        " + 1] + bias.y) : pack2(gelu(acc[i][jn][2 * hh] + bias.x), "
        "gelu(acc[i][jn][2 * hh + 1] + bias.y));")
    for ld in ("W1LD", "W2LD"):
        sub(f"cp_async16(st + k * {ld} + n,",
            f"if (!(kProbe & 4)) cp_async16(st + k * {ld} + n,")
    out = [src]
    for name, (args, probe) in TILINGS.items():
        out.append(f'''
extern "C" int {name}(const void* xs, const void* gidx, const void* perm,
                      const void* w1, const void* b1, const void* w2,
                      const void* b2, const void* eot, void* y, int Tp,
                      int H, int mode, void* stream) {{
  using L = Tiling<{args}>;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    return launch<L, true, false, {probe}>(xs, gidx, perm, w1, b1, w2, b2,
                                          eot, y, Tp, H, 256, s);
  if (mode == 2)
    return launch<L, false, true, {probe}>(xs, gidx, perm, w1, b1, w2, b2,
                                          eot, y, Tp, H, 256, s);
  return launch<L, false, false, {probe}>(xs, gidx, perm, w1, b1, w2, b2,
                                         eot, y, Tp, H, 256, s);
}}''')
    return "\n".join(out) + "\n"


def _nvcc(src: str, name: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"lib{name}.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-shared", "-o",
           so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    with open(os.path.join(OUT, f"{name}.ptxas.log"), "w") as f:
        f.write(log)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    for line in log.splitlines():  # registers and spills of each instance
        if "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip())
    return ctypes.CDLL(so)


def floors() -> None:
    lib = _nvcc(os.path.join(ROOT, "scripts", "card_floors.cu"), "floors")
    out = torch.zeros(1024, device="cuda")
    P = ctypes.c_void_p

    def stream():
        return P(torch.cuda.current_stream().cuda_stream)
    iters = 4096
    ms = smoke.median_ms(lambda: lib.run_mb_mma(P(out.data_ptr()), 264,
                                                iters, stream()), reps=5)
    print(f"mma.sync m16n8k16 on registers: "
          f"{264 * 8 * iters * 16 * 4096 / ms / 1e9:.1f} TFLOP/s")
    per_block = 2 * 384 * 1536 * 2  # one expert's W1 and W2 at ViT-S
    src = torch.empty(8 * per_block, dtype=torch.uint8, device="cuda")
    for stage in (16384, 24576, 49152):
        n = per_block - per_block % stage
        ms = smoke.median_ms(lambda: lib.run_mb_l2(
            P(src.data_ptr()), ctypes.c_longlong(n), 8, stage, 820,
            P(out.data_ptr()), stream()), reps=5)
        print(f"L2 -> shared cp.async, {stage}-byte stages, 820 blocks of "
              f"{n / 1e6:.2f} MB: {820 * n / ms / 1e9:.2f} TB/s "
              f"({ms:.4f} ms)")


def layout(T, D, H, E, gen):
    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)
    x = rnd(T, D)
    router_w = rnd(D, E, std=D ** -0.5, dtype=torch.float32)
    gate_w, eidx = moe.naive_topk_gate(x.float() @ router_w, 2)
    gidx, pslot, eot, _, _ = moe.aligned_expert_layout(eidx, E,
                                                       gate_w=gate_w)
    w = (rnd(E, D, H, std=D ** -0.5), rnd(E, H, std=0.1, dtype=torch.float32),
         rnd(E, H, D, std=H ** -0.5), rnd(E, D, std=0.1, dtype=torch.float32))
    return x, gidx, moe.dispatch_gather(x, gidx, pslot), w, eot


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="tilings to time (default all)")
    ap.add_argument("--floors", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    print(smoke.card_line(), flush=True)
    if args.floors:
        floors()
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "ffn_fwd_tilings.cu")
    with open(src, "w") as f:
        f.write(_source())
    lib = _nvcc(src, "ffn_fwd_tilings")
    gen = torch.Generator().manual_seed(0)
    T = 128 * smoke.N_TOK
    for D, H, E, n_tok in ((384, 1536, 8, T), (192, 768, 8, T),
                           (768, 3072, 32, 32 * smoke.N_TOK)):
        names = [n for n in TILINGS if n.startswith(f"v{D}_")
                 and (not args.names or n in args.names)]
        if not names:
            continue
        x, gidx, xs, (w1, b1, w2, b2), eot = layout(n_tok, D, H, E, gen)
        Tp = xs.shape[0]
        want = ffn.fused_expert_ffn_reference(xs, w1, b1, w2, b2, eot)
        exact = ffn.fused_expert_ffn_reference(xs.float(), w1.float(), b1,
                                               w2.float(), b2, eot)
        perm = torch.arange(Tp // ffn.TILE_ROWS, dtype=torch.int32,
                            device="cuda").flip(0)
        rows = ffn.permuted_rows(perm)
        xp = torch.empty_like(xs)
        xp[rows] = xs
        bound = 4 * Tp * D * H / smoke.BF16_FLOPS * 1e3
        print(f"D={D} H={H} E={E} Tp={Tp}: bound {bound:.4f} ms", flush=True)
        for name in names:
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 + [
                ctypes.c_void_p]

            def call(mode=0, src=xs, out=None):
                out = torch.empty_like(xs) if out is None else out
                err = fn(src.data_ptr(), gidx.data_ptr(), perm.data_ptr(),
                         w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                         b2.data_ptr(), eot.data_ptr(), out.data_ptr(), Tp, H,
                         mode, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
                return out
            y = call()
            torch.cuda.synchronize()
            if TILINGS[name][1]:
                print(f"  {name} (probe {TILINGS[name][1]}): "
                      f"{smoke.median_ms(lambda: call(out=y)):.4f} ms")
                continue
            err, peak, _ = smoke.compare(name, y, want, ("elem",))
            ratio = ((y.float() - exact).abs().mean()
                     / (want.float() - exact).abs().mean()).item()
            yg, yp = call(1, x), call(2, xp)
            torch.cuda.synchronize()
            smoke.compare(name + " gather", yg, want, ("elem",))
            smoke.compare(name + " perm", yp[rows], want, ("elem",))
            ms = smoke.median_ms(lambda: call(out=y))
            ms_g = smoke.median_ms(lambda: call(1, x, yg))
            ms_p = smoke.median_ms(lambda: call(2, xp, yp))
            print(f"  {name}: max|d| {err:.3e} (max|ref| {peak:.2e}), exact "
                  f"ratio {ratio:.4f}; K3 {ms:.4f} ms ({bound / ms:.1%} of "
                  f"the bound), K9 fwd {ms_g:.4f}, K10 fwd {ms_p:.4f}",
                  flush=True)
        dense = smoke.median_ms(lambda: torch.matmul(
            F.gelu(torch.matmul(xs, w1[0])), w2[0]))
        print(f"  dense cuBLAS yardstick, not the same function: "
              f"{dense:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
