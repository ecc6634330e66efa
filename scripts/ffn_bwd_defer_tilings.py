"""Time tilings of the bf16 deferred-dW expert-FFN backward (K8) on the
card against its plain version.

Builds ``csrc/expert_ffn_bwd_defer.cu`` once more with one extra C entry
point per entry of ``TILINGS`` (the ``Dgrad`` and ``Dw`` templates'
arguments) and times each on the layouts of
``scripts/ffn_bwd_defer_split.py`` of its width: cfg4's and the dropless
B = 128 layout (D = 384), moe_tiny_patch16_224_expert8's at B = 128
(D = 192) and moe_base_patch16_224_expert32's at B = 32 (D = 768). Each
line gives the call's time (CUDA events), its launches apart (profiler)
and the largest max |d| / max |ref| of dx, dW1 and dW2 from the plain
version. Usage, on a machine with one GPU:

    python3 scripts/ffn_bwd_defer_tilings.py [name ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import ffn_bwd_defer_split as split  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import _build  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import moe  # noqa: E402

# name: (D, Dgrad<DC, RS, HC, AN, KS, CL>, Dw<DC, HW, RS, AN, KS, NB, CL>);
# d192, d384 and d768 are the tilings the dispatch takes
TILINGS = {
    "d192": (192, "192, 128, 32, 32, 1, 1", "192, 64, 32, 16, 1, 3, 1"),
    "d384": (384, "384, 64, 32, 32, 2, 1", "384, 32, 32, 16, 2, 2, 1"),
    "d384_g16": (384, "384, 64, 32, 16, 1, 1", "384, 32, 32, 16, 2, 2, 1"),
    "d384_w32k4": (384, "384, 64, 32, 32, 2, 1", "384, 32, 32, 32, 4, 2, 1"),
    "d384_w3": (384, "384, 64, 32, 32, 2, 1", "384, 32, 32, 16, 2, 3, 1"),
    "d384_cl2": (384, "192, 128, 32, 32, 1, 2", "192, 64, 32, 16, 1, 3, 2"),
    "d768": (768, "384, 64, 32, 16, 1, 2", "384, 32, 32, 16, 2, 2, 2"),
}
CSRC = os.path.join(ROOT, "slim_switch_moe_vit_tpu_torch", "csrc")
OUT = os.path.join(_build.BUILD_ROOT, "defer_tilings")


def _source(names) -> str:
    """The kernel source with an entry point for each tiling of names."""
    src = open(os.path.join(CSRC, "expert_ffn_bwd_defer.cu")).read()
    src = src[:src.index('extern "C"')]
    out = [src]
    for name in names:
        _, dg, dw = TILINGS[name]
        out.append(f'''
extern "C" int {name}(const void* xs, const void* dy, const void* w1,
                      const void* b1, const void* w2, const void* eot,
                      void* dxs, void* dw1, void* db1, void* dw2, void* db2,
                      int Tp, int H, int E, void* stream) {{
  return (int)launch_tc<Dgrad<{dg}>, Dw<{dw}>>(
      xs, dy, w1, b1, w2, eot, dxs, dw1, db1, dw2, db2, Tp, H, E, 256,
      static_cast<cudaStream_t>(stream));
}}''')
    return "\n".join(out) + "\n"


def _nvcc(src: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, "libdefer_tilings.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{CSRC}", "-shared", "-o",
           so, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{log[-4000:]}")
    for line in log.splitlines():  # registers and spills of each instance
        if "defer_d" in line or "registers" in line or "spill" in line:
            print("  ptxas: " + line.strip()[:150])
    return ctypes.CDLL(so)


def rel_err(got, want) -> float:
    return max(((a.float() - b.float()).abs().max() / b.float().abs().max())
               .item() for a, b in zip(got, want))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="tilings to time (default all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    names = args.names or list(TILINGS)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card {card}", flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "ffn_bwd_defer_tilings.cu")
    with open(src, "w") as f:
        f.write(_source(names))
    lib = _nvcc(src)
    P = ctypes.c_void_p
    gen = torch.Generator().manual_seed(3)
    for label, x, logits, cap, D, H, E, (w1, b1, w2) in split.layouts(gen):
        gate_w, eidx = moe.naive_topk_gate(logits, 2)
        gidx, pslot, eot, w_slot, keep = moe.aligned_expert_layout(
            eidx, E, gate_w=gate_w, capacity=cap)
        xs = moe.dispatch_gather(x, gidx, pslot, None if cap is None else keep)
        dy = (torch.randn(xs.shape, generator=gen).to("cuda", xs.dtype)
              * w_slot[:, None])
        Tp = xs.shape[0]
        want = ffn.reference_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
        want = (want[0], want[1], want[3])
        k4 = split.event_ms(lambda: ffn.fused_expert_ffn_bwd(
            xs, w1, b1, w2, eot, dy))
        print(f"{label}: Tp={Tp}, D={D}, H={H}, E={E}; K4 {k4:.4f} ms",
              flush=True)
        for name in names:
            width, _, _ = TILINGS[name]
            if width != D:
                continue
            fn = getattr(lib, name)
            fn.argtypes = [P] * 11 + [ctypes.c_int] * 3 + [P]
            out = ffn._bwd_outputs(Tp, D, H, E, xs, w1, w2)

            def call():
                err = fn(*(P(t.data_ptr()) for t in (xs, dy, w1, b1, w2, eot,
                                                     *out)),
                         Tp, H, E, P(torch.cuda.current_stream().cuda_stream))
                _build.check(err, name)
            call()
            torch.cuda.synchronize()
            err = rel_err((out[0], out[1], out[3]), want)
            ms = split.event_ms(call)
            parts = split.kernel_ms(call)
            by = ", ".join(f"{k[k.find('defer_'):][:24]} {v:.4f}"
                           for k, v in sorted(parts.items(),
                                              key=lambda kv: -kv[1])
                           if "defer_" in k)
            print(f"  {name}: {ms:.4f} ms ({ms / k4:.2f}x K4), "
                  f"max|d|/max|ref| {err:.2e}; {by}", flush=True)
            del out
        del xs, dy, want
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
