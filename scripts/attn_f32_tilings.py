"""Probe the split-TF32 f32 forms of the attention backward (K6) and the
flash forward (K11) on the card.

Builds ``csrc/mha_bwd.cu`` and ``csrc/flash_fwd.cu`` of this checkout as
``this`` and as the variants named on the command line, each a copy of
``csrc/`` with the text edits of ``VARIANTS`` (the forms the sources were
measured against; the sources themselves keep one path), and, with
``--tree DIR``, the same two sources of another checkout (say the parent
commit, unpacked by ``git archive``) as ``tree``; every nvcc process at
once. Prints each build's registers and spills (``-Xptxas -v``) and its
time at the f32 shapes ``chip_smoke.py`` holds them to, beside the plain
version and SDPA (forward, or its backward through autograd): K6 at the
flagship's heads (6 x 64) at N = 197, B = 32 and N = 577, B = 4, K11 at
N = 197, B = 32, and both at vit_huge's heads (16 x 80, N = 257, B = 8).
Every build is first held to the plain version within
``chip_smoke.F32_TOL`` and its mean |d| from the function in f64 printed
beside the plain version's; K6's rows and cols kernels are then timed
apart from one profiled call. Usage, from the repository root on a machine
with one GPU:

    python3 scripts/attn_f32_tilings.py [--tree DIR] [variant ...]
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import _build  # noqa: E402

# (kernel, B, N, heads, head_dim)
SHAPES = [("fused_mha_bwd", 32, 197, 6, 64), ("fused_mha_bwd", 4, 577, 6, 64),
          ("flash_attention", 32, 197, 6, 64),
          ("fused_mha_bwd", 8, 257, 16, 80), ("flash_attention", 8, 257, 16, 80)]
SOURCES = ("mha_bwd.cu", "flash_fwd.cu")
_SPLIT = ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
          "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
          "0xffffe000u;\n")
_RNA = ("  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : "
        "\"f\"(x - __uint_as_float(hi)));\n")
# variant: [(file in csrc/, text, its replacement)]
VARIANTS = {
    # both TF32 parts rounded to nearest
    "rna": [("mma_tf32.cuh", _SPLIT, _RNA)],
    # K6 sweeps groups of 4 n-tiles, K11 groups of 8
    "k6g4": [("mha_bwd.cu", "constexpr int kF32Group = 8;",
              "constexpr int kF32Group = 4;")],
    "k11g8": [("flash_fwd.cu", "constexpr int kF32Group = 4;",
               "constexpr int kF32Group = 8;")],
    # the cols kernel's query step at HD <= 64
    "qc32": [("mha_bwd.cu", "QC = HD <= 64 ? 64 :", "QC = HD <= 64 ? 32 :")],
}


def variant_csrc(name: str, edits: list) -> str:
    """A copy of csrc/ with the variant's edits made (each must match)."""
    out = os.path.join(_build.BUILD_ROOT, "attn_f32_tilings", name, "csrc")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out)
    for fname, old, new in edits:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return out


def start_build(name: str, csrc: str) -> tuple:
    """The nvcc processes of one build, started (one per source)."""
    out = os.path.join(_build.BUILD_ROOT, "attn_f32_tilings", name)
    os.makedirs(out, exist_ok=True)
    procs = []
    for src in SOURCES:
        obj = os.path.join(out, src + ".o")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(csrc, src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    return out, procs


def finish_build(out: str, procs: list) -> tuple:
    """(the build's library with ssmv_mha_bwd and ssmv_flash_fwd bound,
    its ptxas report of the f32 kernels)."""
    log = ""
    for _, p in procs:
        text = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed:\n{text[-4000:]}")
        log += text
    so = os.path.join(out, "lib.so")
    subprocess.run([_build._nvcc(), "-shared", "-o", so,
                    *[obj for obj, _ in procs]], check=True)
    lines, report = log.splitlines(), []
    for i, line in enumerate(lines):
        m = re.search(r"entry function '(\S+)'", line)
        if m and "f32" in m.group(1):
            kern = re.search(r"(flash_fwd_f32_kernel|mha_bwd_\w+_f32)ILi(\d+)",
                             m.group(1))
            stats = " ".join(ln.split(":")[-1].strip() if "info" in ln
                             else ln.strip() for ln in lines[i + 2:i + 4])
            report.append(f"{kern.group(1)}<{kern.group(2)}> {stats}"
                          if kern else stats)
    return (_build.bind(ctypes.CDLL(so), ("ssmv_mha_bwd", "ssmv_flash_fwd")),
            report)


def call(lib, name, qkv, do, H, d):
    B, N, C3 = qkv.shape
    stream = torch.cuda.current_stream().cuda_stream
    if name == "flash_attention":
        out = torch.empty(B, N, C3 // 3, device="cuda")
        err = lib.ssmv_flash_fwd(qkv.data_ptr(), out.data_ptr(), B, N, H, d,
                                 d ** -0.5, 0, stream)
    else:
        out = torch.empty_like(qkv)
        stats = torch.empty(B * H * N * 3, device="cuda")
        err = lib.ssmv_mha_bwd(qkv.data_ptr(), do.data_ptr(), out.data_ptr(),
                               stats.data_ptr(), B, N, H, d, d ** -0.5, 0,
                               stream)
    _build.check(err, name)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="another checkout, timed as 'tree'")
    ap.add_argument("variants", nargs="*", choices=list(VARIANTS))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    print(smoke.card_line(), flush=True)
    todo = [("this", _build.CSRC)] + [
        (v, variant_csrc(v, VARIANTS[v])) for v in args.variants]
    if args.tree:
        todo.append(("tree", os.path.join(
            os.path.abspath(args.tree), "slim_switch_moe_vit_tpu_torch",
            "csrc")))
    started = [(v, start_build(v, csrc)) for v, csrc in todo]
    libs = {}
    for v, (out, procs) in started:
        libs[v], report = finish_build(out, procs)
        print(f"{v}: " + "; ".join(report), flush=True)
    gen = torch.Generator().manual_seed(0)
    for name, B, N, H, d in SHAPES:
        qkv = torch.randn(B, N, 3 * H * d, generator=gen).cuda()
        do = torch.randn(B, N, H * d, generator=gen).cuda()
        kernel, plain, library, cost = smoke._mha_calls(name, qkv, do, H, d,
                                                        smoke.F32_FLOPS)
        want = plain()
        exact = smoke.f64_attention(name, qkv, do, H, d)
        bound_ms, by = smoke.bound(*cost)
        head = (f"{name} B={B} N={N} {H}x{d}: plain "
                f"{smoke.median_ms(plain, reps=3):.4f} ms, library "
                f"{smoke.median_ms(library):.4f} ms, bound {bound_ms:.4f} ms "
                f"({by})")
        print(head, flush=True)
        for v, lib in libs.items():
            fn = (lambda lib=lib: call(lib, name, qkv, do, H, d))  # noqa: E731
            got = fn()
            err = smoke.compare(name, got, want, ("elem",), smoke.F32_TOL)[0]
            e64 = smoke.f64_error(f"{v} {name}", got, want, exact)[0]
            ms = smoke.median_ms(fn)
            parts = ""
            if name == "fused_mha_bwd":
                prof = smoke.profile_call(lambda: [fn() for _ in range(10)],
                                          f"{v} {name} N={N}, 10 calls")
                split = {k: sum(us for kn, (us, _) in prof.items() if k in kn)
                         / 10e3 for k in ("rows", "cols")}
                parts = (f" (rows {split['rows']:.4f} + cols "
                         f"{split['cols']:.4f})")
            print(f"  {v:8s} {ms:.4f} ms{parts}, {bound_ms / ms:.3f} of the "
                  f"bound, max |d| {err:.2e}, mean |d| from f64 {e64:.3e}",
                  flush=True)


if __name__ == "__main__":
    main()
