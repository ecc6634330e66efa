"""Probe the split-TF32 f32 forms of the attention kernels on the card:
the backward (K6), the forward (K5 and K11, one kernel) and the forward
with the projection folded in (K12).

Builds ``csrc/mha_bwd.cu``, ``csrc/flash_fwd.cu``, ``csrc/mha_fwd.cu`` and
``csrc/mha_proj_fwd.cu`` of this checkout as ``this`` and as the variants
named on the command line, each a copy of ``csrc/`` with the text edits of
``VARIANTS`` (the forms the sources were measured against; the sources
themselves keep one path), and, with ``--tree DIR``, the same sources of
another checkout (say the parent commit, unpacked by ``git archive``) as
``tree``; every nvcc process at once. Prints each build's registers and
spills (``-Xptxas -v``) and its time at the f32 shapes ``chip_smoke.py``
holds them to, beside the plain version and the library call (SDPA
forward, or its backward through autograd; SDPA + ``F.linear`` for K12):
K6 at the flagship's heads (6 x 64) at N = 197, B = 32 and N = 577, B = 4,
K5 at the same two, K11 at N = 197, B = 32, K6 and K11 at vit_huge's heads
(16 x 80, N = 257, B = 8), and K12 at ViT-S eval (B = 128, N = 197, 6
heads of 64) and at N = 577, C = 1024, B = 2. Every build is first held
to the plain version within ``chip_smoke.F32_TOL`` and its mean |d| from
the function in f64 printed beside the plain version's; K6's rows and
cols kernels are then timed apart from one profiled call, and K12's
kernel and its second kernel (the head groups' sum) likewise. Usage, from
the repository root on a machine with one GPU:

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
          ("fused_mha", 32, 197, 6, 64), ("fused_mha", 4, 577, 6, 64),
          ("flash_attention", 32, 197, 6, 64),
          ("fused_mha_bwd", 8, 257, 16, 80),
          ("flash_attention", 8, 257, 16, 80),
          ("fused_mha_proj", 128, 197, 6, 64),
          ("fused_mha_proj", 2, 577, 16, 64)]
SOURCES = ("mha_bwd.cu", "flash_fwd.cu", "mha_fwd.cu", "mha_proj_fwd.cu")
# the f32 kernels' names, this tree's and the parent's (its SIMT K12 is
# mha_proj_fwd_kernel<float, ...>)
F32_KERNELS = (r"(fwd_f32_kernel|flash_fwd_f32_kernel|mha_fwd_f32_kernel|"
               r"mha_bwd_\w+?_f32|mha_proj_f32_kernel|mha_proj_fwd_kernel)")
ENTRIES = ("ssmv_mha_bwd", "ssmv_flash_fwd", "ssmv_mha_fwd",
           "ssmv_mha_proj_fwd", "ssmv_mha_proj_groups")
_SPLIT = ("  hi = __float_as_uint(x) & 0xffffe000u;\n"
          "  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & "
          "0xffffe000u;\n")
_RNA = ("  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo) : "
        "\"f\"(x - __uint_as_float(hi)));\n")
# the f32 head body (head_fwd_f32) with the exact row max first, as the JAX
# K5 kernel (attention.py:195): a pass over the K tiles for the row
# maxima, then the K and V tiles again for e = exp(S - m) and e . V
_EXACT = [
    ("attn_mma.cuh",
     """    if (t < nkt) {
      const int st = t % NST;
      load_rows_f32<HD>(Ks + st * kT * LD, base + C, C3, t * kT, N, d, vec,
                        tid);
      load_rows_f32<HD>(Vs + st * kT * LD, base + 2 * C, C3, t * kT, N, d,
                        vec, tid);
    }""",
     """    if (t < 2 * nkt) {
      const int st = t % NST, kt = t < nkt ? t : t - nkt;
      load_rows_f32<HD>(Ks + st * kT * LD, base + C, C3, kt * kT, N, d, vec,
                        tid);
      if (t >= nkt)
        load_rows_f32<HD>(Vs + st * kT * LD, base + 2 * C, C3, kt * kT, N,
                          d, vec, tid);
    }"""),
    ("attn_mma.cuh",
     "  for (int t = 0; t < nkt; ++t) {\n    cp_async_wait<NST - 2>();  "
     "// tile t (and q) landed, for this thread\n    sync(); ",
     "  for (int t = 0; t < 2 * nkt; ++t) {\n    cp_async_wait<NST - 2>();  "
     "// tile t (and q) landed, for this thread\n    sync(); "),
    ("attn_mma.cuh",
     "    const int k0 = t * kT;\n    const float* Kt",
     "    const bool pass2 = t >= nkt;\n"
     "    const int k0 = (pass2 ? t - nkt : t) * kT;\n    const float* Kt"),
    ("attn_mma.cuh",
     """    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mt[i]));  // finite: k0 < N
      alpha[i] = expf(m[i] - m_new);                     // 0 on the first tile
      m[i] = m_new;
    }""",
     """    if (!pass2) {
      m[0] = fmaxf(m[0], quad_max(mt[0]));
      m[1] = fmaxf(m[1], quad_max(mt[1]));
      continue;
    }
    const float alpha[2] = {1.f, 1.f};"""),
]
# variant: [(file in csrc/, text, its replacement)]
VARIANTS = {
    # both TF32 parts rounded to nearest
    "rna": [("mma_tf32.cuh", _SPLIT, _RNA)],
    # K6 sweeps groups of 4 n-tiles, the f32 head body groups of 8
    "k6g4": [("mha_bwd.cu", "constexpr int kF32Group = 8;",
              "constexpr int kF32Group = 4;")],
    "k11g8": [("attn_mma.cuh", "constexpr int kF32Group = 4;",
               "constexpr int kF32Group = 8;")],
    # the cols kernel's query step at HD <= 64
    "qc32": [("mha_bwd.cu", "QC = HD <= 64 ? 64 :", "QC = HD <= 64 ? 32 :")],
    # K5's (and K11's, K12's) f32 body with the exact row max first
    "exact": _EXACT,
    # K12's f32 plan sizes its head groups for one team (ViT-S: groups of
    # 6 heads, 1 team), not two (groups of 3, 2 teams)
    "teams1": [("mha_proj_fwd.cu",
                "kPlanTeams = std::is_same_v<T, float> ? 2 : 1;",
                "kPlanTeams = std::is_same_v<T, float> ? 1 : 1;")],
    # K12 takes at most 2 heads a block (ViT-S: groups of 2 heads in 2
    # teams, one head each)
    "hpg2": [("mha_proj_fwd.cu", "    for (int h = H; h > 1; --h)\n",
              "    for (int h = H < 2 ? H : 2; h > 1; --h)\n")],
    # K12's projection sweeps groups of 4 n-tiles, not 8
    "pg4": [("mha_proj_fwd.cu", "constexpr int kProjGroup = 8;",
             "constexpr int kProjGroup = 4;")],
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
    """(the build's library with ``ENTRIES`` bound, its ptxas report of
    the f32 kernels)."""
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
        kern = m and re.search(r"\d" + F32_KERNELS + r"I(f?)((?:Li\d+E)+)",
                               m.group(1))
        if kern and (kern.group(1) != "mha_proj_fwd_kernel"
                     or kern.group(2) == "f"):
            args = ",".join(re.findall(r"Li([0-9]+)E", kern.group(3)))
            stats = " ".join(ln.split(":")[-1].strip() if "info" in ln
                             else ln.strip() for ln in lines[i + 2:i + 4])
            report.append(f"{kern.group(1)}<{args}> {stats}")
    return _build.bind(ctypes.CDLL(so), ENTRIES), report


def call(lib, name, qkv, do, H, d, wp=None, bp=None):
    B, N, C3 = qkv.shape
    stream = torch.cuda.current_stream().cuda_stream
    if name in ("flash_attention", "fused_mha"):
        out = torch.empty(B, N, C3 // 3, device="cuda")
        fn = lib.ssmv_flash_fwd if name == "flash_attention" else \
            lib.ssmv_mha_fwd
        err = fn(qkv.data_ptr(), out.data_ptr(), B, N, H, d, d ** -0.5, 0,
                 stream)
    elif name == "fused_mha_proj":
        out = torch.empty(B, N, C3 // 3, device="cuda")
        groups = lib.ssmv_mha_proj_groups(B, N, H, d, 0)
        part = (torch.empty(groups * B * N * C3 // 3, device="cuda")
                if groups > 0 else None)
        err = lib.ssmv_mha_proj_fwd(
            qkv.data_ptr(), wp.data_ptr(), bp.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), B, N, H, d, d ** -0.5,
            0, stream)
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
    # the kernels a profiled call splits into, by a part of their names
    parts = {"fused_mha_bwd": ("rows", "cols"),
             "fused_mha_proj": ("f32_kernel", "reduce")}
    for name, B, N, H, d in SHAPES:
        C = H * d
        qkv = torch.randn(B, N, 3 * C, generator=gen).cuda()
        do = torch.randn(B, N, C, generator=gen).cuda()
        wp = (torch.randn(C, C, generator=gen) * C ** -0.5).cuda()
        bp = (torch.randn(C, generator=gen) * 0.1).cuda()
        if name == "fused_mha_proj":
            kernel, plain, library, cost, _ = smoke._proj_calls(qkv, wp, bp,
                                                                H)
            exact = smoke.f64_proj(qkv, wp, bp, H)
        else:
            kernel, plain, library, cost = smoke._mha_calls(
                name, qkv, do, H, d, smoke.F32_FLOPS)
            exact = smoke.f64_attention(name, qkv, do, H, d)
        want = plain()
        bound_ms, by = smoke.bound(*cost)
        head = (f"{name} B={B} N={N} {H}x{d}: plain "
                f"{smoke.median_ms(plain, reps=3):.4f} ms, library "
                f"{smoke.median_ms(library):.4f} ms, bound {bound_ms:.4f} ms "
                f"({by})")
        print(head, flush=True)
        for v, lib in libs.items():
            def fn(lib=lib):
                return call(lib, name, qkv, do, H, d, wp, bp)

            got = fn()
            err = smoke.compare(name, got, want, ("elem",), smoke.F32_TOL)[0]
            e64 = smoke.f64_error(f"{v} {name}", got, want, exact)[0]
            ms = smoke.median_ms(fn)
            split = ""
            if name in parts:
                prof = smoke.profile_call(lambda: [fn() for _ in range(10)],
                                          f"{v} {name} N={N}, 10 calls")
                ms_of = {k: sum(us for kn, (us, _) in prof.items()
                                if k in kn) / 10e3 for k in parts[name]}
                split = " (" + " + ".join(f"{k} {v:.4f}"
                                          for k, v in ms_of.items()) + ")"
            print(f"  {v:8s} {ms:.4f} ms{split}, {bound_ms / ms:.3f} of the "
                  f"bound, max |d| {err:.2e}, mean |d| from f64 {e64:.3e}",
                  flush=True)

if __name__ == "__main__":
    main()
