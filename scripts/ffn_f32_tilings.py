"""Probe the f32 forms of the expert-FFN forward (K3, K9's and K10's
forward) and backward (K4, K9's and K10's backward, and K8, the
deferred-dW backward) on the card.

Builds ``csrc/expert_ffn_fwd.cu``, ``csrc/expert_ffn_bwd.cu`` and
``csrc/expert_ffn_bwd_defer.cu`` of this
checkout as ``this`` and as the variants named on the command line, each a
copy of ``csrc/`` with the text edits of ``VARIANTS`` (the tilings the
sources were measured against; the sources themselves keep one), and, with
``--tree DIR``, the same sources of another checkout (say the parent
commit, unpacked by ``git archive``) as ``tree``; every nvcc process at
once. Prints each build's registers and spill bytes a kernel instance
(``-Xptxas -v``), then, at the layouts ``chip_smoke.py`` runs the expert
FFN at (D = 384: the flagship's dropless layout at B = 32; D = 192:
moe_tiny's at B = 128; D = 768: moe_base_patch16_224_expert32's at B =
32), each build's forward and backward in its three forms: held to the
plain version within ``chip_smoke.F32_TOL``, the mean |d| from the f64
function (``chip_smoke.f64_ffn``) beside the plain version's, the median
time (``chip_smoke.median_ms``) beside the split-TF32 bound, and K4's and
K8's launches apart from ten profiled calls (K4: the dh or dgrad kernel,
the grads or wgrad kernel, the split-reduce; K8: the dgrad kernel and the
dW kernel). ``--forms`` picks the forms to time (all by default). A tree
whose K8 entry point still takes the flags (the SIMT form's) is called
with them. Usage, from the repository root on a machine with one GPU:

    python3 scripts/ffn_f32_tilings.py [--tree DIR] [--dims 192,384,768]
        [--forms k4,k8] [variant ...]
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
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import moe  # noqa: E402

SOURCES = ("expert_ffn_fwd.cu", "expert_ffn_bwd.cu",
           "expert_ffn_bwd_defer.cu")
ENTRIES = ("ssmv_expert_ffn_fwd", "ssmv_expert_ffn_fwd_gather",
           "ssmv_expert_ffn_fwd_perm", "ssmv_expert_ffn_bwd",
           "ssmv_expert_ffn_bwd_gather", "ssmv_expert_ffn_bwd_perm",
           "ssmv_expert_ffn_bwd_defer")
FORMS = ("k3", "k9", "k10", "k4", "k9 bwd", "k10 bwd", "k8")
# the f32 kernels' names, this tree's and older trees' SIMT forms
F32_KERNELS = (r"(expert_ffn_fwd_f32_kernel|expert_ffn_dh_f32_kernel|"
               r"expert_ffn_grads_f32_kernel|defer_dgrad_f32_kernel|"
               r"defer_dw_f32_kernel|expert_ffn_fwd_simt|"
               r"expert_ffn_dgrad_simt|expert_ffn_wgrad_simt|"
               r"expert_ffn_dw_defer_simt)")
# K8's entry point with the flags argument (the SIMT form's), beside
# _build's signature of this tree's
_P, _I = ctypes.c_void_p, ctypes.c_int
DEFER_WITH_FLAGS = (_P,) * 12 + (_I,) * 6 + (_P,)
# (D, layout tokens, E, H): the smoke's layouts
LAYOUTS = {384: (32 * smoke.N_TOK, smoke.EXPERTS, smoke.HIDDEN),
           192: (smoke.TINY_B * smoke.N_TOK, smoke.TINY_E, smoke.TINY_H),
           768: (smoke.WIDE_B * smoke.N_TOK, smoke.WIDE_E, smoke.WIDE_H)}


def _tiling(d: int, args: str) -> tuple:
    return ("expert_ffn_fwd.cu", f"using TilingF32_{d} = TilingF32<{d}, ",
            f"using TilingF32_{d} = TilingF32<{args}>;  //")


def _k8(name: str, tiling: str) -> tuple:
    return ("expert_ffn_bwd_defer.cu", f"using {name} = ",
            f"using {name} = {tiling}>;  //")


VARIANTS = {
    # the forward's tilings: TilingF32<D, BM, HC, K1, K2, NS>
    "f192hc128": [_tiling(192, "192, 128, 128, 32, 32, 3")],
    "f384hc64": [_tiling(384, "384, 64, 64, 32, 16, 4")],
    "f384ns3": [_tiling(384, "384, 64, 128, 32, 16, 3")],
    "f384k32": [_tiling(384, "384, 64, 128, 32, 32, 3")],
    "f768hc128": [_tiling(768, "768, 32, 128, 32, 16, 3")],
    "f768k8": [_tiling(768, "768, 32, 256, 32, 8, 4")],
    # every product's sums on the tensor cores across all of k, as the
    # attention kernels take them (mma_group2 in place of mma_group2_rn)
    "tcsum": [("mma_tf32.cuh",
               "  mma_group2<J>(t1, 0, a1, b1, t2, 0, a2, b2);\n",
               "  mma_group2<J>(c1, j1, a1, b1, c2, j2, a2, b2);\n  return;\n")],
    # groups of 4 n-tiles in the forward's and the grads kernel's sweeps
    "fg4": [("expert_ffn_fwd.cu", "constexpr int kGroupF32 = 2;",
             "constexpr int kGroupF32 = 4;")],
    "gg4": [("expert_ffn_bwd.cu", "constexpr int kFGroup = 2;",
             "constexpr int kFGroup = 4;")],
    # and single n-tiles (the fewest registers)
    "fg1": [("expert_ffn_fwd.cu", "constexpr int kGroupF32 = 2;",
             "constexpr int kGroupF32 = 1;")],
    "gg1": [("expert_ffn_bwd.cu", "constexpr int kFGroup = 2;",
             "constexpr int kFGroup = 1;")],
    # the k-steps of a stage not unrolled (fewer fragments in flight, fewer
    # registers): the forward's h and y steps, the grads kernel's
    # the forward's k-steps of a stage unrolled (more fragments in flight,
    # spills at every width)
    "fku": [("expert_ffn_fwd.cu",
             "#pragma unroll 1  // fewer fragments in flight: no spills\n"
             "      for (int kk = 0; kk < L::K1; kk += 8)",
             "#pragma unroll\n      for (int kk = 0; kk < L::K1; kk += 8)"),
            ("expert_ffn_fwd.cu",
             "#pragma unroll 1  // fewer fragments in flight: no spills\n"
             "      for (int kk = 0; kk < L::K2; kk += 8)",
             "#pragma unroll\n      for (int kk = 0; kk < L::K2; kk += 8)")],
    # the grads kernel's k-steps of a stage unrolled, or by 2 (spills under
    # its 128 registers a thread)
    "gku": [("expert_ffn_bwd.cu",
             "#pragma unroll 1  // unrolled, it spills past 128 registers\n"
             "    for (int kk = 0; kk < kFBK; kk += 8) {",
             "#pragma unroll\n    for (int kk = 0; kk < kFBK; kk += 8) {")],
    "gku2": [("expert_ffn_bwd.cu",
              "#pragma unroll 1  // unrolled, it spills past 128 registers\n"
              "    for (int kk = 0; kk < kFBK; kk += 8) {",
              "#pragma unroll 2\n    for (int kk = 0; kk < kFBK; kk += 8) {")],
    # the backward's rings: 4 stages for the dh or the grads kernel
    "dh4": [("expert_ffn_bwd.cu", "constexpr int kFDhStages = 3;",
             "constexpr int kFDhStages = 4;")],
    "g4": [("expert_ffn_bwd.cu", "constexpr int kFGStages = 3;",
            "constexpr int kFGStages = 4;")],
    # K8's dgrad tilings: DgradF32<D, BM, HC, K1, K2, NS>
    "k8g384hc32": [_k8("DgradF32_384", "DgradF32<384, 64, 32, 32, 16, 4")],
    "k8g384bm32": [_k8("DgradF32_384", "DgradF32<384, 32, 64, 32, 16, 4")],
    "k8g384ns3": [_k8("DgradF32_384", "DgradF32<384, 64, 64, 32, 16, 3")],
    "k8g384k2": [_k8("DgradF32_384", "DgradF32<384, 64, 64, 32, 32, 3")],
    "k8g768k8": [_k8("DgradF32_768", "DgradF32<768, 32, 64, 32, 8, 4")],
    "k8g192bm128": [_k8("DgradF32_192",
                        "DgradF32<192, 128, 32, 32, 32, 3")],
    "k8g192hc64": [_k8("DgradF32_192", "DgradF32<192, 128, 64, 32, 32, 3")],
    # K8's dW tilings: DwF32<DC, HW, RS, AN, KS, NB, CL, BMW, BNW, NT>; a
    # cluster of two at D = 384 (192 columns a block, 32-row steps), of
    # four at D = 768; 48 x 32 phase-B warp tiles; phase A in 16 x 8 tiles
    # over half of K (each in 16-warp blocks); 16-warp blocks at each width
    # (96 x 16 phase-B warp tiles at D = 384 and 768, 48 x 16 at 192, 16 x
    # 16 phase-A ones)
    "k8cl2": [_k8("DwF32_384",
                  "DwF32<192, 32, 32, 16, 2, 2, 2, 48, 16, 512")],
    "k8cl4": [_k8("DwF32_768",
                  "DwF32<192, 32, 32, 16, 2, 2, 4, 48, 16, 512")],
    "k8w4832": [_k8("DwF32_384",
                    "DwF32<384, 32, 16, 16, 4, 2, 1, 48, 32, 512")],
    "k8ks2": [_k8("DwF32_384", "DwF32<384, 32, 16, 8, 2, 2, 1, 96, 16, 512")],
    "k8w16": [_k8("DwF32_384",
                  "DwF32<384, 32, 16, 16, 4, 2, 1, 96, 16, 512"),
              _k8("DwF32_768",
                  "DwF32<384, 32, 16, 16, 4, 2, 2, 96, 16, 512"),
              _k8("DwF32_192",
                  "DwF32<192, 32, 32, 16, 2, 2, 1, 48, 16, 512")],
    # the dW kernel's phase A k-steps unrolled by 2, its phase B k-steps
    # unrolled
    "k8pa2": [("expert_ffn_bwd_defer.cu",
               "#pragma unroll 1\n  for (int k = k0; k < k1; k += 8) {",
               "#pragma unroll 2\n  for (int k = k0; k < k1; k += 8) {")],
    "k8pbu": [("expert_ffn_bwd_defer.cu",
               "#pragma unroll 1\n    for (int k = 0; k < RS; k += 8) {",
               "#pragma unroll\n    for (int k = 0; k < RS; k += 8) {")],
    # the dgrad kernel's k-steps unrolled (more fragments in flight)
    "k8gku": [("expert_ffn_bwd_defer.cu",
               "#pragma unroll 1  // fewer fragments in flight: no spills\n"
               "      for (int kk = 0; kk < L::K1; kk += 8) {",
               "#pragma unroll\n"
               "      for (int kk = 0; kk < L::K1; kk += 8) {")],
}


def variant_csrc(name: str, edits: list) -> str:
    """A copy of csrc/ with the variant's edits made (each must match
    once)."""
    out = os.path.join(_build.BUILD_ROOT, "ffn_f32_tilings", name, "csrc")
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


def start_build(name: str, csrc: str, edited=None) -> tuple:
    """The nvcc processes of one build, started (one per source; a variant
    compiles only the sources its edits touch, ``edited``, and links this
    tree's objects of the others)."""
    out = os.path.join(_build.BUILD_ROOT, "ffn_f32_tilings", name)
    this = os.path.join(_build.BUILD_ROOT, "ffn_f32_tilings", "this")
    os.makedirs(out, exist_ok=True)
    procs = []
    for src in SOURCES:
        if edited is not None and src not in edited:
            procs.append((os.path.join(this, src + ".o"), None))
            continue
        obj = os.path.join(out, src + ".o")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", obj,
               os.path.join(csrc, src)]
        procs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)))
    return out, procs


def finish_build(out: str, procs: list, csrc: str) -> tuple:
    """(the build's library with ``ENTRIES`` bound, whether its K8 entry
    point takes the flags, its ptxas report of the f32 kernel instances:
    registers and spill bytes)."""
    log = ""
    for _, p in procs:
        if p is None:  # this tree's object
            continue
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
        kern = m and re.search(r"\d" + F32_KERNELS + r"I(\w*)", m.group(1))
        if kern and ("simt" not in kern.group(1)
                     or kern.group(2).startswith("f")):
            args = ",".join(re.findall(r"Li([0-9]+)E", kern.group(2)))
            bools = "".join("1" if b == "Lb1E" else "0"
                            for b in re.findall(r"Lb[01]E", kern.group(2)))
            stats = " ".join(ln.split(":")[-1].strip() if "info" in ln
                             else ln.strip() for ln in lines[i + 2:i + 4])
            report.append(f"{kern.group(1)}<{args}|{bools}> {stats}")
    lib = _build.bind(ctypes.CDLL(so), ENTRIES)
    with open(os.path.join(csrc, "expert_ffn_bwd_defer.cu")) as f:
        flags = "const void* flags" in f.read()
    if flags:
        lib.ssmv_expert_ffn_bwd_defer.argtypes = list(DEFER_WITH_FLAGS)
    return lib, flags, report


def layout(D: int, gen):
    """The smoke's f32 expert layout at width D: (x, gather_idx, e_of_tile,
    tile_perm, xs, w1, b1, w2, b2, dy)."""
    T, E, H = LAYOUTS[D]

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).cuda()

    x = rnd(T, D)
    gate_w, eidx = moe.naive_topk_gate(x @ rnd(D, E, std=D ** -0.5), 2)
    gidx, pslot, eot, w_slot, _ = moe.aligned_expert_layout(eidx, E,
                                                            gate_w=gate_w)
    xs = moe.dispatch_gather(x, gidx, pslot)
    w1, b1 = rnd(E, D, H, std=D ** -0.5), rnd(E, H, std=0.1)
    w2, b2 = rnd(E, H, D, std=H ** -0.5), rnd(E, D, std=0.1)
    dy = rnd(*xs.shape) * w_slot[:, None]
    perm = torch.arange(eot.shape[0], dtype=torch.int32,
                        device="cuda").flip(0)
    return x, gidx, eot, perm, xs, w1, b1, w2, b2, dy


def calls(lib, flags, x, gidx, eot, perm, xs, w1, b1, w2, b2, dy) -> dict:
    """{form: call} of a build's seven entry points (K8's with
    ``bwd_flags`` where ``flags``). The workspace holds both trees' dh
    partials (this tree fills Tp / 128 rows, the SIMT form Tp / 16) and
    this tree's split partials."""
    Tp, D = xs.shape
    E, _, H = w1.shape
    st = torch.cuda.current_stream().cuda_stream
    shapes = ffn.workspace_shapes(Tp, D, H, E, torch.float32)
    ws = [torch.empty(Tp, H, device="cuda"), torch.empty(Tp, H, device="cuda"),
          torch.empty(Tp // 16, H, device="cuda"),
          None if shapes["dw"] is None
          else torch.empty(shapes["dw"], device="cuda")]
    splits = 1 if ws[3] is None else shapes["dw"][0]

    def fwd(fn, *lead):
        y = torch.empty_like(xs)
        _build.check(fn(*lead, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        b2.data_ptr(), eot.data_ptr(),
                        *([perm.data_ptr()] if fn is lib.ssmv_expert_ffn_fwd_perm
                          else []), y.data_ptr(), Tp, D, H, 256, 0, st), "fwd")
        return y

    def bwd(fn, *lead, perm_arg=()):
        out = (torch.empty_like(xs), torch.empty_like(w1),
               torch.empty(E, H, device="cuda"), torch.empty_like(w2),
               torch.empty(E, D, device="cuda"))
        _build.check(fn(*lead, w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                        eot.data_ptr(), *perm_arg,
                        *(t.data_ptr() for t in out),
                        *(None if t is None else t.data_ptr() for t in ws),
                        splits, Tp, D, H,
                        E, 256, 0, st), "bwd")
        return out

    fl = ffn.bwd_flags(eot) if flags else None

    def defer():
        out = (torch.empty_like(xs), torch.empty_like(w1),
               torch.empty(E, H, device="cuda"), torch.empty_like(w2),
               torch.empty(E, D, device="cuda"))
        _build.check(lib.ssmv_expert_ffn_bwd_defer(
            xs.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), eot.data_ptr(),
            *([fl.data_ptr()] if flags else []),
            *(t.data_ptr() for t in out), Tp, D, H, E, 256, 0, st), "k8")
        return out

    return {
        "k3": lambda: fwd(lib.ssmv_expert_ffn_fwd, xs.data_ptr()),
        "k9": lambda: fwd(lib.ssmv_expert_ffn_fwd_gather, x.data_ptr(),
                          gidx.data_ptr()),
        "k10": lambda: fwd(lib.ssmv_expert_ffn_fwd_perm, xs.data_ptr()),
        "k4": lambda: bwd(lib.ssmv_expert_ffn_bwd, xs.data_ptr(),
                          dy.data_ptr()),
        "k9 bwd": lambda: bwd(lib.ssmv_expert_ffn_bwd_gather, x.data_ptr(),
                              gidx.data_ptr(), dy.data_ptr()),
        "k10 bwd": lambda: bwd(lib.ssmv_expert_ffn_bwd_perm, xs.data_ptr(),
                               dy.data_ptr(), perm_arg=(perm.data_ptr(),)),
        "k8": defer,
    }


def plains(forms, x, gidx, eot, perm, xs, w1, b1, w2, b2, dy) -> dict:
    """{form: (the plain version's result, the f64 function's)} of each
    of ``forms``, in the form's own row order."""
    xg, rows = x.index_select(0, gidx), ffn.permuted_rows(perm)

    def k10():
        y64 = torch.empty(xs.shape, dtype=torch.float64, device="cuda")
        y64[rows] = smoke.f64_ffn(xs[rows], w1, b1, w2, b2, eot)
        return (ffn.reference_expert_ffn_permuted(xs, w1, b1, w2, b2, eot,
                                                  perm), y64)

    def k10_bwd():
        g64 = list(smoke.f64_ffn(xs[rows], w1, b1, w2, None, eot, dy[rows]))
        dx64 = torch.empty_like(g64[0])
        dx64[rows] = g64[0]
        return (ffn.reference_expert_ffn_bwd_permuted(
            xs, w1, b1, w2, eot, perm, dy), (dx64, *g64[1:]))

    todo = {
        "k3": lambda: (ffn.fused_expert_ffn_reference(xs, w1, b1, w2, b2,
                                                      eot),
                       smoke.f64_ffn(xs, w1, b1, w2, b2, eot)),
        "k9": lambda: (ffn.fused_expert_ffn_reference(xg, w1, b1, w2, b2,
                                                      eot),
                       smoke.f64_ffn(xg, w1, b1, w2, b2, eot)),
        "k10": k10,
        "k4": lambda: (ffn.reference_expert_ffn_bwd(xs, w1, b1, w2, eot, dy),
                       smoke.f64_ffn(xs, w1, b1, w2, None, eot, dy)),
        "k9 bwd": lambda: (ffn.reference_expert_ffn_bwd(xg, w1, b1, w2, eot,
                                                        dy),
                           smoke.f64_ffn(xg, w1, b1, w2, None, eot, dy)),
        "k10 bwd": k10_bwd,
        "k8": lambda: (ffn.reference_expert_ffn_bwd_defer(xs, w1, b1, w2,
                                                          eot, dy),
                       smoke.f64_ffn(xs, w1, b1, w2, None, eot, dy))}
    return {form: todo[form]() for form in forms}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="another checkout, timed as 'tree'")
    ap.add_argument("--dims", default="384,192,768",
                    help="comma-separated widths to time")
    ap.add_argument("--forms", default=",".join(FORMS),
                    help="comma-separated forms to time, of " +
                    ", ".join(FORMS))
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
    forms = args.forms.split(",")
    started = [(v, csrc, start_build(
        v, csrc, {f for f, *_ in VARIANTS[v]} if v in VARIANTS else None))
        for v, csrc in todo]
    libs = {}
    for v, csrc, (out, procs) in started:
        *libs[v], report = finish_build(out, procs, csrc)
        print(f"{v}:\n  " + "\n  ".join(report), flush=True)
    gen = torch.Generator().manual_seed(0)
    for D in (int(d) for d in args.dims.split(",")):
        inputs = layout(D, gen)
        xs, w1 = inputs[4], inputs[5]
        Tp, (E, _, H) = xs.shape[0], w1.shape
        ref = plains(forms, *inputs)
        flops = {"fwd": 4 * Tp * D * H, "bwd": 10 * Tp * D * H}
        print(f"D={D} H={H} E={E} Tp={Tp}: bounds fwd "
              f"{flops['fwd'] / smoke.F32_FLOPS * 1e3:.4f} ms, bwd "
              f"{flops['bwd'] / smoke.F32_FLOPS * 1e3:.4f} ms (split TF32 "
              f"at {smoke.F32_FLOPS / 1e12:.1f} TFLOP/s)", flush=True)
        for v, (lib, flags) in libs.items():
            for form, fn in calls(lib, flags, *inputs).items():
                if form not in forms:
                    continue
                want, exact = ref[form]
                got = fn()
                bwd = isinstance(got, tuple)
                parts = smoke.FFN_PARTS if bwd else ("y",)
                g, w, x64 = ((got, want, exact) if bwd
                             else ((got,), (want,), (exact,)))
                try:
                    err = "%.2e" % smoke.compare(
                        f"{v} {form}", g, w, ("elem",) * len(g),
                        smoke.F32_TOL)[0]
                except AssertionError as exc:
                    err = f"BEYOND F32_TOL ({exc})"
                ratios = []
                for part, a, b, c in zip(parts, g, w, x64):
                    e = [(t.double() - c).abs().mean().item() for t in (a, b)]
                    ratios.append(f"{part} {e[0] / e[1]:.2f}")
                ms = smoke.median_ms(fn)
                bound = flops["bwd" if bwd else "fwd"] / smoke.F32_FLOPS * 1e3
                split = ""
                if form in ("k4", "k8"):
                    prof = smoke.profile_call(
                        lambda: [fn() for _ in range(10)],
                        f"{v} {form.upper()} D={D}, 10 calls")
                    parts = ((("dh", ("dh_f32", "dgrad")),
                              ("grads", ("grads", "wgrad")),
                              ("reduce", ("reduce",))) if form == "k4" else
                             (("dgrad", ("dgrad",)),
                              ("dw", ("defer_dw", "dw_defer"))))
                    ms_of = {k: sum(us for kn, (us, _) in prof.items()
                                    if any(n in kn for n in names)) / 10e3
                             for k, names in parts}
                    split = " (" + " + ".join(
                        f"{k} {t:.4f}" for k, t in ms_of.items()) + ")"
                print(f"  {v:10s} {form:8s} {ms:.4f} ms{split}, "
                      f"{bound / ms:.3f} of the bound, max |d| {err}, "
                      f"mean |d| from f64 / plain's: {', '.join(ratios)}",
                      flush=True)
        del inputs, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
