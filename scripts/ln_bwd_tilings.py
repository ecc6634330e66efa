"""Time the LayerNorm backward (K1c plain and add forms, K2b) on the card:
its launch configurations, the card's streaming floor for the same bytes,
and the LN-backward kernels of one profiled training step.

- ``--probes``: the add form at bf16, T = 25,216 rows, D = 384 (the
  flagship's B = 128) in every configuration of ``csrc/ln_bwd.cu``'s ring
  (32 or 16 lanes a row x stages 2, 3, 4 x rows a stage 8, 16, 32 x
  blocks an SM 1, 2) and its register-prefetch form (blocks an SM 1, 2),
  each held against the plain version first; the default configuration at
  2,112 rows (one tile a block: the launch's fixed cost); then the three
  forms in the default configuration.
- ``--floors``: ``torch.addcmul(x, dy, du, out=o)`` (three tensors of the
  add form's shape read, one written) and ``torch.add(x, dy, out=o)`` (the
  plain form's two read, one written): what the card reaches on these
  bytes. Not the same function, so no ``library_ms``.
- ``--step``: one profiled step of bench.py's cfg4 (capacity_fused at
  1.25, B = 128) and of the dropless flagship, with every LN-backward
  kernel listed apart (the Triton pair ``ln_bwd_kernel`` +
  ``col_sum_kernel`` of trees before the CUDA kernel, or the CUDA
  ``ln_bwd_kernel``), and the step's kernel sum and launches.

Times are medians of CUDA-event pairs around a loop of calls
(``chip_smoke.median_ms``). Usage, on a machine with one GPU:

    python3 scripts/ln_bwd_tilings.py [--probes] [--floors] [--step]
        [--tree DIR]

``--tree`` takes the port and ``chip_smoke.py`` from another checkout (for
example the parent commit unpacked by ``git archive``); ``--probes`` needs
this tree's kernel.
"""
from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AP = argparse.ArgumentParser(description=__doc__.splitlines()[0])
AP.add_argument("--probes", action="store_true")
AP.add_argument("--floors", action="store_true")
AP.add_argument("--step", action="store_true")
AP.add_argument("--tree", default=ROOT)
ARGS = AP.parse_args()
sys.path.insert(0, os.path.abspath(ARGS.tree))

import copy  # noqa: E402
import ctypes  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import _build  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln  # noqa: E402

T, D = 128 * 197, 384
BF16 = torch.bfloat16


def inputs(dtype=BF16, rows=T, d=D):
    gen = torch.Generator().manual_seed(0)
    a, b, dy, du = (torch.randn(rows, d, generator=gen).to("cuda", dtype)
                    for _ in range(4))
    g = (torch.randn(d, generator=gen) * 0.1 + 1.0).cuda()
    return a, b, dy, du, g


def check(got, want, what: str) -> None:
    """du within the smoke's elementwise limit, dgamma and dbeta within
    SUM_REL of max |ref|."""
    smoke.compare(what, got, want, ("elem", "sum", "sum"))


def probe_library() -> ctypes.CDLL:
    """``csrc/ln_bwd.cu`` built once more with its probe forms (16 lanes a
    row, register prefetch: ``-DSSMV_LN_BWD_PROBES``)."""
    out = os.path.join(_build.BUILD_ROOT, "ln_bwd_probes")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libln_bwd_probes.so")
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-DSSMV_LN_BWD_PROBES",
           "-shared", "-o", so, os.path.join(_build.CSRC, "ln_bwd.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout[-4000:]}"
                           f"{proc.stderr[-4000:]}")
    return _build.bind(ctypes.CDLL(so), ("ssmv_ln_bwd",))


def probes() -> None:
    lib = probe_library()
    a, _, dy, du, g = inputs()
    want = ln.reference_ln_bwd(a, dy, du, g)
    bound = smoke.bound(4 * T * D * 2 + 2 * D * 4, 10 * T * D,
                        smoke.SIMT_FLOPS)[0]
    rows = []
    for team in (32, 16):
        for bps in (1, 2):
            for stages in (2, 3, 4):
                for r in (8, 16, 32):
                    rows.append((f"ring {team} lanes a row, stages {stages} "
                                 f"rows {r} blocks/SM {bps}",
                                 dict(stages=stages, rows_per_stage=r,
                                      blocks_per_sm=bps, team=team,
                                      form="ring")))
    rows += [(f"prefetch blocks/SM {bps}",
              dict(blocks_per_sm=bps, form="prefetch")) for bps in (1, 2)]
    for name, kw in rows:
        call = lambda kw=kw: ln._launch_bwd(a, None, dy, du, g, 1e-6,  # noqa: E731
                                            lib=lib, **kw)
        check(call(), want, name)
        ms = smoke.median_ms(call)
        print(f"probe add form, {name:50s}: {ms:.4f} ms "
              f"({bound / ms:.2f} of the byte bound {bound:.4f})", flush=True)
    # the fixed cost: one tile of 16 rows a block
    a, b, dy, du, g = inputs(rows=132 * 16)
    ms = smoke.median_ms(lambda: ln.fused_add_ln_bwd(a, dy, du, g))
    print(f"add form at {132 * 16} rows (one tile a block): {ms:.4f} ms",
          flush=True)
    for rows in (132 * 16, T):
        phases(rows)
    a, b, dy, du, g = inputs()
    forms = {
        "K1c plain": (lambda: ln.fused_ln_bwd(a, dy, g), 3),
        "K1c add": (lambda: ln.fused_add_ln_bwd(a, dy, du, g), 4),
        "K2b": (lambda: ln.fused_sum_ln_bwd(a, b, dy, g), 4),
    }
    for name, (call, streams) in forms.items():
        ms = smoke.median_ms(call)
        bnd = smoke.bound(streams * T * D * 2 + 2 * D * 4, 10 * T * D,
                          smoke.SIMT_FLOPS)[0]
        print(f"default {name:10s}: {ms:.4f} ms, bound {bnd:.4f} "
              f"({bnd / ms:.2f})", flush=True)


PHASES = ("barriers ready", "first stage arrived", "rows done",
          "warps' sums added", "partial row written and group ticket taken",
          "group row written and last ticket taken", "dgamma/dbeta written")


def phases(rows: int) -> None:
    """The kernel's phases from its per-block %globaltimer stamps (the
    default configuration, the add form, 20 launches): the median over
    blocks of each phase's time from the block's entry, and the launch's
    span from the first block's entry to the last stamp."""
    a, _, dy, du, g = inputs(rows=rows)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stamps = torch.zeros(sms * ln.BWD_BLOCKS_PER_SM, 8, dtype=torch.int64,
                         device="cuda")
    runs = []
    for _ in range(20):
        stamps.zero_()
        ln._launch_bwd(a, None, dy, du, g, 1e-6, stamps=stamps)
        torch.cuda.synchronize()
        st = stamps.cpu().double()
        live = st[:, 0] > 0
        st = st[live]
        t0 = st[:, 0].min()
        rel = st - st[:, :1]
        med = [rel[:, k][st[:, k] > 0].median().item() / 1e3
               for k in range(1, 8)]
        end = st.max().item()
        runs.append((med, (st[:, 0].max() - t0).item() / 1e3,
                     (end - t0).item() / 1e3))
    runs.sort(key=lambda r: r[2])
    med, skew, span = runs[len(runs) // 2]
    print(f"phases at {rows} rows (median run of 20 by span): span "
          f"{span:.2f} us, block entries spread over {skew:.2f} us; "
          "from each block's entry (median over blocks): "
          + ", ".join(f"{n} {t:.2f}" for n, t in zip(PHASES, med)),
          flush=True)


def floors() -> None:
    x, y, z, _, _ = inputs()
    o = torch.empty_like(x)
    for name, call, streams in (
            ("addcmul (3 read, 1 written)",
             lambda: torch.addcmul(x, y, z, out=o), 4),
            ("add (2 read, 1 written)", lambda: torch.add(x, y, out=o), 3)):
        ms = smoke.median_ms(call)
        gbs = streams * T * D * 2 / ms / 1e6
        print(f"floor {name}: {ms:.4f} ms ({gbs:.0f} GB/s; the data sheet's "
              f"{smoke.HBM_BPS / 1e9:.0f})", flush=True)


def profile_step(step, state, x, y, what: str) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        state, _ = step(state, x, y, smoke.LR, smoke.LR)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, x, y, smoke.LR, smoke.LR)
        torch.cuda.synchronize()
    total, n, ln_rows = 0.0, 0, {}
    for ev in prof.events():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)
                or ev.name.startswith("Optimizer.")):
            continue
        us = ev.time_range.elapsed_us()
        total, n = total + us, n + 1
        found = re.search(r"ln_bwd_kernel|col_sum_kernel", ev.name)
        if found:
            key = found.group(0) + (" (CUDA C++)" if "<" in ev.name
                                    else " (Triton)")
            t, c = ln_rows.get(key, (0.0, 0))
            ln_rows[key] = (t + us, c + 1)
    print(f"step {what}: kernels {total / 1e3:.3f} ms in {n} launches",
          flush=True)
    for key, (us, c) in sorted(ln_rows.items()):
        print(f"  {key:60s} {c:4d}x {us / 1e3:.4f} ms "
              f"({us / c:.2f} us each)", flush=True)


def step_profiles() -> None:
    from slim_switch_moe_vit_tpu_torch import create_model

    x, y = smoke._batch(smoke.TRAIN_B, 0, "cuda")
    for what, kw in (("cfg4 default", dict(dispatch_mode="capacity_fused",
                                           capacity_factor=smoke.CAP_FACTOR)),
                     ("dropless B=128", {})):
        base = create_model(smoke.MODEL, num_classes=1000, dtype=BF16, **kw)
        _, state, step = smoke._train_setup(BF16, "cuda",
                                            model=copy.deepcopy(base))
        profile_step(step, state, x, y, what)
        del base, state, step
        torch.cuda.empty_cache()


def main() -> None:
    print(smoke.card_line(), flush=True)
    print(f"tree {os.path.abspath(ARGS.tree)}", flush=True)
    _build.load_library()
    if ARGS.floors:
        floors()
    if ARGS.probes:
        probes()
    if ARGS.step:
        step_profiles()


if __name__ == "__main__":
    main()
