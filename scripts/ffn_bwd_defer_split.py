"""Time the deferred-dW expert-FFN backward (K8) on the card, launch by
launch, beside K4 on the same inputs.

K8 is two launches (dx, then dW and db). This script times a whole
``fused_expert_ffn_bwd_defer`` call with CUDA events and splits it by
kernel name with ``torch.profiler``, on the layouts ``chip_smoke.py``
times K8 on: cfg4's (``capacity_fused`` at factor 1.25,
B = 128: D = 384, H = 1536, 8 experts), the dropless B = 128 layout,
moe_tiny_patch16_224_expert8's dropless layout at B = 128 (D = 192,
H = 768, 8 experts) and moe_base_patch16_224_expert32's at B = 32
(D = 768, H = 3072, 32 experts). It imports the port from ``--tree``
(default: this checkout), so the same command times another tree's K8,
for example the parent commit unpacked by ``git archive``. Usage, on a machine with one
GPU:

    python3 scripts/ffn_bwd_defer_split.py [--tree DIR]
"""
from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys


def kernel_ms(fn, reps: int = 10) -> dict:
    """{kernel name: device ms per call of ``fn``} from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.name] = out.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    return {k: v / 1e3 / reps for k, v in out.items()}


def event_ms(fn, reps: int = 10, loop: int = 5) -> float:
    """Median device ms of one call, CUDA events around ``loop`` calls."""
    import torch

    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        for _ in range(loop):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / loop)
    return statistics.median(times)


def layouts(gen):
    """(label, x, routed logits, capacity, D, H, E, seeded weights)."""
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import moe

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen) * std).to("cuda", dtype)

    for label, B, D, H, E, factor in (("cfg4", 128, 384, 1536, 8, 1.25),
                                      ("dropless", 128, 384, 1536, 8, None),
                                      ("d192", 128, 192, 768, 8, None),
                                      ("d768", 32, 768, 3072, 32, None)):
        T = B * 197
        x = rnd(T, D)
        logits = x.float() @ rnd(D, E, std=D ** -0.5, dtype=torch.float32)
        cap = None if factor is None else moe.compute_capacity(T, E, 2, factor)
        w = (rnd(E, D, H, std=D ** -0.5),
             rnd(E, H, std=0.1, dtype=torch.float32),
             rnd(E, H, D, std=H ** -0.5))
        yield label, x, logits, cap, D, H, E, w


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from slim_switch_moe_vit_tpu_torch.ops import _build
    from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn
    from slim_switch_moe_vit_tpu_torch.ops import moe

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    _build.load_library()
    print(f"tree {os.path.abspath(args.tree)}; card {card}", flush=True)
    gen = torch.Generator().manual_seed(3)
    for label, x, logits, cap, D, H, E, (w1, b1, w2) in layouts(gen):
        gate_w, eidx = moe.naive_topk_gate(logits, 2)
        gidx, pslot, eot, w_slot, keep = moe.aligned_expert_layout(
            eidx, E, gate_w=gate_w, capacity=cap)
        xs = moe.dispatch_gather(x, gidx, pslot, None if cap is None else keep)
        dy = (torch.randn(xs.shape, generator=gen).to("cuda", xs.dtype)
              * w_slot[:, None])
        args8 = (xs, w1, b1, w2, eot, dy)
        k8 = event_ms(lambda: ffn.fused_expert_ffn_bwd_defer(*args8))
        k4 = event_ms(lambda: ffn.fused_expert_ffn_bwd(*args8))
        split = kernel_ms(lambda: ffn.fused_expert_ffn_bwd_defer(*args8))
        parts = ", ".join(f"{name[:60]} {ms:.4f}"
                          for name, ms in sorted(split.items(),
                                                 key=lambda kv: -kv[1]))
        print(f"{label}: Tp={xs.shape[0]}, D={D}, H={H}, E={E}: K8 "
              f"{k8:.4f} ms, K4 {k4:.4f} ms (events); K8 by kernel "
              f"(profiler, ms a call): {parts}", flush=True)
        del xs, dy, args8
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
