"""AdamW + EMA over a model's full parameter set on the card: torch's
foreach path (``update_fn`` + ``engine.ema_update``) against K7's one pass
(``update_fn.fused_apply``, the train step's default there), beside K7's
bound.

For each model (``--models``, the registry's names; f32 parameters under a
bf16 forward, as the benchmark trains them) it prints one JSON line:

- ``device_ms``: CUDA events around one call, the device held idle by a
  sleep kernel while the host queues the call, so the events time the
  device's work alone; the median of ``--reps`` calls;
- ``host_ms``: ``time.perf_counter`` around one call after a synchronise,
  the host's work of the train step's ``train.optimizer`` phase on an
  empty queue; the median;
- ``extra_gb``: memory allocated during a call beyond what it started with
  (``max_memory_allocated`` after ``reset_peak_memory_stats``);
- ``bound_ms``: K7's least time, 36 bytes a parameter (p, g, mu, nu, ema
  read; p, mu, nu, ema written) at ``--hbm-tb-s``, and its share of the
  K7 call's ``device_ms`` (the kernel and its chunk table's copy).

Gradients are seeded, not computed: the optimizer's work does not depend
on their values. The card's name and power limit lead the output.

    python3 scripts/optimizer_step_ab.py [--models NAME ...] [--reps 20]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from slim_switch_moe_vit_tpu_torch import engine, optim  # noqa: E402
from slim_switch_moe_vit_tpu_torch.models import create_model  # noqa: E402
from slim_switch_moe_vit_tpu_torch.ops import fused_adamw  # noqa: E402
from slim_switch_moe_vit_tpu_torch.train_state import \
    create_train_state  # noqa: E402

LR, EMA_DECAY = 1e-3, 0.99996
HOLD_CYCLES = 400_000_000  # ~0.2 s of sleep kernel: longer than any queueing


def device_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return statistics.median(times)


def extra_gb(fn) -> float:
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def measure(name: str, reps: int, hbm: float) -> dict:
    with torch.device("meta"):
        model = create_model(name, num_classes=1000, dtype=torch.bfloat16)
    model = model.to_empty(device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    n = sum(p.numel() for p in model.parameters())
    opt_init, update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cuda", opt_init=opt_init,
                               use_ema=True)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, device="cuda", generator=gen) * 1e-2
    fused = engine.fused_optimizer(update, model)
    if fused is None:
        raise RuntimeError(f"{name}: the step would not take K7")

    def foreach():
        update(state.optimizer, LR, LR)
        engine.ema_update(state.ema_params, model, EMA_DECAY)

    def one_pass():
        fused(model, state.optimizer, state.ema_params, LR, LR, EMA_DECAY)

    foreach()  # AdamW's lazy state
    out = {"model": name, "params": n, "leaves": len(list(
        model.parameters()))}
    for label, fn in (("foreach", foreach), ("k7", one_pass)):
        fn()
        out[label] = {"device_ms": device_ms(fn, reps),
                      "host_ms": host_ms(fn, reps), "extra_gb": extra_gb(fn)}
    out["bound_ms"] = 1e3 * 36 * n / hbm
    out["k7_share_of_bound"] = out["bound_ms"] / out["k7"]["device_ms"]
    out["table_rows"] = sum(-(-p.numel() // fused_adamw.CHUNK)
                            for p in model.parameters())
    del model, state
    torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="+", default=[
        "moe_base_patch16_224_expert32", "moe_small_patch16_224_expert8"])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--hbm-tb-s", type=float, default=3.35)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for name in args.models:
        print(json.dumps(measure(name, args.reps, args.hbm_tb_s * 1e12)),
              flush=True)


if __name__ == "__main__":
    main()
