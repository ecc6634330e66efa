"""Training traffic: the program's training step, at the mix's batch, over a
pool of seeded batches resident on the device and cycled, so routing sees
new rows from step to step.

Set-up builds one step object (``engine.make_train_step`` over the model,
AdamW and the EMA, with the configuration's recipe) and drives it through
its first three steps on batches 0-2, whose rows all differ, keeping what
the check compares (each step's loss, the first gradient from the
optimizer's first moment, the parameters' and the EMA's change, and the
routing, ``capture.py``), then through the mix's warm-up steps. The window
drives the same object. After it, with the program's state freed, the
reference takes the same three steps from the same seed, following the
program's routing.

The window: steps until ``--seconds`` have passed, then a synchronise; the
rate is all the window's images over all its seconds. With ``--trace 1``
one profiler session then covers ``trace_steps`` more steps.
"""
from __future__ import annotations

import gc
import os
import time
import typing as typ

import torch

from .. import capture, check, devtrace, inputs, readers, weights
from ..counts import model as model_counts
from ..counts import shape as count_shape
from ..harness import Outcome, Run, note, peak_rates
from ..reference import model as ref_model
from ..reference import step as ref_step

END_TO_END = {"train_images_per_s": "images/s", "setup_s": "s"}
CHECK_STEPS = 3


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(run: Run):
    """The program's model, train state and step, with the seed's weights."""
    from slim_switch_moe_vit_tpu_torch import engine, losses, optim
    from slim_switch_moe_vit_tpu_torch.models import create_model
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    cfg, rec = run.cfg, run.cfg["recipe"]
    note(run, "program_imported")
    with torch.device("meta"):
        model = create_model(cfg["model"], num_classes=cfg["num_classes"],
                             img_size=cfg["img_size"],
                             dtype=getattr(torch, cfg["dtype"]),
                             drop_rate=0.0, drop_path_rate=rec["drop_path"])
    model = model.to_empty(device=run.device)
    note(run, "model_allocated")
    weights.load_into(model, cfg, run.seed)
    note(run, "weights")
    opt_init, opt_update = optim.make_optimizer(
        opt=rec["opt"], weight_decay=rec["weight_decay"],
        betas=tuple(rec["betas"]), eps=rec["eps"])
    state = create_train_state(model, device=run.device.type,
                               seed=weights.sub_seed(run.seed, "step"),
                               opt_init=opt_init, use_ema=True)
    step = engine.make_train_step(
        model, opt_update,
        losses.make_base_criterion(False, rec["smoothing"], False),
        ema_decay=rec["ema_decay"],
        moe_balance_weight=rec["moe_balance_weight"])
    return model, state, step


def pool(run: Run) -> list:
    B = run.traffic["batch"]
    return [inputs.train_batch(run.cfg, B, i, run.seed, run.device)
            for i in range(run.traffic["pool_batches"])]


def program_record(run: Run, model, state, step, batches
                   ) -> check.TrainRecord:
    """Drive the step object through its first three steps, keeping what
    the check compares."""
    rec = run.cfg["recipe"]
    lr, beta1 = rec["lr"], rec["betas"][0]
    record = check.TrainRecord()
    named = list(model.named_parameters())
    loss = []
    with capture.routes() as routes:
        for s in range(CHECK_STEPS):
            state, metrics = step(state, *batches[s], lr, lr)
            loss.append(metrics["loss"])
            if s == 0:
                opt = state.optimizer.state
                record.take_grad(
                    (n, opt[p]["exp_avg"] / (1.0 - beta1)
                     if "exp_avg" in opt.get(p, {}) else torch.zeros_like(p))
                    for n, p in named)
    record.routes = split_steps(routes, run.cfg["depth"])
    initial = weights.make(run.cfg, run.seed, run.device)
    with torch.no_grad():
        record.take_change(dict(named), state.ema_params, initial)
    del initial
    record.losses = [float(v) for v in loss]
    return record


def split_steps(routes: typ.List[torch.Tensor], depth: int) -> list:
    """A record of the gate's calls, cut into steps of ``depth`` blocks."""
    return [routes[s * depth:(s + 1) * depth]
            for s in range(len(routes) // depth)]


def reference_record(run: Run, mm=ref_model.matmul, half: bool = False,
                     routes: typ.Optional[list] = None
                     ) -> typ.Optional[check.TrainRecord]:
    """The reference's three steps from the seed (``mm``: its products;
    ``half``: each step on the batch's first half alone, a planted fault),
    following ``routes`` (a program's routing, step by step and block by
    block) where given; None where it cannot follow them."""
    cfg, dev = run.cfg, run.device
    B = run.traffic["batch"]
    ref_model.strict_f32()
    initial = weights.make(cfg, run.seed, dev)
    params = {n: t.clone() for n, t in initial.items()}
    kinds = {n: k for n, _, k in weights.layout(cfg)}
    keep = B // 2 if half else B

    def batch(i):
        return lambda: tuple(t[:keep] for t in inputs.train_batch(
            cfg, B, i, run.seed, dev))

    record = check.TrainRecord()

    def after(s, params, grads, ema):
        if s == 0:
            record.take_grad(grads.items())
        if s == CHECK_STEPS - 1:
            record.take_change(params, ema, initial)

    if routes is not None and (
            len(routes) != CHECK_STEPS
            or any(len(r) != cfg["depth"] for r in routes)):
        return None
    try:
        out = ref_step.train_steps(
            cfg, cfg["recipe"], params, kinds,
            [batch(i) for i in range(CHECK_STEPS)],
            run.traffic["check_micro_batch"], mm, after, routes)
    except ref_model.RoutingMismatch:
        return None
    record.losses, record.routes = out["losses"], out["routes"]
    record.route_flip = out["flip"]
    return record


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(run: Run) -> Outcome:
    tr, rec = run.traffic, run.cfg["recipe"]
    B, lr = tr["batch"], rec["lr"]
    note(run, "imports")
    model, state, step = build(run)
    note(run, "model")
    batches = pool(run)
    note(run, "batches")
    record = program_record(run, model, state, step, batches)
    note(run, "first_steps")
    P = len(batches)
    start = CHECK_STEPS
    for i in range(tr["warmup_steps"]):
        state, _ = step(state, *batches[(start + i) % P], lr, lr)
    start += tr["warmup_steps"]

    step_loss = []
    sync(run.device)
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)
    t0 = time.perf_counter()
    i = 0
    while True:
        state, metrics = step(state, *batches[(start + i) % P], lr, lr)
        step_loss.append(metrics["loss"])
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    sync(run.device)
    t1 = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(run.device)
            if run.device.type == "cuda" else 0)
    losses = torch.stack(step_loss).float().cpu()
    failed = int((~torch.isfinite(losses)).sum())

    window = None
    if run.trace:
        session = devtrace.Session(os.path.join(
            run.out_dir, f"{run.workload}.{os.getpid()}.trace.json"))
        n = tr["trace_steps"]
        session.start()
        for j in range(n):
            state, metrics = step(state, *batches[(start + i + j) % P], lr,
                                  lr)
        traced = session.stop()
        os.remove(session.path)
        peaks = peak_rates(run.device)
        window = readers.Window(
            trace=traced, units=n,
            shape=count_shape(run.cfg, B, training=True),
            unit_flops=model_counts.train_step_flops(run.cfg, B),
            peak_flops=peaks["bf16_flops_per_s"],
            peak_bytes_per_s=peaks["hbm_bytes_per_s"],
            measured_units=i, measured_s=t1 - t0)
    del model, state, step, batches, metrics, step_loss
    free(run.device)
    numbers = check.train_numbers(
        record, reference_record(run, routes=record.routes))
    return Outcome(
        end_to_end={"train_images_per_s": i * B / (t1 - t0),
                    "setup_s": t0 - run.started},
        attempted=i, failed=failed, memory_peak_bytes=peak,
        numbers=numbers, window=window)


def readings(run: Run, sides: typ.Sequence[str]) -> typ.Dict[str, dict]:
    """The check's numbers of each side against the reference, for setting
    limits: ``program`` (its first three steps, no window), ``control``
    (the reference in fp8 products in the program's place), ``half_batch``
    (the reference in the program's place, each step on half the
    batch)."""
    out: typ.Dict[str, typ.Any] = {}
    if "program" in sides:
        model, state, step = build(run)
        batches = pool(run)[:CHECK_STEPS]
        out["program"] = program_record(run, model, state, step, batches)
        del model, state, step, batches
        free(run.device)
    if "control" in sides:
        out["control"] = reference_record(run, mm=ref_model.matmul_fp8)
    if "half_batch" in sides:
        out["half_batch"] = reference_record(run, half=True)
    return {k: check.train_numbers(v, reference_record(run, routes=v.routes))
            for k, v in out.items()}

