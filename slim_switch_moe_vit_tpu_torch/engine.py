"""Train/eval engine, in PyTorch: the step functions and the host loops.

Port of ``slim_switch_moe_vit_tpu/engine.py``. The JAX package fuses the
forward, loss, backward, optimizer and EMA into one jitted step; here the
step runs them eagerly on the model's device, each kernel of the path an
autograd Function with its backward kernel (``ops/``). bf16 activations over
f32 parameters, no loss scaling (bf16's exponent range needs none), as in
the JAX package.

Not ported yet: on-device augmentation and mixup (``augment_fn``,
``mixup_fn``; ROADMAP Queue 1 #3) and the fused optimizer (K7).
"""
from __future__ import annotations

import math
import sys
import typing as typ

import torch

from .losses import accuracy_topk, cross_entropy, distillation_loss
from .models.moe import MoEMlp
from .train_state import TrainState
from .utils.metrics import MetricLogger, SmoothedValue


def _moe_modules(model: torch.nn.Module) -> typ.List[MoEMlp]:
    return [m for m in model.modules() if isinstance(m, MoEMlp)]


def _collect_moe_metrics(moe_modules) -> typ.Dict[str, torch.Tensor]:
    """Average each MoE metric (balance_loss, drop_fraction) over the blocks
    that ran."""
    buckets: typ.Dict[str, list] = {}
    for m in moe_modules:
        for k, v in (m.aux or {}).items():
            buckets.setdefault(k, []).append(v)
    return {k: torch.stack(v).mean() for k, v in buckets.items()}


@torch.no_grad()
def ema_update(ema_params: typ.Dict[str, torch.Tensor],
               model: torch.nn.Module, decay: float) -> None:
    """timm ModelEma, in place: e = d*e + (1-d)*p, each EMA tensor paired
    with the parameter of its name."""
    named = list(model.named_parameters())
    ema = [ema_params[n] for n, _ in named]
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [p for _, p in named], alpha=1.0 - decay)


def make_train_step(model: torch.nn.Module, update_fn: typ.Callable,
                    base_criterion: typ.Callable, *,
                    distillation_type: str = "none", alpha: float = 0.5,
                    tau: float = 1.0,
                    teacher_apply: typ.Optional[typ.Callable] = None,
                    ema_decay: typ.Optional[float] = None,
                    moe_balance_weight: float = 0.0,
                    mixup_fn: typ.Optional[typ.Callable] = None,
                    bce_loss: bool = False,
                    augment_fn: typ.Optional[typ.Callable] = None,
                    set_training_mode: bool = True):
    """Build the train step.

    Args:
        update_fn: from ``optim.make_optimizer`` — (optimizer, lr_base,
            lr_gate) -> None, one step on the gradients in ``p.grad``.
        teacher_apply: fn(images) -> logits for distillation (no grad).
    Returns:
        train_step(state, images, targets, lr_base, lr_gate) -> (state,
        metrics): the state updated in place (parameters, optimizer, EMA,
        step), metrics ``{loss, balance_loss, drop_fraction}`` as 0-d
        tensors on the device, not fetched. The step's gradients stay in
        ``p.grad`` until the next step.
    """
    if augment_fn is not None or mixup_fn is not None:
        raise NotImplementedError("on-device augmentation and mixup are not "
                                  "ported yet (ROADMAP Queue 1 #3)")
    moe_modules = _moe_modules(model)

    def train_step(state: TrainState, images, targets, lr_base, lr_gate):
        device = next(model.parameters()).device
        images, targets = images.to(device), targets.to(device)
        if bce_loss:
            targets = (targets > 0.0).float()
        teacher_logits = None
        if distillation_type != "none" and teacher_apply is not None:
            with torch.no_grad():
                teacher_logits = teacher_apply(images)

        # set_training_mode=False keeps dropout/droppath off while still
        # training (the reference's model.train(set_training_mode))
        model.train(set_training_mode)
        for m in moe_modules:
            m.aux = None
        out = model(images, state.generator)
        logits, logits_kd = out if isinstance(out, tuple) else (out, None)
        loss = distillation_loss(base_criterion(logits, targets), logits_kd,
                                 teacher_logits, distillation_type, alpha, tau)
        moe_metrics = _collect_moe_metrics(moe_modules)
        if moe_balance_weight and "balance_loss" in moe_metrics:
            loss = loss + moe_balance_weight * moe_metrics["balance_loss"]

        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        update_fn(state.optimizer, lr_base, lr_gate)
        if state.ema_params is not None and ema_decay is not None:
            ema_update(state.ema_params, model, ema_decay)
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in moe_metrics.items()}}
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, use_ema: bool = False,
                   preprocess_fn: typ.Optional[typ.Callable] = None):
    """Eval step: CE loss + top-1/5 accuracy, as 0-d device tensors."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, targets):
        device = next(model.parameters()).device
        images, targets = images.to(device), targets.to(device)
        if preprocess_fn is not None:
            images = preprocess_fn(images)
        model.eval()
        if use_ema:
            logits = torch.func.functional_call(model, state.ema_params,
                                                (images,))
        else:
            logits = model(images)
        acc1, acc5 = accuracy_topk(logits, targets, ks=(1, 5))
        return cross_entropy(logits, targets), acc1, acc5

    return eval_step


def _fetch(window: typ.List[typ.Dict[str, torch.Tensor]]):
    """One device-to-host transfer for a window of metric dicts."""
    keys = list(window[0])
    flat = torch.stack([m[k].float() for m in window for k in keys]).tolist()
    return [dict(zip(keys, flat[i * len(keys):(i + 1) * len(keys)]))
            for i in range(len(window))]


def train_one_epoch(state: TrainState, train_step, data_loader, epoch: int,
                    lr_base: float, lr_gate: float, *, print_freq: int = 10,
                    max_steps: typ.Optional[int] = None,
                    abort_on_nan: bool = True):
    """Host epoch loop. Returns (state, averaged stats).

    Step metrics stay on the device and are fetched once every
    ``print_freq`` steps (and at the end), so the NaN abort fires up to
    print_freq-1 steps late, as in the JAX package."""
    metric_logger = MetricLogger(delimiter="  ")
    metric_logger.add_meter("lr", SmoothedValue(window_size=1,
                                                fmt="{value:.6f}"))
    header = f"Epoch: [{epoch}]"
    window: typ.List[dict] = []

    def drain():
        if not window:
            return
        fetched = _fetch(window)
        window.clear()
        for m in fetched:
            loss_value = m["loss"]
            if abort_on_nan and not math.isfinite(loss_value):
                print(f"Loss is {loss_value}, stopping training")
                sys.exit(1)
            extra = {k: v for k, v in m.items() if k != "loss"}
            metric_logger.update(loss=loss_value, lr=lr_base, **extra)

    n = 0
    for samples, targets in metric_logger.log_every(data_loader, print_freq,
                                                    header):
        state, metrics = train_step(state, torch.as_tensor(samples),
                                    torch.as_tensor(targets), lr_base, lr_gate)
        window.append(metrics)
        n += 1
        if n % print_freq == 0:
            drain()
        if max_steps is not None and n >= max_steps:
            break

    drain()
    metric_logger.synchronize_between_processes()
    print("Averaged stats:", metric_logger)
    return state, {k: m.global_avg for k, m in metric_logger.meters.items()}


def evaluate(state: TrainState, eval_step, data_loader, *,
             print_freq: int = 10, max_steps: typ.Optional[int] = None):
    """Eval loop; metrics fetched once per ``print_freq`` window."""
    metric_logger = MetricLogger(delimiter="  ")
    window: typ.List[tuple] = []  # (batch_size, {loss, acc1, acc5})

    def drain():
        if not window:
            return
        fetched = _fetch([m for _, m in window])
        sizes = [bs for bs, _ in window]
        window.clear()
        for bs, m in zip(sizes, fetched):
            metric_logger.update(loss=m["loss"])
            metric_logger.meters["acc1"].update(m["acc1"], n=bs)
            metric_logger.meters["acc5"].update(m["acc5"], n=bs)

    n = 0
    for images, target in metric_logger.log_every(data_loader, print_freq,
                                                  "Test:"):
        loss, acc1, acc5 = eval_step(state, torch.as_tensor(images),
                                     torch.as_tensor(target))
        window.append((images.shape[0],
                       {"loss": loss, "acc1": acc1, "acc5": acc5}))
        n += 1
        if n % print_freq == 0:
            drain()
        if max_steps is not None and n >= max_steps:
            break

    drain()
    metric_logger.synchronize_between_processes()
    print("* Acc@1 {:.3f} Acc@5 {:.3f} loss {:.3f}".format(
        metric_logger.acc1.global_avg, metric_logger.acc5.global_avg,
        metric_logger.loss.global_avg))
    return {k: m.global_avg for k, m in metric_logger.meters.items()}
