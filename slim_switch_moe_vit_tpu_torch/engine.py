"""Train/eval engine, in PyTorch: the step functions and the host loops.

Port of ``slim_switch_moe_vit_tpu/engine.py``. The JAX package fuses the
forward, loss, backward, optimizer and EMA into one jitted step; here the
step runs them eagerly on the model's device, each kernel of the path an
autograd Function with its backward kernel (``ops/``). bf16 activations over
f32 parameters, no loss scaling (bf16's exponent range needs none), as in
the JAX package.

The optimizer's ``fused_apply`` (the K7 kernel: AdamW and the EMA in one
pass) is the step's default on the card wherever it exists
(:func:`fused_optimizer`), as the JAX step takes its ``fused_apply`` under
its flag (engine.py:116-125); ``use_fused_optimizer`` requires it. Images
may come as uint8 batches with an ``augment_fn`` (``data/device_aug.py``)
that runs on the device, and a ``mixup_fn`` (``data/mixup.py``) then mixes
the batch and turns the labels into soft targets there, before the
criterion, as the JAX step does (engine.py:71-79).

Under a (data, expert) layout (``mesh``), each gradient is averaged over
the data group after the backward, and the step's metrics too (the JAX
step's loss and MoE metrics are means over the whole batch). The ranks of
one expert group hold the same batch, so their dense gradients come out
equal; the expert gradients are each rank's own experts'. The optimizer,
K7 and the EMA then run on each rank's own parameters.
"""
from __future__ import annotations

import math
import sys
import time
import typing as typ

import torch

from .losses import accuracy_topk, cross_entropy, distillation_loss
from .models.gates import TokenGate
from .models.moe import MoEMlp
from .parallel import collectives as coll
from .train_state import TrainState
from .utils.metrics import MetricLogger, SmoothedValue
from .utils.profiling import span


def _moe_modules(model: torch.nn.Module) -> typ.List[torch.nn.Module]:
    """The MoE MLPs and token gates, whose forwards keep metrics."""
    return [m for m in model.modules() if isinstance(m, (MoEMlp, TokenGate))]


def _collect_moe_metrics(moe_modules) -> typ.Dict[str, torch.Tensor]:
    """Average each metric (balance_loss, drop_fraction of the MoE MLPs,
    skip_fraction of the gates) over the modules that ran."""
    buckets: typ.Dict[str, list] = {}
    for m in moe_modules:
        metrics = (m.aux or {}) if isinstance(m, MoEMlp) else (
            {} if m.skip_fraction is None
            else {"skip_fraction": m.skip_fraction})
        for k, v in metrics.items():
            buckets.setdefault(k, []).append(v)
    return {k: torch.stack(v).mean() for k, v in buckets.items()}


def _reset_metrics(moe_modules) -> None:
    for m in moe_modules:
        if isinstance(m, MoEMlp):
            m.aux = None
        else:
            m.skip_fraction = None


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host batch to the device through pinned memory, so the copy is
    queued behind the work already on the stream instead of waiting for it
    (a pageable copy synchronises)."""
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def fused_optimizer(update_fn: typ.Callable, model: torch.nn.Module,
                    required: bool = False) -> typ.Optional[typ.Callable]:
    """The optimizer's one-pass form, ``update_fn.fused_apply`` (K7: AdamW
    and the EMA in one launch), where the train step takes it; else None,
    and the step runs ``update_fn`` and :func:`ema_update`.

    The step takes it wherever the optimizer has one (adamw without
    ``clip_grad`` or a trainable mask: ``optim.make_optimizer`` decides)
    and the model's trainable parameters are CUDA f32 tensors: the same
    math as the foreach form in one pass over each byte, on the same
    state. ``required`` (``use_fused_optimizer``) takes it on any device
    (its plain version on the CPU) and raises ``ValueError`` where the
    optimizer has none."""
    fused = getattr(update_fn, "fused_apply", None)
    if required:
        if fused is None:
            raise ValueError("use_fused_optimizer: this optimizer has no "
                             "fused form (K7 is AdamW without clip_grad or "
                             "a trainable mask)")
        return fused
    trainable = [p for p in model.parameters() if p.requires_grad]
    if fused is None or not trainable or not all(
            p.is_cuda and p.dtype == torch.float32 for p in trainable):
        return None
    return fused


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
                    set_training_mode: bool = True,
                    use_fused_optimizer: bool = False, mesh=None):
    """Build the train step.

    Args:
        update_fn: from ``optim.make_optimizer`` — (optimizer, lr_base,
            lr_gate) -> None, one step on the gradients in ``p.grad``. Its
            ``fused_apply`` takes the step and the EMA update in one K7
            launch instead wherever :func:`fused_optimizer` finds it: by
            default for adamw on CUDA f32 parameters.
        use_fused_optimizer: require ``fused_apply``, on any device (an
            optimizer without one raises ``ValueError``).
        mesh: this rank's ``parallel.Mesh``, or None on one process.
        teacher_apply: fn(images) -> logits for distillation (no grad).
        augment_fn: fn(generator, images) -> images on the device (uint8
            NHWC in, normalized f32 out), drawing from the state's
            generator.
        mixup_fn: fn(generator, images, int labels) -> (images, soft
            targets) on the device, after ``augment_fn``, drawing from the
            state's generator.
    Returns:
        train_step(state, images, targets, lr_base, lr_gate) -> (state,
        metrics): the state updated in place (parameters, optimizer, EMA,
        step), metrics ``{loss, balance_loss, drop_fraction}`` (and
        ``skip_fraction`` with gates) as 0-d tensors on the device, not
        fetched. The step's gradients stay in ``p.grad`` until the next
        step.
    """
    moe_modules = _moe_modules(model)
    fused_apply = fused_optimizer(update_fn, model, use_fused_optimizer)
    data_group = None if mesh is None else mesh.data_group

    def train_step(state: TrainState, images, targets, lr_base, lr_gate):
        with span("train.step"):
            return _step(state, images, targets, lr_base, lr_gate)

    def _step(state, images, targets, lr_base, lr_gate):
        with span("train.upload"):
            device = next(model.parameters()).device
            images = _to_device(images, device)
            targets = _to_device(targets, device)
            if augment_fn is not None:
                images = augment_fn(state.generator, images)
            if mixup_fn is not None:
                images, targets = mixup_fn(state.generator, images, targets)
            if bce_loss:
                targets = (targets > 0.0).float()
        teacher_logits = None
        if distillation_type != "none" and teacher_apply is not None:
            with span("train.teacher"), torch.no_grad():
                teacher_logits = teacher_apply(images)

        with span("train.forward"):
            # set_training_mode=False keeps dropout/droppath off while
            # still training (the reference's model.train(set_training_mode))
            model.train(set_training_mode)
            _reset_metrics(moe_modules)
            out = model(images, state.generator)
        with span("train.loss"):
            logits, logits_kd = out if isinstance(out, tuple) else (out, None)
            loss = distillation_loss(base_criterion(logits, targets),
                                     logits_kd, teacher_logits,
                                     distillation_type, alpha, tau)
            moe_metrics = _collect_moe_metrics(moe_modules)
            if moe_balance_weight and "balance_loss" in moe_metrics:
                loss = loss + moe_balance_weight * moe_metrics["balance_loss"]

        with span("train.backward"):
            model.zero_grad(set_to_none=True)  # frozen parameters' too
            loss.backward()
            coll.average_gradients(model.parameters(), data_group)
        ema_on = state.ema_params is not None and ema_decay is not None
        with span("train.optimizer"):
            if fused_apply is not None:
                fused_apply(model, state.optimizer,
                            state.ema_params if ema_on else None, lr_base,
                            lr_gate, ema_decay)
            else:
                update_fn(state.optimizer, lr_base, lr_gate)
                if ema_on:
                    ema_update(state.ema_params, model, ema_decay)
        state.step += 1
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in moe_metrics.items()}}
        if data_group is not None:
            stacked = torch.stack([v.float() for v in metrics.values()])
            means = coll.mean_value(stacked, data_group, 1.0)
            metrics = dict(zip(metrics, means))
        return state, metrics

    return train_step


def make_eval_step(model: torch.nn.Module, use_ema: bool = False,
                   preprocess_fn: typ.Optional[typ.Callable] = None):
    """Eval step: CE loss + top-1/5 accuracy, as 0-d device tensors."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, targets):
        device = next(model.parameters()).device
        images, targets = _to_device(images, device), _to_device(targets,
                                                                  device)
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
    print_freq-1 steps late, as in the JAX package. The loop's pace is
    printed at its end in steps/s on the host clock (data loading and the
    last fetch included)."""
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
    t0 = time.perf_counter()
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
    seconds = time.perf_counter() - t0
    print(f"{header} {n} train steps in {seconds:.3f} s "
          f"({n / max(seconds, 1e-9):.3f} steps/s)")
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
