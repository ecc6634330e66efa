"""Training criteria, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/losses.py``: the same math on tensors,
every loss a function of (logits, targets) returning an f32 scalar. The
reference's timm loss classes and BCE target transform are kept as there
(``main.py:653-694``, ``engine.py:49-50`` of the reference).
"""
from __future__ import annotations

import functools
import typing as typ

import torch
import torch.nn.functional as F


def _nll(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain CE with integer labels."""
    return _nll(F.log_softmax(logits.float(), dim=-1), labels).mean()


def label_smoothing_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                  smoothing: float = 0.1) -> torch.Tensor:
    """timm LabelSmoothingCrossEntropy."""
    logp = F.log_softmax(logits.float(), dim=-1)
    smooth = -logp.mean(-1)
    return ((1.0 - smoothing) * _nll(logp, labels) + smoothing * smooth).mean()


def soft_target_cross_entropy(logits: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """timm SoftTargetCrossEntropy (mixup soft labels)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return (-target.float() * logp).sum(-1).mean()


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss in its stable form; callers binarize the
    target first, as the engine does."""
    x, t = logits.float(), target.float()
    return (x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def make_base_criterion(mixup_active: bool, smoothing: float,
                        bce_loss: bool) -> typ.Callable:
    """Criterion selection as the reference's ``main.py:653-664``."""
    if bce_loss:
        return lambda logits, target: bce_with_logits(
            logits, (target > 0.0).float())
    if mixup_active:
        return soft_target_cross_entropy
    if smoothing:
        return functools.partial(label_smoothing_cross_entropy,
                                 smoothing=smoothing)
    return cross_entropy


def distillation_loss(base_loss: torch.Tensor,
                      outputs_kd: typ.Optional[torch.Tensor],
                      teacher_logits: typ.Optional[torch.Tensor],
                      distillation_type: str, alpha: float,
                      tau: float) -> torch.Tensor:
    """DeiT DistillationLoss blend. ``soft``: KL(teacher || student) at
    temperature tau, summed, over the student's numel, times tau^2;
    ``hard``: CE against the teacher's argmax. The teacher is detached."""
    if distillation_type == "none":
        return base_loss
    if outputs_kd is None or teacher_logits is None:
        raise ValueError("distillation needs outputs_kd and teacher_logits")
    teacher = teacher_logits.detach().float()
    if distillation_type == "soft":
        s = F.log_softmax(outputs_kd.float() / tau, dim=-1)
        t = F.log_softmax(teacher / tau, dim=-1)
        dist = (t.exp() * (t - s)).sum() * (tau * tau) / outputs_kd.numel()
    elif distillation_type == "hard":
        dist = cross_entropy(outputs_kd, teacher.argmax(-1))
    else:
        raise ValueError(distillation_type)
    return base_loss * (1.0 - alpha) + dist * alpha


def accuracy_topk(logits: torch.Tensor, labels: torch.Tensor,
                  ks: typ.Sequence[int] = (1, 5)) -> typ.List[torch.Tensor]:
    """Top-k accuracy in percent, one 0-d tensor per k."""
    k_eff = min(max(ks), logits.shape[-1])
    pred = logits.topk(k_eff, dim=-1).indices
    correct = pred == labels.long()[:, None]
    return [correct[:, :min(k, k_eff)].any(-1).float().mean() * 100.0
            for k in ks]
