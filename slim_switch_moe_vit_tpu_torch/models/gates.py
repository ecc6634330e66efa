"""Learned token-skip gates with straight-through estimators, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/gates.py``. A 1-unit f32 linear
head gives a sigmoid probability; a token is SKIPPED when ``prob >
threshold``. The hard masks use the straight-through expressions exactly as
written there (:70-73), in f32:

    skip = hard_skip + prob'.detach() - prob'     (prob' = 1 - prob)
    keep = hard_keep + prob.detach() - prob

which are not bit-exactly the hard values (a + b - b rounds), so they are
kept as written. Training uses the annealed ``threshold``, eval the
``target_threshold`` (:65); a disabled gate passes every token (:76-78).

The JAX ``gates`` collection (``threshold``, ``target_threshold``,
``enabled``) becomes three f32 buffers of each :class:`TokenGate`, so they
ride in the model's ``state_dict``; the trainer-side functions below update
them in place, in the JAX package's gate order (:93-161). Each forward
keeps its skip fraction in ``skip_fraction`` (the JAX ``sow``), for the
engine to average.
"""
from __future__ import annotations

import typing as typ

import torch
from torch import nn

from .layers import Dense

Path = typ.Tuple[str, ...]


class TokenGate(nn.Module):
    def __init__(self, dim: int, starting_threshold: float = 1.0,
                 target_threshold: float = 0.9):
        super().__init__()
        self.head = Dense(dim, 1, dtype=torch.float32)
        f32 = torch.float32
        self.register_buffer("threshold",
                             torch.tensor(starting_threshold, dtype=f32))
        self.register_buffer("target_threshold",
                             torch.tensor(target_threshold, dtype=f32))
        self.register_buffer("enabled", torch.tensor(1.0, dtype=f32))
        self.skip_fraction: typ.Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, N, d) -> mask (B, N, 2) f32: [..., 0] skip, [..., 1] keep."""
        prob = torch.sigmoid(self.head(x.float()))
        nprob = 1.0 - prob
        threshold = self.threshold if self.training else self.target_threshold
        hard_skip = (prob > threshold).float()
        hard_keep = 1.0 - hard_skip
        skip = hard_skip + nprob.detach() - nprob
        keep = hard_keep + prob.detach() - prob
        en = self.enabled
        skip = skip * en
        keep = keep * en + (1.0 - en)
        self.skip_fraction = skip.detach().mean()
        return torch.cat([skip, keep], dim=-1)


def _jax_path(name: str) -> Path:
    """``blocks.3.moe_gate`` -> ``("blocks_3", "moe_gate")``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"blocks_{parts[1]}"] + parts[2:]
    return tuple(parts)


def gate_modules(model: nn.Module) -> typ.Dict[Path, TokenGate]:
    """{JAX path: gate}, in the order the JAX package walks its ``gates``
    collection (sorted keys at every level: ``blocks_10`` before
    ``blocks_2``)."""
    gates = {_jax_path(n): m for n, m in model.named_modules()
             if isinstance(m, TokenGate)}
    return {p: gates[p] for p in sorted(gates)}


def gate_paths(model: nn.Module) -> typ.List[Path]:
    return list(gate_modules(model))


def build_anneal_plan(model: nn.Module, epochs: int, warmup_epochs: int,
                      epoch_offset: float) -> typ.Dict[Path, tuple]:
    """Per-gate (delta, start_epoch): the i-th gate starts at ``warmup +
    i*offset`` and anneals from its current threshold to its target in
    ``epochs - warmup - i*offset`` steps."""
    plan = {}
    for i, (path, gate) in enumerate(gate_modules(model).items()):
        start = float(gate.threshold)
        target = float(gate.target_threshold)
        denom = epochs - warmup_epochs - epoch_offset * i
        delta = (start - target) / denom if denom > 0 else (start - target)
        plan[path] = (delta, warmup_epochs + epoch_offset * i)
    return plan


@torch.no_grad()
def set_enabled(model: nn.Module, path: Path, value: float) -> None:
    gate_modules(model)[path].enabled.fill_(value)


@torch.no_grad()
def anneal(model: nn.Module, path: Path, delta: float) -> None:
    """threshold <- max(threshold - delta, target), in f32."""
    gate = gate_modules(model)[path]
    gate.threshold.copy_(torch.maximum(gate.threshold - delta,
                                       gate.target_threshold))


def apply_epoch_anneal(model: nn.Module, plan: dict, epoch: int) -> None:
    """Enable and step every gate whose start epoch has arrived."""
    for path, (delta, start) in plan.items():
        if epoch >= start:
            set_enabled(model, path, 1.0)
            anneal(model, path, delta)


def disable_all(model: nn.Module) -> None:
    """Disable every gate (at a task's start)."""
    for path in gate_paths(model):
        set_enabled(model, path, 0.0)
