"""The optimizer, in PyTorch: the ``adamw`` part of
``slim_switch_moe_vit_tpu/optim.py::make_optimizer`` (:567-673).

The JAX package's default chain (``scale_by_adam`` then
``add_decayed_weights`` on ``wd_mask``, times -lr per group) is AdamW's
decoupled update, p <- p - lr * (adam(g) + wd * p), which is what
``torch.optim.AdamW`` computes (the foreach form; not ``fused=True``: the
one-pass fused AdamW + EMA is a TPU kernel, K7, that a later slice writes by
hand for the card).

Parameters fall into four groups, weight decay or none by ``wd_mask``
crossed with the base or the gate learning rate by ``gate_mask``; each
update sets the groups' ``lr`` from ``lr_base`` / ``lr_gate``, as the JAX
update takes both as arguments. The masks read the JAX package's parameter
names (``utils/checkpoint.py::jax_path``): the port calls the expert biases
``b1`` / ``b2``, and only their JAX names (``expert_fc*_bias``) say they are
biases, which the JAX mask exempts from decay (optim.py:55).
"""
from __future__ import annotations

import typing as typ

import torch

from .utils.checkpoint import jax_path

NO_WEIGHT_DECAY_NAMES = {"pos_embed", "cls_token", "dist_token"}
GATE_MARKERS = ("moe_gate", "dense_gate")
SUPPORTED_OPTIMIZERS = ("adamw", "adam", "sgd", "nesterov", "momentum",
                        "lamb", "nadam", "radam", "adadelta", "rmsprop")


def wd_mask(named: typ.Iterable[typ.Tuple[str, torch.Tensor]]
            ) -> typ.Dict[str, bool]:
    """{name: True where weight decay applies}: timm's rule on the JAX
    names (ndim > 1, not in the no-decay set, no ``bias`` in the leaf)."""
    out = {}
    for name, p in named:
        path = jax_path(name)
        out[name] = (not any(n in NO_WEIGHT_DECAY_NAMES for n in path)
                     and "bias" not in path[-1] and p.dim() > 1)
    return out


def gate_mask(named: typ.Iterable[typ.Tuple[str, torch.Tensor]]
              ) -> typ.Dict[str, bool]:
    """{name: True for the gate parameters}, trained at ``lr_gate``."""
    return {name: any(m in n for n in jax_path(name) for m in GATE_MARKERS)
            for name, _ in named}


def make_optimizer(*, opt: str = "adamw",
                   weight_decay: float = 0.05,
                   betas: typ.Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, clip_grad: typ.Optional[float] = None):
    """Returns ``(init_fn, update_fn)`` as the JAX package does (which also
    takes the param tree first; here the groups come from the model given
    to ``init_fn``):
    ``init_fn(model)`` builds the optimizer over the model's parameters (on
    their device), ``update_fn(optimizer, lr_base, lr_gate)`` sets the
    groups' learning rates and applies one step to the gradients in
    ``p.grad``."""
    if opt not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f"--opt {opt!r} is not implemented; supported: "
                         f"{SUPPORTED_OPTIMIZERS}")
    if opt != "adamw":
        raise NotImplementedError(
            f"--opt {opt!r} is not ported yet (ROADMAP Queue 1 #6)")
    if clip_grad is not None and clip_grad > 0:
        raise NotImplementedError("clip_grad is not ported yet (ROADMAP "
                                  "Queue 1 #6)")

    def init_fn(model: torch.nn.Module) -> torch.optim.AdamW:
        named = list(model.named_parameters())
        decay, gate = wd_mask(named), gate_mask(named)
        groups = []
        for wd in (True, False):
            for is_gate in (False, True):
                params = [p for n, p in named
                          if decay[n] == wd and gate[n] == is_gate]
                if params:
                    groups.append({"params": params, "gate": is_gate,
                                   "weight_decay": weight_decay if wd else 0.0})
        return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps,
                                 foreach=True)

    def update_fn(optimizer: torch.optim.Optimizer, lr_base: float,
                  lr_gate: float) -> None:
        for group in optimizer.param_groups:
            group["lr"] = float(lr_gate if group["gate"] else lr_base)
        optimizer.step()

    return init_fn, update_fn
