"""Train state, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/train_state.py``. The JAX package threads
one functional pytree through its jitted step; here the state holds the
mutable training objects, updated in place by the step: the model (f32
parameters), its optimizer, the EMA copy of the parameters, an explicit
``torch.Generator`` on the model's device (stochastic depth draws from it,
never from the global generator) and the step count.
"""
from __future__ import annotations

import dataclasses
import typing as typ

import torch

from .utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: typ.Optional[torch.optim.Optimizer]
    ema_params: typ.Optional[typ.Dict[str, torch.Tensor]]
    generator: torch.Generator
    step: int = 0


def create_train_state(model: torch.nn.Module, *, device: str = "cuda",
                       seed: int = 0,
                       opt_init: typ.Optional[typ.Callable] = None,
                       use_ema: bool = False) -> TrainState:
    """Move ``model`` to ``device`` (raises when CUDA is asked for and
    unavailable), build its optimizer with ``opt_init(model)`` and, with
    ``use_ema``, an EMA copy of its parameters."""
    platform = resolve_device(device)
    model.to(platform)
    optimizer = opt_init(model) if opt_init is not None else None
    ema = ({n: p.detach().clone() for n, p in model.named_parameters()}
           if use_ema else None)
    generator = torch.Generator(device=platform).manual_seed(seed)
    return TrainState(model=model, optimizer=optimizer, ema_params=ema,
                      generator=generator)
