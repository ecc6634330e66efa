"""Model registry: ``create_model(name, **kwargs)`` by string name.

Port of ``slim_switch_moe_vit_tpu/models/registry.py``: a plain dict of
constructor functions, no timm.
"""
from __future__ import annotations

import typing as typ

import torch

_REGISTRY: typ.Dict[str, typ.Callable] = {}


def register_model(fn: typ.Callable) -> typ.Callable:
    _REGISTRY[fn.__name__] = fn
    return fn


def create_model(name: str, *, generator: typ.Optional[torch.Generator] = None,
                 **kwargs) -> torch.nn.Module:
    """Build a registered model on the CPU with random weights.

    The weights are drawn from ``generator`` (a CPU generator; a fresh one
    seeded with 0 when None), as the JAX package draws them at ``init``:
    trunc-normal(0.02) for linear weights and tokens, zero biases, unit
    LayerNorm scales. Move the model with ``.to(device)``.
    """
    if name not in _REGISTRY:
        raise ValueError(f"Unknown model '{name}'. Available: {sorted(_REGISTRY)}")
    model = _REGISTRY[name](**kwargs)
    model.init_weights(generator if generator is not None
                       else torch.Generator().manual_seed(0))
    return model


def list_models() -> typ.List[str]:
    return sorted(_REGISTRY)
