"""MoE MLP module (the reference's ``CustomizedMoEMLP``), in PyTorch.

Port of ``MoEMlp`` of ``slim_switch_moe_vit_tpu/models/moe.py`` (:25-154):
a linear router and expert-major FFN parameters (router (d, E), fc1 (E, d,
h) / (E, h), fc2 (E, h, d) / (E, d), all f32), dispatched by
``ops/moe.py``. It computes in its input's dtype.

``dispatch_mode``:

- ``'auto'``: ``'fused'`` on every device;
- ``'fused'``: dropless counting-sort layout + the expert-FFN kernel
  (``ops/fused_ffn.py``), the serving path;
- ``'ragged'``: dropless, one GEMM pair per expert group (plain oracle);
- ``'dense'``: every expert on every token, in f32 (plain oracle).

The capacity, capacity_fused(_a2a) and expert_choice modes are not ported
yet and raise.

Each forward keeps its dispatch's aux (``balance_loss``, ``drop_fraction``)
in ``self.aux``, the last value per block as the JAX module's ``sow`` keeps
it (:151-153), for the engine to collect.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops import moe as moe_ops
from .layers import trunc_normal_

_MODES = {"fused": moe_ops.moe_forward_fused,
          "ragged": moe_ops.moe_forward_ragged,
          "dense": moe_ops.moe_dense}


class MoEMlp(nn.Module):
    def __init__(self, dim: int, hidden_features: int, num_experts: int = 8,
                 top_k: int = 2, drop: float = 0.0,
                 dispatch_mode: str = "auto"):
        super().__init__()
        mode = "fused" if dispatch_mode == "auto" else dispatch_mode
        if mode not in _MODES:
            raise NotImplementedError(
                f"dispatch_mode '{dispatch_mode}' is not ported yet (ROADMAP "
                "Queue 1: capacity dispatch; expert_choice with the extras)")
        self.mode = mode
        self.top_k = top_k
        self.drop = drop
        E, d, h = num_experts, dim, hidden_features
        self.router_weight = nn.Parameter(torch.empty(d, E))
        self.router_bias = nn.Parameter(torch.zeros(E))
        self.w1 = nn.Parameter(torch.empty(E, d, h))
        self.b1 = nn.Parameter(torch.zeros(E, h))
        self.w2 = nn.Parameter(torch.empty(E, h, d))
        self.b2 = nn.Parameter(torch.zeros(E, d))
        self.aux = None

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.router_weight, self.w1, self.w2):
            trunc_normal_(p, generator)
        for p in (self.router_bias, self.b1, self.b2):
            nn.init.zeros_(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.drop > 0.0:
            raise NotImplementedError(
                "expert dropout: the fused dispatch has no dropout path and "
                "the ragged one's is not ported yet (ROADMAP)")
        B, N, d = x.shape
        y, self.aux = _MODES[self.mode](x.reshape(B * N, d), self.router_weight,
                              self.router_bias, self.w1, self.b1, self.w2,
                              self.b2, top_k=self.top_k)
        return y.reshape(B, N, d)
