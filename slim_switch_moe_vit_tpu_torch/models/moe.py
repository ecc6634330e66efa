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
- ``'dense'``: every expert on every token, in f32 (plain oracle);
- ``'capacity'``: static per-expert buffers of ``compute_capacity`` slots
  filled by a scatter, token-major drop priority (plain PyTorch, the oracle
  of the fused form);
- ``'capacity_fused'``: the same drops and outputs through the counting-sort
  capacity layout and the expert-FFN kernels;
- ``'capacity_fused_a2a'``: ``'capacity_fused'`` on one card, the
  all-to-all form under an expert group.

Under a (data, expert) layout (``parallel.shard_params`` calls
:meth:`MoEMlp.set_mesh` and keeps this rank's ``E / ep`` experts), the
capacity modes run their expert-parallel forms (JAX :94-150):
``'capacity_fused'`` the psum form (``ops/moe.py::moe_forward_fused_ep``),
``'capacity_fused_a2a'`` the all-to-all form (``moe_forward_fused_ep_a2a``)
and ``'capacity'`` the sharded scatter-buffer form
(``moe_forward_sharded``). The dropless modes need every expert on every
rank and raise under an expert group larger than 1.

The capacity factor is ``capacity_factor`` in training mode and
``eval_capacity_factor`` otherwise (JAX :92). An odd hidden size sends
``'fused'`` to ``'ragged'`` and the fused capacity modes to ``'capacity'``
(JAX :99-102). ``expert_choice`` and expert dropout are not ported yet and
raise.

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
          "dense": moe_ops.moe_dense,
          "capacity": moe_ops.moe_forward,
          "capacity_fused": moe_ops.moe_forward_fused,
          "capacity_fused_a2a": moe_ops.moe_forward_fused}
_CAPACITY_MODES = ("capacity", "capacity_fused", "capacity_fused_a2a")
_EP_MODES = {"capacity": moe_ops.moe_forward_sharded,
             "capacity_fused": moe_ops.moe_forward_fused_ep,
             "capacity_fused_a2a": moe_ops.moe_forward_fused_ep_a2a}


class MoEMlp(nn.Module):
    def __init__(self, dim: int, hidden_features: int, num_experts: int = 8,
                 top_k: int = 2, drop: float = 0.0,
                 dispatch_mode: str = "auto", capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 2.0):
        super().__init__()
        mode = "fused" if dispatch_mode == "auto" else dispatch_mode
        if mode not in _MODES:
            raise NotImplementedError(
                f"dispatch_mode '{dispatch_mode}' is not ported yet (ROADMAP "
                "Queue 1 #8: expert_choice with the extras)")
        if hidden_features % 2 and _MODES[mode] is moe_ops.moe_forward_fused:
            # the fused kernels take an even hidden size only (JAX :99-102)
            mode = "ragged" if mode == "fused" else "capacity"
        self.mode = mode
        self.top_k = top_k
        self.drop = drop
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        E, d, h = num_experts, dim, hidden_features
        self.router_weight = nn.Parameter(torch.empty(d, E))
        self.router_bias = nn.Parameter(torch.zeros(E))
        self.w1 = nn.Parameter(torch.empty(E, d, h))
        self.b1 = nn.Parameter(torch.zeros(E, h))
        self.w2 = nn.Parameter(torch.empty(E, h, d))
        self.b2 = nn.Parameter(torch.zeros(E, d))
        self.aux = None
        self.mesh = None

    def set_mesh(self, mesh) -> None:
        """Run the expert-parallel form of this module's dispatch mode over
        ``mesh`` (``parallel.Mesh``); the expert parameters must already be
        this rank's slice."""
        if self.mode not in _EP_MODES:
            if mesh.n_expert > 1:
                raise NotImplementedError(
                    f"dispatch_mode '{self.mode}' under expert parallelism: "
                    "the dropless modes need every expert on every rank; "
                    "use 'capacity', 'capacity_fused' or "
                    "'capacity_fused_a2a'")
            return
        self.mesh = mesh

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.router_weight, self.w1, self.w2):
            trunc_normal_(p, generator)
        for p in (self.router_bias, self.b1, self.b2):
            nn.init.zeros_(p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.drop > 0.0:
            raise NotImplementedError(
                "expert dropout: the fused dispatch has no dropout path and "
                "the ragged and capacity ones' are not ported yet (ROADMAP "
                "Queue 1 #8)")
        B, N, d = x.shape
        kw, fn = {}, _MODES[self.mode]
        if self.mode in _CAPACITY_MODES:
            kw["capacity_factor"] = (self.capacity_factor if self.training
                                     else self.eval_capacity_factor)
        if self.mesh is not None:
            fn, kw["mesh"] = _EP_MODES[self.mode], self.mesh
        y, self.aux = fn(x.reshape(B * N, d), self.router_weight,
                         self.router_bias, self.w1, self.b1, self.w2, self.b2,
                         top_k=self.top_k, **kw)
        return y.reshape(B, N, d)
