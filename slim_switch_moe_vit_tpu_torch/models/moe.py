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
- ``'dense'``: every expert on every token, in f32 (plain oracle, the
  JAX ``parity_dense`` path: no expert dropout);
- ``'capacity'``: static per-expert buffers of ``compute_capacity`` slots
  filled by a scatter, token-major drop priority (plain PyTorch, the oracle
  of the fused form);
- ``'capacity_fused'``: the same drops and outputs through the counting-sort
  capacity layout and the expert-FFN kernels;
- ``'capacity_fused_a2a'``: ``'capacity_fused'`` on one card, the
  all-to-all form under an expert group;
- ``'expert_choice'``: each expert picks its top-C tokens (Zhou et al.
  2022; plain PyTorch, as the JAX package computes it).

Under a (data, expert) layout (``parallel.shard_params`` calls
:meth:`MoEMlp.set_mesh` and keeps this rank's ``E / ep`` experts), the
modes run their expert-parallel forms (JAX :94-150 and GSPMD):
``'capacity_fused'`` the psum form (``ops/moe.py::moe_forward_fused_ep``),
``'capacity_fused_a2a'`` the all-to-all form (``moe_forward_fused_ep_a2a``),
``'capacity'`` the sharded scatter-buffer form (``moe_forward_sharded``),
``'expert_choice'`` the same sharded buffer, and the dropless modes gather
the experts over the group (``moe_forward_gathered``) and run unchanged on
every rank, as XLA replicates a Pallas call's inputs in the JAX package.

The capacity factor is ``capacity_factor`` in training mode and
``eval_capacity_factor`` otherwise (JAX :92). An odd hidden size sends
``'fused'`` to ``'ragged'`` and the fused capacity modes to ``'capacity'``
(JAX :99-102), and so does expert dropout (``drop`` > 0, in training):
the fused kernels have no dropout path. The dropout mask over the hidden
activations is drawn by ``ops/moe.py::expert_dropout_mask``.

Each forward keeps its dispatch's aux (``balance_loss``, ``drop_fraction``)
in ``self.aux``, the last value per block as the JAX module's ``sow`` keeps
it (:151-153), for the engine to collect.
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from ..ops import moe as moe_ops
from .layers import trunc_normal_

_MODES = {"fused": moe_ops.moe_forward_fused,
          "ragged": moe_ops.moe_forward_ragged,
          "dense": moe_ops.moe_dense,
          "capacity": moe_ops.moe_forward,
          "capacity_fused": moe_ops.moe_forward_fused,
          "capacity_fused_a2a": moe_ops.moe_forward_fused,
          "expert_choice": moe_ops.moe_forward_expert_choice}
_CAPACITY_MODES = ("capacity", "capacity_fused", "capacity_fused_a2a")
_FUSED_MODES = ("fused", "capacity_fused", "capacity_fused_a2a")
_EP_MODES = {"capacity": moe_ops.moe_forward_sharded,
             "capacity_fused": moe_ops.moe_forward_fused_ep,
             "capacity_fused_a2a": moe_ops.moe_forward_fused_ep_a2a,
             "expert_choice": moe_ops.moe_forward_expert_choice,
             "fused": functools.partial(moe_ops.moe_forward_gathered,
                                        dispatch=moe_ops.moe_forward_fused),
             "ragged": functools.partial(moe_ops.moe_forward_gathered,
                                         dispatch=moe_ops.moe_forward_ragged),
             "dense": functools.partial(moe_ops.moe_forward_gathered,
                                        dispatch=moe_ops.moe_dense)}
_DROPLESS_MODES = ("fused", "ragged", "dense")


class MoEMlp(nn.Module):
    def __init__(self, dim: int, hidden_features: int, num_experts: int = 8,
                 top_k: int = 2, drop: float = 0.0,
                 dispatch_mode: str = "auto", capacity_factor: float = 2.0,
                 eval_capacity_factor: float = 2.0):
        super().__init__()
        mode = "fused" if dispatch_mode == "auto" else dispatch_mode
        if mode not in _MODES:
            raise ValueError(f"unknown dispatch_mode '{dispatch_mode}'; "
                             f"supported: auto, {', '.join(_MODES)}")
        if hidden_features % 2 and mode in _FUSED_MODES:
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
        this rank's slice. The dropless modes need it only under an expert
        group larger than 1."""
        if self.mode in _DROPLESS_MODES and mesh.n_expert == 1:
            return
        self.mesh = mesh

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.router_weight, self.w1, self.w2):
            trunc_normal_(p, generator)
        for p in (self.router_bias, self.b1, self.b2):
            nn.init.zeros_(p)

    def dispatch(self) -> str:
        """The mode this forward runs: under expert dropout in training the
        fused forms, which have no dropout path, give way to ``'ragged'``
        (dropless) and ``'capacity'`` (the fused capacity modes), as the
        JAX module decides (:95-102)."""
        if self.training and self.drop > 0.0 and self.mode in _FUSED_MODES:
            return "ragged" if self.mode == "fused" else "capacity"
        return self.mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, d = x.shape
        mode = self.dispatch()
        kw, fn = {}, _MODES[mode]
        if mode in _CAPACITY_MODES or mode == "expert_choice":
            kw["capacity_factor"] = (self.capacity_factor if self.training
                                     else self.eval_capacity_factor)
        if mode != "expert_choice":
            kw["top_k"] = self.top_k
        if self.training and self.drop > 0.0 and mode != "dense":
            kw["drop_rate"] = self.drop
        if self.mesh is not None:
            fn, kw["mesh"] = _EP_MODES[mode], self.mesh
        y, self.aux = fn(x.reshape(B * N, d), self.router_weight,
                         self.router_bias, self.w1, self.b1, self.w2, self.b2,
                         **kw)
        return y.reshape(B, N, d)
