"""The (data, expert) layout of the ranks, and parameter sharding.

Port of ``slim_switch_moe_vit_tpu/parallel/sharding.py`` (:1-103). The JAX
package lays its devices out as one (data, expert) mesh and lets XLA insert
the collectives. Here each rank is one process, and :func:`make_mesh`
returns this rank's place in the same layout, with ``torch.distributed``
subgroups for the collectives:

- world = n_data x n_expert, and rank = data_index x n_expert +
  expert_index: the row-major order of the JAX ``make_mesh`` reshape (:31);
- ``data_group``: the ranks with this rank's expert index, one per data
  shard (the gradients are averaged over it);
- ``expert_group``: the ranks with this rank's data index, which hold the
  same batch and split the experts between them.

:func:`shard_params` keeps this rank's ``E / n_expert`` experts of every
expert tensor (the parameters whose JAX name contains ``expert``: the
port's ``w1``/``b1``/``w2``/``b2``) and replicates everything else, as the
JAX function places them (:84-103).

Not ported: ``constrain`` (``with_sharding_constraint``) has no meaning in
PyTorch, where no compiler places tensors: the expert-parallel forms of
``ops/moe.py`` move the rows themselves. ``batch_sharding`` and
``replicated`` have none either: each rank loads its own data shard
(``main.py``'s samplers).
"""
from __future__ import annotations

import dataclasses
import typing as typ

import torch
import torch.distributed as dist

DATA_AXIS = "data"
EXPERT_AXIS = "expert"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, expert) layout. The groups are None
    where the axis has one rank."""
    n_data: int
    n_expert: int
    data_index: int = 0
    expert_index: int = 0
    data_group: typ.Any = None
    expert_group: typ.Any = None

    @property
    def shape(self) -> typ.Dict[str, int]:
        return {DATA_AXIS: self.n_data, EXPERT_AXIS: self.n_expert}


def make_mesh(n_data: int = -1, n_expert: int = 1) -> Mesh:
    """This rank's (data, expert) layout over the initialized process group
    (one process: a 1 x 1 layout). ``n_data=-1`` takes all the ranks that
    the expert axis leaves. Every rank must call it, in the same order, as
    ``torch.distributed.new_group`` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_expert < 1 or world % n_expert:
        raise ValueError(f"{world} rank(s) do not split into expert groups "
                         f"of {n_expert}")
    if n_data == -1:
        n_data = world // n_expert
    if n_data * n_expert != world:
        raise ValueError(f"a {n_data} x {n_expert} (data, expert) layout "
                         f"needs {n_data * n_expert} ranks, not {world}")
    data_index, expert_index = divmod(rank, n_expert)
    data_group = expert_group = None
    if world > 1:
        for j in range(n_expert):
            group = dist.new_group([i * n_expert + j for i in range(n_data)])
            if j == expert_index and n_data > 1:
                data_group = group
        for i in range(n_data):
            group = dist.new_group([i * n_expert + j for j in range(n_expert)])
            if i == data_index and n_expert > 1:
                expert_group = group
    return Mesh(n_data, n_expert, data_index, expert_index, data_group,
                expert_group)


def mesh_axis_size(mesh: typ.Optional[Mesh], name: str) -> int:
    """Ranks along an axis of ``mesh``, 1 without one."""
    return 1 if mesh is None else mesh.shape[name]


def axis_index(mesh: typ.Optional[Mesh], name: str) -> int:
    """This rank's index along an axis (``jax.lax.axis_index``)."""
    if mesh is None:
        return 0
    return mesh.data_index if name == DATA_AXIS else mesh.expert_index


def is_expert_param(name: str) -> bool:
    """Whether the parameter's JAX name (``expert_fc{1,2}_{kernel,bias}``)
    contains ``expert``, as the JAX ``shard_params`` decides."""
    from ..utils.checkpoint import jax_path

    return any("expert" in part for part in jax_path(name))


def expert_slice(mesh: Mesh, n_experts: int) -> slice:
    """This rank's experts along an expert tensor's leading axis."""
    if n_experts % mesh.n_expert:
        raise ValueError(f"{n_experts} experts do not split over "
                         f"{mesh.n_expert} expert ranks")
    n = n_experts // mesh.n_expert
    return slice(mesh.expert_index * n, (mesh.expert_index + 1) * n)


@torch.no_grad()
def shard_params(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """In place: keep this rank's experts of every expert parameter and
    replicate the rest; every MoE MLP then runs the expert-parallel form of
    its dispatch mode over ``mesh``. Call before the optimizer and the EMA
    are built. Returns the model."""
    from ..models.moe import MoEMlp

    for name, p in model.named_parameters():
        if is_expert_param(name):
            p.data = p.data[expert_slice(mesh, p.shape[0])].clone()
    for m in model.modules():
        if isinstance(m, MoEMlp):
            m.set_mesh(mesh)
    return model
