"""Collectives of the expert-parallel forms, as autograd Functions whose
backwards suit a loss that every rank of the group computes in full.

Inside an expert group every rank holds the same batch and computes the
same loss from it (the JAX ``shard_map`` forms' replicated output). So the
cotangent of a replicated value is the same on every rank, and a partial
contribution to a replicated input's gradient must be summed over the
group. ``torch.distributed.nn.functional``'s autograd would sum the
cotangents of an all-reduce or an all-gather instead, multiplying the
gradients by the group's size. Here:

- :func:`psum`: the sum over the group; backward the identity;
- :func:`sum_grad`: the identity; backward the sum over the group (where a
  replicated input enters a rank's partial computation);
- :func:`all_gather_rows` / :func:`chunk_rows`: the concatenation of the
  group's row blocks / this rank's block of replicated rows; each one's
  backward is the other's forward (the rank's slice of the cotangent /
  the gathered cotangents);
- :func:`all_to_all`: the equal-split row exchange; backward the same
  exchange of the cotangent;
- :func:`gather_rows_sum_grad`: the concatenation of the group's row
  blocks, backward the sum of the cotangents over the group, then this
  rank's slice (for a function of the whole data-parallel batch whose
  per-rank losses are averaged);
- :func:`mean_value`: the group mean of a scalar, backward the cotangent
  times ``grad_scale`` (1 over the data group, whose gradients the train
  step averages; 1 / group size over an expert group, whose gradients
  :func:`sum_grad` sums).

Each is the identity where the group is None (an axis of one rank). The
sums run in f32 and round once to the input's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    out = t.to(torch.float32, memory_format=torch.contiguous_format,
               copy=True)
    dist.all_reduce(out, group=group)
    return out.to(t.dtype)


def gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks concatenated, in group rank order (no
    autograd)."""
    t = t.contiguous()
    out = t.new_empty((group_size(group) * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out


def _block(t: torch.Tensor, group) -> torch.Tensor:
    n = t.shape[0] // group_size(group)
    r = group_rank(group)
    return t[r * n:(r + 1) * n].contiguous()


def _exchange(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.group), None


class _ChunkRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _block(x, group)

    @staticmethod
    def backward(ctx, g):
        return gather_rows(g, ctx.group), None


class _GatherRowsSumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return gather_rows(x, group)

    @staticmethod
    def backward(ctx, g):
        return _block(_all_reduce_sum(g, ctx.group), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


class _MeanValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, grad_scale):
        ctx.grad_scale = grad_scale
        return _all_reduce_sum(x, group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _Psum.apply(x, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _SumGrad.apply(x, group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllGatherRows.apply(x, group)


def chunk_rows(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _ChunkRows.apply(x, group)


def gather_rows_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _GatherRowsSumGrad.apply(x, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    return x if group is None else _AllToAll.apply(x, group)


def mean_value(x: torch.Tensor, group, grad_scale: float) -> torch.Tensor:
    return x if group is None else _MeanValue.apply(x, group, grad_scale)


@torch.no_grad()
def average_gradients(params, group) -> None:
    """In place: each gradient becomes its mean over ``group`` (one f32
    all-reduce over the flattened gradients). Parameters without a gradient
    are skipped; every rank must hold the same set."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= group_size(group)
    offset = 0
    for g in grads:
        n = g.numel()
        g.copy_(flat[offset:offset + n].view_as(g))
        offset += n
