"""Row gather and row scatter-add (K13), for the H100.

Replaces the two Pallas kernels of
``slim_switch_moe_vit_tpu/ops/gather_pallas.py``: ``_gather_kernel`` (:43)
behind ``_gather_impl`` (:117) and ``gather_rows`` (:161), and
``_scatter_add_kernel`` (:72) behind ``_scatter_add_impl`` (:144) and
``scatter_add_rows`` (:179). The CUDA C++ kernels are
``csrc/gather_rows.cu``; its header note says what bounds them and how
they differ from the TPU kernels.

As in the JAX package these are ops that no model path calls (the JAX
module is quarantined there, slower than XLA's row ops on the TPU): each is
differentiable, the other's backward (``custom_vjp`` :161-193).

- ``gather_rows(x, idx)``: out[i] = x[idx[i]], idx in [0, N).
- ``scatter_add_rows(g, idx, num_rows)``: out[r] = sum of g[i] over
  idx[i] = r, over zeros((num_rows, D)). Deterministic: the wrapper sorts
  idx stably into a CSR of destination -> sources (index preparation, as
  the JAX wrapper's padding is), and the kernels sum each row's sources in
  index order in f32 and round once. In f32 that is ``np.add.at`` bit for
  bit; in bf16 the JAX kernel rounds after every add, a divergence by design
  (``tests/test_torch_gather.py`` bounds it). Indices outside
  [0, num_rows) add nowhere. Rows of at most :data:`LONG_ROW` sources are
  summed a warp each, several rows a warp; longer rows (the dropless
  layout's padding slots all name one token, ~2,000 sources) a block each,
  their sources streamed through a ``cp.async`` ring in shared memory, so
  the loads run in parallel while the adds keep index order.

Dispatch: a CPU tensor takes the plain versions
(:func:`reference_gather_rows`, :func:`reference_scatter_add_rows`); a CUDA
tensor launches the kernels or raises.
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import check_tensor

INDEX_DTYPES = (torch.int32, torch.int64)
DTYPES = (torch.bfloat16, torch.float32)
# rows of more sources than this take the scatter-add's long-row kernel
LONG_ROW = 64


def reference_gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: ``x.index_select(0, idx)``."""
    return x.index_select(0, idx.long())


def scatter_plan(idx: torch.Tensor, num_rows: int) -> tuple:
    """(order, row_ptr): the sources sorted stably by destination, and the
    start of each destination's run (num_rows + 1 entries, int64). Entries
    outside [0, num_rows) fall before row 0's run or after the last's: the
    keys are clamped to [-1, num_rows], which keeps that order and lets
    them sort as int32 (half the radix passes of int64)."""
    dt = torch.int32 if num_rows < 2 ** 31 - 1 else torch.int64
    dest, order = torch.sort(idx.clamp(-1, num_rows).to(dt), stable=True)
    bounds = torch.arange(num_rows + 1, device=idx.device, dtype=dt)
    return order, torch.searchsorted(dest, bounds)


def reference_scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                               num_rows: int) -> torch.Tensor:
    """Plain version of the scatter-add, the kernel's function: each row's
    sources added in index order in f32 (one ``index_add_`` per rank of a
    source within its row, so no row takes two adds in one call), then
    rounded once to g's dtype."""
    order, row_ptr = scatter_plan(idx, num_rows)
    dest = idx.long()[order]
    rank = (torch.arange(order.shape[0], device=g.device)
            - row_ptr[dest.clamp(0, num_rows)])
    inside = (dest >= 0) & (dest < num_rows)
    order, dest, rank = order[inside], dest[inside], rank[inside]
    acc = torch.zeros((num_rows, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    for r in range(int(rank.max().item()) + 1 if rank.numel() else 0):
        sel = rank == r
        acc.index_add_(0, dest[sel], g.index_select(0, order[sel]).float())
    return acc.to(g.dtype)


def _gather(x, idx):
    if not x.is_cuda:
        return reference_gather_rows(x, idx)
    check_tensor(x, "x", DTYPES)
    check_tensor(idx, "idx", INDEX_DTYPES, device=x.device)
    if x.dim() != 2 or idx.dim() != 1 or idx.shape[0] < 1:
        raise ValueError(f"x must be (N, D) and idx (M,), M >= 1, got "
                         f"{tuple(x.shape)} and {tuple(idx.shape)}")
    M, D = idx.shape[0], x.shape[1]
    out = torch.empty((M, D), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    err = lib.ssmv_gather_rows(x.data_ptr(), idx.data_ptr(),
                               int(idx.dtype == torch.int64), out.data_ptr(),
                               M, D, x.element_size(),
                               torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gather_rows")
    gather_rows.launches += 1
    return out


def _scatter_add(g, idx, num_rows):
    if not g.is_cuda:
        return reference_scatter_add_rows(g, idx, num_rows)
    check_tensor(g, "g", DTYPES)
    check_tensor(idx, "idx", INDEX_DTYPES, device=g.device)
    if g.dim() != 2 or idx.shape != (g.shape[0],) or num_rows < 1:
        raise ValueError(f"g must be (M, D), idx (M,) and num_rows >= 1, got "
                         f"{tuple(g.shape)}, {tuple(idx.shape)}, {num_rows}")
    order, row_ptr = scatter_plan(idx, num_rows)
    out = torch.empty((num_rows, g.shape[1]), dtype=g.dtype, device=g.device)
    lib = _build.load_library()
    err = lib.ssmv_scatter_add_rows(g.data_ptr(), order.data_ptr(),
                                    row_ptr.data_ptr(), out.data_ptr(),
                                    num_rows, g.shape[1], LONG_ROW,
                                    int(g.dtype == torch.bfloat16),
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(err, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.num_rows = x.shape[0]
        ctx.save_for_backward(idx)
        return _gather(x, idx)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return _scatter_add(dout.contiguous(), idx, ctx.num_rows), None


class _ScatterAddRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, idx, num_rows):
        ctx.save_for_backward(idx)
        return _scatter_add(g, idx, num_rows)

    @staticmethod
    def backward(ctx, dout):
        (idx,) = ctx.saved_tensors
        return _gather(dout.contiguous(), idx), None, None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]] (K13 gather); differentiable in x, its backward
    the scatter-add.

    Args:
        x: (N, D), bf16 or f32 on the card.
        idx: (M,) int32 or int64, each in [0, N).
    Returns:
        (M, D) in x's dtype.
    """
    return _GatherRows.apply(x, idx)


def scatter_add_rows(g: torch.Tensor, idx: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """out[idx[i]] += g[i] over zeros((num_rows, D)) (K13 scatter-add), in
    index order with f32 sums; differentiable in g, its backward the
    gather.

    Args:
        g: (M, D), bf16 or f32 on the card.
        idx: (M,) int32 or int64.
        num_rows: rows of the output.
    Returns:
        (num_rows, D) in g's dtype.
    """
    return _ScatterAddRows.apply(g, idx, num_rows)


gather_rows.launches = 0
scatter_add_rows.launches = 0
