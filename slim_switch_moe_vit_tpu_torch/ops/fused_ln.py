"""Residual-add + LayerNorm, forward and backward, for the H100 (K1a, K1b,
K2a, K1c, K2b).

Replaces five Pallas kernels of ``slim_switch_moe_vit_tpu/ops/fused_ln.py``:

- ``_fwd_kernel_noadd`` (:123) behind ``fused_ln`` (:244): y = LN(x);
- ``_fwd_kernel_add`` (:117) behind ``fused_add_ln`` (:214): u = x + r,
  y = LN(u), both written;
- ``_fwd_kernel_slim`` (:268) behind ``fused_sum_ln`` (:316): y = LN(a + b),
  the sum never written;
- ``_bwd_kernel`` (:159) behind ``_bwd`` (:191), the backward of the first
  two (``_ln_bwd`` :253 and ``_add_ln_bwd`` :232, the latter with the
  stream's own cotangent du_out added);
- ``_bwd_kernel_slim`` (:273) behind ``_sum_ln_bwd`` (:326), the backward of
  the third, recomputing a + b.

Triton kernels (``_fused_ln_triton.py``): one forward with ``HAS_RESIDUAL``
and ``WRITE_SUM`` as compile-time flags, one backward with ``HAS_B`` and
``HAS_DU_OUT``. Triton is enough here: a row normalisation is one reduction
and one elementwise pass, and its backward adds a column reduction.

What bounds them on the H100: device-memory bytes. At D=384 a bf16 row is
768 bytes and the kernels do ~10 FLOP per element, far below the card's
~295 FLOP per byte, so the design is to move each byte once. The forward
takes one row per program with the row in registers between the two
reductions. The backward takes a run of rows per program (about four
programs per SM), recomputes the statistics from u, writes du once, and
sums dgamma/dbeta over its rows in f32 registers; one f32 row of partials
per program then goes through a second Triton pass that adds them in a
fixed order (deterministic, no atomics).

Math, as the JAX kernels: the residual sum is rounded to the activation
dtype first; statistics in f32 with eps inside the rsqrt; gamma and beta
applied in f32; y cast to the input dtype. Backward: dy (and du_out) cast
to u's dtype before the kernel, du rounded once to u's dtype, dgamma and
dbeta in f32.

Dispatch: a CPU tensor takes the plain versions (:func:`reference_add_ln`,
:func:`reference_ln_bwd`); a CUDA tensor launches the kernels or raises.
The autograd Functions save what the JAX VJPs save: (x, gamma), (u, gamma)
and (a, b, gamma).
"""
from __future__ import annotations

import typing as typ

import torch

from ._checks import check_tensor

BWD_BLOCK_R = 4  # rows per step of a backward program


def reference_add_ln(x: torch.Tensor, r: typ.Optional[torch.Tensor],
                     gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-6):
    """Plain version: (u, y) = (x + r, LN(x + r) * gamma + beta); with
    ``r=None``, u = x."""
    u = x + r if r is not None else x
    u32 = u.float()
    mean = u32.mean(-1, keepdim=True)
    d = u32 - mean
    var = (d * d).mean(-1, keepdim=True)
    y = d * torch.rsqrt(var + eps) * gamma + beta
    return u, y.to(x.dtype)


def reference_ln_bwd(u: torch.Tensor, dy: torch.Tensor,
                     du_out: typ.Optional[torch.Tensor], gamma: torch.Tensor,
                     eps: float = 1e-6):
    """Plain version of the backward, step by step as the JAX kernel:
    returns (du in u's dtype, dgamma f32, dbeta f32)."""
    u32 = u.float()
    dy = dy.to(u.dtype).float()
    mean = u32.mean(-1, keepdim=True)
    d = u32 - mean
    var = (d * d).mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    xhat = d * rstd
    dyg = dy * gamma.float()
    m1 = dyg.mean(-1, keepdim=True)
    m2 = (dyg * xhat).mean(-1, keepdim=True)
    du = (dyg - m1 - xhat * m2) * rstd
    if du_out is not None:
        du = du + du_out.to(u.dtype).float()
    D = u.shape[-1]
    dg = (dy * xhat).reshape(-1, D).sum(0)
    db = dy.reshape(-1, D).sum(0)
    return du.to(u.dtype), dg, db


def _check_rows(x, others, gamma, beta=None):
    check_tensor(x, "x", (torch.bfloat16, torch.float32))
    if x.dim() < 2:
        raise ValueError(f"x must be (..., D), got {tuple(x.shape)}")
    D = x.shape[-1]
    for name, t in others:
        if t is not None:
            check_tensor(t, name, (x.dtype,), device=x.device, shape=x.shape)
    check_tensor(gamma, "gamma", (torch.float32,), device=x.device, shape=(D,))
    if beta is not None:
        check_tensor(beta, "beta", (torch.float32,), device=x.device,
                     shape=(D,))
    return D, x.numel() // D, 1 << (D - 1).bit_length()


def _launch_fwd(x, r, gamma, beta, eps, write_sum):
    from ._fused_ln_triton import ln_fwd_kernel  # needs Triton

    D, rows, block = _check_rows(x, [("r", r)], gamma, beta)
    y = torch.empty_like(x)
    u = torch.empty_like(x) if write_sum else y
    ln_fwd_kernel[(rows,)](x, x if r is None else r, u, y, gamma, beta, D,
                           eps, HAS_RESIDUAL=r is not None,
                           WRITE_SUM=write_sum, BLOCK_D=block, num_warps=4)
    return u, y


def _launch_bwd(a, b, dy, du_out, gamma, eps):
    from ._fused_ln_triton import col_sum_kernel, ln_bwd_kernel

    D, rows, block = _check_rows(a, [("b", b), ("dy", dy), ("du_out", du_out)],
                                 gamma)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    per_prog = -(-rows // (4 * sms))
    per_prog = -(-per_prog // BWD_BLOCK_R) * BWD_BLOCK_R
    progs = -(-rows // per_prog)
    du = torch.empty_like(a)
    part = torch.empty((progs, 2 * D), dtype=torch.float32, device=a.device)
    ln_bwd_kernel[(progs,)](
        a, a if b is None else b, dy, a if du_out is None else du_out, du,
        gamma, part, rows, D, per_prog, eps, HAS_B=b is not None,
        HAS_DU_OUT=du_out is not None, BLOCK_R=BWD_BLOCK_R, BLOCK_D=block,
        num_warps=4)
    sums = torch.empty(2 * D, dtype=torch.float32, device=a.device)
    col_sum_kernel[(-(-2 * D // 128),)](part, sums, progs, 2 * D, BLOCK_P=32,
                                        BLOCK_C=128, num_warps=4)
    return du, sums[:D], sums[D:]


def fused_ln_bwd(x, dy, gamma, eps: float = 1e-6):
    """(dx, dgamma, dbeta) of y = LN(x) (K1c, plain form)."""
    if not x.is_cuda:
        return reference_ln_bwd(x, dy, None, gamma, eps)
    out = _launch_bwd(x, None, dy, None, gamma, eps)
    fused_ln_bwd.launches += 1
    return out


def fused_add_ln_bwd(u, dy, du_out, gamma, eps: float = 1e-6):
    """(du, dgamma, dbeta) of (u, y) = (x + r, LN(x + r)) (K1c, add form);
    du includes the stream's own cotangent du_out."""
    if not u.is_cuda:
        return reference_ln_bwd(u, dy, du_out, gamma, eps)
    out = _launch_bwd(u, None, dy, du_out, gamma, eps)
    fused_add_ln_bwd.launches += 1
    return out


def fused_sum_ln_bwd(a, b, dy, gamma, eps: float = 1e-6):
    """(du, dgamma, dbeta) of y = LN(a + b), the sum recomputed (K2b)."""
    if not a.is_cuda:
        return reference_ln_bwd(a + b, dy, None, gamma, eps)
    out = _launch_bwd(a, b, dy, None, gamma, eps)
    fused_sum_ln_bwd.launches += 1
    return out


def _cot(t, like):
    """A cotangent in the activation dtype, contiguous, as the kernels take
    it."""
    return t.to(like.dtype).contiguous()


class _FusedLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, gamma)
        if not x.is_cuda:
            return reference_add_ln(x, None, gamma, beta, eps)[1]
        _, y = _launch_fwd(x, None, gamma, beta, eps, write_sum=False)
        fused_ln.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        dx, dg, db = fused_ln_bwd(x, _cot(dy, x), gamma, ctx.eps)
        return dx, dg, db, None


class _FusedAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, gamma, beta, eps):
        if not x.is_cuda:
            u, y = reference_add_ln(x, r, gamma, beta, eps)
        else:
            u, y = _launch_fwd(x, r, gamma, beta, eps, write_sum=True)
            fused_add_ln.launches += 1
        ctx.eps = eps
        ctx.save_for_backward(u, gamma)
        return u, y

    @staticmethod
    def backward(ctx, du_out, dy):
        u, gamma = ctx.saved_tensors
        du, dg, db = fused_add_ln_bwd(u, _cot(dy, u), _cot(du_out, u), gamma,
                                      ctx.eps)
        return du, du, dg, db, None


class _FusedSumLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, gamma, beta, eps):
        ctx.eps = eps
        ctx.save_for_backward(a, b, gamma)
        if not a.is_cuda:
            return reference_add_ln(a, b, gamma, beta, eps)[1]
        _, y = _launch_fwd(a, b, gamma, beta, eps, write_sum=False)
        fused_sum_ln.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        a, b, gamma = ctx.saved_tensors
        du, dg, db = fused_sum_ln_bwd(a, b, _cot(dy, a), gamma, ctx.eps)
        return du, du, dg, db, None


def fused_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = LayerNorm(x) * gamma + beta (no residual add)."""
    return _FusedLN.apply(x, gamma, beta, eps)


def fused_add_ln(x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-6):
    """(u, y) = (x + r, LayerNorm(x + r) * gamma + beta)."""
    return _FusedAddLN.apply(x, r, gamma, beta, eps)


def fused_sum_ln(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = LayerNorm(a + b) * gamma + beta; the sum is never written."""
    return _FusedSumLN.apply(a, b, gamma, beta, eps)


for _fn in (fused_ln, fused_add_ln, fused_sum_ln, fused_ln_bwd,
            fused_add_ln_bwd, fused_sum_ln_bwd):
    _fn.launches = 0
