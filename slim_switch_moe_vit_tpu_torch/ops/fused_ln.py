"""Residual-add + LayerNorm forwards for the H100 (K1a, K1b, K2a).

Replaces three Pallas kernels of ``slim_switch_moe_vit_tpu/ops/fused_ln.py``:

- ``_fwd_kernel_noadd`` (:123) behind ``fused_ln`` (:244): y = LN(x);
- ``_fwd_kernel_add`` (:117) behind ``fused_add_ln`` (:214): u = x + r,
  y = LN(u), both written;
- ``_fwd_kernel_slim`` (:268) behind ``fused_sum_ln`` (:316): y = LN(a + b),
  the sum never written.

One Triton kernel (``_fused_ln_triton.py``) covers the three, with
``HAS_RESIDUAL`` and ``WRITE_SUM`` as compile-time flags. Triton is enough
here: a row normalisation is one reduction and one elementwise pass.

What bounds it on the H100: device-memory bytes. At D=384 a bf16 row is 768
bytes and the kernel does ~10 FLOP per element, far below the card's ~295
FLOP per byte, so the design is to move each byte once: read x (and r) once,
write y (and u) once, with the row held in registers between the two
reductions. One program takes one row, BLOCK_D (512 at D=384) lanes masked
to D.

Math, as the JAX kernels: the residual sum is rounded to the activation
dtype first; statistics in f32 with eps inside the rsqrt; gamma and beta
applied in f32; y cast to the input dtype.

Dispatch: a CPU tensor takes the plain version (:func:`reference_add_ln`);
a CUDA tensor launches the kernel or raises. Forward only: the backward
kernels (K1c, K2b) are not ported yet, so the CUDA path refuses inputs that
require grad.
"""
from __future__ import annotations

import typing as typ

import torch

from ._checks import check_no_grad, check_tensor


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


def _launch(x, r, gamma, beta, eps, write_sum):
    from ._fused_ln_triton import ln_fwd_kernel  # needs Triton

    check_tensor(x, "x", (torch.bfloat16, torch.float32))
    if x.dim() < 2:
        raise ValueError(f"x must be (..., D), got {tuple(x.shape)}")
    D = x.shape[-1]
    if r is not None:
        check_tensor(r, "r", (x.dtype,), device=x.device, shape=x.shape)
    check_tensor(gamma, "gamma", (torch.float32,), device=x.device, shape=(D,))
    check_tensor(beta, "beta", (torch.float32,), device=x.device, shape=(D,))
    check_no_grad(x, r, gamma, beta, what="LayerNorm forward (backward: K1c/K2b)")
    y = torch.empty_like(x)
    u = torch.empty_like(x) if write_sum else y
    rows = x.numel() // D
    block = 1 << (D - 1).bit_length()
    ln_fwd_kernel[(rows,)](x, x if r is None else r, u, y, gamma, beta, D,
                           eps, HAS_RESIDUAL=r is not None,
                           WRITE_SUM=write_sum, BLOCK_D=block, num_warps=4)
    return u, y


def fused_ln(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """y = LayerNorm(x) * gamma + beta (no residual add)."""
    if not x.is_cuda:
        return reference_add_ln(x, None, gamma, beta, eps)[1]
    _, y = _launch(x, None, gamma, beta, eps, write_sum=False)
    fused_ln.launches += 1
    return y


def fused_add_ln(x: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-6):
    """(u, y) = (x + r, LayerNorm(x + r) * gamma + beta)."""
    if not x.is_cuda:
        return reference_add_ln(x, r, gamma, beta, eps)
    u, y = _launch(x, r, gamma, beta, eps, write_sum=True)
    fused_add_ln.launches += 1
    return u, y


def fused_sum_ln(a: torch.Tensor, b: torch.Tensor, gamma: torch.Tensor,
                 beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """y = LayerNorm(a + b) * gamma + beta; the sum is never written."""
    if not a.is_cuda:
        return reference_add_ln(a, b, gamma, beta, eps)[1]
    _, y = _launch(a, b, gamma, beta, eps, write_sum=False)
    fused_sum_ln.launches += 1
    return y


fused_ln.launches = 0
fused_add_ln.launches = 0
fused_sum_ln.launches = 0
