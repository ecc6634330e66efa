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

The forwards are Triton kernels (``_fused_ln_triton.py``): one kernel
with ``HAS_RESIDUAL`` and ``WRITE_SUM`` as compile-time flags, one row per
program with the row in registers between the two reductions. Triton is
enough there: a row normalisation is one reduction and one elementwise
pass. The backward of all three (K1c plain and add forms, K2b) is one CUDA
C++ kernel, ``csrc/ln_bwd.cu``: a persistent grid streaming row tiles
through a ring of bulk asynchronous copies, a warp per row, and dgamma and
dbeta summed in the same launch in a fixed order (deterministic, no float
atomics); its source note gives the design and its probes.

What bounds them on the H100: device-memory bytes. At D=384 a bf16 row is
768 bytes and the kernels do ~10 FLOP per element, far below the card's
~295 FLOP per byte, so the design is to move each byte once.

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

import math
import typing as typ

import torch

from . import _build
from ._checks import check_tensor

MAX_BWD_DIM = 2048  # the widest row the backward kernel takes (kMaxD)
# the backward's launch: ring stages, rows a stage, blocks an SM, lanes a
# row (the design probes of csrc/ln_bwd.cu's note)
BWD_STAGES, BWD_ROWS, BWD_BLOCKS_PER_SM, BWD_TEAM = 2, 8, 2, 32
_BWD_FORMS = {"ring": 0, "prefetch": 1, "scalar": 2}
_BWD_SMEM = 232448 - 1024  # a block's shared memory, less the reserved 1 KB
_TICKET_SLOTS = 65         # the kernel's kMaxGroups + 1
_tickets: dict = {}


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


def _bwd_tickets(device) -> torch.Tensor:
    """The backward's int32 tickets on this device and stream: zeroed once
    here, and left zero by every launch."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(_TICKET_SLOTS, dtype=torch.int32,
                                        device=device)
    return t


def _launch_bwd(a, b, dy, du_out, gamma, eps, stages=BWD_STAGES,
                rows_per_stage=BWD_ROWS, blocks_per_sm=BWD_BLOCKS_PER_SM,
                team=BWD_TEAM, form=None, stamps=None, lib=None):
    """One launch of ``csrc/ln_bwd.cu``: (du, dgamma, dbeta) of u = a
    (+ b). ``form`` is "ring" wherever a row's bytes are a multiple of 16,
    else "scalar"; the other arguments, "prefetch", ``stamps`` (an int64
    tensor of 8 phase times a block) and ``lib`` (a build with the probe
    forms) serve the design probes (``scripts/ln_bwd_tilings.py``)."""
    D, rows, _ = _check_rows(a, [("b", b), ("dy", dy), ("du_out", du_out)],
                             gamma)
    if D > MAX_BWD_DIM:
        raise ValueError(f"the LayerNorm backward kernel takes D <= "
                         f"{MAX_BWD_DIM}, got {D}")
    du = torch.empty_like(a)
    if rows == 0:
        sums = torch.zeros(2 * D, dtype=torch.float32, device=a.device)
        return du, sums[:D], sums[D:]
    item = a.element_size()
    if form is None:
        form = "ring" if D * item % 16 == 0 else "scalar"
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    # shared memory: barriers, gamma, and the ring or the nine warps'
    # column sums, whichever is larger
    fixed = 256 + (D * 4 + 127) // 128 * 128
    if D > 512 or fixed + 72 * D > _BWD_SMEM // blocks_per_sm:
        blocks_per_sm = 1  # two blocks' registers fit an SM up to D = 512
    budget = _BWD_SMEM // blocks_per_sm - fixed
    if form == "ring":
        row_bytes = (2 + (b is not None) + (du_out is not None)) * D * item
        rows_per_stage = max(1, min(rows_per_stage,
                                    budget // (stages * row_bytes)))
        stages = max(1, min(stages, budget // (rows_per_stage * row_bytes)))
        work = -(-rows // rows_per_stage)
    else:
        work = -(-rows // 9)  # a block's nine warps take a row each
    grid = min(work, sms * blocks_per_sm)
    group = math.isqrt(grid - 1) + 1  # ceil(sqrt(grid))
    part = torch.empty((grid + -(-grid // group)) * 2 * D,
                       dtype=torch.float32, device=a.device)
    sums = torch.empty(2 * D, dtype=torch.float32, device=a.device)
    err = (lib or _build.load_library()).ssmv_ln_bwd(
        a.data_ptr(), None if b is None else b.data_ptr(), dy.data_ptr(),
        None if du_out is None else du_out.data_ptr(), du.data_ptr(),
        gamma.data_ptr(), part.data_ptr(), _bwd_tickets(a.device).data_ptr(),
        sums.data_ptr(), None if stamps is None else stamps.data_ptr(), rows,
        D, int(a.dtype == torch.bfloat16), eps, grid,
        stages, rows_per_stage, group, _BWD_FORMS[form],
        team if form == "ring" else 32,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "ln_bwd")
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
