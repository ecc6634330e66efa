"""Per-expert FFN (fc1 -> GELU -> fc2) over the tile-aligned expert layout,
forward (K3) and backward (K4), for the H100.

Replaces two Pallas kernels of ``slim_switch_moe_vit_tpu/ops/fused_ffn.py``:
``_fwd_kernel`` (:166) behind ``_fwd`` (:176) and ``fused_expert_ffn``
(:511), and ``_bwd_kernel`` (:261) behind ``_bwd`` (:374) and ``_ffn_bwd``
(:834). The CUDA C++ kernels are ``csrc/expert_ffn_fwd.cu`` and
``csrc/expert_ffn_bwd.cu``; their header notes say what bounds them on the
card and how their designs answer that. In short: the FFN is FLOP-bound;
the forward keeps the (rows, H) hidden activation out of device memory by
streaming H in chunks, and the backward recomputes it the same way for dx,
then sums dW1/dW2 per expert over its consecutive tiles in a second kernel.

Layout contract (``ops/moe.py::aligned_expert_layout``): rows are sorted by
expert and every ``TILE_ROWS``-row tile belongs to one expert,
``e_of_tile[tile]``.

GELU and its derivative are the exact erf forms at every dtype. The JAX
package evaluates them for bf16 with odd polynomials (``gelu_fast``, within
5.7e-4 of exact; gelu' within 1.5e-3), a TPU VPU policy that is not ported.

Dispatch: a CPU tensor takes the plain versions
(:func:`fused_expert_ffn_reference`, :func:`reference_expert_ffn_bwd`); a
CUDA tensor launches the kernels or raises. The autograd Function saves
(xs, w1, b1, w2, b2, e_of_tile), as the JAX VJP does (fused_ffn.py:829-831).
"""
from __future__ import annotations

import math

import torch

from . import _build
from ._checks import check_tensor

TILE_ROWS = 256  # layout alignment: every TILE_ROWS-row tile has one expert


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """0.5 * h * (1 + erf(h / sqrt(2))), in h's dtype."""
    return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


def dgelu(h: torch.Tensor) -> torch.Tensor:
    """d/dh [h * Phi(h)] = Phi(h) + h * phi(h), the exact erf form."""
    cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    return cdf + h * torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact-GELU semantics at the activation's precision: evaluated in f32
    and cast back (the JAX package's bf16 polynomial is not ported)."""
    return gelu_exact(x.float()).to(x.dtype)


def fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile):
    """Plain version: a loop over row tiles, each with the expert
    ``e_of_tile[tile]``. Products in f32 on the activation-dtype operands,
    GELU in f32, g rounded to the activation dtype, one final rounding."""
    Tp, D = xs.shape
    tile = Tp // e_of_tile.shape[0]
    y = torch.empty_like(xs)
    for i, e in enumerate(e_of_tile.tolist()):
        rows = slice(i * tile, (i + 1) * tile)
        h = xs[rows].float() @ w1[e].float() + b1[e].float()
        g = gelu_exact(h).to(xs.dtype)
        out = g.float() @ w2[e].float() + b2[e].float()
        y[rows] = out.to(xs.dtype)
    return y


def reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy):
    """Plain version of the backward: a loop over row tiles, step by step as
    the JAX kernel (products in f32 on the activation-dtype operands, dh
    rounded to the activation dtype for the dx and dW1 products, g for the
    dW2 product, db1 from the f32 dh). Returns (dx, dw1, db1, dw2, db2): dx
    in xs's dtype, dw1/dw2 in the weights' dtype, the biases' f32."""
    Tp, D = xs.shape
    E, _, H = w1.shape
    tile = Tp // e_of_tile.shape[0]
    dt = xs.dtype
    dx = torch.empty_like(xs)
    dw1 = torch.zeros((E, D, H), dtype=torch.float32, device=xs.device)
    dw2 = torch.zeros((E, H, D), dtype=torch.float32, device=xs.device)
    db1 = torch.zeros((E, H), dtype=torch.float32, device=xs.device)
    db2 = torch.zeros((E, D), dtype=torch.float32, device=xs.device)
    for i, e in enumerate(e_of_tile.tolist()):
        rows = slice(i * tile, (i + 1) * tile)
        x, d = xs[rows].float(), dy[rows].to(dt).float()
        h = x @ w1[e].float() + b1[e].float()
        dh = (d @ w2[e].float().T) * dgelu(h)
        dhb = dh.to(dt).float()
        dx[rows] = (dhb @ w1[e].float().T).to(dt)
        dw1[e] += x.T @ dhb
        dw2[e] += gelu_exact(h).to(dt).float().T @ d
        db1[e] += dh.sum(0)
        db2[e] += d.sum(0)
    return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def _check_ffn(xs, w1, b1, w2, b2, e_of_tile):
    check_tensor(xs, "xs", (torch.bfloat16,))
    if xs.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"xs must be (Tp, D) and w1 (E, D, H), got "
                         f"{tuple(xs.shape)} and {tuple(w1.shape)}")
    Tp, D = xs.shape
    E, _, H = w1.shape
    if D not in (192, 384):
        raise ValueError(f"the expert-FFN kernels take D 192 or 384, got {D}")
    if H % 64 or Tp % TILE_ROWS:
        raise ValueError(f"H ({H}) must be a multiple of 64 and Tp ({Tp}) of "
                         f"{TILE_ROWS}")
    dev = xs.device
    check_tensor(w1, "w1", (torch.bfloat16,), device=dev, shape=(E, D, H))
    check_tensor(b1, "b1", (torch.float32,), device=dev, shape=(E, H))
    check_tensor(w2, "w2", (torch.bfloat16,), device=dev, shape=(E, H, D))
    if b2 is not None:
        check_tensor(b2, "b2", (torch.float32,), device=dev, shape=(E, D))
    check_tensor(e_of_tile, "e_of_tile", (torch.int32,), device=dev,
                 shape=(Tp // TILE_ROWS,))
    return Tp, D, H, E


def fused_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy):
    """(dx, dw1, db1, dw2, db2) of :func:`fused_expert_ffn` (K4) for the
    cotangent dy (zero at padding slots, as the combine backward gives)."""
    if not xs.is_cuda:
        return reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy)
    Tp, D, H, E = _check_ffn(xs, w1, b1, w2, None, e_of_tile)
    check_tensor(dy, "dy", (torch.bfloat16,), device=xs.device, shape=(Tp, D))
    dx = torch.empty_like(xs)
    dw1, dw2 = torch.empty_like(w1), torch.empty_like(w2)
    db1 = torch.empty((E, H), dtype=torch.float32, device=xs.device)
    db2 = torch.empty((E, D), dtype=torch.float32, device=xs.device)
    ws_dh = torch.empty((Tp, H), dtype=xs.dtype, device=xs.device)
    ws_g = torch.empty_like(ws_dh)
    ws_db1 = torch.empty((Tp // 64, H), dtype=torch.float32, device=xs.device)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_bwd(
        xs.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), e_of_tile.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), ws_dh.data_ptr(),
        ws_g.data_ptr(), ws_db1.data_ptr(), Tp, D, H, E, TILE_ROWS,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_expert_ffn_bwd")
    fused_expert_ffn_bwd.launches += 1
    return dx, dw1, db1, dw2, db2


def _ffn_forward(xs, w1, b1, w2, b2, e_of_tile):
    if not xs.is_cuda:
        return fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile)
    Tp, D, H, _ = _check_ffn(xs, w1, b1, w2, b2, e_of_tile)
    y = torch.empty_like(xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_fwd(
        xs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), e_of_tile.data_ptr(), y.data_ptr(), Tp, D, H,
        TILE_ROWS, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_expert_ffn")
    fused_expert_ffn.launches += 1
    return y


class _FusedExpertFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w1, b1, w2, b2, e_of_tile):
        ctx.save_for_backward(xs, w1, b1, w2, b2, e_of_tile)
        return _ffn_forward(xs, w1, b1, w2, b2, e_of_tile)

    @staticmethod
    def backward(ctx, dy):
        xs, w1, b1, w2, _, e_of_tile = ctx.saved_tensors
        grads = fused_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile,
                                     dy.to(xs.dtype).contiguous())
        return (*grads, None)


def fused_expert_ffn(xs: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     e_of_tile: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(xs))) with per-tile expert weights.

    Args:
        xs: (Tp, D) tokens sorted by expert, groups TILE_ROWS-aligned.
        w1/b1/w2/b2: (E, D, H) / (E, H) / (E, H, D) / (E, D); w1 and w2 in
            xs's dtype, the biases f32.
        e_of_tile: (Tp // TILE_ROWS,) int32, owning expert of each row tile.
    Returns:
        (Tp, D) in xs's dtype.
    """
    return _FusedExpertFFN.apply(xs, w1, b1, w2, b2, e_of_tile)


fused_expert_ffn.launches = 0
fused_expert_ffn_bwd.launches = 0
