"""Per-expert FFN forward (fc1 -> GELU -> fc2) over the tile-aligned expert
layout (K3) for the H100.

Replaces the Pallas kernel ``_fwd_kernel`` of
``slim_switch_moe_vit_tpu/ops/fused_ffn.py`` (:166), behind ``_fwd`` (:176)
and ``fused_expert_ffn`` (:511). The CUDA C++ kernel is
``csrc/expert_ffn_fwd.cu``; its header note says what bounds it on the card
and how its design answers that. In short: the FFN is FLOP-bound, and like
the TPU kernel it keeps the (rows, H) hidden activation out of device
memory by streaming H in chunks, with both products on the tensor cores.

Layout contract (``ops/moe.py::aligned_expert_layout``): rows are sorted by
expert and every ``TILE_ROWS``-row tile belongs to one expert,
``e_of_tile[tile]``.

GELU is the exact erf form at every dtype. The JAX package evaluates it for
bf16 with an odd polynomial (``gelu_fast``, within 5.7e-4 of exact), a TPU
VPU policy that is not ported.

Dispatch: a CPU tensor takes the plain version
(:func:`fused_expert_ffn_reference`); a CUDA tensor launches the kernel or
raises. Forward only: the backward kernels (K4, K8) are not ported yet.
"""
from __future__ import annotations

import math

import torch

from . import _build
from ._checks import check_no_grad, check_tensor

TILE_ROWS = 256  # layout alignment: every TILE_ROWS-row tile has one expert


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """0.5 * h * (1 + erf(h / sqrt(2))), in h's dtype."""
    return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


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
    if not xs.is_cuda:
        return fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile)
    check_tensor(xs, "xs", (torch.bfloat16,))
    if xs.dim() != 2 or w1.dim() != 3:
        raise ValueError(f"xs must be (Tp, D) and w1 (E, D, H), got "
                         f"{tuple(xs.shape)} and {tuple(w1.shape)}")
    Tp, D = xs.shape
    E, _, H = w1.shape
    if D not in (192, 384):
        raise ValueError(f"fused_expert_ffn kernel takes D 192 or 384, got {D}")
    if H % 64 or Tp % TILE_ROWS:
        raise ValueError(f"H ({H}) must be a multiple of 64 and Tp ({Tp}) of "
                         f"{TILE_ROWS}")
    dev = xs.device
    check_tensor(w1, "w1", (torch.bfloat16,), device=dev, shape=(E, D, H))
    check_tensor(b1, "b1", (torch.float32,), device=dev, shape=(E, H))
    check_tensor(w2, "w2", (torch.bfloat16,), device=dev, shape=(E, H, D))
    check_tensor(b2, "b2", (torch.float32,), device=dev, shape=(E, D))
    check_tensor(e_of_tile, "e_of_tile", (torch.int32,), device=dev,
                 shape=(Tp // TILE_ROWS,))
    check_no_grad(xs, w1, b1, w2, b2, what="fused_expert_ffn (backward: K4)")
    y = torch.empty_like(xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_fwd(
        xs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), e_of_tile.data_ptr(), y.data_ptr(), Tp, D, H,
        TILE_ROWS, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_expert_ffn")
    fused_expert_ffn.launches += 1
    return y


fused_expert_ffn.launches = 0
