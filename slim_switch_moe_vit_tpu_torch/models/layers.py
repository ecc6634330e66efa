"""Core layers of the ViT stack, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/layers.py``. Parameters are stored
in f32; each layer computes in its ``dtype`` (bf16 for serving).

- :class:`Dense`: ``F.linear`` in the compute dtype, the bias added in that
  dtype (as the JAX layer: two roundings in bf16). The weight is stored
  (out, in), PyTorch's convention; the JAX (in, out) kernel is transposed
  only by ``utils/checkpoint.py::from_jax_params``.
- :class:`LayerNorm`: eps 1e-6, with the ``residual`` and ``emit_sum``
  forms; routes to the kernels of ``ops/fused_ln.py``.
- :class:`DropPath`: stochastic depth from an explicit generator, the
  identity at eval.
- :class:`Mlp`: fc1 -> GELU -> dropout -> fc2 -> dropout.
- :class:`PatchEmbed`: channels-last (NHWC) images cut into patches by a
  reshape and embedded by one GEMM; no convolution.

Weights are drawn by ``init_weights(generator)`` (timm/DeiT init:
trunc-normal(0.02) truncated at 2 std, zero biases, unit LN scales).
"""
from __future__ import annotations

import typing as typ

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_ffn import gelu_fast
from ..ops.fused_ln import fused_add_ln, fused_ln, fused_sum_ln

TRUNC_STD = 0.02


def trunc_normal_(t: torch.Tensor, generator: torch.Generator) -> None:
    """In place: N(0, 0.02) truncated at +-2 std (timm's trunc_normal_)."""
    nn.init.trunc_normal_(t, std=TRUNC_STD, a=-2 * TRUNC_STD,
                          b=2 * TRUNC_STD, generator=generator)


class Dense(nn.Module):
    """Linear layer computing in ``dtype``, params stored in f32."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        return y


class LayerNorm(nn.Module):
    """LayerNorm over the trailing dim (eps 1e-6, DeiT's), f32 statistics,
    output in the input's dtype.

    ``forward(x)`` returns LN(x). With ``residual``, the preceding residual
    add is folded in: ``(x + residual, LN(x + residual))``, or only the
    normalized value when ``emit_sum=False`` (the sum is then never
    written)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                residual: typ.Optional[torch.Tensor] = None,
                emit_sum: bool = True):
        if residual is None:
            return fused_ln(x, self.weight, self.bias, self.eps)
        residual = residual.to(x.dtype)
        if emit_sum:
            return fused_add_ln(x, residual, self.weight, self.bias, self.eps)
        return fused_sum_ln(x, residual, self.weight, self.bias, self.eps)


class DropPath(nn.Module):
    """Stochastic depth: drop the whole residual branch per sample while
    training (kept branches scaled by 1/keep); the identity at eval. The
    mask is drawn from the ``generator`` the caller passes (on x's device),
    never from the global one."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs the caller's "
                             "torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, device=x.device, generator=generator) < keep
        return torch.where(mask, x / keep, torch.zeros_like(x))


class Mlp(nn.Module):
    """Transformer FFN: fc1 -> GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, in_features: int, hidden_features: int,
                 out_features: typ.Optional[int] = None, drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features or in_features,
                         dtype=dtype)
        self.drop = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(gelu_fast(self.fc1(x)))
        return self.drop(self.fc2(x))


class PatchEmbed(nn.Module):
    """(B, H, W, C) images -> (B, N, D) patch tokens: a block reshape and one
    (B*N, p*p*C) x (p*p*C, D) GEMM, which equals the stride-p convolution."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, embed_dim: int = 768,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.proj = Dense(patch_size * patch_size * in_chans, embed_dim,
                          dtype=dtype)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        p = self.patch_size
        gh, gw = H // p, W // p
        x = x.reshape(B, gh, p, gw, p, C).permute(0, 1, 3, 2, 4, 5)
        return self.proj(x.reshape(B, gh * gw, p * p * C))
