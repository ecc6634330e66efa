"""Vision Transformer backbone (DeiT family), in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/vit.py``: :class:`Attention`
(:36-107) over the packed-qkv MHA kernel, :class:`Block` with its plain and
residual-deferred forms (:146-168), and :class:`VisionTransformer` with the
residual-deferred chain (:279-331). The distilled and pre-logits heads are
not ported yet.

Training runs the same chain in ``model.train()``: every kernel wrapper is
an autograd Function with its backward kernel. Stochastic depth draws from
the ``generator`` passed to ``forward``; attention dropout and expert
dropout raise (no kernel has a dropout path).

Residual-deferred chain: each block leaves its last branch output
(``pending``) un-added; the next LayerNorm folds the add into its kernel.
Block 0's ``norm1`` is the no-add LN, every later norm the add+LN, and the
final norm the slim LN that never writes the sum. The head runs in f32 on
the class token.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch
from torch import nn

from ..ops.attention import fused_mha
from .layers import Dense, DropPath, LayerNorm, Mlp, PatchEmbed, trunc_normal_


class Attention(nn.Module):
    """Multi-head self-attention: qkv GEMM, the packed-qkv MHA kernel, proj
    GEMM."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.attn_drop > 0.0:
            raise NotImplementedError(
                "attention dropout: the MHA kernels have no dropout path")
        C = x.shape[-1]
        scale = (C // self.num_heads) ** -0.5
        out = fused_mha(self.qkv(x), self.num_heads, scale)
        return self.proj_drop(self.proj(out))


class Block(nn.Module):
    """Pre-LN transformer block; ``mlp`` is any module (dense or MoE)."""

    def __init__(self, dim: int, num_heads: int, mlp: nn.Module,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=drop, dtype=dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = mlp
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)

    def deferred(self, u: torch.Tensor, pending: typ.Optional[torch.Tensor],
                 generator: typ.Optional[torch.Generator] = None):
        """Residual-deferred step: ``pending`` (the previous branch output)
        is not yet added to the stream ``u``; the add rides this block's
        norm1. Returns (new stream, new pending). Same math as forward."""
        if pending is None:
            u1, y1 = u, self.norm1(u)
        else:
            u1, y1 = self.norm1(u, residual=pending)
        a = self.drop_path(self.attn(y1), generator)
        u2, y2 = self.norm2(u1, residual=a)
        return u2, self.drop_path(self.mlp(y2), generator)


MlpFactory = typ.Callable[[int, int, float, float, torch.dtype], nn.Module]


class VisionTransformer(nn.Module):
    """ViT for classification over channels-last (B, H, W, 3) images.

    ``block_mlp_factory(layer_idx, dim, mlp_ratio, drop, dtype)`` builds each
    block's MLP (the MoE models plug in here); None gives the dense Mlp.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 block_mlp_factory: typ.Optional[MlpFactory] = None):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.patch_embed.num_patches + 1, embed_dim))
        self.pos_drop = nn.Dropout(drop_rate)
        dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, depth)]

        def dense_mlp(idx, dim, ratio, drop, dt):
            return Mlp(dim, int(dim * ratio), drop=drop, dtype=dt)

        factory = block_mlp_factory or dense_mlp
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads,
                  factory(i, embed_dim, mlp_ratio, drop_rate, dtype),
                  qkv_bias=qkv_bias, drop=drop_rate, attn_drop=attn_drop_rate,
                  drop_path=dpr[i], dtype=dtype)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim)
        self.head = (Dense(embed_dim, num_classes, dtype=torch.float32)
                     if num_classes > 0 else None)

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` in module order."""
        trunc_normal_(self.cls_token, generator)
        trunc_normal_(self.pos_embed, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward_features(self, x: torch.Tensor,
                         generator: typ.Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        x = self.patch_embed(x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.pos_drop(x)
        pending = None
        for blk in self.blocks:
            x, pending = blk.deferred(x, pending, generator)
        # the raw sum is never read again: the slim (no-sum) LN
        return self.norm(x, residual=pending, emit_sum=False)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits (f32); ``generator`` feeds stochastic depth in training."""
        feat = self.forward_features(x, generator)[:, 0].float()
        return feat if self.head is None else self.head(feat)
