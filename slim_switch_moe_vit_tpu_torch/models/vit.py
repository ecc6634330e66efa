"""Vision Transformer backbone (DeiT family), in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/vit.py``: :class:`Attention`
(:36-107) over the packed-qkv MHA kernels with the JAX rule for when they
run (:func:`attention_route`), :class:`Block` with its plain and
residual-deferred forms (:146-168), :class:`VisionTransformer` with the
residual-deferred chain and the ``block_factory`` hook (:199-310), and
:func:`resize_pos_embed` (:334-346), with the DeiT distillation token and
second head (``distilled``) and the pre-logits layer
(``representation_size``).

Training runs the same chain in ``model.train()``: every kernel wrapper is
an autograd Function with its backward kernel. Stochastic depth draws from
the ``generator`` passed to ``forward``; attention dropout takes the plain
attention with dropout on the probabilities, as the JAX XLA branch does;
expert dropout takes a dropout path of the MoE dispatch (``models/moe.py``).

Residual-deferred chain: each block leaves its last branch output
(``pending``) un-added; the next LayerNorm folds the add into its kernel.
Block 0's ``norm1`` is the no-add LN, every later norm the add+LN, and the
final norm the slim LN that never writes the sum. The head runs in f32 on
the class token (and ``head_dist`` on the distillation token).
"""
from __future__ import annotations

import collections
import math
import typing as typ

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (MAX_N, flash_attention, fused_mha,
                             fused_mha_reference)
from .layers import Dense, DropPath, LayerNorm, Mlp, PatchEmbed, trunc_normal_

# every attention forward's route, counted by name (see attention_route)
ROUTE_COUNTS: collections.Counter = collections.Counter()


def attention_route(N: int, training: bool, attn_drop: float,
                    use_flash: bool) -> str:
    """The path of one attention forward, chosen before any launch, by the
    JAX package's rule (``Attention._fused_ok`` and its branches,
    models/vit.py:50-101):

    - ``"plain_dropout"``: training with ``attn_drop > 0``, the plain
      attention with dropout on the probabilities (JAX's XLA branch);
    - ``"flash"``: K11, for ``use_flash`` in eval;
    - ``"plain"``: the plain attention through autograd for ``use_flash``
      in training and for N > ``MAX_N`` = 1024 (JAX's XLA branch both);
    - ``"k5"``: K5 in eval;
    - ``"k5_k6"``: K5 and its backward K6 in training.

    The kernels take bf16 and f32 and head_dim up to 128
    (``ops.attention.MAX_HEAD_DIM``; the widest head of either zoo is 80);
    a wider head raises on the card, naming the cap."""
    if training and attn_drop > 0.0:
        return "plain_dropout"
    if use_flash:
        return "plain" if training else "flash"
    if N > MAX_N:
        return "plain"
    return "k5_k6" if training else "k5"


def plain_attention(qkv: torch.Tensor, num_heads: int, scale: float,
                    attn_drop: float = 0.0) -> torch.Tensor:
    """softmax(Q K^T * scale) V over packed qkv through autograd, as the JAX
    XLA branch (vit.py:88-101): f32 scores and softmax, dropout on the
    probabilities when ``attn_drop > 0`` (global generator), then cast to
    v's dtype for the PV product."""
    if attn_drop <= 0.0:
        return fused_mha_reference(qkv, num_heads, scale)
    B, N, C3 = qkv.shape
    C = C3 // 3
    q, k, v = (t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = F.dropout(torch.softmax(attn, dim=-1), attn_drop, training=True)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.transpose(1, 2).reshape(B, N, C).to(qkv.dtype)


def resize_pos_embed(pos_embed: torch.Tensor, num_extra_tokens: int,
                     new_grid: int) -> torch.Tensor:
    """Bicubic resize of the position embedding's patch grid to
    ``new_grid`` x ``new_grid`` (the extra tokens kept), as the JAX
    package's ``resize_pos_embed`` (models/vit.py:334-346).
    ``jax.image.resize(..., "bicubic")`` is the Keys kernel with a = -0.5
    and antialiasing; torch's plain bicubic uses a = -0.75, its antialiased
    form the JAX one, so that is the form taken here."""
    extra = pos_embed[:, :num_extra_tokens]
    grid = pos_embed[:, num_extra_tokens:]
    orig = int(math.sqrt(grid.shape[1]))
    D = grid.shape[-1]
    grid = grid.reshape(1, orig, orig, D).permute(0, 3, 1, 2).float()
    grid = F.interpolate(grid, size=(new_grid, new_grid), mode="bicubic",
                         align_corners=False, antialias=True)
    grid = grid.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, D)
    return torch.cat([extra, grid.to(pos_embed.dtype)], dim=1)


class Attention(nn.Module):
    """Multi-head self-attention: qkv GEMM, the packed-qkv attention on the
    route :func:`attention_route` picks (counted in ``ROUTE_COUNTS``), proj
    GEMM.

    With ``use_flash``, an eval forward takes the online-softmax kernel
    (K11) and a training forward the plain attention (autograd through f32
    scores and softmax): the JAX package's own choice, whose ``_fused_ok``
    turns the fused kernel off under ``use_flash`` and whose flash call is
    for deterministic forwards only (vit.py:50-101)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.use_flash = use_flash
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, N, C = x.shape
        scale = (C // self.num_heads) ** -0.5
        qkv = self.qkv(x)
        route = attention_route(N, self.training, self.attn_drop,
                                self.use_flash)
        ROUTE_COUNTS[route] += 1
        if route in ("k5", "k5_k6"):
            out = fused_mha(qkv, self.num_heads, scale)
        elif route == "flash":
            out = flash_attention(qkv, self.num_heads, scale)
        else:
            out = plain_attention(
                qkv, self.num_heads, scale,
                self.attn_drop if route == "plain_dropout" else 0.0)
        return self.proj_drop(self.proj(out))


class Block(nn.Module):
    """Pre-LN transformer block; ``mlp`` is any module (dense or MoE)."""

    def __init__(self, dim: int, num_heads: int, mlp: nn.Module,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=drop, dtype=dtype,
                              use_flash=use_flash)
        self.norm2 = LayerNorm(dim)
        self.mlp = mlp
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)

    def deferred_call(self, u: torch.Tensor,
                      pending: typ.Optional[torch.Tensor],
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
BlockFactory = typ.Callable[..., nn.Module]


class VisionTransformer(nn.Module):
    """ViT for classification over channels-last (B, H, W, 3) images.

    ``block_mlp_factory(layer_idx, dim, mlp_ratio, drop, dtype)`` builds each
    block's MLP (the MoE models plug in here); None gives the dense Mlp.
    ``block_factory(layer_idx, **block_kwargs)`` replaces the whole block
    (the gated ResMoE blocks plug in here).

    ``distilled`` adds the DeiT distillation token (N + 2 tokens) and its
    head ``head_dist``: a training forward returns ``(logits,
    logits_dist)``, an eval forward their mean (JAX vit.py:312-325).
    ``representation_size`` puts the pre-logits layer (a Dense and tanh) on
    the class token before the head; it is ignored when ``distilled``. With
    ``num_classes == 0`` the forward returns the features the head would
    read.
    """

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True,
                 representation_size: typ.Optional[int] = None,
                 distilled: bool = False, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 block_mlp_factory: typ.Optional[MlpFactory] = None,
                 block_factory: typ.Optional[BlockFactory] = None):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.distilled = distilled
        self.dtype = dtype
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.dist_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                           if distilled else None)
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.patch_embed.num_patches + self.num_tokens, embed_dim))
        self.pos_drop = nn.Dropout(drop_rate)
        dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, depth)]

        def dense_mlp(idx, dim, ratio, drop, dt):
            return Mlp(dim, int(dim * ratio), drop=drop, dtype=dt)

        factory = block_mlp_factory or dense_mlp

        def block(i):
            kw = dict(dim=embed_dim, num_heads=num_heads, qkv_bias=qkv_bias,
                      drop=drop_rate, attn_drop=attn_drop_rate,
                      drop_path=dpr[i], dtype=dtype, use_flash=use_flash)
            if block_factory is not None:
                return block_factory(i, mlp_ratio=mlp_ratio, **kw)
            return Block(mlp=factory(i, embed_dim, mlp_ratio, drop_rate, dtype),
                         **kw)

        self.blocks = nn.ModuleList(block(i) for i in range(depth))
        self.norm = LayerNorm(embed_dim)
        feat = embed_dim
        self.pre_logits = None
        if representation_size and not distilled:
            self.pre_logits = Dense(embed_dim, representation_size,
                                    dtype=torch.float32)
            feat = representation_size
        self.head = self.head_dist = None
        if num_classes > 0:
            self.head = Dense(feat, num_classes, dtype=torch.float32)
            if distilled:
                self.head_dist = Dense(embed_dim, num_classes,
                                       dtype=torch.float32)

    @property
    def num_tokens(self) -> int:
        """The tokens before the patches: the class token, and the
        distillation token when ``distilled``."""
        return 2 if self.distilled else 1

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` in module order."""
        trunc_normal_(self.cls_token, generator)
        if self.dist_token is not None:
            trunc_normal_(self.dist_token, generator)
        trunc_normal_(self.pos_embed, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward_features(self, x: torch.Tensor,
                         generator: typ.Optional[torch.Generator] = None
                         ) -> torch.Tensor:
        x = self.patch_embed(x)
        tokens = [self.cls_token] + ([self.dist_token] if self.distilled
                                     else [])
        x = torch.cat([t.to(x.dtype).expand(x.shape[0], -1, -1)
                       for t in tokens] + [x], dim=1)
        x = self.pos_drop(x + self.pos_embed.to(x.dtype))
        pending = None
        for blk in self.blocks:
            if hasattr(blk, "deferred_call"):
                x, pending = blk.deferred_call(x, pending, generator)
            else:
                if pending is not None:
                    x, pending = x + pending, None
                x = blk(x, generator)
        if pending is not None:
            # the raw sum is never read again: the slim (no-sum) LN
            return self.norm(x, residual=pending, emit_sum=False)
        return self.norm(x)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None):
        """Logits (f32); ``generator`` feeds stochastic depth in training.
        A distilled model in training returns ``(logits, logits_dist)``."""
        x = self.forward_features(x, generator)
        if self.distilled:
            if self.head is None:
                return x[:, 0]
            logits = self.head(x[:, 0].float())
            logits_dist = self.head_dist(x[:, 1].float())
            if self.training:
                return logits, logits_dist
            return (logits + logits_dist) / 2.0
        feat = x[:, 0].float()
        if self.pre_logits is not None:
            feat = torch.tanh(self.pre_logits(feat))
        return feat if self.head is None else self.head(feat)
