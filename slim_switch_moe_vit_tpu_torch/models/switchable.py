"""Switchable ViT: a bucketed router norm and mid-network token truncation,
in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/switchable.py``:
:class:`SwitchableLayerNorm` (:43-103), :class:`SwitchableVisionTransformer`
(:105-248) and ``deit_sw_tiny_patch16_224`` (:254-266).

- :class:`SwitchableLayerNorm`: a LayerNorm (eps 1e-5, f32 statistics)
  whose affine comes in ``switchable_buckets`` variants. Each token takes a
  bucket, given or chosen by the least L2 distance to the ``centroids``
  buffer (not trained; :meth:`~SwitchableLayerNorm.set_centroids`); ties go
  to the first bucket, as ``jnp.argmin``'s do. The per-bucket affine is one
  gather over the bucket dimension. No kernel: the JAX layer is plain XLA.
- :class:`SwitchableVisionTransformer`: the blocks split into pre, mid and
  post groups around the router (``router_start`` / ``router_end``; 0 / 11
  / 1 at the defaults). In routing mode the tokens whose bucket is at least
  ``threshold`` are moved to the front in their order (a stable sort),
  truncated to the static ``route_capacity``, run through the mid blocks
  and scattered back; every other token, and a pass-through token beyond
  the capacity, takes its pre-router activation. The blocks are
  ``models/vit.py::Block``: their norms take the LN kernels and their
  attention the route ``attention_route`` picks, on the truncated N in the
  mid blocks.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch
from torch import nn

from .layers import Dense, LayerNorm, Mlp, PatchEmbed, trunc_normal_
from .registry import register_model
from .vit import Block


class SwitchableLayerNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5,
                 elementwise_affine: bool = True, switchable_buckets: int = 1):
        super().__init__()
        self.eps = eps
        self.register_buffer("centroids",
                             torch.zeros(switchable_buckets, features))
        self.weights = self.biases = None
        if elementwise_affine:
            self.weights = nn.Parameter(torch.ones(switchable_buckets,
                                                   features))
            self.biases = nn.Parameter(torch.zeros(switchable_buckets,
                                                   features))

    def init_weights(self, generator: torch.Generator) -> None:
        if self.weights is not None:
            nn.init.ones_(self.weights)
            nn.init.zeros_(self.biases)

    def forward(self, x: torch.Tensor, buckets=None):
        """x: (..., d). ``buckets``: an int, an int tensor of x's leading
        shape, or None to choose by centroid distance. Returns (y, the
        selected buckets)."""
        x32 = x.float()
        mean = x32.mean(-1, keepdim=True)
        diff = x32 - mean
        var = (diff * diff).mean(-1, keepdim=True)
        normalized = diff * torch.rsqrt(var + self.eps)
        if buckets is None:
            c = self.centroids
            dists = ((x32 * x32).sum(-1, keepdim=True)
                     - 2.0 * torch.einsum("...d,bd->...b", x32, c)
                     + (c * c).sum(-1))
            selected = dists.argmin(-1)
        else:
            selected = torch.as_tensor(buckets, dtype=torch.long,
                                       device=x.device).expand(x.shape[:-1])
        if self.weights is not None:
            normalized = (normalized * self.weights[selected]
                          + self.biases[selected])
        return normalized.to(x.dtype), selected

    @torch.no_grad()
    def set_centroids(self, centroids: torch.Tensor) -> None:
        """Replace the centroids (reference set_centroids)."""
        if tuple(centroids.shape) != tuple(self.centroids.shape):
            raise ValueError("Passed centroids must match (buckets, "
                             "features)!")
        self.centroids.copy_(centroids)


class SwitchableVisionTransformer(nn.Module):
    """reference vision_transformer.py:325-639, over channels-last images.

    ``forward(x, generator, bucket=None, threshold=0, routing=False)``: the
    logits (f32); a distilled model in training returns ``(logits,
    logits_dist)``, in eval their mean; with ``collect_embeddings`` the
    output and the pre-router activations."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 num_classes: int = 1000, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, distilled: bool = False,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 buckets: int = 1, router_start: int = 0,
                 router_end: int = -1,
                 route_capacity: typ.Optional[int] = None,
                 collect_embeddings: bool = False):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.distilled = distilled
        self.dtype = dtype
        self.route_capacity = route_capacity
        self.collect_embeddings = collect_embeddings
        self.patch_embed = PatchEmbed(img_size, patch_size, 3, embed_dim,
                                      dtype=dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.dist_token = (nn.Parameter(torch.empty(1, 1, embed_dim))
                           if distilled else None)
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.patch_embed.num_patches + self.num_tokens, embed_dim))
        self.pos_drop = nn.Dropout(drop_rate)
        self.router = SwitchableLayerNorm(embed_dim,
                                          switchable_buckets=buckets)
        # the split (reference :422-472): pre = start % depth, mid = (end -
        # start) % depth, post = (depth - end % depth) % depth
        self.n_pre = router_start % depth
        self.n_mid = (router_end - router_start) % depth
        n_post = (depth - router_end % depth) % depth
        dpr = [float(r) for r in np.linspace(0.0, drop_path_rate, depth)]
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads,
                  Mlp(embed_dim, int(embed_dim * mlp_ratio), drop=drop_rate,
                      dtype=dtype),
                  qkv_bias=qkv_bias, drop=drop_rate, attn_drop=attn_drop_rate,
                  drop_path=dpr[i], dtype=dtype, use_flash=use_flash)
            for i in range(self.n_pre + self.n_mid + n_post))
        self.norm = LayerNorm(embed_dim)
        self.head = self.head_dist = None
        if num_classes > 0:
            self.head = Dense(embed_dim, num_classes, dtype=torch.float32)
            if distilled:
                self.head_dist = Dense(embed_dim, num_classes,
                                       dtype=torch.float32)

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    def groups(self) -> typ.Tuple[list, list, list]:
        """(pre, mid, post) blocks."""
        blocks, a, b = list(self.blocks), self.n_pre, self.n_pre + self.n_mid
        return blocks[:a], blocks[a:b], blocks[b:]

    def init_weights(self, generator: torch.Generator) -> None:
        trunc_normal_(self.cls_token, generator)
        if self.dist_token is not None:
            trunc_normal_(self.dist_token, generator)
        trunc_normal_(self.pos_embed, generator)
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward_pre(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x)
        tokens = [self.cls_token] + ([self.dist_token] if self.distilled
                                     else [])
        x = torch.cat([t.to(x.dtype).expand(x.shape[0], -1, -1)
                       for t in tokens] + [x], dim=1)
        return self.pos_drop(x + self.pos_embed.to(x.dtype))

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None,
                bucket=None, threshold: int = 0, routing: bool = False):
        pre, mid, post = self.groups()
        x = self.forward_pre(x)
        for blk in pre:
            x = blk(x, generator)
        pre_x = x if (self.collect_embeddings or routing) else None
        x, buckets = self.router(x, bucket)
        if routing:
            B, N, D = x.shape
            C = self.route_capacity or N
            passthru = buckets >= threshold
            # pass-through tokens first, in their order; truncate to C
            order = torch.argsort((~passthru).to(torch.int32), dim=-1,
                                  stable=True)
            sel = order[:, :C]
            idx = sel[..., None].expand(B, C, D)
            shortened = x.gather(1, idx)
            for blk in mid:
                shortened = blk(shortened, generator)
            full = pre_x.scatter(1, idx, shortened.to(pre_x.dtype))
            keep = torch.zeros(B, N, dtype=torch.bool, device=x.device)
            keep = keep.scatter(1, sel, True) & passthru
            x = torch.where(keep[..., None], full, pre_x)
        else:
            for blk in mid:
                x = blk(x, generator)
        for blk in post:
            x = blk(x, generator)
        x = self.norm(x)
        if self.head is None:
            out = x[:, 0]
        elif self.distilled:
            logits = self.head(x[:, 0].float())
            logits_dist = self.head_dist(x[:, 1].float())
            out = ((logits, logits_dist) if self.training
                   else (logits + logits_dist) / 2.0)
        else:
            out = self.head(x[:, 0].float())
        if self.collect_embeddings:
            return out, pre_x
        return out


@register_model
def deit_sw_tiny_patch16_224(pretrained=False, **kwargs):
    """reference models/model.py:103-122."""
    from .zoo import _common_kwargs

    extra = {k: kwargs[k] for k in ("buckets", "router_start", "router_end",
                                    "route_capacity", "collect_embeddings")
             if k in kwargs}
    return SwitchableVisionTransformer(
        patch_size=16, embed_dim=192, depth=12, num_heads=3, mlp_ratio=4.0,
        qkv_bias=True, **extra, **_common_kwargs(kwargs))
