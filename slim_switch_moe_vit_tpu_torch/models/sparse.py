"""Structured pruning: zeta-masked attention and MLP, and the network-wide
search controller, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/sparse.py``: :class:`SparseAttention`
(:36-92) with the head, uniform and full zeta shapes and the tanh per-patch
mask, :class:`SparseMlp` and :class:`SparseBlock` (:94-156), the controller
(:158-315: :func:`give_zetas`, :func:`calculate_search_threshold`,
:func:`get_sparsity_loss`, :func:`compress` with the last-to-first OR
propagation of the patch masks, :func:`decompress`, :func:`get_remaining`,
the FLOP and parameter counts) and ``sparse_deit_tiny_patch16_224``
(:331-351), built through ``VisionTransformer``'s ``block_factory``.

The soft zetas are parameters. The JAX ``pruning`` collection (the
binarized ``searched_zeta`` / ``searched_patch_zeta`` and the
``is_searched`` switch) is a set of buffers of the same names, which the
controller sets in place. As in the JAX package, a ``SparseBlock`` keeps
plain norms (torch's ``nn.LayerNorm``) and its own attention, so its blocks
launch none of the port's kernels; the model's final norm is
``VisionTransformer``'s LayerNorm (K1a).

The controller reads the zetas on the host in numpy f32, as the JAX one
does: a threshold is the element at sorted index ``int((1 - budget) *
len)``, compared with ``>=``.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_ffn import gelu_fast
from .layers import Dense, DropPath
from .registry import register_model


class SparseAttention(nn.Module):
    """reference layers.py:275-388."""

    def __init__(self, dim: int, num_heads: int, num_patches: int = 197,
                 qkv_bias: bool = True, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, head_search: bool = False,
                 uniform_search: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        d = dim // num_heads
        if head_search:
            zshape = (1, 1, num_heads, 1, 1)
        elif uniform_search:
            zshape = (1, 1, 1, 1, d)
        else:
            zshape = (1, 1, num_heads, 1, d)
        self.zeta = nn.Parameter(torch.ones(zshape))
        self.patch_zeta = nn.Parameter(torch.full((1, num_patches, 1), 3.0))
        self.register_buffer("is_searched", torch.tensor(0.0))
        self.register_buffer("searched_zeta", torch.ones(zshape))
        self.register_buffer("searched_patch_zeta",
                             torch.ones(1, num_patches, 1))
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.proj_drop = nn.Dropout(proj_drop)
        self.dtype = dtype

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.zeta)
        nn.init.constant_(self.patch_zeta, 3.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        d = C // H
        sw = self.is_searched
        z_patch = (sw * self.searched_patch_zeta
                   + (1 - sw) * torch.tanh(self.patch_zeta))
        z = sw * self.searched_zeta + (1 - sw) * self.zeta
        x = x * z_patch.to(x.dtype)
        qkv = self.qkv(x).reshape(B, N, 3, H, d).permute(2, 0, 3, 1, 4)
        qkv = qkv * z.transpose(0, 1).to(qkv.dtype)  # zeta on q, k and v
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
        attn = F.dropout(torch.softmax(attn, dim=-1), self.attn_drop,
                         training=self.training)
        out = torch.matmul(attn.to(v.dtype).float(), v.float())
        out = out.transpose(1, 2).reshape(B, N, C).to(self.dtype)
        return self.proj_drop(self.proj(out))


class SparseMlp(nn.Module):
    """reference layers.py:420-473."""

    def __init__(self, in_features: int, hidden_features: int,
                 drop: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.zeta = nn.Parameter(torch.ones(1, 1, hidden_features))
        self.register_buffer("is_searched", torch.tensor(0.0))
        self.register_buffer("searched_zeta",
                             torch.ones(1, 1, hidden_features))
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, in_features, dtype=dtype)
        self.drop = nn.Dropout(drop)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.zeta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sw = self.is_searched
        z = sw * self.searched_zeta + (1 - sw) * self.zeta
        x = gelu_fast(self.fc1(x))
        x = self.drop(x * z.to(x.dtype))  # removes fc1-out / fc2-in channels
        return self.drop(self.fc2(x))


class SparseBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, num_patches: int = 197,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32,
                 head_search: bool = False, uniform_search: bool = False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SparseAttention(
            dim, num_heads, num_patches=num_patches, qkv_bias=qkv_bias,
            attn_drop=attn_drop, proj_drop=drop, head_search=head_search,
            uniform_search=uniform_search, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = SparseMlp(dim, int(dim * mlp_ratio), drop=drop,
                             dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.drop_path(self.attn(self.norm1(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


# ---------------------------------------------------------------------------
# The network-wide pruning controller (reference base_model.py)
# ---------------------------------------------------------------------------

def sparse_modules(model: nn.Module
                   ) -> typ.List[typ.Tuple[str, nn.Module, str]]:
    """(name, module, kind) of every sparse layer in block order; kind is
    ``attn`` (with a patch zeta) or ``mlp``."""
    return [(n, m, "attn" if isinstance(m, SparseAttention) else "mlp")
            for n, m in model.named_modules()
            if isinstance(m, (SparseAttention, SparseMlp))]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def give_zetas(model: nn.Module):
    """All zeta values, flattened: (attention, MLP, tanh of the patch
    zetas) (reference base_model.py:62-76)."""
    za, zm, zp = [], [], []
    for _, m, kind in sparse_modules(model):
        if kind == "attn":
            za.extend(_host(m.zeta).ravel().tolist())
            zp.extend(np.tanh(_host(m.patch_zeta)).ravel().tolist())
        else:
            zm.extend(_host(m.zeta).ravel().tolist())
    return za, zm, zp


def calculate_search_threshold(model: nn.Module, budget_attn: float,
                               budget_mlp: float, budget_patch: float):
    """Percentile thresholds from budgets (reference base_model.py:14-22)."""
    za, zm, zp = (sorted(z) for z in give_zetas(model))
    ta = za[int((1.0 - budget_attn) * len(za))]
    tm = zm[int((1.0 - budget_mlp) * len(zm))]
    tp = zp[int((1.0 - budget_patch) * len(zp))]
    return ta, tm, tp


def get_sparsity_loss(model: nn.Module):
    """L1 over the zetas (reference base_model.py:49-60), differentiable:
    (attention, MLP, patch)."""
    la = lm = lp = 0.0
    for _, m, kind in sparse_modules(model):
        if kind == "attn":
            la = la + m.zeta.abs().sum()
            lp = lp + torch.tanh(m.patch_zeta).abs().sum()
        else:
            lm = lm + m.zeta.abs().sum()
    return la, lm, lp


@torch.no_grad()
def compress(model: nn.Module, budget_attn: float, budget_mlp: float,
             budget_patch: float):
    """Binarize every zeta at its budget's threshold, in place; the patch
    masks are OR-propagated from the last block to the first (reference
    base_model.py:88-118). Returns the thresholds (attention, MLP, 0)."""
    ta, tm, tp = calculate_search_threshold(model, budget_attn, budget_mlp,
                                            budget_patch)
    attn = []
    for _, m, kind in sparse_modules(model):
        thr = ta if kind == "attn" else tm
        m.is_searched.fill_(1.0)
        m.searched_zeta.copy_(torch.from_numpy(
            (_host(m.zeta) >= np.float32(thr)).astype(np.float32)))
        if kind == "attn":
            attn.append(m)
    mask = None
    for m in reversed(attn):
        keep = np.tanh(_host(m.patch_zeta)) >= np.float32(tp)
        mask = keep if mask is None else np.logical_or(mask, keep)
        m.searched_patch_zeta.copy_(torch.from_numpy(
            mask.astype(np.float32)))
    return ta, tm, 0


@torch.no_grad()
def decompress(model: nn.Module) -> None:
    """Back to the soft masks (reference base_model.py:134-136)."""
    for _, m, _ in sparse_modules(model):
        m.is_searched.fill_(0.0)


def get_remaining(model: nn.Module, num_patches: int):
    """Active fractions of the attention, MLP and patch zetas (reference
    base_model.py:29-47)."""
    ra = ta_ = rm = tm_ = rp = tp_ = 0.0
    for _, m, kind in sparse_modules(model):
        searched = float(m.is_searched) > 0
        z = _host(m.searched_zeta if searched else m.zeta)
        if kind == "attn":
            p = (_host(m.searched_patch_zeta) if searched
                 else np.tanh(_host(m.patch_zeta)))
            ra += float(z.sum())
            ta_ += z.size
            rp += float(p.sum())
            tp_ += num_patches
        else:
            rm += float(z.sum())
            tm_ += z.size
    return ra / max(ta_, 1), rm / max(tm_, 1), rp / max(tp_, 1)


def sparse_attention_flops(dim: int, num_heads: int, searched_zeta,
                           num_patches: int, active_patches: float,
                           head_search=False, uniform_search=False):
    """(total, active) FLOPs of one sparse attention (reference
    layers.py:362-383)."""
    H, d = num_heads, dim // num_heads
    N, n = num_patches, active_patches
    sd = float(np.sum(np.asarray(searched_zeta)))
    if head_search:
        sd *= d
    elif uniform_search:
        sd *= H
    total = N * (H * d * (3 * H * d)) + 3 * N * H * d
    total += H * N * d * N + H * N * N
    total += 5 * H * N * N
    total += H * N * N * d
    total += N * (H * d * (H * d)) + N * H * d
    active = n * (H * d * (3 * sd)) + 3 * n * sd
    active += n * n * sd + H * n * n
    active += 5 * H * n * n
    active += n * n * sd
    active += n * (sd * (H * d)) + n * H * d
    return total, active


def sparse_mlp_params_count(dim_in: int, hidden: int, searched_zeta):
    """(total, active) parameters of one sparse MLP (reference
    layers.py:458-464)."""
    active = float(np.sum(np.asarray(searched_zeta)))
    total = 2 * (dim_in * hidden) + dim_in + hidden
    act = 2 * (dim_in * active) + dim_in + active
    return total, act


@register_model
def sparse_deit_tiny_patch16_224(pretrained=False, head_search=False,
                                 uniform_search=False, **kwargs):
    """ViT-tiny with zeta-prunable attention and MLP in every block."""
    from .vit import VisionTransformer
    from .zoo import _common_kwargs

    common = _common_kwargs(kwargs)
    n_patches = (common.get("img_size", 224) // 16) ** 2 + 1

    def block_factory(i, **bk):
        bk.pop("use_flash", None)  # SparseAttention has its own attention
        return SparseBlock(num_patches=n_patches, head_search=head_search,
                           uniform_search=uniform_search, **bk)

    return VisionTransformer(patch_size=16, embed_dim=192, depth=12,
                             num_heads=3, mlp_ratio=4.0, qkv_bias=True,
                             block_factory=block_factory, **common)
