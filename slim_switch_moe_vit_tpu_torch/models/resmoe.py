"""ResMoE: gated residual blocks with MoE MLPs, and the model registrations.

Port of ``slim_switch_moe_vit_tpu/models/resmoe.py``: :class:`ResMoEBlock`
(:40-156), ``_moe_kwargs`` (:159-172), ``_resmoe_vit`` / ``_moe_vit``
(:175-214) and the ``resmoe_*`` / ``moe_*`` registrations (:217-248). The
block wiring is the reference's ``forward_residule_moe``:

    x = norm1(x); m = dense_gate(x); skip, tk = x*m[..., 0], x*m[..., 1]
    x = drop_path(attn(tk)) + tk + skip
    x = norm2(x); m = moe_gate(x);   skip, tk = x*m[..., 0], x*m[..., 1]
    x = drop_path(moe_mlp(tk)) + tk + skip

In the residual-deferred chain the block returns the MoE branch and its
passthrough un-added; the next norm1 (or the final norm) folds the add into
the slim LN, which never writes the sum (the reference norms straight
through the residual). So block 0's norm1 is the plain LN (K1a) and every
other norm the slim LN (K2a/K2b): 1 + 24 LN launches per forward.

``resmoe_mode``:

- ``'parity'``: skipped tokens are zero-masked, attention and the MoE run
  over the full sequence (the reference's semantics);
- ``'compact'``: the top ``ceil(N * token_capacity)`` tokens by keep
  weight (rounded up to 8, at most N; a stable sort, so ties keep token
  order) are gathered, the sub-block runs on the short sequence, and the
  result is scattered back; tokens outside the selection contribute zero.
"""
from __future__ import annotations

import math
import typing as typ

import torch
from torch import nn

from .gates import TokenGate
from .layers import DropPath, LayerNorm
from .moe import MoEMlp
from .registry import register_model
from .vit import Attention, VisionTransformer
from .zoo import _common_kwargs


class ResMoEBlock(nn.Module):
    """Gated attention + gated MoE-MLP block."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_flash: bool = False,
                 num_experts: int = 8, top_k: int = 2,
                 dispatch_mode: str = "auto",
                 starting_threshold: float = 1.0,
                 target_threshold: float = 0.9, mode: str = "parity",
                 token_capacity: float = 1.0):
        super().__init__()
        if mode not in ("parity", "compact"):
            raise ValueError(f"resmoe mode {mode!r}: parity or compact")
        self.mode = mode
        self.token_capacity = token_capacity
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias,
                              attn_drop=attn_drop, proj_drop=drop, dtype=dtype,
                              use_flash=use_flash)
        self.norm2 = LayerNorm(dim)
        self.mlp = MoEMlp(dim, int(dim * mlp_ratio), num_experts=num_experts,
                          top_k=top_k, drop=drop, dispatch_mode=dispatch_mode)
        self.dense_gate = TokenGate(dim, starting_threshold, target_threshold)
        self.moe_gate = TokenGate(dim, starting_threshold, target_threshold)
        self.drop_path = DropPath(drop_path)

    def _compact_apply(self, fn, x: torch.Tensor,
                       keep_w: torch.Tensor) -> torch.Tensor:
        """Gather the top-C tokens of ``x`` by keep weight, run ``fn`` on the
        short sequence, scatter back; the gate weight still multiplies (the
        STE gradient path) and tokens beyond capacity are zeroed."""
        B, N, d = x.shape
        C = math.ceil(N * self.token_capacity)
        C = min((C + 7) // 8 * 8, N)
        order = torch.argsort(-keep_w[..., 0], dim=-1, stable=True)
        sel = order[:, :C]
        idx = sel[..., None].expand(B, C, d)
        out_short = fn(torch.gather(x, 1, idx))
        out = torch.zeros_like(x).scatter(1, idx, out_short.to(x.dtype))
        in_sel = torch.zeros(B, N, dtype=x.dtype, device=x.device).scatter(
            1, sel, 1.0)
        return out * keep_w.to(x.dtype) * in_sel[..., None]

    def _gated_sub_block(self, xn, gate, fn, generator):
        """(branch = drop_path(fn(kept)), passthrough = tk + skip)."""
        mask = gate(xn)
        skip = xn * mask[..., 0:1].to(xn.dtype)
        tk = xn * mask[..., 1:2].to(xn.dtype)
        if self.mode == "compact":
            y = self._compact_apply(fn, xn, mask[..., 1:2])
        else:
            y = fn(tk)
        return self.drop_path(y, generator), tk + skip

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        y, s = self.deferred_call(x, None, generator)
        return y + s

    def deferred_call(self, u: torch.Tensor,
                      pending: typ.Optional[torch.Tensor],
                      generator: typ.Optional[torch.Generator] = None):
        """Residual-deferred form: ``pending`` (the previous block's
        passthrough) is added inside norm1's slim LN. Returns the MoE branch
        and its passthrough un-added."""
        if pending is None:
            xn = self.norm1(u)
        else:
            xn = self.norm1(u, residual=pending, emit_sum=False)
        y, s = self._gated_sub_block(xn, self.dense_gate, self.attn, generator)
        xn2 = self.norm2(y, residual=s, emit_sum=False)
        return self._gated_sub_block(xn2, self.moe_gate, self.mlp, generator)


def _moe_kwargs(kwargs: dict) -> dict:
    """Pop the MoE and gate kwargs (the training CLI passes all of them).
    The capacity factors are dropped: every ported dispatch mode is
    dropless, and the JAX package's dropless ``MoEMlp`` ignores them too."""
    for unused in ("capacity_factor", "eval_capacity_factor"):
        kwargs.pop(unused, None)
    dense = kwargs.pop("parity_dense", False)
    mode = kwargs.pop("dispatch_mode", "auto")
    return dict(num_experts=kwargs.pop("num_experts", 8),
                top_k=kwargs.pop("moe_top_k", 2),
                dispatch_mode="dense" if dense else mode,
                starting_threshold=kwargs.pop("starting_threshold", 1.0),
                target_threshold=kwargs.pop("target_threshold", 0.9),
                mode=kwargs.pop("resmoe_mode", "parity"),
                token_capacity=kwargs.pop("token_capacity", 1.0))


# the gate and token-skip settings of _moe_kwargs, which blocks without
# gates do not take (the JAX package's _moe_vit drops them the same way)
_GATE_KEYS = ("starting_threshold", "target_threshold", "mode",
              "token_capacity")


def _resmoe_vit(embed_dim: int, num_heads: int, moe: dict, **kwargs):
    def block_factory(idx, **bk):
        return ResMoEBlock(**moe, **bk)

    return VisionTransformer(
        patch_size=16, embed_dim=embed_dim, depth=12, num_heads=num_heads,
        mlp_ratio=4.0, qkv_bias=True, block_factory=block_factory,
        **_common_kwargs(kwargs))


def _moe_vit(embed_dim: int, num_heads: int, moe: dict, **kwargs):
    moe = {k: v for k, v in moe.items() if k not in _GATE_KEYS}

    def mlp_factory(idx, dim, ratio, drop, dtype):
        return MoEMlp(dim, int(dim * ratio), drop=drop, **moe)

    return VisionTransformer(
        patch_size=16, embed_dim=embed_dim, depth=12, num_heads=num_heads,
        mlp_ratio=4.0, qkv_bias=True, block_mlp_factory=mlp_factory,
        **_common_kwargs(kwargs))


@register_model
def resmoe_tiny_patch16_224_expert8(pretrained=False, **kwargs):
    """Gates + 8-expert top-2 MoE in all 12 blocks (reference
    resMoE.py:151-187)."""
    return _resmoe_vit(192, 3, _moe_kwargs(kwargs), **kwargs)


@register_model
def resmoe_small_patch16_224_expert8(pretrained=False, **kwargs):
    return _resmoe_vit(384, 6, _moe_kwargs(kwargs), **kwargs)


@register_model
def resmoe_base_patch16_224_expert8(pretrained=False, **kwargs):
    return _resmoe_vit(768, 12, _moe_kwargs(kwargs), **kwargs)


@register_model
def moe_tiny_patch16_224_expert8(pretrained=False, **kwargs):
    """MoE MLP only, no gates (reference resMoE.py:190-209)."""
    return _moe_vit(192, 3, _moe_kwargs(kwargs), **kwargs)


@register_model
def moe_small_patch16_224_expert8(pretrained=False, **kwargs):
    return _moe_vit(384, 6, _moe_kwargs(kwargs), **kwargs)


@register_model
def moe_base_patch16_224_expert32(pretrained=False, **kwargs):
    """ViT-B/16 with 32 experts."""
    kwargs.setdefault("num_experts", 32)
    return _moe_vit(768, 12, _moe_kwargs(kwargs), **kwargs)
