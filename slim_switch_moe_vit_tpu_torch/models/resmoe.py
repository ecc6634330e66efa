"""Switch-MoE ViT registrations.

Port of ``_moe_kwargs`` (:159-172), ``_moe_vit`` (:197-214) and the
``moe_tiny/small/base`` registrations (:233-248) of
``slim_switch_moe_vit_tpu/models/resmoe.py``: a ViT whose every block MLP
is an 8-expert (32 for base) top-2 dropless MoE. The gated ResMoE blocks
are not ported yet.
"""
from __future__ import annotations

from .moe import MoEMlp
from .registry import register_model
from .vit import VisionTransformer
from .zoo import _common_kwargs


def _moe_kwargs(kwargs: dict) -> dict:
    """Pop the MoE kwargs (the gate thresholds and capacity factors are
    accepted for the same call surface; the dropless modes ignore them)."""
    for unused in ("starting_threshold", "target_threshold",
                   "capacity_factor", "eval_capacity_factor", "resmoe_mode",
                   "token_capacity"):
        kwargs.pop(unused, None)
    dense = kwargs.pop("parity_dense", False)
    mode = kwargs.pop("dispatch_mode", "auto")
    return dict(num_experts=kwargs.pop("num_experts", 8),
                top_k=kwargs.pop("moe_top_k", 2),
                dispatch_mode="dense" if dense else mode)


def _moe_vit(embed_dim: int, num_heads: int, moe: dict, **kwargs):
    def mlp_factory(idx, dim, ratio, drop, dtype):
        return MoEMlp(dim, int(dim * ratio), drop=drop, **moe)

    return VisionTransformer(
        patch_size=16, embed_dim=embed_dim, depth=12, num_heads=num_heads,
        mlp_ratio=4.0, qkv_bias=True, block_mlp_factory=mlp_factory,
        **_common_kwargs(kwargs))


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
