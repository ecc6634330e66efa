"""The DeiT and timm ViT registrations, and the keyword mapping the other
registrations share.

Port of ``slim_switch_moe_vit_tpu/models/zoo.py``: ``_vit`` and
``_common_kwargs`` (:16-49), the eight DeiT names
``deit_{tiny,small,base}[_distilled]_patch16_{224,384}`` (:52-91) and the
26 timm ViT names of ``_register_timm_vits`` (:108-179): the 1k models,
the ``*_in21k`` heads (21,843 classes; ``vit_large_patch32_224_in21k`` and
``vit_huge_patch14_224_in21k`` with the pre-logits layer) and the
``*_miil`` models without qkv bias.

The pre-logits layer is dropped when ``num_classes`` is set to another
count than the model's own, as the original timm registration does for
fine-tuning. The JAX package keeps it (its zoo.py:169); this is a
divergence from the JAX package, kept on purpose.
"""
from __future__ import annotations

from .registry import register_model
from .vit import VisionTransformer


def _vit(distilled: bool = False, **over) -> VisionTransformer:
    kw = dict(patch_size=16, embed_dim=768, depth=12, num_heads=12,
              mlp_ratio=4.0, qkv_bias=True, distilled=distilled)
    kw.update(over)
    return VisionTransformer(**kw)


def _common_kwargs(kwargs: dict) -> dict:
    """Map the training CLI's model kwargs onto VisionTransformer fields.
    Unknown keys (``pretrained``, ...) are ignored, as in the JAX package."""
    keys = ("num_classes", "img_size", "drop_rate", "drop_path_rate", "dtype",
            "use_flash")
    return {k: kwargs[k] for k in keys if k in kwargs}


@register_model
def deit_tiny_patch16_224(pretrained=False, **kwargs):
    return _vit(embed_dim=192, num_heads=3, **_common_kwargs(kwargs))


@register_model
def deit_small_patch16_224(pretrained=False, **kwargs):
    return _vit(embed_dim=384, num_heads=6, **_common_kwargs(kwargs))


@register_model
def deit_base_patch16_224(pretrained=False, **kwargs):
    return _vit(embed_dim=768, num_heads=12, **_common_kwargs(kwargs))


@register_model
def deit_tiny_distilled_patch16_224(pretrained=False, **kwargs):
    return _vit(distilled=True, embed_dim=192, num_heads=3,
                **_common_kwargs(kwargs))


@register_model
def deit_small_distilled_patch16_224(pretrained=False, **kwargs):
    return _vit(distilled=True, embed_dim=384, num_heads=6,
                **_common_kwargs(kwargs))


@register_model
def deit_base_distilled_patch16_224(pretrained=False, **kwargs):
    return _vit(distilled=True, embed_dim=768, num_heads=12,
                **_common_kwargs(kwargs))


@register_model
def deit_base_patch16_384(pretrained=False, **kwargs):
    kwargs.setdefault("img_size", 384)
    return _vit(embed_dim=768, num_heads=12, **_common_kwargs(kwargs))


@register_model
def deit_base_distilled_patch16_384(pretrained=False, **kwargs):
    kwargs.setdefault("img_size", 384)
    return _vit(distilled=True, embed_dim=768, num_heads=12,
                **_common_kwargs(kwargs))


# The timm ViTs (the JAX zoo.py:108-179): the fields each name sets over
# _vit's; ``img`` and ``classes`` are the defaults of img_size and
# num_classes.
_TIMM_VITS = {
    "vit_tiny_patch16_224": dict(embed_dim=192, num_heads=3),
    "vit_tiny_patch16_384": dict(embed_dim=192, num_heads=3, img=384),
    "vit_small_patch32_224": dict(patch_size=32, embed_dim=384, num_heads=6),
    "vit_small_patch32_384": dict(patch_size=32, embed_dim=384, num_heads=6,
                                  img=384),
    "vit_small_patch16_224": dict(embed_dim=384, num_heads=6),
    "vit_small_patch16_384": dict(embed_dim=384, num_heads=6, img=384),
    "vit_base_patch32_224": dict(patch_size=32, embed_dim=768, num_heads=12),
    "vit_base_patch32_384": dict(patch_size=32, embed_dim=768, num_heads=12,
                                 img=384),
    "vit_base_patch16_224": dict(embed_dim=768, num_heads=12),
    "vit_base_patch16_384": dict(embed_dim=768, num_heads=12, img=384),
    "vit_base_patch8_224": dict(patch_size=8, embed_dim=768, num_heads=12),
    "vit_large_patch32_224": dict(patch_size=32, embed_dim=1024, num_heads=16,
                                  depth=24),
    "vit_large_patch32_384": dict(patch_size=32, embed_dim=1024, num_heads=16,
                                  depth=24, img=384),
    "vit_large_patch16_224": dict(embed_dim=1024, num_heads=16, depth=24),
    "vit_large_patch16_384": dict(embed_dim=1024, num_heads=16, depth=24,
                                  img=384),
    "vit_huge_patch14_224": dict(patch_size=14, embed_dim=1280, num_heads=16,
                                 depth=32),
    "vit_tiny_patch16_224_in21k": dict(embed_dim=192, num_heads=3,
                                       classes=21843),
    "vit_small_patch32_224_in21k": dict(patch_size=32, embed_dim=384,
                                        num_heads=6, classes=21843),
    "vit_small_patch16_224_in21k": dict(embed_dim=384, num_heads=6,
                                        classes=21843),
    "vit_base_patch32_224_in21k": dict(patch_size=32, embed_dim=768,
                                       num_heads=12, classes=21843),
    "vit_base_patch16_224_in21k": dict(embed_dim=768, num_heads=12,
                                       classes=21843),
    "vit_large_patch32_224_in21k": dict(patch_size=32, embed_dim=1024,
                                        num_heads=16, depth=24,
                                        representation_size=1024,
                                        classes=21843),
    "vit_large_patch16_224_in21k": dict(embed_dim=1024, num_heads=16,
                                        depth=24, classes=21843),
    "vit_huge_patch14_224_in21k": dict(patch_size=14, embed_dim=1280,
                                       num_heads=16, depth=32,
                                       representation_size=1280,
                                       classes=21843),
    # Alibaba-MIIL weights: no qkv bias
    "vit_base_patch16_224_miil_in21k": dict(embed_dim=768, num_heads=12,
                                            qkv_bias=False, classes=11221),
    "vit_base_patch16_224_miil": dict(embed_dim=768, num_heads=12,
                                      qkv_bias=False),
}


def _timm_vit(spec: dict):
    def ctor(pretrained=False, **kwargs):
        s = dict(spec)
        img, classes = s.pop("img", None), s.pop("classes", 1000)
        if img is not None:
            kwargs.setdefault("img_size", img)
        kwargs.setdefault("num_classes", classes)
        if kwargs["num_classes"] != classes:
            # timm drops the pre-logits layer for a new head (fine-tuning)
            s.pop("representation_size", None)
        return _vit(**s, **_common_kwargs(kwargs))
    return ctor


for _name, _spec in _TIMM_VITS.items():
    _ctor = _timm_vit(_spec)
    _ctor.__name__ = _name
    register_model(_ctor)
