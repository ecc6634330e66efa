"""Keyword mapping shared by the model registrations.

Port of ``_common_kwargs`` of ``slim_switch_moe_vit_tpu/models/zoo.py``
(:30-49). The DeiT registrations themselves are not ported yet.
"""
from __future__ import annotations


def _common_kwargs(kwargs: dict) -> dict:
    """Map the training CLI's model kwargs onto VisionTransformer fields.
    Unknown keys (``pretrained``, ...) are ignored, as in the JAX package."""
    if kwargs.get("use_flash"):
        raise NotImplementedError(
            "use_flash: the flash-attention kernel (K11) is not ported yet "
            "(ROADMAP Queue 2)")
    keys = ("num_classes", "img_size", "drop_rate", "drop_path_rate", "dtype")
    return {k: kwargs[k] for k in keys if k in kwargs}
