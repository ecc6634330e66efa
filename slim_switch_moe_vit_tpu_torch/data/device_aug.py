"""On-device eval normalization, in PyTorch.

Port of ``build_eval_normalize`` of
``slim_switch_moe_vit_tpu/data/device_aug.py`` (:377-397) and the ImageNet
constants of ``data/datasets.py``. The augmentation pipeline is not ported
yet.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def build_eval_normalize(mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                         dtype: typ.Optional[torch.dtype] = None):
    """images (uint8 NHWC, any device) -> (images - mean*255) / (std*255) in
    f32 on the images' device, then cast to ``dtype`` when given (the JAX
    order)."""
    mean_a = torch.from_numpy(np.asarray(mean, np.float32) * np.float32(255.0))
    std_a = torch.from_numpy(np.asarray(std, np.float32) * np.float32(255.0))

    def normalize(images: torch.Tensor) -> torch.Tensor:
        y = ((images.float() - mean_a.to(images.device))
             / std_a.to(images.device))
        return y if dtype is None else y.to(dtype)

    return normalize
