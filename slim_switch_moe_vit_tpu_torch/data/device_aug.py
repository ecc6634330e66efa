"""On-device augmentation and eval normalization, in PyTorch.

Port of ``build_device_augment`` (:313-374) and ``build_eval_normalize``
(:377-397) of ``slim_switch_moe_vit_tpu/data/device_aug.py``, with the
ImageNet constants of ``data/datasets.py``. Batches arrive as uint8 NHWC on
the device; the training pipeline is hflip -> normalize (timm's order), the
flips drawn from the caller's explicit ``torch.Generator``. RandAugment,
3-Augment, color jitter and random erasing are not ported yet and raise
(ROADMAP Queue 1 #3).
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def _scaled(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.float32) * np.float32(255.0))


def build_device_augment(*, input_size: int,
                         aa: typ.Optional[str] = "rand-m9-mstd0.5-inc1",
                         hflip: float = 0.5, color_jitter: float = 0.3,
                         reprob: float = 0.25, recount: int = 1,
                         three_augment: bool = False,
                         mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD):
    """Returns fn(generator, uint8 images NHWC) -> normalized f32 NHWC on the
    images' device: each sample flipped left-right with probability
    ``hflip``, then (x - mean*255) / (std*255)."""
    unported = {"--aa (RandAugment)": aa, "--ThreeAugment": three_augment,
                "--color-jitter": color_jitter, "--reprob (random erasing)":
                reprob}
    asked = [k for k, v in unported.items() if v]
    if asked:
        raise NotImplementedError(
            f"{', '.join(asked)}: the photometric augmentations are not "
            "ported yet (ROADMAP Queue 1 #3); pass --aa '' --color-jitter 0 "
            "--reprob 0")
    mean_a, std_a = _scaled(mean), _scaled(std)

    def augment(generator: torch.Generator,
                images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        flip = torch.rand(x.shape[0], device=x.device,
                          generator=generator) < hflip
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return (x - mean_a.to(x.device)) / std_a.to(x.device)

    return augment


def build_eval_normalize(mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD,
                         dtype: typ.Optional[torch.dtype] = None):
    """images (uint8 NHWC, any device) -> (images - mean*255) / (std*255) in
    f32 on the images' device, then cast to ``dtype`` when given (the JAX
    order)."""
    mean_a, std_a = _scaled(mean), _scaled(std)

    def normalize(images: torch.Tensor) -> torch.Tensor:
        y = ((images.float() - mean_a.to(images.device))
             / std_a.to(images.device))
        return y if dtype is None else y.to(dtype)

    return normalize
