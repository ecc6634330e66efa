"""The inputs a cell hands to both sides, made from the seed.

Each training batch and each block of served images has a generator of its
own, so the reference makes any one of them again without the others.
"""
from __future__ import annotations

import numpy as np
import torch

from .weights import generator


def train_batch(cfg: dict, batch: int, index: int, seed: int, device):
    """Batch ``index``: ``(images (B, S, S, 3) f32 ~ N(0, 1), the normalised
    images a data pipeline hands the model; labels (B,) int64 over the
    configuration's classes)``."""
    S = cfg["img_size"]
    g = generator(seed, f"train_batch:{index}", device)
    images = torch.randn((batch, S, S, 3), generator=g, device=device)
    labels = torch.randint(0, cfg["num_classes"], (batch,), generator=g,
                           device=device)
    return images, labels


def serve_block(cfg: dict, batch: int, index: int, seed: int, device):
    """Block ``index`` of served images: (B, S, S, 3) uint8 on the host,
    drawn on ``device``."""
    S = cfg["img_size"]
    g = generator(seed, f"serve_block:{index}", device)
    x = torch.randint(0, 256, (batch, S, S, 3), generator=g, device=device,
                      dtype=torch.uint8)
    return np.ascontiguousarray(x.cpu().numpy())
