"""Host-side per-sample transforms: the geometry before batching.

Port of ``slim_switch_moe_vit_tpu/data/transforms.py``. The host does
RandomResizedCrop (train) or resize + center crop (eval) to a fixed size on
uint8, and everything batchable runs on the device (``device_aug.py``), so
batches travel to the card as uint8.

The crop boxes (:func:`rrc_params`, the per-sample generator of
:class:`TrainTransform`) are the JAX package's, number for number. The
bicubic resize is ``torch.nn.functional.interpolate(mode="bicubic",
antialias=True)`` on the host (PIL's filter: a = -0.5, support scaled when
shrinking) in place of PIL or the package's native library, neither of
which the card host has; its pixels agree with the JAX package's within a
few uint8 levels (float sums against PIL's fixed-point ones; the bound is
in tests/test_torch_driver.py).

Eval geometry (reference datasets.py:310-318): resize the short side to
``int(256/224 * input_size)`` bicubic, then center crop.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch
import torch.nn.functional as F


def resize_bicubic(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) uint8 -> (out_h, out_w, C) uint8, antialiased bicubic."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=(out_h, out_w), mode="bicubic",
                      align_corners=False, antialias=True)
    y = y.round_().clamp_(0, 255).to(torch.uint8)
    return y[0].permute(1, 2, 0).contiguous().numpy()


def _crop_resize(img: np.ndarray, i: int, j: int, h: int, w: int, size: int,
                 interp_name: str) -> np.ndarray:
    """Crop rows [i, i+h) and columns [j, j+w), resize to size x size."""
    if interp_name != "bicubic":
        raise NotImplementedError(
            f"--train-interpolation {interp_name!r}: only bicubic is ported")
    return resize_bicubic(img[i:i + h, j:j + w], size, size)


def rrc_params(img_shape, rng: np.random.RandomState, scale=(0.08, 1.0),
               ratio=(3 / 4, 4 / 3)):
    """RandomResizedCrop box sampling (timm semantics). Returns (i, j, h, w)."""
    H, W = img_shape[:2]
    area = H * W
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        log_ratio = (np.log(ratio[0]), np.log(ratio[1]))
        aspect = np.exp(rng.uniform(*log_ratio))
        w = int(round(np.sqrt(target_area * aspect)))
        h = int(round(np.sqrt(target_area / aspect)))
        if 0 < w <= W and 0 < h <= H:
            i = rng.randint(0, H - h + 1)
            j = rng.randint(0, W - w + 1)
            return i, j, h, w
    in_ratio = W / H
    if in_ratio < ratio[0]:
        w, h = W, int(round(W / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = H, int(round(H * ratio[1]))
    else:
        w, h = W, H
    return (H - h) // 2, (W - w) // 2, h, w


def random_resized_crop(img: np.ndarray, size: int, rng: np.random.RandomState,
                        scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                        interpolation: str = "bicubic") -> np.ndarray:
    """timm RandomResizedCropAndInterpolation semantics."""
    i, j, h, w = rrc_params(img.shape, rng, scale, ratio)
    return _crop_resize(img, i, j, h, w, size, interpolation)


def resize_center_crop(img: np.ndarray, size: int,
                       crop_ratio: float = 0.875) -> np.ndarray:
    """Eval path: short side -> size/crop_ratio (256 for 224), center crop,
    in one pass: the centered region whose short side is ``short *
    crop_ratio`` resized to size x size."""
    H, W = img.shape[:2]
    scale_size = int(size / crop_ratio)
    if H < W:
        ch = int(round(H * size / scale_size))
        cw = ch
    else:
        cw = int(round(W * size / scale_size))
        ch = cw
    i = (H - ch) // 2
    j = (W - cw) // 2
    return _crop_resize(img, i, j, ch, cw, size, "bicubic")


def simple_random_crop(img: np.ndarray, size: int, rng: np.random.RandomState,
                       padding: int = 4) -> np.ndarray:
    """DeiT-III SRC: resize the short side to ``size``, then a reflect-pad
    random crop (reference augment.py:101-106); also the <=32px RandomCrop
    path (datasets.py:304-307)."""
    arr = img
    if min(img.shape[:2]) != size:
        H, W = img.shape[:2]
        if H < W:
            nh, nw = size, int(round(W * size / H))
        else:
            nh, nw = int(round(H * size / W)), size
        arr = resize_bicubic(img, nh, nw)
    arr = np.pad(arr, ((padding, padding), (padding, padding), (0, 0)),
                 mode="reflect")
    H, W = arr.shape[:2]
    i = rng.randint(0, H - size + 1)
    j = rng.randint(0, W - size + 1)
    return arr[i:i + size, j:j + size]


class TrainTransform:
    """Host geometry for training.

    Reproducible under threads: each call derives a fresh RandomState from
    (seed, epoch, sample index) via SeedSequence, so loader workers share no
    generator and two runs with the same seed give the same batches. Call
    ``set_epoch`` next to the sampler's."""

    wants_index = True

    def __init__(self, input_size: int, src: bool = False,
                 interpolation: str = "bicubic", seed: int = 0):
        self.input_size = input_size
        self.src = src
        self.interpolation = interpolation
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.RandomState:
        ss = np.random.SeedSequence([self.seed, self.epoch, int(index)])
        return np.random.RandomState(ss.generate_state(1)[0])

    def __call__(self, img: np.ndarray, index: int = 0) -> np.ndarray:
        rng = self._rng(index)
        small = min(img.shape[:2]) <= 32 and self.input_size <= 32
        if small or self.src:
            return simple_random_crop(img, self.input_size, rng)
        return random_resized_crop(img, self.input_size, rng,
                                   interpolation=self.interpolation)


class EvalTransform:
    def __init__(self, input_size: int, crop_ratio: float = 0.875):
        self.input_size = input_size
        self.crop_ratio = crop_ratio

    def __call__(self, img: np.ndarray) -> np.ndarray:
        if img.shape[0] == img.shape[1] == self.input_size:
            return img
        if self.input_size <= 32:  # no crop for small images (reference :291)
            return resize_bicubic(img, self.input_size, self.input_size)
        return resize_center_crop(img, self.input_size, self.crop_ratio)


def build_transform(is_train: bool, args) -> typ.Callable:
    """The host part of reference datasets.py:290-322; the photometric ops
    run on the device (``device_aug.build_device_augment``)."""
    if is_train:
        return TrainTransform(
            args.input_size, src=getattr(args, "src", False),
            interpolation=getattr(args, "train_interpolation", "bicubic"),
            seed=getattr(args, "seed", 0),
        )
    return EvalTransform(args.input_size,
                         crop_ratio=getattr(args, "eval_crop_ratio", 0.875))
