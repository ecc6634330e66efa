"""On-device augmentation and eval normalization, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/data/device_aug.py`` (:41-397), with the
ImageNet constants of ``data/datasets.py``. Batches arrive as uint8 NHWC on
the device. The training pipeline is timm's order: hflip -> RandAugment
(``--aa rand-m{M}-mstd{S}[-inc1]``), or 3-Augment (``--ThreeAugment``), or
color jitter alone -> normalize -> random erasing (``--reprob``, pixel
mode, in normalized space).

The whole batch is augmented at once: every per-sample parameter (flip,
op, magnitude, sign, box, ...) is a tensor over the batch, drawn on the
images' device from the caller's ``torch.Generator`` in a fixed order, and
each op is computed for every sample and kept where the sample drew it. No
value goes back to the host.

- RandAugment: the 15 ops of the JAX ``_RA_OPS`` (:203-235), two layers,
  each applied with probability 0.5 at magnitude N(m, mstd) clipped to [0,
  10], negated with probability 0.5 on the signed ops. The five affine ops
  share one bilinear resample a layer, from the per-sample 2x3 matrices:
  the JAX ``map_coordinates(order=1, mode="constant", cval=128)`` equals
  ``grid_sample(img - 128, zeros padding, align_corners=True) + 128``.
- 3-Augment (:238-279): grayscale, solarize at 128, or a Gaussian blur
  (sigma in U(0.1, 2.0), a 9x9 separable kernel), then color jitter.
- Color jitter (:251-260): brightness, contrast, saturation factors in
  U(1 - s, 1 + s).
- Random erasing (:282-310): ``recount`` boxes of area U(0.02, 1/3) of the
  image over ``recount`` and log-aspect U(log 0.3, log 1/0.3), filled with
  unit Gaussian noise, each with probability ``reprob``.
"""
from __future__ import annotations

import math
import typing as typ

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

FILL = 128.0
_LEVEL_DENOM = 10.0
NUM_LAYERS = 2


def _scaled(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, np.float32) * np.float32(255.0))


def _v(t: torch.Tensor) -> torch.Tensor:
    """A per-sample (B,) tensor broadcast over (B, H, W, C) images."""
    return t.reshape(-1, 1, 1, 1)


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, device=device, generator=generator)


# ---------------------------------------------------------------------------
# Geometry: (B, H, W, 3) f32 in [0, 255]; inverse-affine sampling.
# ---------------------------------------------------------------------------

def _affine(img: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Resample each image through its inverse affine matrix (mats: (B, 2,
    3); in = mat @ (x_out, y_out, 1)), bilinear, grey (128) outside."""
    B, H, W, _ = img.shape
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    m = mats.float()[:, :, :, None, None]
    x_in = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    y_in = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    grid = torch.stack([x_in * (2.0 / max(W - 1, 1)) - 1.0,
                        y_in * (2.0 / max(H - 1, 1)) - 1.0], dim=-1)
    out = F.grid_sample((img - FILL).permute(0, 3, 1, 2), grid,
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)
    return out.permute(0, 2, 3, 1) + FILL


def _center_mat(H: int, W: int, a, b, c, d, e, f) -> torch.Tensor:
    """PIL-style affine about the image center, (B, 2, 3)."""
    cx, cy = (W - 1) * 0.5, (H - 1) * 0.5
    c2 = c + cx - (a * cx + b * cy)
    f2 = f + cy - (d * cx + e * cy)
    return torch.stack([torch.stack([a, b, c2], -1),
                        torch.stack([d, e, f2], -1)], -2)


def _rotate_mat(mag, H, W):
    rad = mag / _LEVEL_DENOM * 30.0 * math.pi / 180.0
    cos, sin = torch.cos(rad), torch.sin(rad)
    zero = torch.zeros_like(mag)
    return _center_mat(H, W, cos, sin, zero, -sin, cos, zero)


def _shear_x_mat(mag, H, W):
    s, one, zero = mag / _LEVEL_DENOM * 0.3, torch.ones_like(mag), \
        torch.zeros_like(mag)
    return _center_mat(H, W, one, s, zero, zero, one, zero)


def _shear_y_mat(mag, H, W):
    s, one, zero = mag / _LEVEL_DENOM * 0.3, torch.ones_like(mag), \
        torch.zeros_like(mag)
    return _center_mat(H, W, one, zero, zero, s, one, zero)


def _translate_mat(tx, ty):
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack([torch.stack([one, zero, tx], -1),
                        torch.stack([zero, one, ty], -1)], -2)


def _translate_x_mat(mag, H, W):
    return _translate_mat(mag / _LEVEL_DENOM * 0.45 * W, torch.zeros_like(mag))


def _translate_y_mat(mag, H, W):
    return _translate_mat(torch.zeros_like(mag), mag / _LEVEL_DENOM * 0.45 * H)


# ---------------------------------------------------------------------------
# Photometric ops: (B, H, W, 3) f32 and per-sample magnitudes (B,)
# ---------------------------------------------------------------------------

def _grayscale(img: torch.Tensor) -> torch.Tensor:
    # PIL L-mode weights
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return g[..., None].expand_as(img)


def _blend(a, b, factor):
    return a + factor * (b - a)


def _autocontrast(img, mag):
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    scale = torch.where(hi > lo, 255.0 / (hi - lo), torch.ones_like(lo))
    off = torch.where(hi > lo, -lo * scale, torch.zeros_like(lo))
    return (img * scale + off).clamp(0.0, 255.0)


def _equalize(img, mag):
    """PIL's equalize, channel by channel: (B*3, 256) histograms by
    ``scatter_add_``, the LUT from their exclusive cumsum in integers."""
    B, H, W, C = img.shape
    ints = img.clamp(0, 255).to(torch.int64).permute(0, 3, 1, 2).reshape(
        B * C, H * W)
    hist = torch.zeros(B * C, 256, dtype=torch.int64, device=img.device)
    hist.scatter_add_(1, ints, torch.ones_like(ints))
    step = (hist.sum(1, keepdim=True) - hist[:, 255:]) // 255
    csum = hist.cumsum(1) - hist  # exclusive
    lut = torch.where(step > 0, (csum + step // 2) // step.clamp(min=1),
                      torch.zeros_like(csum)).clamp(0, 255).float()
    out = lut.gather(1, ints).reshape(B, C, H, W).permute(0, 2, 3, 1)
    keep = (step > 0).reshape(B, C)[:, None, None, :]
    return torch.where(keep, out, img)


def _invert(img, mag):
    return 255.0 - img


def _posterize(img, mag):
    # PosterizeIncreasing: bits = 4 - round(4*m/10); more magnitude = coarser
    bits = _v((4 - torch.round(mag / _LEVEL_DENOM * 4.0)).clamp(0, 8))
    step = torch.exp2(8.0 - bits)
    return torch.where(bits >= 8, img, torch.floor(img / step) * step)


def _solarize(img, mag):
    # SolarizeIncreasing: thresh = 256 - round(256*m/10)
    thresh = _v(256.0 - torch.round(mag / _LEVEL_DENOM * 256.0))
    return torch.where(img >= thresh, 255.0 - img, img)


def _solarize_add(img, mag):
    add = _v(torch.round(mag / _LEVEL_DENOM * 110.0))
    return torch.where(img < 128.0, (img + add).clamp(0, 255), img)


def _enhance_factor(mag):
    # *Increasing variants: factor = 1 + m/10*0.9, the random sign in mag
    return _v(1.0 + mag / _LEVEL_DENOM * 0.9)


def _color(img, mag):
    return _blend(_grayscale(img), img, _enhance_factor(mag)).clamp(0, 255)


def _gray_mean(img):
    return _grayscale(img)[..., :1].mean(dim=(1, 2), keepdim=True)


def _contrast(img, mag):
    # PIL Contrast degenerate: the mean of the grayscale image
    return _blend(_gray_mean(img).expand_as(img), img,
                  _enhance_factor(mag)).clamp(0, 255)


def _brightness(img, mag):
    return (img * _enhance_factor(mag)).clamp(0, 255)


_SMOOTH_KERNEL = torch.tensor([[1.0, 1.0, 1.0], [1.0, 5.0, 1.0],
                               [1.0, 1.0, 1.0]]) / 13.0


def _sharpness(img, mag):
    # PIL Sharpness degenerate: 3x3 smoothing, borders keep the original
    _, H, W, C = img.shape
    k = _SMOOTH_KERNEL.to(img.device)[None, None].expand(C, 1, 3, 3)
    smooth = F.conv2d(img.permute(0, 3, 1, 2), k, padding=1,
                      groups=C).permute(0, 2, 3, 1)
    border = torch.ones(H, W, dtype=torch.bool, device=img.device)
    border[1:-1, 1:-1] = False
    smooth = torch.where(border[..., None], img, smooth)
    return _blend(smooth, img, _enhance_factor(mag)).clamp(0, 255)


# The 15 ops in the JAX ``_RA_OPS`` order: (name, signed, photometric op or
# the affine op's matrix builder). Signed ops negate the magnitude with
# probability 0.5 (timm's randomly_negate).
_RA_OPS = (
    ("AutoContrast", False, _autocontrast), ("Equalize", False, _equalize),
    ("Invert", False, _invert), ("Rotate", True, _rotate_mat),
    ("Posterize", False, _posterize), ("Solarize", False, _solarize),
    ("SolarizeAdd", False, _solarize_add), ("Color", True, _color),
    ("Contrast", True, _contrast), ("Brightness", True, _brightness),
    ("Sharpness", True, _sharpness), ("ShearX", True, _shear_x_mat),
    ("ShearY", True, _shear_y_mat), ("TranslateXRel", True, _translate_x_mat),
    ("TranslateYRel", True, _translate_y_mat),
)
_AFFINE = {_rotate_mat, _shear_x_mat, _shear_y_mat, _translate_x_mat,
           _translate_y_mat}
SIGNED = tuple(s for _, s, _ in _RA_OPS)


def apply_op(k: int, img: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    """RandAugment op ``k`` (``_RA_OPS`` order) on every image of the batch
    at its own magnitude (mag: (B,), the sign included)."""
    _, _, fn = _RA_OPS[k]
    if fn in _AFFINE:
        return _affine(img, fn(mag, img.shape[1], img.shape[2]))
    return fn(img, mag)


def parse_rand_config(aa: str) -> typ.Tuple[float, float]:
    """(magnitude, mstd) of ``rand-m{M}-mstd{S}[-inc1]``, defaults 9 and
    0.5, as the JAX parse (:320-326)."""
    magnitude, mstd = 9.0, 0.5
    for tok in aa.split("-")[1:]:
        if tok.startswith("mstd"):
            mstd = float(tok[4:])
        elif tok.startswith("m"):
            magnitude = float(tok[1:])
    return magnitude, mstd


def sample_randaugment(generator: torch.Generator, n: int, magnitude: float,
                       mstd: float, device, num_layers: int = NUM_LAYERS):
    """Each layer's per-sample (op index, applied, signed magnitude), each
    (n,), drawn in the order op, apply, magnitude, sign."""
    signed = torch.tensor(SIGNED, device=device)
    layers = []
    for _ in range(num_layers):
        op = torch.randint(0, len(_RA_OPS), (n,), device=device,
                           generator=generator)
        apply = torch.rand(n, device=device, generator=generator) < 0.5
        mag = (magnitude + mstd * torch.randn(
            n, device=device, generator=generator)).clamp(0.0, _LEVEL_DENOM)
        neg = signed[op] & (torch.rand(n, device=device,
                                       generator=generator) < 0.5)
        layers.append((op, apply, torch.where(neg, -mag, mag)))
    return layers


def _randaugment_layer(img, op, apply, mag):
    """One layer: every op on the whole batch, each kept where a sample
    drew it (the affine ops as one resample of the per-sample matrices)."""
    H, W = img.shape[1], img.shape[2]
    mats = torch.eye(2, 3, device=img.device).expand(img.shape[0], 2, 3)
    affine = torch.zeros_like(apply)
    for k, (_, _, fn) in enumerate(_RA_OPS):
        if fn in _AFFINE:
            mats = torch.where((op == k)[:, None, None], fn(mag, H, W), mats)
            affine |= op == k
    out = torch.where(_v(apply & affine), _affine(img, mats), img)
    for k, (_, _, fn) in enumerate(_RA_OPS):
        if fn not in _AFFINE:
            out = torch.where(_v(apply & (op == k)), fn(img, mag), out)
    return out


# ---------------------------------------------------------------------------
# 3-Augment (DeiT-III) and color jitter
# ---------------------------------------------------------------------------

def _gaussian_blur(img, sigma):
    """9x9 separable Gaussian blur at each sample's sigma (B,), zero
    padded ("SAME"), rows then columns as the JAX op."""
    B, H, W, C = img.shape
    xs = torch.arange(-4, 5, dtype=torch.float32, device=img.device)
    k1 = torch.exp(-(xs ** 2) / (2 * sigma[:, None] ** 2))
    k1 = (k1 / k1.sum(1, keepdim=True)).repeat_interleave(C, 0)
    x = img.permute(0, 3, 1, 2).reshape(1, B * C, H, W)
    x = F.conv2d(x, k1[:, None, None, :], padding=(0, 4), groups=B * C)
    x = F.conv2d(x, k1[:, None, :, None], padding=(4, 0), groups=B * C)
    return x.reshape(B, C, H, W).permute(0, 2, 3, 1)


def _color_jitter(img, b, c, s):
    """Brightness, contrast and saturation at per-sample factors (B,)."""
    img = (img * _v(b)).clamp(0, 255)
    img = _blend(_gray_mean(img).expand_as(img), img, _v(c)).clamp(0, 255)
    return _blend(_grayscale(img), img, _v(s)).clamp(0, 255)


def _jitter_factors(generator, n, strength, device):
    return [_uniform(generator, n, 1 - strength, 1 + strength, device)
            for _ in range(3)]


def _three_augment(img, choice, sigma):
    solarized = torch.where(img >= 128.0, 255.0 - img, img)
    out = torch.where(_v(choice == 1), solarized, _gaussian_blur(img, sigma))
    return torch.where(_v(choice == 0), _grayscale(img), out)


# ---------------------------------------------------------------------------
# Random erasing (timm RandomErasing, 'pixel' mode), in normalized space
# ---------------------------------------------------------------------------

def _erase_hw(area_frac, log_r, H: int, W: int, count: int):
    """The box's (h, w) from its drawn area fraction and log-aspect."""
    target = area_frac * (H * W) / count
    aspect = torch.exp(log_r)
    h = torch.sqrt(target * aspect).to(torch.int64).clamp(1, H - 1)
    w = torch.sqrt(target / aspect).to(torch.int64).clamp(1, W - 1)
    return h, w


def sample_erase(generator: torch.Generator, n: int, H: int, W: int,
                 prob: float, count: int, device):
    """Each pass's per-sample (erased, top, left, h, w), each (n,), drawn
    in the order erased, area, aspect, top, left."""
    boxes = []
    for _ in range(count):
        do = torch.rand(n, device=device, generator=generator) < prob
        area = _uniform(generator, n, 0.02, 1 / 3, device)
        log_r = _uniform(generator, n, math.log(0.3), math.log(1 / 0.3),
                         device)
        top = torch.randint(0, H, (n,), device=device, generator=generator)
        left = torch.randint(0, W, (n,), device=device, generator=generator)
        boxes.append((do, top, left) + _erase_hw(area, log_r, H, W, count))
    return boxes


def _erase(img, do, top, left, h, w, noise):
    """``noise`` inside each erased sample's box, ``img`` elsewhere (the box
    may run past the image's edge, as the JAX op's)."""
    _, H, W, _ = img.shape
    ys = torch.arange(H, device=img.device)[None, :, None]
    xs = torch.arange(W, device=img.device)[None, None, :]
    box = ((ys >= top[:, None, None]) & (ys < (top + h)[:, None, None])
           & (xs >= left[:, None, None]) & (xs < (left + w)[:, None, None]))
    return torch.where((do[:, None, None] & box)[..., None], noise, img)


# ---------------------------------------------------------------------------
# Full pipelines
# ---------------------------------------------------------------------------

def build_device_augment(*, input_size: int,
                         aa: typ.Optional[str] = "rand-m9-mstd0.5-inc1",
                         hflip: float = 0.5, color_jitter: float = 0.3,
                         reprob: float = 0.25, recount: int = 1,
                         three_augment: bool = False,
                         mean=IMAGENET_DEFAULT_MEAN, std=IMAGENET_DEFAULT_STD):
    """Returns fn(generator, uint8 images NHWC) -> normalized f32 NHWC on the
    images' device (the generator's device): hflip -> RandAugment (or
    3-Augment, or color jitter alone) -> normalize -> random erasing. The
    draws, in this order: the flips; RandAugment's layers, or 3-Augment's
    choice, sigma and jitter factors, or the jitter factors; the erasing
    boxes, then each pass's noise."""
    magnitude, mstd = parse_rand_config(aa) if aa else (None, None)
    mean_a, std_a = _scaled(mean), _scaled(std)

    def augment(generator: torch.Generator,
                images: torch.Tensor) -> torch.Tensor:
        x = images.float()
        B, H, W, _ = x.shape
        dev = x.device
        flip = torch.rand(B, device=dev, generator=generator) < hflip
        x = torch.where(_v(flip), x.flip(2), x)
        if three_augment:
            choice = torch.randint(0, 3, (B,), device=dev,
                                   generator=generator)
            sigma = _uniform(generator, B, 0.1, 2.0, dev)
            x = _three_augment(x, choice, sigma)
            if color_jitter:
                x = _color_jitter(x, *_jitter_factors(generator, B,
                                                      color_jitter, dev))
        elif aa:
            for op, apply, mag in sample_randaugment(generator, B, magnitude,
                                                     mstd, dev):
                x = _randaugment_layer(x, op, apply, mag)
        elif color_jitter:
            x = _color_jitter(x, *_jitter_factors(generator, B, color_jitter,
                                                  dev))
        x = (x - mean_a.to(dev)) / std_a.to(dev)
        if reprob > 0:
            for box in sample_erase(generator, B, H, W, reprob, recount, dev):
                noise = torch.randn(x.shape, device=dev, generator=generator)
                x = _erase(x, *box, noise)
        return x

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
