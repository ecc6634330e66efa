"""RegNetY, the DeiT recipe's distillation teacher, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/models/regnet.py``: the pycls width
arithmetic (:26-42), ``_ConvBN``, ``_SE``, ``_Bottleneck`` and ``RegNet``
(:45-131), the ``regnety_160`` and ``regnety_040`` registrations (:144-156)
and ``import_torch_regnet`` (:162-262).

The convolutions and BatchNorm run on cuDNN (``F.conv2d``,
``F.batch_norm``): the JAX package computes them in XLA, outside any
Pallas kernel, so no hand-written kernel stands in for them.

- Layout: the port's images are NHWC. ``forward`` views the batch as
  NCHW by a permute, which leaves channels-last strides (no copy), and the
  convolution weights are kept channels-last, so cuDNN runs NHWC kernels.
- TF32: the model sets no backend flag. Under PyTorch's default
  (``torch.backends.cudnn.allow_tf32 = True``, which the driver keeps),
  cuDNN runs the f32 convolutions in TF32 on the card: that is the
  teacher's precision. The JAX teacher on the TPU runs its f32
  convolutions at XLA's default precision, a single bf16 pass, which
  keeps fewer mantissa bits than TF32. A caller that wants full f32 runs
  the forward under ``torch.backends.cudnn.flags(..., allow_tf32=False)``.
- BatchNorm: in training mode the output is normalized by the batch
  statistics, and the running statistics follow flax's
  ``BatchNorm(momentum=0.9)``: ``0.9 * running + 0.1 * batch``, with the
  biased batch variance. torch's ``BatchNorm2d`` would use the unbiased
  one, so the update is taken here. In eval mode the running statistics
  normalize. eps is 1e-5 in both. BatchNorm's output is f32 (flax's
  ``BatchNorm(dtype=float32)``), and the SE block and the head compute in
  f32.

Module names are timm's (``stem.conv``, ``s{i}.b{j}.conv{1,2,3}.{conv,bn}``,
``.se.fc{1,2}``, ``.downsample``, ``head.fc``), so a timm ``state_dict``
loads by name; ``utils/checkpoint.py::from_jax_params`` maps the flax
tree's ``s{i}_b{j}`` and ``head_fc`` onto them.
"""
from __future__ import annotations

import math
import typing as typ

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .registry import register_model

BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: the share of the old running value


def generate_regnet_widths(wa: float, w0: int, wm: float, depth: int,
                           q: int = 8):
    """pycls generate_regnet: per-stage (widths, depths)."""
    widths_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / q) * q).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    order = np.argsort(stage_widths)
    return stage_widths[order].tolist(), stage_depths[order].tolist()


def adjust_widths_groups(widths, groups):
    """Make widths divisible by their group width (pycls adjust_ws_gs_comp)."""
    gs = [min(g, w) for g, w in zip(groups, widths)]
    ws = [int(round(w / g) * g) for w, g in zip(widths, gs)]
    return ws, gs


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at +-2 std, scaled
    so the variance is 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class _BatchNorm(nn.Module):
    """BatchNorm over (B, C, H, W) with flax's running-statistics rule."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, BN_EPS)
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         BN_EPS)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
            self.running_mean.mul_(BN_MOMENTUM).add_(mean,
                                                     alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(var,
                                                    alpha=1 - BN_MOMENTUM)
        return y


class _ConvBN(nn.Module):
    def __init__(self, w_in: int, features: int, kernel: int = 1,
                 stride: int = 1, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(w_in, features, kernel, stride=stride,
                              padding=kernel // 2, groups=groups, bias=False)
        self.bn = _BatchNorm(features)

    def init_weights(self, generator: torch.Generator) -> None:
        w = self.conv.weight
        _lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.conv
        x = F.conv2d(x.to(self.dtype), c.weight.to(self.dtype), None,
                     c.stride, c.padding, c.dilation, c.groups)
        return self.bn(x)


class _SE(nn.Module):
    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, rd_channels, 1)
        self.fc2 = nn.Conv2d(rd_channels, channels, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        for fc in (self.fc1, self.fc2):
            _lecun_normal_(fc.weight, fc.weight.shape[1], generator)
            nn.init.zeros_(fc.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(x.mean((2, 3), keepdim=True))))
        return x * torch.sigmoid(s)


class _Bottleneck(nn.Module):
    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 se_ratio: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        w_b = w_out  # bottleneck ratio 1.0
        self.conv1 = _ConvBN(w_in, w_b, 1, dtype=dtype)
        self.conv2 = _ConvBN(w_b, w_b, 3, stride, w_b // group_width,
                             dtype=dtype)
        self.se = (_SE(w_b, int(round(w_in * se_ratio))) if se_ratio > 0
                   else None)
        self.conv3 = _ConvBN(w_b, w_out, 1, dtype=dtype)
        self.downsample = (_ConvBN(w_in, w_out, 1, stride, dtype=dtype)
                           if stride != 1 or w_in != w_out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.conv1(x))
        y = F.relu(self.conv2(y))
        if self.se is not None:
            y = self.se(y)
        y = self.conv3(y)
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.relu(y + shortcut)


class _Head(nn.Module):
    def __init__(self, w_in: int, num_classes: int):
        super().__init__()
        self.fc = nn.Linear(w_in, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        _lecun_normal_(self.fc.weight, self.fc.weight.shape[1], generator)
        nn.init.zeros_(self.fc.bias)


class RegNet(nn.Module):
    """Stem conv, stages of bottleneck blocks (3x3 group conv + SE), global
    pool and an f32 head, over channels-last (B, H, W, 3) images. BatchNorm
    uses the batch statistics in ``train()`` mode and the running ones in
    ``eval()``."""

    def __init__(self, stage_widths: typ.Sequence[int],
                 stage_depths: typ.Sequence[int], group_width: int,
                 se_ratio: float = 0.25, stem_width: int = 32,
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stage_widths = list(stage_widths)
        self.stage_depths = list(stage_depths)
        self.num_classes = num_classes
        self.stem = _ConvBN(3, stem_width, 3, 2, dtype=dtype)
        w_in = stem_width
        for si, (w, d) in enumerate(zip(self.stage_widths,
                                        self.stage_depths)):
            blocks = {}
            for bi in range(d):
                blocks[f"b{bi + 1}"] = _Bottleneck(
                    w_in, w, 2 if bi == 0 else 1, group_width, se_ratio,
                    dtype=dtype)
                w_in = w
            setattr(self, f"s{si + 1}", nn.ModuleDict(blocks))
        self.head = _Head(w_in, num_classes) if num_classes > 0 else None
        self.to(memory_format=torch.channels_last)

    def stages(self) -> typ.List[nn.ModuleDict]:
        return [getattr(self, f"s{i + 1}")
                for i in range(len(self.stage_depths))]

    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every weight from ``generator`` in module order (flax's
        initializers: LeCun-normal kernels, zero biases, unit BN scales)."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, x: torch.Tensor,
                generator: typ.Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NCHW shape, channels-last strides
        x = F.relu(self.stem(x))
        for stage in self.stages():
            for blk in stage.values():
                x = blk(x)
        x = x.float().mean((2, 3))
        return x if self.head is None else self.head.fc(x)


def _regnety(wa, w0, wm, depth, group_width, **kwargs) -> RegNet:
    widths, depths = generate_regnet_widths(wa, w0, wm, depth)
    widths, groups = adjust_widths_groups(widths,
                                          [group_width] * len(widths))
    return RegNet(stage_widths=widths, stage_depths=depths,
                  group_width=min(groups), se_ratio=0.25,
                  num_classes=kwargs.get("num_classes", 1000),
                  dtype=kwargs.get("dtype", torch.float32))


@register_model
def regnety_160(pretrained=False, **kwargs):
    """RegNetY-16GF (timm regnety_160): w0=200, wa=106.23, wm=2.48, d=18,
    group=112."""
    kwargs.pop("img_size", None)
    return _regnety(106.23, 200, 2.48, 18, 112, **kwargs)


@register_model
def regnety_040(pretrained=False, **kwargs):
    kwargs.pop("img_size", None)
    return _regnety(31.41, 96, 2.24, 22, 64, **kwargs)


def import_torch_regnet(path_or_dict, model: RegNet) -> RegNet:
    """Load a timm regnety ``state_dict`` (a ``.pth`` path or a dict) into
    ``model``, in place: every parameter and running statistic of the
    model must be in it under timm's name and with the model's shape (a
    missing name raises ``KeyError``, a shape ``ValueError``); other keys
    (``num_batches_tracked``) are ignored."""
    from ..utils.checkpoint import read_state_dict

    sd = read_state_dict(path_or_dict, ("model", "state_dict"))
    with torch.no_grad():
        for name, dst in model.state_dict().items():
            if name not in sd:
                raise KeyError(f"{name} is not in the RegNet checkpoint")
            if sd[name].shape != tuple(dst.shape):
                raise ValueError(f"shape mismatch at {name}: "
                                 f"{tuple(dst.shape)} vs {sd[name].shape}")
            dst.copy_(torch.from_numpy(sd[name]))
    return model
