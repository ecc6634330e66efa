"""On-device Mixup / CutMix over a batch, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/data/mixup.py`` (:25-130), timm's
``Mixup`` in its 'batch' mode (the reference default ``--mixup-mode
batch``): one draw a batch, every sample paired with the reversed batch.

- With probability ``prob`` the batch is mixed; otherwise it passes
  unchanged (lambda = 1). When both are on, cutmix is chosen with
  probability ``switch_prob``, else mixup.
- mixup: x = lam * x + (1 - lam) * reverse(x), lam ~ Beta(a, a).
- cutmix: the reversed batch's box of area ratio (1 - lam) pasted in,
  centred uniformly and clipped to the image; lam is corrected to the
  clipped box's area (timm ``rand_bbox``), or with ``cutmix_minmax`` the
  box's sides are drawn as ratios of the image's (``rand_bbox_minmax``).
- targets: one-hot with label smoothing folded in, mixed by lam.

Every draw is a tensor on the images' device, taken from the caller's
``torch.Generator``; both branches are computed and one is selected, so no
value goes back to the host. Beta(a, a) is the ratio of two Gamma(a) draws,
each by Marsaglia and Tsang's method over a fixed number of proposals.
"""
from __future__ import annotations

import math
import typing as typ

import torch
import torch.nn.functional as F

# proposals per Gamma draw; each is accepted with probability >= 0.95 (a >=
# 1, where the draw is taken), so all fail with probability <= 0.05 ** 16
GAMMA_PROPOSALS = 16


def one_hot_smooth(labels: torch.Tensor, num_classes: int,
                   smoothing: float = 0.0) -> torch.Tensor:
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    return F.one_hot(labels.long(), num_classes).float() * (on - off) + off


def _gamma(generator: torch.Generator, alpha: float, n: int,
           device) -> torch.Tensor:
    """n Gamma(alpha, 1) draws (Marsaglia and Tsang; alpha < 1 boosted by
    U^(1/alpha))."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    shape = (n, GAMMA_PROPOSALS)
    x = torch.randn(shape, device=device, generator=generator)
    u = torch.rand(shape, device=device, generator=generator)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(v.clamp(min=1e-30)))
    first = ok.int().argmax(1, keepdim=True)  # the first accepted proposal
    g = d * v.clamp(min=1e-30).gather(1, first)[:, 0]
    if alpha < 1.0:
        u = torch.rand(n, device=device, generator=generator)
        g = g * u ** (1.0 / alpha)
    return g


def _beta(generator: torch.Generator, alpha: float, n: int,
          device) -> torch.Tensor:
    """n Beta(alpha, alpha) draws, as two Gammas."""
    g1 = _gamma(generator, alpha, n, device)
    g2 = _gamma(generator, alpha, n, device)
    return g1 / (g1 + g2)


def _bbox(cy, cx, H: int, W: int, lam):
    """timm rand_bbox around the drawn centre (cy, cx): the box of area
    ratio (1 - lam) clipped to the image; returns (y0, y1, x0, x1,
    corrected lam)."""
    ratio = torch.sqrt(1.0 - lam)
    cut_h = (H * ratio).to(torch.int64)
    cut_w = (W * ratio).to(torch.int64)
    y0 = (cy - cut_h // 2).clamp(0, H)
    y1 = (cy + cut_h // 2).clamp(0, H)
    x0 = (cx - cut_w // 2).clamp(0, W)
    x1 = (cx + cut_w // 2).clamp(0, W)
    lam_corr = 1.0 - ((y1 - y0) * (x1 - x0)).float() / float(H * W)
    return y0, y1, x0, x1, lam_corr


def _rand_bbox(generator, H: int, W: int, lam, device):
    n = lam.shape[0]
    cy = torch.randint(0, H, (n,), device=device, generator=generator)
    cx = torch.randint(0, W, (n,), device=device, generator=generator)
    return _bbox(cy, cx, H, W, lam)


def _rand_bbox_minmax(generator, H: int, W: int, minmax, n: int, device):
    """timm rand_bbox_minmax: the box's height and width drawn
    independently as ratios in [minmax[0], minmax[1]) of each side; lam is
    the kept area's ratio."""
    def side(size):
        lo = int(minmax[0] * size)
        return torch.randint(lo, max(int(minmax[1] * size), lo + 1), (n,),
                             device=device, generator=generator)
    cut_h, cut_w = side(H), side(W)
    y0 = (torch.rand(n, device=device, generator=generator)
          * (H - cut_h + 1)).floor().to(torch.int64)
    x0 = (torch.rand(n, device=device, generator=generator)
          * (W - cut_w + 1)).floor().to(torch.int64)
    lam = 1.0 - (cut_h * cut_w).float() / float(H * W)
    return y0, y0 + cut_h, x0, x0 + cut_w, lam


def mix(x: torch.Tensor, labels: torch.Tensor, do_apply, do_cutmix, lam_m,
        box, num_classes: int, smoothing: float):
    """The batch transform at given draws (0-d tensors, ``box`` = (y0, y1,
    x0, x1, corrected lam)): (images, soft targets)."""
    _, H, W, _ = x.shape
    x_rev = x.flip(0)
    x_mix = lam_m.to(x.dtype) * x + (1.0 - lam_m).to(x.dtype) * x_rev
    y0, y1, x0, x1, lam_c = box
    rows = torch.arange(H, device=x.device)[:, None]
    cols = torch.arange(W, device=x.device)[None, :]
    in_box = (rows >= y0) & (rows < y1) & (cols >= x0) & (cols < x1)
    x_cut = torch.where(in_box[None, :, :, None], x_rev, x)
    lam = torch.where(do_apply, torch.where(do_cutmix, lam_c, lam_m),
                      torch.ones_like(lam_m))
    x_out = torch.where(do_apply, torch.where(do_cutmix, x_cut, x_mix), x)
    y1h = one_hot_smooth(labels, num_classes, smoothing)
    return x_out, y1h * lam + y1h.flip(0) * (1.0 - lam)


def make_mixup_fn(*, mixup_alpha: float = 0.8, cutmix_alpha: float = 1.0,
                  cutmix_minmax: typ.Optional[typ.Sequence[float]] = None,
                  prob: float = 1.0, switch_prob: float = 0.5,
                  label_smoothing: float = 0.1, num_classes: int = 1000
                  ) -> typ.Callable:
    """Returns fn(generator, images (B, H, W, C), int labels (B,)) ->
    (images, soft targets (B, num_classes) f32). ``cutmix_minmax``
    overrides ``cutmix_alpha`` and turns cutmix on with min/max box
    ratios (timm semantics, reference main.py:293-298)."""
    use_mixup = mixup_alpha > 0.0
    use_cutmix = cutmix_alpha > 0.0 or cutmix_minmax is not None

    def draw(generator, n: int, H: int, W: int, device):
        """n draws of (apply, cutmix, mixup lam, box), each (n,), in the
        order apply, switch, the two lams, the box."""
        do_apply = torch.rand(n, device=device, generator=generator) < prob
        switch = torch.rand(n, device=device, generator=generator)
        do_cutmix = (switch < switch_prob if use_mixup and use_cutmix
                     else torch.full((n,), use_cutmix, device=device))
        lam_m = _beta(generator, mixup_alpha if use_mixup else 1.0, n, device)
        # with cutmix_minmax the box sets lambda and this draw goes unused
        lam_c = _beta(generator, cutmix_alpha if cutmix_alpha > 0 else 1.0,
                      n, device)
        if cutmix_minmax is not None:
            box = _rand_bbox_minmax(generator, H, W, cutmix_minmax, n, device)
        else:
            box = _rand_bbox(generator, H, W, lam_c, device)
        return do_apply, do_cutmix, lam_m, box

    def apply(generator: torch.Generator, x: torch.Tensor,
              labels: torch.Tensor):
        _, H, W, _ = x.shape
        do_apply, do_cutmix, lam_m, box = draw(generator, 1, H, W, x.device)
        return mix(x, labels, do_apply[0], do_cutmix[0], lam_m[0],
                   tuple(t[0] for t in box), num_classes, label_smoothing)

    apply.draw = draw
    return apply


def mixup_active(mixup: float, cutmix: float,
                 cutmix_minmax: typ.Optional[typ.Sequence[float]]) -> bool:
    """reference main.py:506."""
    return mixup > 0.0 or cutmix > 0.0 or cutmix_minmax is not None
