"""The inputs a cell hands to both sides: its weights, made from the seed.

The benchmark, not the program, makes the weights. ``layout(cfg)`` lists
every parameter of the configuration's model under the name the program's
module gives it, with its shape and its kind; ``make(cfg, seed, device)``
draws them all in one call on ``device`` from a generator seeded from
``seed``, so the reference makes the same tensors again from the same seed
and takes nothing from the program.

Every tensor is drawn from N(0, 0.02) truncated at two standard deviations
(DeiT's weight init); biases and LayerNorm shifts too, and LayerNorm scales
are 1 plus such a draw, as trained weights have them, so that the
comparison sees the biases and the affine parts (DeiT starts them at 0
and 1).
"""
from __future__ import annotations

import hashlib
import typing as typ

import torch

STD = 0.02


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``tag``) of a run's ``seed``; any whole
    number is taken, of any size."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def layout(cfg: dict) -> typ.List[typ.Tuple[str, tuple, str]]:
    """``[(name, shape, kind)]``; ``kind`` is ``weight`` (a matrix or
    token, under weight decay), ``bias``, ``ln_scale``, ``ln_shift`` or
    ``embed`` (the class token and position embedding, no decay)."""
    D, E, H = cfg["embed_dim"], cfg["num_experts"], cfg["hidden"]
    P, C = cfg["patch_size"], cfg["num_classes"]
    n = (cfg["img_size"] // P) ** 2 + 1
    out = [("cls_token", (1, 1, D), "embed"),
           ("pos_embed", (1, n, D), "embed"),
           ("patch_embed.proj.weight", (D, P * P * 3), "weight"),
           ("patch_embed.proj.bias", (D,), "bias")]
    for i in range(cfg["depth"]):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (D,), "ln_scale"),
                (b + "norm1.bias", (D,), "ln_shift"),
                (b + "attn.qkv.weight", (3 * D, D), "weight"),
                (b + "attn.qkv.bias", (3 * D,), "bias"),
                (b + "attn.proj.weight", (D, D), "weight"),
                (b + "attn.proj.bias", (D,), "bias"),
                (b + "norm2.weight", (D,), "ln_scale"),
                (b + "norm2.bias", (D,), "ln_shift"),
                (b + "mlp.router_weight", (D, E), "weight"),
                (b + "mlp.router_bias", (E,), "bias"),
                (b + "mlp.w1", (E, D, H), "weight"),
                (b + "mlp.b1", (E, H), "bias"),
                (b + "mlp.w2", (E, H, D), "weight"),
                (b + "mlp.b2", (E, D), "bias")]
    out += [("norm.weight", (D,), "ln_scale"), ("norm.bias", (D,), "ln_shift"),
            ("head.weight", (C, D), "weight"), ("head.bias", (C,), "bias")]
    return out


def count(cfg: dict) -> int:
    return sum(_numel(s) for _, s, _ in layout(cfg))


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def make_flat(cfg: dict, seed: int, device) -> torch.Tensor:
    """Every parameter in one f32 buffer, in ``layout`` order, drawn by one
    call."""
    flat = torch.empty(count(cfg), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(flat, std=STD, a=-2 * STD, b=2 * STD,
                                generator=generator(seed, "weights", device))
    o = 0
    for _, shape, kind in layout(cfg):
        n = _numel(shape)
        if kind == "ln_scale":
            flat[o:o + n] += 1.0
        o += n
    return flat


def views(cfg: dict, flat: torch.Tensor) -> typ.Dict[str, torch.Tensor]:
    """``{name: view of flat}`` in ``layout`` order."""
    out, o = {}, 0
    for name, shape, _ in layout(cfg):
        n = _numel(shape)
        out[name] = flat[o:o + n].view(shape)
        o += n
    return out


def make(cfg: dict, seed: int, device) -> typ.Dict[str, torch.Tensor]:
    return views(cfg, make_flat(cfg, seed, device))


@torch.no_grad()
def load_into(model: torch.nn.Module, cfg: dict, seed: int) -> None:
    """Copy the seed's weights into ``model``'s parameters, by name; every
    name and shape of the layout must match the model's."""
    params = dict(model.named_parameters())
    want = {n: s for n, s, _ in layout(cfg)}
    got = {n: tuple(p.shape) for n, p in params.items()}
    if want != got:
        missing = sorted(set(want) ^ set(got))[:5]
        wrong = sorted(n for n in set(want) & set(got) if want[n] != got[n])
        raise ValueError(f"the model's parameters differ from the layout: "
                         f"names {missing}, shapes {wrong[:5]}")
    device = next(iter(params.values())).device
    for name, t in make(cfg, seed, device).items():
        params[name].copy_(t)
