"""The MoE Vision Transformer, written out plainly.

DeiT's ViT (Touvron et al. 2020; Dosovitskiy et al. 2020) with every MLP a
Switch/FMoE layer as in the Slim-Switch-MoE reference
(``models/resMoE.py:190-209``): a linear router, the top-k experts by
router logit, their outputs mixed by the softmax of the k logits (FMoE's
``NaiveGate``), no capacity (every routed token is computed). Pre-norm
blocks, LayerNorm eps 1e-6, exact erf GELU, attention scale d**-0.5, the
head on the class token after the final norm. Images are channels-last;
a patch is flattened in (row, column, channel) order, the order of the
stride-16 convolution's kernel flattened the same way.

Parameters are a dict of tensors under the names of ``weights.layout``:
Dense weights (out, in), the router (D, E), the experts (E, D, H) and
(E, H, D).

``mm`` is the one product every GEMM goes through: :func:`matmul` in f32
for the reference, :func:`matmul_fp8` for the control. The router and the
head stay in f32 in both.
"""
from __future__ import annotations

import math
import typing as typ

import torch
import torch.nn.functional as F

LN_EPS = 1e-6
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_FORWARD = torch.float8_e4m3fn
FP8_BACKWARD = torch.float8_e5m2


def strict_f32() -> None:
    """f32 products in f32: TF32 off for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _quantize(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round ``t`` to fp8 ``dtype`` under one scale for the tensor (its
    largest magnitude to the format's largest), back in f32."""
    top = torch.finfo(dtype).max
    amax = t.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """a @ b with both operands in e4m3, the incoming gradient in e5m2 (the
    usual fp8 training recipe), products summed in f32."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _quantize(a, FP8_FORWARD), _quantize(b, FP8_FORWARD)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _quantize(g, FP8_BACKWARD)
        return (torch.matmul(qg, qb.transpose(-1, -2)),
                torch.matmul(qa.transpose(-1, -2), qg))


def matmul_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


def linear(x, w, b, mm=matmul):
    """x (..., in) @ w.T + b, through ``mm`` on 2-D operands."""
    shape = x.shape
    y = mm(x.reshape(-1, shape[-1]), w.t())
    return (y + b).reshape(*shape[:-1], w.shape[0])


def layer_norm(x, w, b):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (B, S, S, 3) -> f32 (x - 255 mean) / (255 std)."""
    mean = torch.tensor(IMAGENET_MEAN, device=images.device) * 255.0
    std = torch.tensor(IMAGENET_STD, device=images.device) * 255.0
    return (images.float() - mean) / std


def patchify(images, patch):
    B, S, _, C = images.shape
    g = S // patch
    x = images.reshape(B, g, patch, g, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, patch * patch * C)


def attention(x, p, pre, heads, mm):
    B, N, D = x.shape
    d = D // heads
    qkv = linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"], mm)
    q, k, v = (t.reshape(B, N, heads, d).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    s = mm(q, k.transpose(-1, -2)) * d ** -0.5
    o = mm(torch.softmax(s, dim=-1), v)
    o = o.transpose(1, 2).reshape(B, N, D)
    return linear(o, p[pre + "proj.weight"], p[pre + "proj.bias"], mm)


class RoutingMismatch(ValueError):
    """Imposed routing of another shape than the tokens it routes."""


class Routing:
    """Which experts each token takes, block by block.

    By default each block takes its own top-k. With ``imposed`` (one (T, k)
    tensor of expert ids per MoE block, in order: another side's routing)
    each block takes those ids instead, and ``flips`` counts the imposed
    (token, expert) pairs that are not among this side's own top-k, of
    ``pairs``. ``chosen`` keeps the ids taken, on the host."""

    def __init__(self,
                 imposed: typ.Optional[typ.Sequence[torch.Tensor]] = None):
        self.imposed = imposed
        self.chosen: typ.List[torch.Tensor] = []
        self.flips = self.pairs = 0

    def pick(self, logits: torch.Tensor, k: int) -> torch.Tensor:
        idx = torch.topk(logits, k, dim=-1).indices
        if self.imposed is not None:
            want = self.imposed[len(self.chosen)].to(logits.device)
            if want.shape != idx.shape:
                raise RoutingMismatch(
                    f"imposed routing {tuple(want.shape)} for "
                    f"{tuple(idx.shape)} tokens")
            own = (want[:, :, None] == idx[:, None, :]).any(-1)
            self.flips += int((~own).sum())
            self.pairs += want.numel()
            idx = want
        self.chosen.append(idx.cpu())
        return idx


def moe(x, p, pre, top_k, mm, routing: typ.Optional[Routing] = None):
    """The routed MLP over (T, D) tokens: each token's top-k experts by
    router logit (or ``routing``'s), mixed by the softmax of their
    logits."""
    T, D = x.shape
    logits = x @ p[pre + "router_weight"] + p[pre + "router_bias"]
    routing = routing if routing is not None else Routing()
    idx = routing.pick(logits.detach(), top_k)
    gate = torch.softmax(logits.gather(-1, idx), dim=-1)
    w1, b1 = p[pre + "w1"], p[pre + "b1"]
    w2, b2 = p[pre + "w2"], p[pre + "b2"]
    y = torch.zeros_like(x)
    for e in range(w1.shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = gelu(mm(x[tok], w1[e]) + b1[e])
        out = mm(h, w2[e]) + b2[e]
        y = y.index_add(0, tok, out * gate[tok, slot][:, None])
    return y


def forward(p: typ.Dict[str, torch.Tensor], images: torch.Tensor, cfg: dict,
            mm=matmul, routing: typ.Optional[Routing] = None) -> torch.Tensor:
    """Logits (B, classes) of normalised f32 images (B, S, S, 3), routed by
    ``routing`` (see :class:`Routing`; by default each block's own top-k)."""
    depth, heads, k = cfg["depth"], cfg["num_heads"], cfg["top_k"]
    x = linear(patchify(images, cfg["patch_size"]),
               p["patch_embed.proj.weight"], p["patch_embed.proj.bias"], mm)
    B, _, D = x.shape
    x = torch.cat([p["cls_token"].expand(B, -1, -1), x], dim=1)
    x = x + p["pos_embed"]
    N = x.shape[1]
    for i in range(depth):
        b = f"blocks.{i}."
        h = layer_norm(x, p[b + "norm1.weight"], p[b + "norm1.bias"])
        x = x + attention(h, p, b + "attn.", heads, mm)
        h = layer_norm(x, p[b + "norm2.weight"], p[b + "norm2.bias"])
        x = x + moe(h.reshape(B * N, D), p, b + "mlp.", k, mm,
                    routing).reshape(B, N, D)
    x = layer_norm(x, p["norm.weight"], p["norm.bias"])
    return x[:, 0] @ p["head.weight"].t() + p["head.bias"]


def smoothed_ce(logits: torch.Tensor, labels: torch.Tensor,
                smoothing: float) -> torch.Tensor:
    """Label-smoothed cross-entropy, summed over the rows (timm's
    ``LabelSmoothingCrossEntropy`` times the row count)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None])[:, 0]
    return ((1.0 - smoothing) * nll - smoothing * logp.mean(-1)).sum()


def token_rows(routes: typ.Sequence[torch.Tensor], first: int, last: int,
               tokens: int) -> typ.List[torch.Tensor]:
    """Each block's routing of images [first, last) out of whole-batch
    routing, whose rows are the images' tokens in order."""
    return [r[first * tokens:last * tokens] for r in routes]


def joined(parts: typ.Sequence[typ.Sequence[torch.Tensor]]
           ) -> typ.List[torch.Tensor]:
    """Whole-batch routing, block by block, from that of blocks of rows."""
    return [torch.cat(layer) for layer in zip(*parts)]


@torch.no_grad()
def predict(p, images_u8: torch.Tensor, cfg: dict, mm=matmul,
            block: int = 64,
            routes: typ.Optional[typ.Sequence[torch.Tensor]] = None):
    """Served logits of uint8 images, ``block`` images at a time, routed by
    ``routes`` (whole-batch routing, one tensor per MoE block) or by their
    own top-k. Returns (logits, the share of imposed pairs outside the
    reference's own top-k, the routing taken)."""
    N = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    out, flips, pairs, parts = [], 0, 0, []
    for i in range(0, images_u8.shape[0], block):
        j = min(i + block, images_u8.shape[0])
        routing = Routing(None if routes is None
                          else token_rows(routes, i, j, N))
        out.append(forward(p, normalize(images_u8[i:j]), cfg, mm, routing))
        flips, pairs = flips + routing.flips, pairs + routing.pairs
        parts.append(routing.chosen)
    return torch.cat(out), flips / max(pairs, 1), joined(parts)
