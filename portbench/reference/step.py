"""The training step, written out plainly: the loss over the batch, its
gradients by autograd over ``model.forward``, AdamW and the EMA.

AdamW as Loshchilov & Hutter and ``torch.optim.AdamW`` state it: with
``t`` the step, m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2 and
p <- p (1 - lr wd) - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps),
weight decay on the matrices only (the ``weight`` kind of the layout:
not biases, LayerNorm, the class token or the position embedding). The
EMA follows each update: e <- d e + (1 - d) p, starting at the initial
parameters.

The batch's mean loss is summed over blocks of rows (``micro``), so the
step fits beside the program's freed state at any batch: with dropless
routing and no batch statistics every row's loss depends on that row alone.
"""
from __future__ import annotations

import math
import typing as typ

import torch

from . import model as ref


def train_steps(cfg: dict, recipe: dict, params: typ.Dict[str, torch.Tensor],
                kinds: typ.Dict[str, str],
                batches: typ.Sequence[typ.Callable[[], tuple]], micro: int,
                mm=ref.matmul,
                after: typ.Optional[typ.Callable] = None,
                routes: typ.Optional[typ.Sequence] = None) -> dict:
    """Train ``params`` (f32 tensors, updated in place) one step per batch.

    ``batches[s]()`` returns step s's (images, labels). ``after(s, params,
    grads, ema)`` is called after each step's update with that step's
    gradients. ``routes[s]``, where given, is step s's whole-batch routing
    (one (B N, k) tensor of expert ids per MoE block), which the forward
    takes instead of its own (``model.Routing``). Returns ``{"losses": the
    steps' mean losses, "routes": the routing taken, "flip": the share of
    imposed pairs outside the reference's own top-k}``."""
    b1, b2 = recipe["betas"]
    eps, wd, lr = recipe["eps"], recipe["weight_decay"], recipe["lr"]
    decay = recipe["ema_decay"]
    names = list(params)
    for n in names:
        params[n].requires_grad_(True)
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    ema = {n: params[n].detach().clone() for n in names}
    N = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    losses, taken, flips, pairs = [], [], 0, 0
    for s, make_batch in enumerate(batches):
        images, labels = make_batch()
        B = images.shape[0]
        for n in names:
            params[n].grad = None
        total, parts = 0.0, []
        for i in range(0, B, micro):
            j = min(i + micro, B)
            routing = ref.Routing(None if routes is None
                                  else ref.token_rows(routes[s], i, j, N))
            logits = ref.forward(params, images[i:j], cfg, mm, routing)
            loss = ref.smoothed_ce(logits, labels[i:j],
                                   recipe["smoothing"]) / B
            loss.backward()
            total += float(loss.detach())
            flips, pairs = flips + routing.flips, pairs + routing.pairs
            parts.append(routing.chosen)
        losses.append(total)
        taken.append(ref.joined(parts))
        del images, labels
        t = s + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        grads = {}
        with torch.no_grad():
            for n in names:
                p, g = params[n], params[n].grad
                if kinds[n] == "weight":
                    p.mul_(1.0 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[n].sqrt() / math.sqrt(bc2)).add_(eps)
                p.addcdiv_(m[n], denom, value=-lr / bc1)
                ema[n].mul_(decay).add_(p, alpha=1.0 - decay)
                grads[n] = g
            if after is not None:
                after(s, params, grads, ema)
        del grads
    for n in names:
        params[n].grad = None
        params[n].requires_grad_(False)
    return {"losses": losses, "routes": taken,
            "flip": flips / max(pairs, 1)}
