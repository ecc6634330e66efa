"""How ``correct`` is decided: the numbers compared and how each is read.

Training (the first three steps of the object the window then drives,
against the reference's three steps on the same weights and batches):

- ``loss_gap``: the largest over the steps of |loss - reference| over the
  reference's loss.
- ``grad_gap``: the first step's gradient as the optimizer got it (its
  first moment after one step over 1 - beta1), by the worst leaf: the gap
  between the program's norm and the reference's, over the reference's
  norm of that leaf or of the median leaf, whichever is larger.
- ``change_gap``, ``ema_gap``: the same of the parameters' and of the
  EMA's change over the three steps, over the leaves whose reference
  gradient is at least a thousandth of the median leaf's (a leaf under
  that moves under Adam by round-off alone).
- ``grad_diff``: over the dense leaves (everything outside the MoE
  layers) that count, the median of |g - g_ref| / |g_ref|: the
  gradient's first-order error.
- ``route_flip``: the reference follows the program's routing (which
  experts each token took, ``capture.py``); this is the routing checked by
  itself: the share of the program's (token, expert) pairs, over the
  steps' blocks, that are not among the reference's own f32 top-k. A
  program whose routing the reference cannot follow (another number of
  tokens or blocks) reads inf on every number.

A leaf is a parameter, with the qkv projection's weight and bias cut into
their q, k and v parts (the key's bias has no gradient under softmax).

Serving (a sample of the window's requests, drawn from the seed):

- ``logit_err_median``, ``logit_err_max``: the median and the largest over
  the sampled images of |logits - reference| / |reference| (2-norms over
  the classes), the reference following the program's routing.
- ``route_flip``: as in training, over the sampled requests.
- ``rerun_diff``: the routing is read from the sampled requests served
  again after the window; the largest |logit| by which a request's answer
  served again differs from its answer in the window, over the window's
  largest |logit| (0 for a program that answers the same request the same
  way).
"""
from __future__ import annotations

import math
import statistics
import typing as typ

import torch

LEAF_RULE = 1e-3  # a leaf counts where its gradient is over this x median


def leaves(name: str, t: torch.Tensor
           ) -> typ.List[typ.Tuple[str, torch.Tensor]]:
    if name.endswith("attn.qkv.weight") or name.endswith("attn.qkv.bias"):
        return [(f"{name}:{part}", c)
                for part, c in zip("qkv", t.chunk(3, dim=0))]
    return [(name, t)]


def is_dense(leaf: str) -> bool:
    return ".mlp." not in leaf


def leaf_norms(pairs: typ.Iterable[typ.Tuple[str, torch.Tensor]]
               ) -> typ.Dict[str, float]:
    """Each leaf's 2-norm, of ``(name, tensor)`` pairs made one at a time."""
    out = {}
    for name, t in pairs:
        for leaf, c in leaves(name, t):
            out[leaf] = float(torch.linalg.vector_norm(c, dtype=torch.float64))
    return out


class TrainRecord:
    """What one side's first three steps leave to compare."""

    def __init__(self):
        self.losses: typ.List[float] = []
        self.grad: typ.Dict[str, float] = {}
        self.dense_grad: typ.Dict[str, torch.Tensor] = {}
        self.change: typ.Dict[str, float] = {}
        self.ema_change: typ.Dict[str, float] = {}
        self.routes: typ.List[typ.List[torch.Tensor]] = []  # step, block
        self.route_flip = 0.0

    def take_grad(self, pairs: typ.Iterable[typ.Tuple[str, torch.Tensor]]
                  ) -> None:
        """The first step's gradients, of ``(name, tensor)`` pairs made one
        at a time: every leaf's norm, and the dense leaves themselves."""
        for name, t in pairs:
            for leaf, c in leaves(name, t):
                self.grad[leaf] = float(
                    torch.linalg.vector_norm(c, dtype=torch.float64))
                if is_dense(leaf):
                    self.dense_grad[leaf] = c.detach().float().cpu().clone()

    def take_change(self, params, ema, initial) -> None:
        self.change = leaf_norms((n, params[n].detach() - initial[n])
                                 for n in params)
        self.ema_change = leaf_norms((n, ema[n] - initial[n]) for n in ema)


def _worst_gap(prog: typ.Dict[str, float], ref: typ.Dict[str, float],
               counted: typ.Iterable[str]) -> float:
    counted = list(counted)
    med = statistics.median(ref[k] for k in counted)
    return max(_nan_inf(abs(prog.get(k, 0.0) - ref[k])
                        / max(ref[k], med, 1e-30)) for k in counted)


def _nan_inf(x: float) -> float:
    return math.inf if math.isnan(x) else x


def counted_leaves(ref: TrainRecord) -> typ.List[str]:
    med = statistics.median(ref.grad.values())
    return [k for k, v in ref.grad.items() if v >= LEAF_RULE * med]


TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "ema_gap", "grad_diff",
                 "route_flip")


def train_numbers(prog: TrainRecord, ref: typ.Optional[TrainRecord]
                  ) -> typ.Dict[str, float]:
    """The numbers of ``prog`` against ``ref`` (None where the reference
    could not follow the program's routing)."""
    if ref is None:
        return {k: math.inf for k in TRAIN_NUMBERS}
    counted = counted_leaves(ref)
    loss = (max(_nan_inf(abs(p - r) / abs(r))
                for p, r in zip(prog.losses, ref.losses))
            if len(prog.losses) == len(ref.losses) else math.inf)
    diffs = []
    for k in counted:
        if is_dense(k):
            g, r = prog.dense_grad.get(k), ref.dense_grad[k]
            diffs.append(math.inf if g is None else _nan_inf(
                float((g - r).norm() / r.norm().clamp(min=1e-30))))
    return {"loss_gap": loss,
            "grad_gap": _worst_gap(prog.grad, ref.grad, ref.grad),
            "change_gap": _worst_gap(prog.change, ref.change, counted),
            "ema_gap": _worst_gap(prog.ema_change, ref.ema_change, counted),
            "grad_diff": statistics.median(diffs),
            "route_flip": _nan_inf(ref.route_flip)}


def serve_numbers(prog: torch.Tensor, ref: torch.Tensor, route_flip: float,
                  again: typ.Optional[torch.Tensor] = None
                  ) -> typ.Dict[str, float]:
    """``prog``, ``ref`` and ``again`` (the program's answers served again):
    (n, classes) logits of the sampled images."""
    prog, ref = prog.double(), ref.double()
    err = ((prog - ref).norm(dim=1) / ref.norm(dim=1).clamp(min=1e-30))
    err = torch.where(torch.isnan(err), torch.full_like(err, math.inf), err)
    out = {"logit_err_median": float(err.median()),
           "logit_err_max": float(err.max()),
           "route_flip": _nan_inf(route_flip)}
    if again is not None:
        out["rerun_diff"] = _nan_inf(float(
            (again.double() - prog).abs().max() / prog.abs().max()))
    return out


def judge(numbers: typ.Dict[str, float], limits: typ.Dict[str, float]
          ) -> typ.Tuple[bool, typ.Dict[str, dict]]:
    """Each limited number beside its limit; correct when every one is
    finite and at most its limit."""
    rows = {k: {"value": numbers.get(k, math.inf), "limit": lim}
            for k, lim in limits.items()}
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"]
             for r in rows.values())
    return ok, rows
