"""The optimizer and the learning-rate schedules, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/optim.py``: the four timm schedules and
``create_scheduler`` (:84-356, pure Python, copied as they are), ``scaled_lr``
(:359-364), ``attn_only_mask`` (:66-82) and ``make_optimizer`` (:567-697)
with every optimizer name, ``clip_grad`` and the trainable mask.

The JAX package's default chain (``scale_by_adam`` then
``add_decayed_weights`` on ``wd_mask``, times -lr per group) is AdamW's
decoupled update, p <- p - lr * (adam(g) + wd * p), which is what
``torch.optim.AdamW`` computes (the foreach form). ``update_fn.fused_apply``
is the one-pass AdamW + EMA of the K7 kernel (``ops/fused_adamw.py``), in
the JAX math's order; it reads and writes the same state
``torch.optim.AdamW`` keeps (``exp_avg``, ``exp_avg_sq``, ``step``), so a
checkpoint moves between the two paths, as the JAX package keeps optax's
layout for its fused path (optim.py:604-607).

Parameters fall into groups, weight decay or none by ``wd_mask`` crossed
with the base or the gate learning rate by ``gate_mask`` and with expert or
dense tensors (the global norms under an expert group sum the expert
tensors' squares over it); each update sets the groups' ``lr`` from
``lr_base`` / ``lr_gate``, as the JAX update takes both as arguments. The masks read the JAX package's parameter
names (``utils/checkpoint.py::jax_path``): the port calls the expert biases
``b1`` / ``b2``, and only their JAX names (``expert_fc*_bias``) say they are
biases, which the JAX mask exempts from decay (optim.py:55).
"""
from __future__ import annotations

import math
import typing as typ

import numpy as np
import torch

from .ops.fused_adamw import bias_corrections, fused_adamw_ema
from .parallel import collectives as coll
from .parallel.sharding import is_expert_param
from .utils.checkpoint import jax_path

NO_WEIGHT_DECAY_NAMES = {"pos_embed", "cls_token", "dist_token"}
GATE_MARKERS = ("moe_gate", "dense_gate")
SUPPORTED_OPTIMIZERS = ("adamw", "adam", "sgd", "nesterov", "momentum",
                        "lamb", "nadam", "radam", "adadelta", "rmsprop")


def wd_mask(named: typ.Iterable[typ.Tuple[str, torch.Tensor]]
            ) -> typ.Dict[str, bool]:
    """{name: True where weight decay applies}: timm's rule on the JAX
    names (ndim > 1, not in the no-decay set, no ``bias`` in the leaf)."""
    out = {}
    for name, p in named:
        path = jax_path(name)
        out[name] = (not any(n in NO_WEIGHT_DECAY_NAMES for n in path)
                     and "bias" not in path[-1] and p.dim() > 1)
    return out


def gate_mask(named: typ.Iterable[typ.Tuple[str, torch.Tensor]]
              ) -> typ.Dict[str, bool]:
    """{name: True for the gate parameters}, trained at ``lr_gate``."""
    return {name: any(m in n for n in jax_path(name) for m in GATE_MARKERS)
            for name, _ in named}


def attn_only_mask(named: typ.Iterable[typ.Tuple[str, torch.Tensor]]
                   ) -> typ.Dict[str, bool]:
    """{name: True for the parameters ``--attn-only`` trains} (JAX :66-82,
    reference main.py:575-595): the attention parameters, the heads and
    ``pos_embed``; ``patch_embed`` and everything else freeze."""
    out = {}
    for name, _ in named:
        path = jax_path(name)
        out[name] = ("patch_embed" not in path
                     and (any("attn" in n for n in path)
                          or path[0] in ("head", "head_dist", "fc",
                                         "pos_embed")))
    return out


class TimmCosineSchedule:
    """lr(epoch) per param group, matching timm CosineLRScheduler defaults as
    driven by the reference CLI (sched=cosine, warmup_prefix False)."""

    def __init__(self, base_lr: float, epochs: int, warmup_epochs: int = 5,
                 warmup_lr: float = 1e-6, min_lr: float = 1e-5,
                 cooldown_epochs: int = 10,
                 noise_range: typ.Optional[typ.Sequence[float]] = None,
                 noise_pct: float = 0.67, noise_std: float = 1.0,
                 noise_seed: int = 42):
        self.base_lr = base_lr
        self.epochs = epochs
        self.warmup_epochs = warmup_epochs
        self.warmup_lr = warmup_lr
        self.min_lr = min_lr
        self.cooldown_epochs = cooldown_epochs
        # timm lr-noise: epoch percentages of t_initial (--lr-noise pct pct)
        self.noise_range = None
        if noise_range:
            rng = [p * epochs if p < 1.0 else p for p in noise_range]
            self.noise_range = (rng[0], rng[1] if len(rng) > 1 else epochs)
        self.noise_pct = noise_pct
        self.noise_std = noise_std
        self.noise_seed = noise_seed

    def _noise(self, epoch: int) -> float:
        """timm Scheduler._calculate_noise: per-epoch seeded gaussian clipped
        to +/- noise_pct."""
        if self.noise_range is None:
            return 0.0
        if not (self.noise_range[0] <= epoch < self.noise_range[1]):
            return 0.0
        import numpy as np

        g = np.random.RandomState(self.noise_seed + epoch)
        while True:
            n = g.randn() * self.noise_std
            if abs(n) < self.noise_pct:
                return float(n)

    def scale(self, epoch: int) -> float:
        """Relative multiplier applied to every group's base lr. Warmup is an
        absolute ramp for the main group; we return the main group's ratio and
        let groups share it (timm scales groups proportionally)."""
        return self(epoch) / self.base_lr if self.base_lr > 0 else 0.0

    def __call__(self, epoch: int) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            slope = (self.base_lr - self.warmup_lr) / self.warmup_epochs
            return self.warmup_lr + slope * epoch
        if epoch >= self.epochs:
            return self.min_lr
        t = epoch / max(self.epochs, 1)
        lr = self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 + math.cos(math.pi * t)
        )
        return lr * (1.0 + self._noise(epoch))


class TimmStepSchedule:
    """lr(epoch) matching timm StepLRScheduler as driven by the reference CLI
    (``--sched step --decay-epochs N --decay-rate R``): linear warmup, then
    ``base_lr * R ** (epoch // N)``. timm does not clamp step decay to
    ``min_lr``; lr-noise applies the same way as for cosine."""

    def __init__(self, base_lr: float, epochs: int, *, decay_epochs: float = 30,
                 decay_rate: float = 0.1, warmup_epochs: int = 5,
                 warmup_lr: float = 1e-6,
                 noise_range: typ.Optional[typ.Sequence[float]] = None,
                 noise_pct: float = 0.67, noise_std: float = 1.0,
                 noise_seed: int = 42):
        self.base_lr = base_lr
        self.epochs = epochs
        self.decay_epochs = max(decay_epochs, 1e-9)
        self.decay_rate = decay_rate
        self.warmup_epochs = warmup_epochs
        self.warmup_lr = warmup_lr
        self._noise_helper = TimmCosineSchedule(
            base_lr, epochs, noise_range=noise_range, noise_pct=noise_pct,
            noise_std=noise_std, noise_seed=noise_seed)

    def scale(self, epoch: int) -> float:
        return self(epoch) / self.base_lr if self.base_lr > 0 else 0.0

    def __call__(self, epoch: int) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            slope = (self.base_lr - self.warmup_lr) / self.warmup_epochs
            return self.warmup_lr + slope * epoch
        lr = self.base_lr * self.decay_rate ** int(epoch // self.decay_epochs)
        return lr * (1.0 + self._noise_helper._noise(epoch))


class TimmPlateauSchedule:
    """``--sched plateau``: timm PlateauLRScheduler semantics — a thin wrapper
    around ``torch.optim.lr_scheduler.ReduceLROnPlateau`` (mode inferred from
    the eval metric; accuracy -> 'max') with timm's linear warmup on top.
    Parity-tested against torch's ReduceLROnPlateau itself
    (tests/test_optim_extras.py), since torch is the authoritative
    implementation timm defers to.

    NOTE the reference driver cannot actually run plateau: it steps the
    scheduler without a metric (its ``main.py:886``,
    ``lr_scheduler.step(epoch)``), and torch's ReduceLROnPlateau then raises
    on ``float(None)``. Implemented here are the INTENDED semantics — the way
    timm's own train loop drives it, feeding the epoch's eval metric — via
    ``observe(metric)`` called after each epoch's eval (main.py). lr-noise is
    not supported with plateau (timm applies/restores it around the torch
    state in a way that cannot be reproduced without torch's internals;
    passing ``--lr-noise`` with plateau raises up front).

    torch-parity points (ReduceLROnPlateau defaults): relative improvement
    threshold 1e-4 — for mode 'max' an epoch improves iff
    ``metric > best * (1 + 1e-4)`` — patience counted in *bad* epochs, decay
    ``lr *= decay_rate`` floored at ``min_lr``, cooldown 0.
    """

    def __init__(self, base_lr: float, epochs: int, *, decay_rate: float = 0.1,
                 patience_epochs: int = 10, warmup_epochs: int = 5,
                 warmup_lr: float = 1e-6, min_lr: float = 1e-5,
                 mode: str = "max", threshold: float = 1e-4,
                 eps: float = 1e-8):
        self.base_lr = base_lr
        self.epochs = epochs
        self.decay_rate = decay_rate
        self.patience = patience_epochs
        self.warmup_epochs = warmup_epochs
        self.warmup_lr = warmup_lr
        self.min_lr = min_lr
        self.mode = mode
        self.threshold = threshold
        self.eps = eps
        self.current_lr = base_lr
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad = 0

    def _is_better(self, metric: float) -> bool:
        # torch ReduceLROnPlateau.is_better, threshold_mode='rel'
        if self.mode == "max":
            return metric > self.best * (1.0 + self.threshold)
        return metric < self.best * (1.0 - self.threshold)

    def observe(self, epoch: int, metric: float) -> None:
        """Feed epoch's eval metric (timm train loop:
        ``lr_scheduler.step(epoch + 1, eval_metric)``). No-op during warmup,
        mirroring timm's PlateauLRScheduler.step warmup branch."""
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            return
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            # torch _reduce_lr: floor at min_lr, skip sub-eps updates (so the
            # lr can never INCREASE toward min_lr, and tiny lrs stop moving)
            new_lr = max(self.current_lr * self.decay_rate, self.min_lr)
            if self.current_lr - new_lr > self.eps:
                self.current_lr = new_lr
            self.num_bad = 0

    def scale(self, epoch: int) -> float:
        return self(epoch) / self.base_lr if self.base_lr > 0 else 0.0

    def __call__(self, epoch: int) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            slope = (self.base_lr - self.warmup_lr) / self.warmup_epochs
            return self.warmup_lr + slope * epoch
        return self.current_lr

    # Unlike cosine/step, plateau is STATEFUL — the reference checkpoints
    # lr_scheduler.state_dict() (main.py:900) so a resumed run keeps its
    # decay bookkeeping. Same here via a JSON sidecar
    # (utils/checkpoint.py::save_checkpoint extra={"sched": ...}).
    def state_dict(self) -> dict:
        return {"current_lr": self.current_lr, "best": self.best,
                "num_bad": self.num_bad}

    def load_state_dict(self, st: dict) -> None:
        self.current_lr = float(st["current_lr"])
        self.best = float(st["best"])
        self.num_bad = int(st["num_bad"])


class TimmTanhSchedule:
    """``--sched tanh``: timm TanhLRScheduler — the hyperbolic-tangent decay
    of Hsueh et al. 2018 (arXiv:1806.01593), the fourth and last schedule the
    DeiT-era timm ``create_scheduler`` dispatches (cosine/tanh/step/plateau).

    Decay: ``lr = min_lr + 0.5*(base - min_lr) * (1 - tanh(lb + (ub-lb)*t/T))``
    with timm's defaults ``lb=-6.0, ub=4.0`` (not CLI-exposed in the reference,
    so the defaults are the whole surface). Warmup ramp, cooldown-to-min_lr,
    and lr-noise behave exactly as in TimmCosineSchedule (shared timm
    ``Scheduler`` base-class behavior).

    Copied as the JAX package has it, including its open fault: lb/ub are
    not verified against timm (ROADMAP Queue 3)."""

    def __init__(self, base_lr: float, epochs: int, *, lb: float = -6.0,
                 ub: float = 4.0, warmup_epochs: int = 5,
                 warmup_lr: float = 1e-6, min_lr: float = 1e-5,
                 cooldown_epochs: int = 10,
                 noise_range: typ.Optional[typ.Sequence[float]] = None,
                 noise_pct: float = 0.67, noise_std: float = 1.0,
                 noise_seed: int = 42):
        self.base_lr = base_lr
        self.epochs = epochs
        self.lb = lb
        self.ub = ub
        self.warmup_epochs = warmup_epochs
        self.warmup_lr = warmup_lr
        self.min_lr = min_lr
        self.cooldown_epochs = cooldown_epochs
        self._noise_helper = TimmCosineSchedule(
            base_lr, epochs, noise_range=noise_range, noise_pct=noise_pct,
            noise_std=noise_std, noise_seed=noise_seed)

    def scale(self, epoch: int) -> float:
        return self(epoch) / self.base_lr if self.base_lr > 0 else 0.0

    def __call__(self, epoch: int) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            slope = (self.base_lr - self.warmup_lr) / self.warmup_epochs
            return self.warmup_lr + slope * epoch
        if epoch >= self.epochs:
            return self.min_lr
        tr = epoch / max(self.epochs, 1)
        lr = self.min_lr + 0.5 * (self.base_lr - self.min_lr) * (
            1.0 - math.tanh(self.lb + (self.ub - self.lb) * tr)
        )
        return lr * (1.0 + self._noise_helper._noise(epoch))


SUPPORTED_SCHEDULERS = ("cosine", "tanh", "step", "plateau")


def create_scheduler(sched: str, base_lr: float, epochs: int, *,
                     warmup_epochs: int = 5, warmup_lr: float = 1e-6,
                     min_lr: float = 1e-5, cooldown_epochs: int = 10,
                     decay_epochs: float = 30, decay_rate: float = 0.1,
                     patience_epochs: int = 10,
                     noise_range=None, noise_pct: float = 0.67,
                     noise_std: float = 1.0, noise_seed: int = 42):
    """timm ``create_scheduler`` parity for the CLI surface this framework
    honors (reference ``main.py:734``). Unsupported names raise instead of
    silently substituting an algorithm (PARITY 2.1)."""
    if sched == "cosine":
        return TimmCosineSchedule(
            base_lr, epochs, warmup_epochs=warmup_epochs, warmup_lr=warmup_lr,
            min_lr=min_lr, cooldown_epochs=cooldown_epochs,
            noise_range=noise_range, noise_pct=noise_pct, noise_std=noise_std,
            noise_seed=noise_seed)
    if sched == "tanh":
        return TimmTanhSchedule(
            base_lr, epochs, warmup_epochs=warmup_epochs, warmup_lr=warmup_lr,
            min_lr=min_lr, cooldown_epochs=cooldown_epochs,
            noise_range=noise_range, noise_pct=noise_pct, noise_std=noise_std,
            noise_seed=noise_seed)
    if sched == "step":
        return TimmStepSchedule(
            base_lr, epochs, decay_epochs=decay_epochs, decay_rate=decay_rate,
            warmup_epochs=warmup_epochs, warmup_lr=warmup_lr,
            noise_range=noise_range, noise_pct=noise_pct, noise_std=noise_std,
            noise_seed=noise_seed)
    if sched == "plateau":
        if noise_range:
            raise ValueError(
                "--lr-noise is not supported with --sched plateau (see "
                "TimmPlateauSchedule docstring)")
        return TimmPlateauSchedule(
            base_lr, epochs, decay_rate=decay_rate,
            patience_epochs=patience_epochs, warmup_epochs=warmup_epochs,
            warmup_lr=warmup_lr, min_lr=min_lr)
    raise ValueError(
        f"--sched {sched!r} is not implemented; supported: "
        f"{SUPPORTED_SCHEDULERS} (see PARITY.md 2.1 — this framework refuses "
        "to silently substitute a schedule)")


def scaled_lr(lr: float, batch_size: int, world_size: int,
              unscale_lr: bool) -> float:
    """Linear LR scaling: lr * global_batch / 512 (reference main.py:615-617)."""
    if unscale_lr:
        return lr
    return lr * batch_size * world_size / 512.0


def global_norm(tensors: typ.Sequence[torch.Tensor],
                expert: typ.Sequence[bool], expert_group=None) -> torch.Tensor:
    """The L2 norm of the whole parameter tree's ``tensors`` (0-d, in
    their dtype, on their device), as the JAX package takes it over its
    GSPMD tree: under an expert group each rank holds ``E / ep`` experts
    of an ``expert`` tensor, so those tensors' squares are summed over the
    group, the dense ones' counted once (every rank of the group holds the
    same). Each tensor's norm accumulates in f64 (:func:`_norms`)."""
    sq = []
    for flag in (False, True):
        part = [t for t, e in zip(tensors, expert) if e == flag]
        sq.append(_norms(part).square().sum() if part else
                  tensors[0].new_zeros((), dtype=torch.float64))
    if expert_group is not None:
        sq[1] = coll.psum(sq[1], expert_group)
    return torch.sqrt(sq[0] + sq[1]).to(tensors[0].dtype)


def _norms(tensors: typ.List[torch.Tensor]) -> torch.Tensor:
    """Each tensor's L2 norm, accumulated in f64: PyTorch's f32 norm on the
    CPU of a (8, 384, 1536) expert tensor is 1.2e-4 of itself off."""
    return torch.stack(torch._foreach_norm(tensors, 2, dtype=torch.float64))


def _tensor_norms(tensors: typ.List[torch.Tensor], expert: bool,
                  expert_group) -> typ.List[torch.Tensor]:
    """Each tensor's L2 norm over the whole tensor: an expert tensor's
    squares summed over the expert group (one all-reduce for the list)."""
    if not tensors:
        return []
    norms = _norms(tensors)
    if expert and expert_group is not None:
        norms = torch.sqrt(coll.psum(norms.square(), expert_group))
    return list(norms.to(tensors[0].dtype).unbind())


@torch.no_grad()
def clip_by_global_norm(params: typ.Sequence[torch.Tensor],
                        expert: typ.Sequence[bool], max_norm: float,
                        expert_group=None) -> None:
    """``optax.clip_by_global_norm`` on the gradients of ``params``, in
    place and without a host sync: where the global norm is at least
    ``max_norm``, g <- (g / norm) * max_norm."""
    grads = [p.grad for p in params]
    norm = global_norm(grads, expert, expert_group)
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))


class Lamb(torch.optim.Optimizer):
    """timm's Lamb (the FusedLAMB port) as the JAX package chains it
    (optim.py:521-564, :620-631), in place over foreach ops:

    1. every gradient is divided by max(1, global grad-norm /
       ``max_grad_norm``);
    2. Adam moments and the bias-corrected direction u = m_hat /
       (sqrt(v_hat) + eps) (eps outside the sqrt, as ``scale_by_adam``);
    3. decoupled decay u += wd * p;
    4. on a group with weight decay only, the trust ratio ||p|| / ||u||
       (1 where either norm is 0) scales u;
    5. p -= lr * u.

    The global norm and an expert tensor's ||p|| and ||u|| are taken over
    the whole tensor under an expert group (``expert_group``, the groups
    flagged ``expert``), so every layout clips and scales alike. The state
    is ``torch.optim.AdamW``'s (``step``, ``exp_avg``, ``exp_avg_sq``)."""

    def __init__(self, params, lr: float = 0.0,
                 betas: typ.Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, expert_group=None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay,
                                      expert=False))
        self.max_grad_norm = max_grad_norm
        self.expert_group = expert_group

    @torch.no_grad()
    def step(self, closure=None):
        work = [(g, [p for p in g["params"] if p.grad is not None])
                for g in self.param_groups]
        work = [(g, ps) for g, ps in work if ps]
        if not work:
            return None
        norm = global_norm([p.grad for _, ps in work for p in ps],
                           [g["expert"] for g, ps in work for _ in ps],
                           self.expert_group)
        denom = torch.clamp(norm / self.max_grad_norm, min=1.0)
        for group, params in work:
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:  # torch.optim.AdamW's lazily built state
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
            # the bias corrections in f32, as optax takes them (b2 = 0.999
            # in f32 moves 1 - b2 by 1.3e-5 of itself)
            t = np.float32(self.state[params[0]]["step"])
            c1, c2 = (float(np.float32(1.0) - np.float32(b) ** t)
                      for b in (b1, b2))
            grads = torch._foreach_div([p.grad for p in params], denom)
            m = [self.state[p]["exp_avg"] for p in params]
            v = [self.state[p]["exp_avg_sq"] for p in params]
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, grads, alpha=1.0 - b1)
            torch._foreach_mul_(v, b2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - b2)
            u = torch._foreach_div(m, c1)
            den = torch._foreach_sqrt(torch._foreach_div(v, c2))
            torch._foreach_add_(den, group["eps"])
            torch._foreach_div_(u, den)
            wd = group["weight_decay"]
            if wd != 0:
                torch._foreach_add_(u, params, alpha=wd)
                for ui, pn, un in zip(
                        u, _tensor_norms(params, group["expert"],
                                         self.expert_group),
                        _tensor_norms(u, group["expert"],
                                      self.expert_group)):
                    ratio = torch.where((pn > 0) & (un > 0), pn / un,
                                        torch.ones_like(pn))
                    ui.mul_(ratio)
            torch._foreach_add_(params, u, alpha=-group["lr"])
        return None


def make_optimizer(*, opt: str = "adamw",
                   weight_decay: float = 0.05,
                   betas: typ.Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, momentum: float = 0.9,
                   clip_grad: typ.Optional[float] = None,
                   trainable_mask: typ.Optional[typ.Callable] = None,
                   expert_group=None):
    """Returns ``(init_fn, update_fn)`` as the JAX package does (which also
    takes the param tree first; here the groups come from the model given
    to ``init_fn``):
    ``init_fn(model)`` builds the optimizer over the model's parameters (on
    their device), ``update_fn(optimizer, lr_base, lr_gate)`` sets the
    groups' learning rates, clips the gradients in ``p.grad`` by their
    global norm (``clip_grad``) and applies one step.

    ``opt`` is one of the timm names of the JAX ``make_optimizer``
    (:567-697), each with its math there:

    - ``adamw``: ``torch.optim.AdamW``, decoupled weight decay;
    - ``adam``: ``torch.optim.Adam``, L2 decay on the gradient;
    - ``sgd`` / ``nesterov`` / ``momentum``: ``torch.optim.SGD`` with
      Nesterov (the first two) or heavy-ball ``momentum``, L2 decay;
    - ``lamb``: :class:`Lamb`;
    - ``nadam``: ``torch.optim.NAdam``, momentum decay 4e-3, L2 decay;
    - ``radam``: ``torch.optim.RAdam``, decoupled decay;
    - ``adadelta``: ``torch.optim.Adadelta``, rho 0.9, L2 decay;
    - ``rmsprop``: ``torch.optim.RMSprop`` as timm builds it, alpha 0.9,
      eps outside the sqrt, ``momentum``, L2 decay.

    adadelta takes ``eps`` (the JAX chain fixes 1e-6) and radam adds it to
    sqrt(v) before the bias correction (the JAX chain after it), as timm's
    torch optimizers do. The groups of every optimizer are weight decay or
    none (``wd_mask``) x the base or the gate learning rate (``gate_mask``)
    x expert or dense tensors (whose norms under ``expert_group`` sum over
    the group: ``clip_grad``'s global norm, :class:`Lamb`'s).

    ``trainable_mask(named_parameters) -> {name: bool}`` (``--attn-only``:
    :func:`attn_only_mask`) leaves the other parameters out of the
    optimizer: they move by neither an update nor weight decay, and their
    gradients enter no norm, as the JAX update zeroes both (:662-672).

    ``update_fn.fused_apply(model, optimizer, ema, lr_base, lr_gate,
    ema_decay)`` (adamw without ``clip_grad`` or a mask, as in the JAX
    package) takes the same step, and the EMA update when ``ema`` (the EMA
    tensors by parameter name) is given, in one K7 launch."""
    if opt not in SUPPORTED_OPTIMIZERS:
        raise ValueError(f"--opt {opt!r} is not implemented; supported: "
                         f"{SUPPORTED_OPTIMIZERS}")
    clip = clip_grad if clip_grad is not None and clip_grad > 0 else None

    def build(groups):
        if opt == "adamw":
            return torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=eps,
                                     foreach=True)
        if opt == "adam":
            return torch.optim.Adam(groups, lr=0.0, betas=betas, eps=eps,
                                    foreach=True)
        if opt == "lamb":
            return Lamb(groups, betas=betas, eps=eps,
                        expert_group=expert_group)
        if opt == "nadam":
            return torch.optim.NAdam(groups, lr=0.0, betas=betas, eps=eps,
                                     momentum_decay=4e-3, foreach=True)
        if opt == "radam":
            return torch.optim.RAdam(groups, lr=0.0, betas=betas, eps=eps,
                                     decoupled_weight_decay=True,
                                     foreach=True)
        if opt == "adadelta":
            return torch.optim.Adadelta(groups, lr=0.0, rho=0.9, eps=eps,
                                        foreach=True)
        if opt == "rmsprop":
            return torch.optim.RMSprop(groups, lr=0.0, alpha=0.9, eps=eps,
                                       momentum=momentum, foreach=True)
        return torch.optim.SGD(  # sgd / nesterov / momentum
            groups, lr=0.0, momentum=momentum,
            nesterov=opt != "momentum" and momentum > 0, foreach=True)

    def init_fn(model: torch.nn.Module) -> torch.optim.Optimizer:
        named = list(model.named_parameters())
        if trainable_mask is not None:
            keep = trainable_mask(named)
            named = [(n, p) for n, p in named if keep[n]]
        decay, gate = wd_mask(named), gate_mask(named)
        groups = []
        for wd in (True, False):
            for is_gate in (False, True):
                for expert in (False, True):
                    params = [p for n, p in named
                              if decay[n] == wd and gate[n] == is_gate
                              and is_expert_param(n) == expert]
                    if params:
                        groups.append({
                            "params": params, "gate": is_gate,
                            "expert": expert,
                            "weight_decay": weight_decay if wd else 0.0})
        return build(groups)

    def update_fn(optimizer: torch.optim.Optimizer, lr_base: float,
                  lr_gate: float) -> None:
        for group in optimizer.param_groups:
            group["lr"] = float(lr_gate if group["gate"] else lr_base)
        if clip is not None:
            work = [(p, g["expert"]) for g in optimizer.param_groups
                    for p in g["params"] if p.grad is not None]
            if work:
                clip_by_global_norm([p for p, _ in work],
                                    [e for _, e in work], clip,
                                    expert_group)
        optimizer.step()

    @torch.no_grad()
    def fused_apply(model: torch.nn.Module, optimizer: torch.optim.AdamW,
                    ema: typ.Optional[typ.Dict[str, torch.Tensor]],
                    lr_base: float, lr_gate: float,
                    ema_decay: typ.Optional[float]) -> None:
        names = {p: n for n, p in model.named_parameters()}
        leaves: typ.Dict[str, list] = {k: [] for k in (
            "p", "g", "mu", "nu", "ema", "wd", "gate", "step")}
        for group in optimizer.param_groups:
            group["lr"] = float(lr_gate if group["gate"] else lr_base)
            for p in group["params"]:
                if p.grad is None:  # as torch.optim.AdamW: no step
                    continue
                st = optimizer.state[p]
                if not st:  # torch.optim.AdamW's lazily built state
                    st["step"] = torch.tensor(0.0, dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                for k, v in (("p", p), ("g", p.grad), ("mu", st["exp_avg"]),
                             ("nu", st["exp_avg_sq"]),
                             ("wd", group["weight_decay"] != 0),
                             ("gate", group["gate"]), ("step", st["step"])):
                    leaves[k].append(v)
                if ema is not None:
                    leaves["ema"].append(ema[names[p]])
        if not leaves["p"]:
            return
        t = int(leaves["step"][0]) + 1
        bc1, bc2 = bias_corrections(betas[0], betas[1], t)
        fused_adamw_ema(
            leaves["p"], leaves["g"], leaves["mu"], leaves["nu"],
            leaves["ema"] if ema is not None else None, leaves["wd"],
            leaves["gate"], lr_base=float(lr_base), lr_gate=float(lr_gate),
            bc1=bc1, bc2=bc2, b1=betas[0], b2=betas[1], eps=eps,
            weight_decay=weight_decay,
            ema_decay=ema_decay if ema is not None else None)
        for step in leaves["step"]:
            step.fill_(t)

    if opt == "adamw" and clip is None and trainable_mask is None:
        update_fn.fused_apply = fused_apply
    return init_fn, update_fn
