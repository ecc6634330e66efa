"""Analytic and counted FLOP accounting, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/ops/flops.py``: the closed-form counts
(:19-85), copied, priced by *active* token counts (post-gate) as the
reference's FLOP hook prices them (``models/resmoe_flop_hook.py``):
attention ``4·n·d² + 2·n²·d``, the gate and router linears, norms and
residuals. :func:`cost_analysis` is the counterpart of the JAX
``xla_cost_analysis`` (:88-96): it counts one call's operations with
``torch.utils.flop_counter.FlopCounterMode`` (the matmuls, convolutions and
attention of the plain PyTorch ops; a hand-written kernel's launch is not
seen) and returns the same kind of dict.
"""
from __future__ import annotations

import typing as typ

import torch


def gate_flops(tokens: float, dim: int) -> float:
    """Token-skip gate head: (T, d) @ (d, 1) (resmoe_flop_hook.py:13-17)."""
    return tokens * dim * 1


def router_flops(tokens: float, dim: int, num_experts: int) -> float:
    """MoE gate linear + softmax (resmoe_flop_hook.py:4-10)."""
    return tokens * dim * num_experts + tokens * (3 * num_experts - 1)


def attention_flops(active_tokens: float, dim: int) -> float:
    """4·n·d² (qkv+proj) + 2·n²·d (scores+mix) (resmoe_flop_hook.py:34)."""
    return 4 * active_tokens * dim * dim + 2 * active_tokens ** 2 * dim


def expert_ffn_flops(active_tokens: float, dim: int, hidden: int,
                     top_k: int = 1) -> float:
    """Per-token expert FFN cost: each routed copy does 2·d·h MACs -> 2 GEMMs."""
    return 2 * active_tokens * top_k * dim * hidden * 2 / 2  # = 2*T*k*d*h


def norm_flops(total_scalars: float, affine: bool = True) -> float:
    """reference prices a norm at 1 (or 2 with affine) flop/scalar
    (resmoe_flop_hook.py:25-27)."""
    return total_scalars * (2 if affine else 1)


def resmoe_block_flops(batch: int, tokens: int, dim: int, hidden: int,
                       num_experts: int, top_k: int,
                       attn_keep_frac: float = 1.0,
                       moe_keep_frac: float = 1.0) -> float:
    """One ResMoE block priced at *active* token counts (the reference hook
    recomputes gate masks to count kept tokens, resmoe_flop_hook.py:20-62)."""
    total = batch * tokens
    n_attn = total * attn_keep_frac
    n_moe = total * moe_keep_frac
    scalars = total * dim
    f = 0.0
    f += norm_flops(scalars)                      # norm1
    f += gate_flops(total, dim)                   # dense gate
    f += attention_flops(n_attn / batch, dim) * batch
    f += scalars                                  # attn residual
    f += norm_flops(scalars)                      # norm2
    f += gate_flops(total, dim)                   # moe gate
    f += router_flops(n_moe, dim, num_experts)    # expert router
    f += 4 * n_moe * top_k * dim * hidden         # two grouped GEMMs, 2 MAC=2flop
    f += scalars                                  # moe residual
    return f


def vit_flops(batch: int, img_size: int, patch_size: int, dim: int, depth: int,
              hidden_mult: float = 4.0, num_classes: int = 1000,
              num_tokens: int = 1, moe: bool = False, num_experts: int = 8,
              top_k: int = 2) -> float:
    """Forward FLOPs of a (Res)MoE / dense ViT."""
    grid = img_size // patch_size
    n = grid * grid + num_tokens
    hidden = int(dim * hidden_mult)
    f = 2.0 * batch * (grid * grid) * (patch_size * patch_size * 3) * dim
    for _ in range(depth):
        if moe:
            f += resmoe_block_flops(batch, n, dim, hidden, num_experts, top_k)
        else:
            f += batch * (attention_flops(n, dim) + 4 * n * dim * hidden
                          + 2 * norm_flops(n * dim) + 2 * n * dim)
    f += 2.0 * batch * dim * num_classes
    return f


def cost_analysis(fn: typ.Callable, *args, **kwargs) -> typ.Dict[str, float]:
    """Counted cost of ``fn(*args, **kwargs)``: ``{"flops": total}`` plus
    one ``"flops <op>"`` entry per operator, as floats."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        fn(*args, **kwargs)
    out = {"flops": float(counter.get_total_flops())}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out[f"flops {op}"] = float(n)
    return out
