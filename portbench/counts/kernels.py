"""FLOPs and bytes of the functions a roofline metric times, for one unit of
traffic (a training step, or one served batch), over all blocks.

- ``expert_ffn_fwd``: y = GELU(x W1 + b1) W2 + b2 over the routed rows of
  each block (K3's function): 4 R D H FLOPs for R = B N k routed rows;
  x, W1, b1, W2, b2 read, y written.
- ``expert_ffn_bwd``: dx, dW1, db1, dW2, db2 from x, dy and the weights
  (K4's function): the products dh = dy W2^T, dx = dh W1^T, dW1 = x^T dh,
  dW2 = g^T dy, 8 R D H FLOPs; the recompute of h and g is not counted.
- ``attention_fwd``: softmax(Q K^T / sqrt(d)) V from packed qkv (K5):
  4 B N^2 D FLOPs; qkv read, o written.
- ``attention_bwd``: dqkv from qkv and do (K6): dV, dP, dQ and dK, 8 B N^2
  D FLOPs; qkv and do read, dqkv written.
- ``layernorm``: every LayerNorm of the step (K1a, K1b, K2a; in training
  their backwards K1c, K2b): each row's residual sum, statistics and
  affine map, 8 FLOPs an element forward and 12 backward; the rows read
  and written as each form's inputs and outputs.
"""
from __future__ import annotations

import typing as typ

F32 = 4


def shape(cfg: dict, batch: int, training: bool) -> dict:
    n = (cfg["img_size"] // cfg["patch_size"]) ** 2 + 1
    return {"B": batch, "N": n, "D": cfg["embed_dim"], "H": cfg["hidden"],
            "E": cfg["num_experts"], "k": cfg["top_k"], "depth": cfg["depth"],
            "act_bytes": 2 if cfg["dtype"] == "bfloat16" else 4,
            "training": training}


def _rows(s):
    return s["B"] * s["N"] * s["k"]


def expert_ffn_fwd(s: dict) -> typ.Tuple[float, float]:
    R, D, H, E, a = _rows(s), s["D"], s["H"], s["E"], s["act_bytes"]
    flops = 4.0 * R * D * H
    bytes_ = a * R * D * 2 + a * 2 * E * D * H + F32 * E * (H + D)
    return s["depth"] * flops, s["depth"] * bytes_


def expert_ffn_bwd(s: dict) -> typ.Tuple[float, float]:
    R, D, H, E, a = _rows(s), s["D"], s["H"], s["E"], s["act_bytes"]
    flops = 8.0 * R * D * H
    read = a * R * D * 2 + a * 2 * E * D * H + F32 * E * H
    written = a * R * D + a * 2 * E * D * H + F32 * E * (H + D)
    return s["depth"] * flops, s["depth"] * (read + written)


def attention_fwd(s: dict) -> typ.Tuple[float, float]:
    B, N, D, a = s["B"], s["N"], s["D"], s["act_bytes"]
    return (s["depth"] * 4.0 * B * N * N * D,
            s["depth"] * a * B * N * (3 * D + D))


def attention_bwd(s: dict) -> typ.Tuple[float, float]:
    B, N, D, a = s["B"], s["N"], s["D"], s["act_bytes"]
    return (s["depth"] * 8.0 * B * N * N * D,
            s["depth"] * a * B * N * (3 * D + D + 3 * D))


def layernorm(s: dict) -> typ.Tuple[float, float]:
    M, D, a, depth = s["B"] * s["N"], s["D"], s["act_bytes"], s["depth"]
    el = M * D
    adds = 2 * depth - 1
    calls = 2 * depth + 1
    # forwards: the first norm y = LN(x); the adds u = x + r, y = LN(u);
    # the final norm y = LN(a + b) without the sum
    fwd_bytes = a * el * (2 + 4 * adds + 3) + calls * 2 * F32 * D
    flops = 8.0 * el * calls
    bytes_ = fwd_bytes
    if s["training"]:
        # backwards: du from (u, dy); du from (u, dy, du_out); the final
        # norm's d(a + b) from (a, b, dy); dgamma, dbeta of each
        bytes_ += a * el * (3 + 4 * adds + 4) + calls * 3 * F32 * D
        flops += 12.0 * el * calls
    return flops, bytes_


FUNCTIONS = {"expert_ffn_fwd": expert_ffn_fwd,
             "expert_ffn_bwd": expert_ffn_bwd,
             "attention_fwd": attention_fwd,
             "attention_bwd": attention_bwd,
             "layernorm": layernorm}
