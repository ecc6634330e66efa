"""Dropless Switch/MoE dispatch for the H100, forward and backward.

Port of the dropless pieces of ``slim_switch_moe_vit_tpu/ops/moe.py``:

- :func:`naive_topk_gate` (:49-79): top-k by repeated argmax (ties go to the
  first index), softmax over the k selected logits (FastMoE ``NaiveGate``);
- :func:`load_balance_loss` (:82-93), the Switch auxiliary loss;
- :func:`rank_in_expert` (:279-308) and :func:`aligned_expert_layout`
  (:353-469, dropless form): a counting sort of the (token, choice) pairs by
  expert into a padded layout whose expert groups start on ``TILE_ROWS``
  boundaries, ``Tp = roundup(T*k, tile) + E*tile`` rows, at least one tile
  per expert, with ``w_slot``, the combine weight of each slot;
- :func:`dispatch_gather` (:476-507) and :func:`combine_slots` (:510-552)
  as autograd Functions with the JAX custom backwards: k row gathers
  instead of a scatter-add for dx, one row gather scaled by ``w_slot`` for
  the combine's d_out;
- :func:`moe_forward_fused` (:555-626), the serving and training path, over
  the expert-FFN kernels of ``ops/fused_ffn.py``;
- :func:`moe_forward_ragged` (:222-276) and :func:`moe_dense` (:902) as
  plain oracles.

Each forward returns ``(y, aux)``, aux holding ``balance_loss`` and
``drop_fraction`` (0 for the dropless modes) as 0-d f32 tensors.

Functions keep the JAX package's layouts: ``router_w`` is (d, E), the expert
tensors are expert-major (E, d, h) / (E, h) / (E, h, d) / (E, d).

Not ported here (TPU layout policies): the lane-major prefix count of
``_rank_in_expert`` (a one-hot cumsum does the same), the packed-s32 slot
table (``w_slot`` is one scatter into the activation dtype, the same values
the JAX package's packing gives), and the 512-row layout policy (the
flagship's T*k = 50,432 takes the 256-row layout there too). Capacity
dispatch waits for its ROADMAP item.
"""
from __future__ import annotations

import torch

from .fused_ffn import TILE_ROWS, fused_expert_ffn, gelu_exact, gelu_fast


def _router_logits(x, router_w, router_b):
    return x.float() @ router_w.float() + router_b.float()


def naive_topk_gate(logits: torch.Tensor, top_k: int):
    """Select the top-k experts by repeated argmax, softmax over their
    scores. Returns ((T, k) f32 weights, (T, k) int64 expert ids)."""
    cur = logits.float()
    vals, idxs = [], []
    for _ in range(top_k):
        i = torch.argmax(cur, dim=-1)  # first index among ties
        vals.append(cur.gather(-1, i[:, None])[:, 0])
        idxs.append(i)
        cur = cur.scatter(-1, i[:, None], float("-inf"))
    weights = torch.softmax(torch.stack(vals, dim=-1), dim=-1)
    return weights, torch.stack(idxs, dim=-1)


def load_balance_loss(logits: torch.Tensor, expert_idx: torch.Tensor,
                      num_experts: int) -> torch.Tensor:
    """Switch-transformer auxiliary loss E * sum_e f_e * P_e: f_e the share
    of tokens whose top-1 choice is e, P_e the mean router probability."""
    probs = torch.softmax(logits.float(), dim=-1)
    f = torch.nn.functional.one_hot(expert_idx[:, 0], num_experts).float()
    return num_experts * (f.mean(0) * probs.mean(0)).sum()


def rank_in_expert(flat_e: torch.Tensor, num_experts: int):
    """For each pair, how many earlier pairs (token-major order) chose the
    same expert, plus the group sizes.

    The one-hot is laid out (E, T*k) so the scan runs along the contiguous
    dim: PyTorch's scan along the outer dim of a (T*k, E) one-hot took 9.4
    ms per call at T*k = 50,432 on the H100."""
    experts = torch.arange(num_experts, device=flat_e.device)
    oh = (flat_e[None, :] == experts[:, None]).to(torch.int32)
    before = torch.cumsum(oh, dim=1, dtype=torch.int32) - oh
    rank = before.gather(0, flat_e[None, :])[0]
    return rank, oh.sum(dim=1)


def aligned_expert_layout(expert_idx: torch.Tensor, num_experts: int,
                          gate_w: torch.Tensor = None,
                          weight_dtype: torch.dtype = torch.bfloat16):
    """Sort (token, choice) pairs by expert with TILE_ROWS-aligned group
    starts.

    Returns:
        gather_idx: (Tp,) int64, source token of each padded slot (padding
            slots point at token 0; their outputs are never read).
        pair_slot: (T, k) int64, slot of each (token, choice) pair.
        e_of_tile: (Tp // TILE_ROWS,) int32, owning expert of each row tile.
        w_slot: (Tp,) ``weight_dtype``, the combine weight of each slot (0 at
            padding; detached, the gate's gradient comes through the
            combine's d_gate), or None when ``gate_w`` is None.
    """
    T, k = expert_idx.shape
    TK = T * k
    E = num_experts
    tile = TILE_ROWS
    flat = expert_idx.reshape(-1)
    rank, group_sizes = rank_in_expert(flat, E)
    Tp = (TK + tile - 1) // tile * tile + E * tile
    # at least one tile per expert, as the JAX layout keeps for its backward
    padded = torch.clamp((group_sizes + tile - 1) // tile * tile, min=tile)
    starts = torch.cumsum(padded, dim=0) - padded
    slot = starts[flat] + rank
    pairs = torch.arange(TK, device=flat.device)
    gather_idx = torch.zeros(Tp, dtype=torch.long, device=flat.device)
    gather_idx.scatter_(0, slot, pairs // k)
    tile_starts = torch.arange(0, Tp, tile, device=flat.device)
    e_of_tile = torch.clamp(
        torch.searchsorted(starts, tile_starts, right=True) - 1, 0, E - 1)
    w_slot = None
    if gate_w is not None:
        w_slot = torch.zeros(Tp, dtype=weight_dtype, device=flat.device)
        w_slot.scatter_(0, slot, gate_w.detach().reshape(-1).to(weight_dtype))
    return gather_idx, slot.reshape(T, k), e_of_tile.to(torch.int32), w_slot


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gather_idx, pair_slot):
        ctx.save_for_backward(pair_slot)
        return x.index_select(0, gather_idx)

    @staticmethod
    def backward(ctx, dxs):
        # each token owns exactly its k slots, and padding slots carry zero
        # cotangents: k row gathers instead of a scatter-add
        (pair_slot,) = ctx.saved_tensors
        dx = None
        for kk in range(pair_slot.shape[1]):
            g = dxs.index_select(0, pair_slot[:, kk])
            dx = g if dx is None else dx + g
        return dx, None, None


def dispatch_gather(x: torch.Tensor, gather_idx: torch.Tensor,
                    pair_slot: torch.Tensor) -> torch.Tensor:
    """xs[s] = x[gather_idx[s]]: tokens into the padded expert layout;
    backward dx[t] = sum_k dxs[pair_slot[t, k]]."""
    return _DispatchGather.apply(x, gather_idx, pair_slot)


class _CombineSlots(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, pair_slot, gate_w, gather_idx, w_slot):
        ctx.save_for_backward(out, pair_slot, gate_w, gather_idx, w_slot)
        y = None
        for kk in range(pair_slot.shape[1]):
            yk = out.index_select(0, pair_slot[:, kk])
            yk = yk * gate_w[:, kk:kk + 1].to(out.dtype)
            y = yk if y is None else y + yk
        return y

    @staticmethod
    def backward(ctx, dy):
        out, pair_slot, gate_w, gather_idx, w_slot = ctx.saved_tensors
        dyc = dy.to(out.dtype)
        d_gate = torch.stack(
            [(out.index_select(0, pair_slot[:, kk]) * dyc).sum(-1)
             for kk in range(pair_slot.shape[1])], dim=1).to(gate_w.dtype)
        # slots are unique and gather_idx inverts them: one row gather,
        # scaled by the slot's weight (0 at padding)
        d_out = dyc.index_select(0, gather_idx) * w_slot[:, None].to(out.dtype)
        return d_out, None, d_gate, None, None


def combine_slots(out: torch.Tensor, pair_slot: torch.Tensor,
                  gate_w: torch.Tensor, gather_idx: torch.Tensor,
                  w_slot: torch.Tensor) -> torch.Tensor:
    """y[t] = sum_k gate_w[t, k] * out[pair_slot[t, k]], in out's dtype;
    backward d_out = dy[gather_idx] * w_slot, d_gate[t, k] =
    rowsum(out[pair_slot[t, k]] * dy[t]) in out's dtype."""
    return _CombineSlots.apply(out, pair_slot, gate_w, gather_idx, w_slot)


def _aux(logits, expert_idx, num_experts):
    return {"balance_loss": load_balance_loss(logits, expert_idx, num_experts),
            "drop_fraction": torch.zeros((), dtype=torch.float32,
                                         device=logits.device)}


def moe_forward_fused(x, router_w, router_b, w1, b1, w2, b2, *,
                      top_k: int = 2):
    """Dropless MoE MLP over (T, d) tokens through the expert-FFN kernels.
    Returns (y in x's dtype, aux)."""
    E = w1.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    gather_idx, pair_slot, e_of_tile, w_slot = aligned_expert_layout(
        expert_idx, E, gate_w=gate_w, weight_dtype=x.dtype)
    xs = dispatch_gather(x, gather_idx, pair_slot)
    out = fused_expert_ffn(xs, w1.to(x.dtype).contiguous(), b1.float(),
                           w2.to(x.dtype).contiguous(), b2.float(), e_of_tile)
    y = combine_slots(out, pair_slot, gate_w, gather_idx, w_slot)
    return y.to(x.dtype), _aux(logits, expert_idx, E)


def moe_forward_ragged(x, router_w, router_b, w1, b1, w2, b2, *,
                       top_k: int = 2):
    """Plain oracle: stable sort by expert, one GEMM pair per expert group
    (products in x's dtype, as ``lax.ragged_dot`` with
    ``preferred_element_type=x.dtype``), then unsort and mix."""
    T, d = x.shape
    E = w1.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    flat_e = expert_idx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    xs = x.index_select(0, sort_idx // top_k)
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    outs = []
    for e, rows in enumerate(torch.split(xs, sizes)):
        h = rows @ w1[e].to(x.dtype) + b1[e].to(x.dtype)
        g = gelu_fast(h)
        outs.append(g @ w2[e].to(x.dtype) + b2[e].to(x.dtype))
    out = torch.cat(outs)
    inv = torch.argsort(sort_idx).reshape(T, top_k)
    y = torch.zeros((T, d), dtype=out.dtype, device=x.device)
    for kk in range(top_k):
        yk = out.index_select(0, inv[:, kk])
        y = y + yk * gate_w[:, kk:kk + 1].to(yk.dtype)
    return y.to(x.dtype), _aux(logits, expert_idx, E)


def moe_dense(x, router_w, router_b, w1, b1, w2, b2, *, top_k: int = 2):
    """Exact dropless oracle: every expert runs every token, in f32."""
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    h = torch.einsum("td,edh->eth", x.float(), w1.float())
    h = gelu_exact(h + b1.float()[:, None, :])
    out = torch.einsum("eth,ehd->etd", h, w2.float()) + b2.float()[:, None, :]
    picked = out.transpose(0, 1).gather(
        1, expert_idx[:, :, None].expand(-1, -1, out.shape[-1]))
    y = torch.einsum("tkd,tk->td", picked, gate_w)
    return y.to(x.dtype), _aux(logits, expert_idx, w1.shape[0])
