"""Switch/MoE dispatch for the H100, forward and backward.

Port of the single-device pieces of ``slim_switch_moe_vit_tpu/ops/moe.py``:

- :func:`naive_topk_gate` (:49-79): top-k by repeated argmax (ties go to the
  first index), softmax over the k selected logits (FastMoE ``NaiveGate``);
- :func:`load_balance_loss` (:82-93), the Switch auxiliary loss;
- :func:`rank_in_expert` (:279-308) and :func:`aligned_expert_layout`
  (:353-469): a counting sort of the (token, choice) pairs by expert into a
  padded layout whose expert groups start on ``TILE_ROWS`` boundaries.
  Dropless: ``Tp = roundup(T*k, tile) + E*tile`` rows, at least one tile
  per expert. With a ``capacity``: a static region of
  ``Cp = capacity_region_rows(capacity)`` rows per expert whose last slot
  is always padding; pairs ranked at or beyond the capacity are dropped.
  ``w_slot`` is the combine weight of each slot;
- the capacity primitives :func:`compute_capacity` (:96-101),
  :func:`make_dispatch` (:104-125), :func:`dispatch_tokens` (:128-143),
  :func:`combine_tokens` (:146-160), :func:`grouped_ffn` (:163-183) and
  :func:`moe_forward` (:186-219), the scatter-buffer ``'capacity'`` mode:
  plain PyTorch, the oracle of the fused capacity form; expert dropout on
  the hidden activations (:176-178, :256-258), its mask drawn by
  :func:`expert_dropout_mask`;
- :func:`moe_forward_expert_choice` (:858-899), each expert picking its
  top-C tokens, plain as in the JAX package;
- :func:`dispatch_gather` (:476-507) and :func:`combine_slots` (:510-552)
  as autograd Functions with the JAX custom backwards: k row gathers
  instead of a scatter-add for dx (the dropped pairs' masked to zero), one
  row gather scaled by ``w_slot`` for the combine's d_out;
- :func:`moe_forward_fused` (:555-626), the serving and training path, over
  the expert-FFN kernels of ``ops/fused_ffn.py``, dropless or with a
  capacity; with ``SSMV_GATHER_IN_KERNEL=1`` the dispatch gather rides the
  FFN kernels' x loads (K9, ``fused_expert_ffn_gather``);
- :func:`moe_forward_ragged` (:222-276) and :func:`moe_dense` (:902) as
  plain oracles;
- the expert-parallel forms over a (data, expert) layout
  (``parallel/sharding.py::Mesh``), each taking this rank's ``E / ep``
  experts: :func:`moe_forward_fused_ep` (:629-723, the psum form),
  :func:`moe_forward_fused_ep_a2a` (:725-856, the all-to-all form, with
  ``SSMV_A2A_PERMUTED=1`` on the permuted-tile FFN K10) and
  :func:`moe_forward_sharded` (the ``'capacity'`` mode, whose (E, C, d)
  buffer GSPMD shards over the expert axis in the JAX package,
  ``models/moe.py:136-150``), and :func:`moe_forward_gathered`, a dropless
  mode with the experts gathered over the group (GSPMD's replication of a
  Pallas call's inputs). Their collectives are the autograd Functions of
  ``parallel/collectives.py``.

Each forward returns ``(y, aux)``, aux holding ``balance_loss`` and
``drop_fraction`` (0 for the dropless modes, ``1 - mean(keep)`` with a
capacity) as 0-d f32 tensors.

Functions keep the JAX package's layouts: ``router_w`` is (d, E), the expert
tensors are expert-major (E, d, h) / (E, h) / (E, h, d) / (E, d).

Not ported here (TPU layout policies): the lane-major prefix count of
``_rank_in_expert`` (a one-hot cumsum does the same), the packed-s32 slot
table (``w_slot`` is one scatter into the activation dtype, the same values
the JAX package's packing gives), the 512-row layout policy (the
flagship's T*k = 50,432 takes the 256-row layout there too).
"""
from __future__ import annotations

import os
import typing as typ

import torch

from ..parallel import collectives as coll
from ..parallel.sharding import EXPERT_AXIS, axis_index, mesh_axis_size
from .fused_ffn import (TILE_ROWS, fused_expert_ffn, fused_expert_ffn_gather,
                        fused_expert_ffn_permuted, gather_slots_to_tokens,
                        gelu_exact, gelu_fast)


def _gather_in_kernel() -> bool:
    """``SSMV_GATHER_IN_KERNEL=1``: fold the dispatch row gather into the
    expert-FFN kernels' x loads (K9). Read at call time, as the JAX package
    reads it at trace time; off by default, as there."""
    return os.environ.get("SSMV_GATHER_IN_KERNEL", "0") == "1"


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


def compute_capacity(tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float, multiple: int = 8) -> int:
    """Static per-expert slot count: int(T*k*factor/E) + 1, at most T,
    rounded up to ``multiple`` (the JAX package's Python float arithmetic)."""
    cap = int(tokens * top_k * capacity_factor / num_experts) + 1
    cap = min(cap, tokens)  # an expert can never receive more than all tokens
    return ((cap + multiple - 1) // multiple) * multiple


def make_dispatch(expert_idx: torch.Tensor, num_experts: int, capacity: int):
    """Destinations of the (token, choice) pairs in the (E*C,) buffer.

    Priority is token order, then choice order (FastMoE's): a pair's
    position in its expert is the count of earlier pairs that chose it.
    Returns ((T, k) int64 ``dest``, E*C (the dump row) for dropped pairs;
    (T, k) bool ``keep``)."""
    T, k = expert_idx.shape
    flat = expert_idx.reshape(-1)
    pos, _ = rank_in_expert(flat, num_experts)
    keep = pos < capacity
    dest = torch.where(keep, flat * capacity + pos, num_experts * capacity)
    return dest.reshape(T, k), keep.reshape(T, k)


def dispatch_tokens(x: torch.Tensor, dest: torch.Tensor, num_experts: int,
                    capacity: int) -> torch.Tensor:
    """Scatter the tokens into the (E, C, d) buffer. Duplicate destinations
    only hit the dump row E*C, which is dropped, so which copy lands there
    does not matter."""
    T, d = x.shape
    k = dest.shape[1]
    src = x.repeat_interleave(k, dim=0) if k > 1 else x
    buf = torch.zeros((num_experts * capacity + 1, d), dtype=x.dtype,
                      device=x.device).index_copy(0, dest.reshape(-1), src)
    return buf[:-1].reshape(num_experts, capacity, d)


def combine_tokens(expert_out: torch.Tensor, dest: torch.Tensor,
                   keep: torch.Tensor, gate_weights: torch.Tensor):
    """y[t] = sum_k gate[t, k] * keep[t, k] * expert_out[dest[t, k]]."""
    E, C, d = expert_out.shape
    flat = torch.cat([expert_out.reshape(E * C, d),
                      expert_out.new_zeros((1, d))])
    gathered = flat[dest]  # (T, k, d)
    w = (gate_weights * keep.to(gate_weights.dtype)).to(gathered.dtype)
    return torch.einsum("tkd,tk->td", gathered, w)


def expert_dropout_mask(shape, drop_rate: float,
                        device: torch.device) -> torch.Tensor:
    """Expert dropout's keep mask over the hidden activations h: True with
    probability 1 - ``drop_rate``, drawn from ``device``'s default
    generator (JAX: ``jax.random.bernoulli(rng, 1 - p, h.shape)``). Every
    dropout path draws through this one function."""
    return torch.rand(shape, device=device) < 1.0 - drop_rate


def _dropout(h: torch.Tensor, keep: typ.Optional[torch.Tensor],
             drop_rate: float) -> torch.Tensor:
    """h where kept, scaled by 1 / (1 - p), 0 elsewhere (JAX
    ``jnp.where(mask, h / (1 - p), 0)``)."""
    if keep is None:
        return h
    return torch.where(keep, h / (1.0 - drop_rate),
                       torch.zeros((), dtype=h.dtype, device=h.device))


def _buffer_mask(E: int, C: int, w1, drop_rate: float, device):
    """The keep mask of an (E, C, h) buffer's hidden activations, None
    without dropout."""
    if drop_rate <= 0.0:
        return None
    return expert_dropout_mask((E, C, w1.shape[-1]), drop_rate, device)


def grouped_ffn(buf: torch.Tensor, w1, b1, w2, b2,
                keep: typ.Optional[torch.Tensor] = None,
                drop_rate: float = 0.0) -> torch.Tensor:
    """Per-expert FFN over the (E, C, d) buffer: products in f32 on
    buf-dtype operands, + b1, the exact GELU in f32, expert dropout (the
    (E, C, h) ``keep`` mask at ``drop_rate``) in f32, rounded to buf's
    dtype, then fc2 in f32 + b2 and one final rounding (the JAX einsums
    with ``preferred_element_type=f32``)."""
    dt = buf.dtype
    h = torch.einsum("ecd,edh->ech", buf.float(), w1.to(dt).float())
    h = _dropout(gelu_exact(h + b1.float()[:, None, :]), keep,
                 drop_rate).to(dt)
    y = torch.einsum("ech,ehd->ecd", h.float(), w2.to(dt).float())
    return (y + b2.float()[:, None, :]).to(dt)


def moe_forward(x, router_w, router_b, w1, b1, w2, b2, *, top_k: int = 2,
                capacity_factor: float = 2.0,
                capacity: typ.Optional[int] = None, drop_rate: float = 0.0):
    """The ``'capacity'`` mode: static per-expert buffers filled by a
    scatter, token-major drop priority, grouped GEMMs (expert dropout at
    ``drop_rate``), gather + mix. Plain PyTorch; the oracle of the fused
    capacity form. Returns (y, aux)."""
    T, d = x.shape
    E = w1.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    if capacity is None:
        capacity = compute_capacity(T, E, top_k, capacity_factor)
    dest, keep = make_dispatch(expert_idx, E, capacity)
    buf = dispatch_tokens(x, dest, E, capacity)
    out = grouped_ffn(buf, w1, b1, w2, b2,
                      _buffer_mask(E, capacity, w1, drop_rate, x.device),
                      drop_rate)
    y = combine_tokens(out, dest, keep, gate_w)
    return y.to(x.dtype), _aux(logits, expert_idx, E, keep)


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


def capacity_region_rows(capacity: int, tile: int = TILE_ROWS) -> int:
    """Rows of each expert's static region in a capacity layout:
    roundup(capacity + 1, tile); the +1 keeps the last slot always padding,
    the slot dropped pairs point at."""
    return (capacity + 1 + tile - 1) // tile * tile


def aligned_expert_layout(expert_idx: torch.Tensor, num_experts: int,
                          gate_w: torch.Tensor = None,
                          weight_dtype: torch.dtype = torch.bfloat16,
                          capacity: typ.Optional[int] = None):
    """Sort (token, choice) pairs by expert with TILE_ROWS-aligned group
    starts.

    Dropless (``capacity`` None): ``Tp = roundup(T*k, tile) + E*tile``
    rows, every expert at least one tile. With ``capacity``: each expert owns
    a static region of ``Cp = capacity_region_rows(capacity)`` rows,
    ``Tp = E*Cp``; pairs ranked at or beyond ``capacity`` (token-major, the
    scatter path's priority) are dropped and point at slot ``Tp - 1``.

    Returns:
        gather_idx: (Tp,) int64, source token of each padded slot (padding
            slots point at token 0; their outputs are never read).
        pair_slot: (T, k) int64, slot of each (token, choice) pair.
        e_of_tile: (Tp // TILE_ROWS,) int32, owning expert of each row tile.
        w_slot: (Tp,) ``weight_dtype``, the combine weight of each slot (0 at
            padding; detached, the gate's gradient comes through the
            combine's d_gate), or None when ``gate_w`` is None.
        keep: (T, k) bool, False where the pair was dropped (all True
            without a capacity).
    """
    T, k = expert_idx.shape
    TK = T * k
    E = num_experts
    tile = TILE_ROWS
    flat = expert_idx.reshape(-1)
    dev = flat.device
    rank, group_sizes = rank_in_expert(flat, E)
    if capacity is not None:
        Cp = capacity_region_rows(capacity, tile)
        Tp = E * Cp
        keep = rank < capacity
        slot = torch.where(keep, flat * Cp + rank, Tp - 1)
        # dropped pairs must not enter the slot table (slot Tp - 1 is real
        # padding): their scatters go to a dump row Tp, cut off below
        dest = torch.where(keep, slot, Tp)
        e_of_tile = torch.arange(E, dtype=torch.int32,
                                 device=dev).repeat_interleave(Cp // tile)
    else:
        Tp = (TK + tile - 1) // tile * tile + E * tile
        keep = torch.ones(TK, dtype=torch.bool, device=dev)
        # at least one tile per expert, as the JAX layout keeps for its
        # backward
        padded = torch.clamp((group_sizes + tile - 1) // tile * tile,
                             min=tile)
        starts = torch.cumsum(padded, dim=0) - padded
        slot = dest = starts[flat] + rank
        tile_starts = torch.arange(0, Tp, tile, device=dev)
        e_of_tile = torch.clamp(
            torch.searchsorted(starts, tile_starts, right=True) - 1, 0,
            E - 1).to(torch.int32)
    pairs = torch.arange(TK, device=dev)
    gather_idx = torch.zeros(Tp + 1, dtype=torch.long, device=dev)
    gather_idx.scatter_(0, dest, pairs // k)
    w_slot = None
    if gate_w is not None:
        w_slot = torch.zeros(Tp + 1, dtype=weight_dtype, device=dev)
        w_slot.scatter_(0, dest, gate_w.detach().reshape(-1).to(weight_dtype))
        w_slot = w_slot[:Tp]
    return (gather_idx[:Tp], slot.reshape(T, k), e_of_tile, w_slot,
            keep.reshape(T, k))


class _DispatchGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gather_idx, pair_slot, keep):
        ctx.save_for_backward(pair_slot, keep)
        return x.index_select(0, gather_idx)

    @staticmethod
    def backward(ctx, dxs):
        pair_slot, keep = ctx.saved_tensors
        return gather_slots_to_tokens(dxs, pair_slot, keep), None, None, None


def dispatch_gather(x: torch.Tensor, gather_idx: torch.Tensor,
                    pair_slot: torch.Tensor,
                    keep: typ.Optional[torch.Tensor] = None) -> torch.Tensor:
    """xs[s] = x[gather_idx[s]]: tokens into the padded expert layout;
    backward dx[t] = sum_k dxs[pair_slot[t, k]], the dropped pairs' (keep
    False) masked to zero."""
    return _DispatchGather.apply(x, gather_idx, pair_slot, keep)


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


def _aux(logits, expert_idx, num_experts, keep=None):
    drop = (torch.zeros((), dtype=torch.float32, device=logits.device)
            if keep is None else 1.0 - keep.float().mean())
    return {"balance_loss": load_balance_loss(logits, expert_idx, num_experts),
            "drop_fraction": drop}


def _kernel_weights(x, w1, b1, w2, b2):
    """The expert tensors as the FFN kernels take them."""
    return (w1.to(x.dtype).contiguous(), b1.float(),
            w2.to(x.dtype).contiguous(), b2.float())


def moe_forward_fused(x, router_w, router_b, w1, b1, w2, b2, *,
                      top_k: int = 2,
                      capacity_factor: typ.Optional[float] = None,
                      capacity: typ.Optional[int] = None):
    """MoE MLP over (T, d) tokens through the expert-FFN kernels. Dropless
    by default; with ``capacity_factor`` or ``capacity`` the fused form of
    the ``'capacity'`` mode (static regions, token-major drop priority, the
    same outputs as :func:`moe_forward`). Returns (y in x's dtype, aux)."""
    T = x.shape[0]
    E = w1.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    if capacity is None and capacity_factor is not None:
        capacity = compute_capacity(T, E, top_k, capacity_factor)
    gather_idx, pair_slot, e_of_tile, w_slot, keep = aligned_expert_layout(
        expert_idx, E, gate_w=gate_w, weight_dtype=x.dtype, capacity=capacity)
    if capacity is None:
        gate_eff, keep_in = gate_w, None
    else:
        gate_eff, keep_in = gate_w * keep.to(gate_w.dtype), keep
    weights = (*_kernel_weights(x, w1, b1, w2, b2), e_of_tile)
    if _gather_in_kernel():
        out = fused_expert_ffn_gather(x, gather_idx, pair_slot, keep_in,
                                      *weights)
    else:
        xs = dispatch_gather(x, gather_idx, pair_slot, keep_in)
        out = fused_expert_ffn(xs, *weights)
    y = combine_slots(out, pair_slot, gate_eff, gather_idx, w_slot)
    return y.to(x.dtype), _aux(logits, expert_idx, E, keep_in)


def _a2a_permuted() -> bool:
    """``SSMV_A2A_PERMUTED=1``: the a2a form runs the permuted-tile FFN
    (K10) over the received rows instead of relayouting them expert-major
    around K3/K4. Read at call time, as the JAX package reads it at trace
    time; off by default, as there."""
    return os.environ.get("SSMV_A2A_PERMUTED", "0") == "1"


def _expert_axis(mesh, w1):
    """(ep, this rank's expert index, the expert group, E_local, E)."""
    ep = mesh_axis_size(mesh, EXPERT_AXIS)
    return (ep, axis_index(mesh, EXPERT_AXIS), mesh.expert_group, w1.shape[0],
            w1.shape[0] * ep)


def moe_forward_fused_ep(x, router_w, router_b, w1, b1, w2, b2, *, mesh,
                         top_k: int = 2, capacity_factor: float = 2.0,
                         capacity: typ.Optional[int] = None):
    """Expert-parallel ``capacity_fused``, the psum form. ``x`` is this data
    shard's (T, d) tokens, the same on every rank of the expert group; w1,
    b1, w2, b2 this rank's E_local experts.

    Every rank of the expert group routes all T tokens and builds the whole
    capacity layout (replicated work), gathers the rows of its own static
    region (E_local regions of Cp rows), runs the expert FFN on them,
    combines its partial (T, d) output and sums it over the group. Capacity
    priority is token-major per data shard. With one data shard the output
    is the single-card :func:`moe_forward_fused`'s (the partial sums add
    exact zeros where a token's two experts live on one rank).

    Gradients: the psum's backward is the identity, and x (into the
    dispatch) and the gate weights (into the combine) sum their partial
    gradients over the group, so every rank ends with the full dx and
    router gradient. ``balance_loss`` and ``drop_fraction`` are averaged
    over the data group (JAX :702-705)."""
    ep, j, group, E_local, E = _expert_axis(mesh, w1)
    T = x.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    if capacity is None:
        capacity = compute_capacity(T, E, top_k, capacity_factor)
    gather_idx, pair_slot, _, w_slot, keep = aligned_expert_layout(
        expert_idx, E, gate_w=gate_w, weight_dtype=x.dtype, capacity=capacity)
    Cp = capacity_region_rows(capacity)
    rows = E_local * Cp
    start = j * rows
    slot_local = pair_slot - start
    valid = (slot_local >= 0) & (slot_local < rows) & keep
    # pairs of other ranks' experts (and dropped ones) -> the region's last
    # row, padding by construction (weight 0); ``valid`` zeroes their dx
    # and gate gradients
    slot_l = torch.where(valid, slot_local, rows - 1)
    g_mine = gather_idx[start:start + rows]
    xs = dispatch_gather(coll.sum_grad(x, group), g_mine, slot_l, valid)
    e_of_tile = torch.arange(E_local, dtype=torch.int32,
                             device=x.device).repeat_interleave(
                                 Cp // TILE_ROWS)
    out = fused_expert_ffn(xs, *_kernel_weights(x, w1, b1, w2, b2),
                           e_of_tile)
    gate_eff = coll.sum_grad(gate_w, group) * valid.to(gate_w.dtype)
    y_part = combine_slots(out, slot_l, gate_eff, g_mine,
                           w_slot[start:start + rows])
    y = coll.psum(y_part, group)
    aux = _aux(logits, expert_idx, E, keep)
    return y.to(x.dtype), {k: coll.mean_value(v, mesh.data_group, 1.0)
                           for k, v in aux.items()}


def moe_forward_fused_ep_a2a(x, router_w, router_b, w1, b1, w2, b2, *, mesh,
                             top_k: int = 2, capacity_factor: float = 2.0,
                             capacity: typ.Optional[int] = None):
    """Expert-parallel ``capacity_fused`` with an all-to-all row exchange
    (FastMoE's global exchange). ``x`` is this data shard's (T, d) tokens,
    the same on every rank of the expert group; w1, b1, w2, b2 this rank's
    E_local experts.

    Rank j of the expert group owns the token chunk ``x[j*Tc:(j+1)*Tc]``,
    Tc = T / ep: it routes the chunk and builds the chunk's capacity layout
    (expert-major, so each destination rank's rows are one contiguous
    block), sends each rank its experts' regions (``all_to_all``), runs the
    expert FFN on the rows from every source chunk bound for its experts,
    sends the outputs back, combines its chunk and gathers the (T, d) batch
    over the group. The received rows are source-major; the FFN's weight
    gradient sums each expert over consecutive tiles, so they are either
    relayouted expert-major around K3/K4 (the default) or visited
    expert-major in place by K10 (``SSMV_A2A_PERMUTED=1``). Capacity
    priority is per (data shard, chunk). ``balance_loss`` and
    ``drop_fraction`` are averaged over the expert group, then over the data
    group (JAX :836-841).

    Gradients: the chunk's cotangents are gathered into the full dx, and the
    router's partial gradients summed over the group; the final gather's
    backward is this rank's slice."""
    ep, j, group, E_local, E = _expert_axis(mesh, w1)
    T, d = x.shape
    if T % ep != 0:
        raise ValueError(
            f"a2a EP needs the per-data-shard token count ({T}) "
            f"divisible by the expert axis ({ep}); pad the batch or use "
            "dispatch_mode='capacity_fused' (psum form)")
    Tc = T // ep
    xc = coll.chunk_rows(x, group)
    logits = _router_logits(xc, coll.sum_grad(router_w, group),
                            coll.sum_grad(router_b, group))
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    if capacity is None:
        capacity = compute_capacity(Tc, E, top_k, capacity_factor)
    gather_idx, pair_slot, _, w_slot, keep = aligned_expert_layout(
        expert_idx, E, gate_w=gate_w, weight_dtype=x.dtype, capacity=capacity)
    Cp = capacity_region_rows(capacity)
    n_per = Cp // TILE_ROWS  # tiles per (source, expert) region
    xs = dispatch_gather(xc, gather_idx, pair_slot, keep)
    # (ep source blocks) x (E_local experts) x (Cp rows)
    xr = coll.all_to_all(xs, group)
    e_of_step = torch.arange(E_local, dtype=torch.int32,
                             device=x.device).repeat_interleave(ep * n_per)
    weights = _kernel_weights(x, w1, b1, w2, b2)
    if _a2a_permuted():
        # step (e, src, t) visits source-major tile src*E_local*n_per +
        # e*n_per + t; outputs land in their own tiles, source-major
        perm = torch.arange(ep * E_local * n_per, dtype=torch.int32,
                            device=x.device).reshape(
                                ep, E_local, n_per).transpose(0, 1).reshape(-1)
        out = fused_expert_ffn_permuted(xr, *weights, e_of_step, perm)
    else:
        xr = xr.reshape(ep, E_local, Cp, d).transpose(0, 1).reshape(-1, d)
        out = fused_expert_ffn(xr, *weights, e_of_step)
        out = out.reshape(E_local, ep, Cp, d).transpose(0, 1).reshape(-1, d)
    out_back = coll.all_to_all(out, group)
    gate_eff = gate_w * keep.to(gate_w.dtype)
    yc = combine_slots(out_back, pair_slot, gate_eff, gather_idx, w_slot)
    y = coll.all_gather_rows(yc, group)
    aux = {k: coll.mean_value(coll.mean_value(v, group, 1.0 / ep),
                              mesh.data_group, 1.0)
           for k, v in _aux(logits, expert_idx, E, keep).items()}
    return y.to(x.dtype), aux


def moe_forward_sharded(x, router_w, router_b, w1, b1, w2, b2, *, mesh,
                        top_k: int = 2, capacity_factor: float = 2.0,
                        capacity: typ.Optional[int] = None,
                        drop_rate: float = 0.0):
    """The ``'capacity'`` mode over a (data, expert) layout: the function of
    :func:`moe_forward` over the whole batch, as GSPMD computes it in the
    JAX package. ``x`` is this data shard's (T, d) tokens; w1, b1, w2, b2
    this rank's E_local experts.

    The data shards' tokens are gathered (dp > 1), every rank routes them
    and fills the replicated (E, C, d) buffer, runs its E_local experts'
    slice through :func:`grouped_ffn` and gathers the outputs over the
    expert group before the combine; each rank keeps its own rows of y.
    Capacity and drop priority are those of the whole batch. Under expert
    dropout every rank draws the whole buffer's mask (the ranks of an
    expert group share their generators' seed) and applies its experts'
    rows. Plain PyTorch, as in the JAX package, where no Pallas kernel
    runs here.

    Gradients: x into the buffer sums its partial gradients over the expert
    group; the token gather's backward sums over the data group and keeps
    this rank's rows, which with the train step's average over the data
    group gives the gradient of the mean of the shards' losses."""
    ep, j, group, E_local, E = _expert_axis(mesh, w1)
    T = x.shape[0]
    x_all = coll.gather_rows_sum_grad(x, mesh.data_group)
    logits = _router_logits(x_all, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    if capacity is None:
        capacity = compute_capacity(x_all.shape[0], E, top_k,
                                    capacity_factor)
    dest, keep = make_dispatch(expert_idx, E, capacity)
    buf = dispatch_tokens(coll.sum_grad(x_all, group), dest, E, capacity)
    mine = slice(j * E_local, (j + 1) * E_local)
    keep_h = _buffer_mask(E, capacity, w1, drop_rate, x.device)
    out = grouped_ffn(buf[mine], w1, b1, w2, b2,
                      None if keep_h is None else keep_h[mine], drop_rate)
    y = combine_tokens(coll.all_gather_rows(out, group), dest, keep, gate_w)
    i = mesh.data_index
    return (y[i * T:(i + 1) * T].to(x.dtype),
            _aux(logits, expert_idx, E, keep))


def expert_choice_capacity(tokens: int, num_experts: int,
                           capacity_factor: float) -> int:
    """Tokens each expert picks: int(T*cf/E) + 1 rounded up to 8, at most
    T (JAX ops/moe.py:876-878)."""
    cap = int(tokens * capacity_factor / num_experts) + 1
    return min((cap + 7) // 8 * 8, tokens)


def expert_choice_gate(probs: torch.Tensor, capacity: int):
    """Each expert's top-``capacity`` tokens by router probability: ((E, C)
    f32 gate weights, (E, C) int64 token ids), largest first (JAX
    ``lax.top_k(probs.T, C)``)."""
    return torch.topk(probs.t(), capacity, dim=1)


def moe_forward_expert_choice(x, router_w, router_b, w1, b1, w2, b2, *,
                              capacity_factor: float = 2.0,
                              capacity: typ.Optional[int] = None,
                              drop_rate: float = 0.0, mesh=None):
    """Expert-choice routing (Zhou et al. 2022; JAX ops/moe.py:858-899):
    the router's softmax over the experts, then each expert takes its
    top-C tokens by probability (``topk`` over probs.T), an (E, C, d)
    buffer through :func:`grouped_ffn` (expert dropout at ``drop_rate``)
    and a combine y[t] = sum_e gate[e, c] * out[e, c] over the (e, c) that
    picked t. Plain PyTorch, as the JAX package computes it outside any
    Pallas kernel. aux: ``balance_loss`` 0 (balanced by construction) and
    ``drop_fraction`` the share of tokens no expert took.

    The combine adds each token's rows in expert order from a (T, E) slot
    table (the order of the JAX scatter-add), a gather per expert instead
    of an atomic scatter, so every run and every rank rounds alike.

    Under an expert group (``mesh``; w1, b1, w2, b2 this rank's E_local
    experts) it runs as the sharded ``'capacity'`` mode does
    (:func:`moe_forward_sharded`): the data shards' tokens are gathered,
    every rank routes the whole batch and fills the whole buffer, runs its
    experts' rows (the buffer's gradient into x summed over the group),
    the outputs are gathered over the group before the combine, and each
    rank keeps its own rows of y."""
    T0, d = x.shape
    group = None if mesh is None else mesh.expert_group
    ep, j = ((1, 0) if mesh is None else
             (mesh_axis_size(mesh, EXPERT_AXIS), axis_index(mesh,
                                                           EXPERT_AXIS)))
    x_all = (x if mesh is None
             else coll.gather_rows_sum_grad(x, mesh.data_group))
    T = x_all.shape[0]
    E_local = w1.shape[0]
    E = E_local * ep
    logits = _router_logits(x_all, router_w, router_b)
    probs = torch.softmax(logits, dim=-1)
    if capacity is None:
        capacity = expert_choice_capacity(T, E, capacity_factor)
    C = capacity
    gate_w, token_idx = expert_choice_gate(probs, C)
    mine = slice(j * E_local, (j + 1) * E_local)
    xs = coll.sum_grad(x_all, group).index_select(
        0, token_idx[mine].reshape(-1)).reshape(E_local, C, d)
    keep_h = _buffer_mask(E, C, w1, drop_rate, x.device)
    out = grouped_ffn(xs, w1, b1, w2, b2,
                      None if keep_h is None else keep_h[mine], drop_rate)
    out = coll.all_gather_rows(out, group)
    flat = out.reshape(E * C, d) * gate_w.reshape(-1, 1).to(out.dtype)
    flat = torch.cat([flat, flat.new_zeros((1, d))])  # row E*C: nothing
    experts = torch.arange(E, device=x.device)
    slot = torch.full((T, E), E * C, dtype=torch.long, device=x.device)
    slot[token_idx, experts[:, None].expand(E, C)] = torch.arange(
        E * C, device=x.device).reshape(E, C)
    y = flat.index_select(0, slot[:, 0])
    for e in range(1, E):
        y = y + flat.index_select(0, slot[:, e])
    served = (slot < E * C).any(dim=1)
    aux = {"balance_loss": torch.zeros((), dtype=torch.float32,
                                       device=x.device),
           "drop_fraction": (~served).float().mean()}
    if mesh is not None:
        i = mesh.data_index
        y = y[i * T0:(i + 1) * T0]
    return y.to(x.dtype), aux


def moe_forward_gathered(x, router_w, router_b, w1, b1, w2, b2, *, mesh,
                         dispatch: typ.Callable, **kw):
    """A dropless mode (``dispatch``: :func:`moe_forward_fused`,
    :func:`moe_forward_ragged`) under an expert group, as GSPMD runs it in
    the JAX package (a Pallas call cannot be partitioned, so XLA gathers
    its inputs): w1, b1, w2 and b2, this rank's E_local experts, are
    gathered over the group, and the unchanged dropless function runs on
    every rank over this data shard's tokens, the same kernels on the same
    inputs. The gathers' backward is this rank's slice of the cotangent,
    which is the gradient because every rank of the group computes the
    same loss."""
    group = mesh.expert_group
    w = [coll.all_gather_rows(t, group) for t in (w1, b1, w2, b2)]
    return dispatch(x, router_w, router_b, *w, **kw)


def moe_forward_ragged(x, router_w, router_b, w1, b1, w2, b2, *,
                       top_k: int = 2, drop_rate: float = 0.0):
    """Plain oracle: stable sort by expert, one GEMM pair per expert group
    (products in x's dtype, as ``lax.ragged_dot`` with
    ``preferred_element_type=x.dtype``), then unsort and mix. Expert
    dropout at ``drop_rate`` masks the (T*k, h) hidden activations in
    sorted order, drawn once."""
    T, d = x.shape
    E = w1.shape[0]
    logits = _router_logits(x, router_w, router_b)
    gate_w, expert_idx = naive_topk_gate(logits, top_k)
    flat_e = expert_idx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    xs = x.index_select(0, sort_idx // top_k)
    sizes = torch.bincount(flat_e, minlength=E).tolist()
    keeps = ([None] * E if drop_rate <= 0.0 else torch.split(
        expert_dropout_mask((T * top_k, w1.shape[-1]), drop_rate, x.device),
        sizes))
    outs = []
    for e, (rows, keep) in enumerate(zip(torch.split(xs, sizes), keeps)):
        h = rows @ w1[e].to(x.dtype) + b1[e].to(x.dtype)
        g = _dropout(gelu_fast(h), keep, drop_rate)
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
