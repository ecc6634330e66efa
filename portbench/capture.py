"""The program's routing, recorded outside the measured window.

Top-k routing is discontinuous: where a token's k-th and (k+1)-th router
logits nearly tie, bf16 rounding picks one expert and f32 the other, and
the token's path then differs in every later block. So the reference
follows the program's routing (which experts each token took), and the
routing is checked by itself: the share of the program's (token, expert)
pairs that are not among the reference's own f32 top-k (``route_flip``).

:func:`routes` taps the program's top-k gate (``ops.moe.naive_topk_gate``,
which every MoE dispatch of the program calls): inside the ``with``, each
call's expert ids are copied to the host in call order, and the gate's
outputs are returned unchanged. The tap is off during the window.
"""
from __future__ import annotations

import contextlib
import typing as typ

import torch


@contextlib.contextmanager
def routes() -> typ.Iterator[typ.List[torch.Tensor]]:
    from slim_switch_moe_vit_tpu_torch.ops import moe

    gate = moe.naive_topk_gate
    record: typ.List[torch.Tensor] = []

    def tapped(logits, top_k):
        weights, idx = gate(logits, top_k)
        record.append(idx.detach().to("cpu", copy=True))
        return weights, idx

    moe.naive_topk_gate = tapped
    try:
        yield record
    finally:
        moe.naive_topk_gate = gate
