"""Kernels of the serving, training and driver paths and their plain
PyTorch versions.

Each kernel wrapper counts its launches in an integer attribute,
``<wrapper>.launches``, incremented only where the kernel is launched: the
five forwards, the five backward forms their autograd Functions call, the
flash forward, the fused optimizer, and the expert FFN's gather-in-kernel
forward and backward (K9), deferred-dW backward (K8) and permuted-tile
forward and backward (K10), and the two ops no model path calls, as in
the JAX package: the proj-folded attention forward (K12) and the row
gather and scatter-add (K13).
"""
from __future__ import annotations

from . import attention, fused_adamw, fused_ffn, fused_ln, gather
from .attention import fused_mha_proj
from .gather import gather_rows, scatter_add_rows

KERNEL_WRAPPERS = (fused_ln.fused_ln, fused_ln.fused_add_ln,
                   fused_ln.fused_sum_ln, attention.fused_mha,
                   fused_ffn.fused_expert_ffn, fused_ln.fused_ln_bwd,
                   fused_ln.fused_add_ln_bwd, fused_ln.fused_sum_ln_bwd,
                   attention.fused_mha_bwd, fused_ffn.fused_expert_ffn_bwd,
                   fused_adamw.fused_adamw_ema, attention.flash_attention,
                   fused_ffn.fused_expert_ffn_gather,
                   fused_ffn.fused_expert_ffn_gather_bwd,
                   fused_ffn.fused_expert_ffn_bwd_defer,
                   fused_ffn.fused_expert_ffn_permuted,
                   fused_ffn.fused_expert_ffn_permuted_bwd,
                   attention.fused_mha_proj, gather.gather_rows,
                   gather.scatter_add_rows)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
