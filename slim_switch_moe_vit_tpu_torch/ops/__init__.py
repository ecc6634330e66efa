"""Kernels of the serving, training and driver paths and their plain
PyTorch versions.

Each kernel wrapper counts its launches in an integer attribute,
``<wrapper>.launches``, incremented only where the kernel is launched: the
five forwards, the five backward forms their autograd Functions call, the
flash forward and the fused optimizer.
"""
from __future__ import annotations

from . import attention, fused_adamw, fused_ffn, fused_ln

KERNEL_WRAPPERS = (fused_ln.fused_ln, fused_ln.fused_add_ln,
                   fused_ln.fused_sum_ln, attention.fused_mha,
                   fused_ffn.fused_expert_ffn, fused_ln.fused_ln_bwd,
                   fused_ln.fused_add_ln_bwd, fused_ln.fused_sum_ln_bwd,
                   attention.fused_mha_bwd, fused_ffn.fused_expert_ffn_bwd,
                   fused_adamw.fused_adamw_ema, attention.flash_attention)


def launch_counts() -> dict:
    """{wrapper name: launches so far}."""
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0
