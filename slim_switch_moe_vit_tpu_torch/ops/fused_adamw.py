"""One-pass AdamW + EMA update over a list of parameters (K7), for the H100.

Replaces the Pallas kernels ``_kernel`` (:50) and ``_kernel_no_ema`` (:71)
of ``slim_switch_moe_vit_tpu/ops/fused_adamw.py``, reached through
``fused_adamw_ema`` (:129). The CUDA C++ kernel is ``csrc/fused_adamw.cu``
(one launch for every leaf: a table of chunks of at most :data:`CHUNK`
elements; its header says what bounds it and how the design answers that).

Math, exactly the JAX package's (optax's ``scale_by_adam`` ->
``add_decayed_weights`` -> per-group lr, :12-17):

    mu' = b1*mu + (1-b1)*g            nu' = b2*nu + (1-b2)*g^2
    u   = (mu'*bc1) / (sqrt(nu'*bc2) + eps),   bc = 1/(1-b^t)
    u  += wd * p                       (leaves whose wd flag is set)
    p'  = p - lr * u                   (lr_gate for gate leaves, else lr_base)
    ema'= d*ema + (1-d)*p'

The JAX function returns new trees; here p, mu, nu and ema are updated in
place (the JAX kernel aliases them to its outputs too). bc1 and bc2 are
computed in f32, as the JAX package computes them from its int32 count.

Dispatch: CPU tensors take the plain version
(:func:`fused_adamw_ema_reference`); CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import typing as typ

import numpy as np
import torch

from . import _build
from ._checks import check_tensor

CHUNK = 1 << 16  # elements per row of the kernel's chunk table

Tensors = typ.Sequence[torch.Tensor]


def bias_corrections(b1: float, b2: float, t: int) -> typ.Tuple[float, float]:
    """(1/(1-b1^t), 1/(1-b2^t)) in f32, as the JAX package computes them."""
    one, tf = np.float32(1.0), np.float32(t)
    return (float(one / (one - np.float32(b1) ** tf)),
            float(one / (one - np.float32(b2) ** tf)))


def fused_adamw_ema_reference(params: Tensors, grads: Tensors, mus: Tensors,
                              nus: Tensors, emas: typ.Optional[Tensors],
                              wd_flags: typ.Sequence[bool],
                              gate_flags: typ.Sequence[bool], *,
                              lr_base: float, lr_gate: float, bc1: float,
                              bc2: float, b1: float = 0.9, b2: float = 0.999,
                              eps: float = 1e-8, weight_decay: float = 0.05,
                              ema_decay: typ.Optional[float] = None) -> None:
    """Plain version, in place, leaf by leaf (``_leaf_update_ref``, :115)."""
    for i, (p, g, mu, nu) in enumerate(zip(params, grads, mus, nus,
                                           strict=True)):
        mu.copy_(b1 * mu + (1.0 - b1) * g)
        nu.copy_(b2 * nu + (1.0 - b2) * (g * g))
        u = (mu * bc1) / (torch.sqrt(nu * bc2) + eps)
        if wd_flags[i] and weight_decay:
            u = u + weight_decay * p
        p.copy_(p - (lr_gate if gate_flags[i] else lr_base) * u)
        if emas is not None:
            emas[i].copy_(ema_decay * emas[i] + (1.0 - ema_decay) * p)


def chunk_table(params: Tensors, grads: Tensors, mus: Tensors, nus: Tensors,
                emas: typ.Optional[Tensors], wd_flags: typ.Sequence[bool],
                gate_flags: typ.Sequence[bool]) -> np.ndarray:
    """The kernel's table, (chunks, 7) int64: the addresses of each chunk's
    p, g, mu, nu and ema (0 without an EMA), its length, and its flags
    (bit 0 decay, bit 1 gate lr)."""
    sizes = np.array([p.numel() for p in params], np.int64)
    per_leaf = (sizes + CHUNK - 1) // CHUNK
    leaf = np.repeat(np.arange(len(sizes)), per_leaf)
    first = np.repeat(np.cumsum(per_leaf) - per_leaf, per_leaf)
    start = (np.arange(len(leaf)) - first) * CHUNK
    table = np.empty((len(leaf), 7), np.int64)
    for col, ts in enumerate((params, grads, mus, nus)):
        table[:, col] = (np.array([t.data_ptr() for t in ts], np.int64)[leaf]
                         + start * 4)
    table[:, 4] = (0 if emas is None else
                   np.array([t.data_ptr() for t in emas], np.int64)[leaf]
                   + start * 4)
    table[:, 5] = np.minimum(CHUNK, sizes[leaf] - start)
    table[:, 6] = (np.asarray(wd_flags, np.int64)[leaf]
                   | np.asarray(gate_flags, np.int64)[leaf] << 1)
    return table


def fused_adamw_ema(params: Tensors, grads: Tensors, mus: Tensors,
                    nus: Tensors, emas: typ.Optional[Tensors],
                    wd_flags: typ.Sequence[bool],
                    gate_flags: typ.Sequence[bool], *, lr_base: float,
                    lr_gate: float, bc1: float, bc2: float, b1: float = 0.9,
                    b2: float = 0.999, eps: float = 1e-8,
                    weight_decay: float = 0.05,
                    ema_decay: typ.Optional[float] = None) -> None:
    """One AdamW (+ EMA when ``emas`` is given) step over every leaf, in
    place. Leaves are f32 and contiguous; ``grads`` match them in shape."""
    if (emas is None) != (ema_decay is None):
        raise ValueError("emas and ema_decay go together")
    kw = dict(lr_base=lr_base, lr_gate=lr_gate, bc1=bc1, bc2=bc2, b1=b1,
              b2=b2, eps=eps, weight_decay=weight_decay, ema_decay=ema_decay)
    if not params[0].is_cuda:
        return fused_adamw_ema_reference(params, grads, mus, nus, emas,
                                         wd_flags, gate_flags, **kw)
    dev = params[0].device
    groups = [(params, "p"), (grads, "g"), (mus, "mu"), (nus, "nu")]
    if emas is not None:
        groups.append((emas, "ema"))
    for group, name in groups:
        for t, p in zip(group, params, strict=True):
            check_tensor(t, name, (torch.float32,), device=dev, shape=p.shape)
    # through pinned memory, so the upload is queued behind the step's
    # backward instead of waiting for it (a pageable copy synchronises)
    table = torch.from_numpy(chunk_table(
        params, grads, mus, nus, emas, wd_flags, gate_flags)).pin_memory().to(
            dev, non_blocking=True)
    lib = _build.load_library()
    d = 0.0 if ema_decay is None else ema_decay
    err = lib.ssmv_fused_adamw(
        table.data_ptr(), table.shape[0], lr_base, lr_gate, bc1, bc2, b1, b2,
        eps, weight_decay, d, 1.0 - b1, 1.0 - b2, 1.0 - d,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_adamw_ema")
    fused_adamw_ema.launches += 1


fused_adamw_ema.launches = 0
