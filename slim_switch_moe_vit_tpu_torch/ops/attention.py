"""Multi-head attention over the packed qkv tensor (K5) for the H100.

Replaces the Pallas kernel ``_mha_fwd_kernel`` of
``slim_switch_moe_vit_tpu/ops/attention.py`` (:168), behind ``_mha_fwd_call``
(:279) and ``fused_mha`` (:296). The CUDA C++ kernel is
``csrc/mha_fwd.cu``; its header note says what bounds it on the card and
how its design answers that. In short: at ViT lengths the whole score
matrix of a (sample, head) pair fits in shared memory, so the kernel reads
the packed (B, N, 3C) qkv once and writes the (B, N, C) output once, with
an exact softmax and no transposes on the host.

Dispatch: a CPU tensor takes the plain version
(:func:`fused_mha_reference`); a CUDA tensor launches the kernel or raises.
Forward only: the backward kernel (K6) is not ported yet.
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import check_no_grad, check_tensor


def fused_mha_reference(qkv: torch.Tensor, num_heads: int,
                        scale: float) -> torch.Tensor:
    """Plain version: softmax(Q K^T * scale) V over packed qkv, as the JAX
    package's ``fused_mha_reference``: f32 scores and softmax, the
    probabilities cast to v's dtype for the PV product (f32 sums)."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    q, k, v = (t.reshape(B, N, num_heads, d).transpose(1, 2)
               for t in qkv.split(C, dim=-1))
    attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    attn = torch.softmax(attn, dim=-1)
    out = torch.matmul(attn.to(v.dtype).float(), v.float())
    return out.transpose(1, 2).reshape(B, N, C).to(qkv.dtype)


def fused_mha(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(Q K^T * scale) V over packed qkv.

    Args:
        qkv: (B, N, 3C), heads contiguous within each C-span
            (q = qkv[..., :C].reshape(B, N, H, d)).
    Returns:
        (B, N, C) in qkv's dtype, ready for the proj GEMM.
    """
    if not qkv.is_cuda:
        return fused_mha_reference(qkv, num_heads, scale)
    check_tensor(qkv, "qkv", (torch.bfloat16, torch.float32))
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*C) with C divisible by "
                         f"{num_heads} heads, got {tuple(qkv.shape)}")
    check_no_grad(qkv, what="fused_mha (backward: K6)")
    B, N, C3 = qkv.shape
    C = C3 // 3
    d = C // num_heads
    if d != 64:
        raise ValueError(f"fused_mha kernel takes head_dim 64, got {d}")
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load_library()
    err = lib.ssmv_mha_fwd(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, d,
                           float(scale), int(qkv.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mha")
    fused_mha.launches += 1
    return out


fused_mha.launches = 0
