"""Multi-head attention over the packed qkv tensor, forward (K5) and
backward (K6), for the H100.

Replaces two Pallas kernels of ``slim_switch_moe_vit_tpu/ops/attention.py``:
``_mha_fwd_kernel`` (:168) behind ``_mha_fwd_call`` (:279) and ``fused_mha``
(:296), and ``_mha_bwd_kernel`` (:203) behind ``_fused_mha_bwd`` (:312). The
CUDA C++ kernels are ``csrc/mha_fwd.cu`` and ``csrc/mha_bwd.cu``; their
header notes say what bounds them on the card and how their designs answer
that. In short: at ViT lengths the whole score matrix of a (sample, head)
pair fits on chip, so the forward reads the packed (B, N, 3C) qkv once and
writes the (B, N, C) output once, and the backward recomputes the softmax
and writes d(qkv) in the packed layout, the normalized probabilities never
in device memory.

Dispatch: a CPU tensor takes the plain versions
(:func:`fused_mha_reference`, :func:`reference_mha_bwd`); a CUDA tensor
launches the kernels or raises. The autograd Function saves qkv, as the JAX
VJP does (attention.py:308-310).
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import check_tensor


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


def _split_heads(qkv, num_heads):
    B, N, C3 = qkv.shape
    C = C3 // 3
    return [t.reshape(B, N, num_heads, C // num_heads).transpose(1, 2).float()
            for t in qkv.split(C, dim=-1)]


def reference_mha_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                      scale: float) -> torch.Tensor:
    """Plain version of the backward, step by step as the JAX kernel: the
    softmax recomputed in f32, e and do*linv rounded to qkv's dtype for the
    dv product, dp_s an f32 product, ds rounded to qkv's dtype for the dq
    and dk products. Returns d(qkv) in the packed layout."""
    B, N, C3 = qkv.shape
    dt = qkv.dtype
    q, k, v = _split_heads(qkv, num_heads)
    do = do.to(dt).reshape(B, N, num_heads, -1).transpose(1, 2).float()
    s = (q * scale) @ k.transpose(-1, -2)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    linv = 1.0 / e.sum(-1, keepdim=True)
    dv = e.to(dt).float().transpose(-1, -2) @ (do * linv).to(dt).float()
    dp_s = (do * (linv * scale)) @ v.transpose(-1, -2)
    edp = e * dp_s
    ds = (edp - e * (linv * edp.sum(-1, keepdim=True))).to(dt).float()
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    return torch.cat([t.transpose(1, 2).reshape(B, N, C3 // 3)
                      for t in (dq, dk, dv)], dim=-1).to(dt)


def _check_qkv(qkv, num_heads, dtypes):
    check_tensor(qkv, "qkv", dtypes)
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv must be (B, N, 3*C) with C divisible by "
                         f"{num_heads} heads, got {tuple(qkv.shape)}")
    B, N, C3 = qkv.shape
    d = C3 // 3 // num_heads
    if d != 64:
        raise ValueError(f"the MHA kernels take head_dim 64, got {d}")
    return B, N, C3 // 3, d


def fused_mha_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                  scale: float) -> torch.Tensor:
    """d(qkv) of softmax(Q K^T * scale) V (K6), in the packed layout."""
    if not qkv.is_cuda:
        return reference_mha_bwd(qkv, do, num_heads, scale)
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16,))
    if N > 208:
        raise ValueError(f"the MHA backward kernel takes N <= 208, got {N}")
    check_tensor(do, "do", (torch.bfloat16,), device=qkv.device,
                 shape=(B, N, C))
    dqkv = torch.empty_like(qkv)
    lib = _build.load_library()
    err = lib.ssmv_mha_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(), B,
                           N, num_heads, d, float(scale),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mha_bwd")
    fused_mha_bwd.launches += 1
    return dqkv


def _mha_forward(qkv, num_heads, scale):
    if not qkv.is_cuda:
        return fused_mha_reference(qkv, num_heads, scale)
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16, torch.float32))
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load_library()
    err = lib.ssmv_mha_fwd(qkv.data_ptr(), out.data_ptr(), B, N, num_heads, d,
                           float(scale), int(qkv.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mha")
    fused_mha.launches += 1
    return out


class _FusedMHA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv)
        return _mha_forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        do = do.to(qkv.dtype).contiguous()
        return fused_mha_bwd(qkv, do, ctx.num_heads, ctx.scale), None, None


def fused_mha(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    """softmax(Q K^T * scale) V over packed qkv.

    Args:
        qkv: (B, N, 3C), heads contiguous within each C-span
            (q = qkv[..., :C].reshape(B, N, H, d)).
    Returns:
        (B, N, C) in qkv's dtype, ready for the proj GEMM.
    """
    return _FusedMHA.apply(qkv, num_heads, scale)


fused_mha.launches = 0
fused_mha_bwd.launches = 0
