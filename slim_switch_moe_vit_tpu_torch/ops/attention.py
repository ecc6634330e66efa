"""Multi-head attention over the packed qkv tensor, forward (K5) and
backward (K6), the online-softmax forward (K11) and the forward with the
output projection folded in (K12), for the H100.

Replaces four Pallas kernels of ``slim_switch_moe_vit_tpu/ops/attention.py``:
``_mha_fwd_kernel`` (:168) behind ``_mha_fwd_call`` (:279) and ``fused_mha``
(:296), ``_mha_bwd_kernel`` (:203) behind ``_fused_mha_bwd`` (:312),
``_flash_kernel`` (:35) behind ``flash_attention`` (:120), and
``_mha_fwd_proj_kernel`` (:335) behind ``fused_mha_proj`` (:393). The CUDA
C++ kernels are ``csrc/mha_fwd.cu``, ``csrc/mha_bwd.cu``,
``csrc/flash_fwd.cu`` and ``csrc/mha_proj_fwd.cu``; their
header notes say what bounds them on the card and how their designs answer
that. In short: the forward reads the packed (B, N, 3C) qkv once and
writes the (B, N, C) output once, and the backward recomputes the softmax
and writes d(qkv) in the packed layout, the probabilities never in device
memory. All four take their products on the tensor cores (``mma.sync``,
``csrc/attn_mma.cuh``) with the scores in registers, and stream K and V
through ``cp.async`` rings. In bf16, K5, K6 and K12 take the exact row
maximum first, from a pass that computes only row maxima (K12 runs K5's
head body for each head, then its projection as one tile GEMM on the
tensor cores, the attention output never in device memory); K11 takes
one pass with the JAX kernel's online softmax. In f32 every form runs in
split TF32 (``csrc/mma_tf32.cuh``: each f32 operand split into two TF32
parts, three ``mma.sync.m16n8k8`` products a k-step, mean error from the
function in f64 5-10x the plain f32 version's; e, ds and P stay f32):
K6 in K6's structure, and K5, K11 and K12 on one f32 head body with the
online softmax (``head_fwd_f32``; K5's and K11's f32 forms are one kernel,
the same function up to the order of the softmax, and K12 feeds the body's
output to its projection in split TF32).

Dispatch: a CPU tensor takes the plain versions
(:func:`fused_mha_reference`, :func:`reference_mha_bwd`,
:func:`flash_attention_reference`); a CUDA tensor launches the kernels or
raises. The autograd Functions save qkv, as the JAX VJPs do
(attention.py:308-310, :125-127). The flash forward's backward recomputes
through the plain version with ``torch.matmul``, as the JAX package's
``_fa_bwd`` differentiates its XLA oracle outside any kernel
("correctness-first", :129-133); so does K12's, as the JAX VJP
(:421-428) differentiates its unfused reference.

Shapes: every kernel takes bf16 and f32 and any head_dim d up to
``MAX_HEAD_DIM`` = 128 (the widest head of either package's zoo is 80),
each on the smallest compiled width of 32, 64, 96 and 128 that holds d,
the extra columns zero on chip. K5, K6 and K12 take N <= ``MAX_N`` = 1024,
the lengths the JAX package runs its kernels at (``Attention._fused_ok``);
K11 takes any N; K12 takes C <= ``K12_MAX_C`` = 1280 (``vit_huge``'s
width). Outside these a CUDA tensor raises, naming the cap;
``models/vit.py::attention_route`` chooses a path before any launch.
"""
from __future__ import annotations

import torch

from . import _build
from ._checks import check_tensor

MAX_HEAD_DIM = 128  # the widest head the attention kernels take
MAX_N = 1024        # K5, K6 and K12 take N up to the JAX package's kernel rule
K12_MAX_C = 1280    # K12 takes C up to vit_huge's, the widest of either zoo


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
    if d > MAX_HEAD_DIM:
        raise ValueError(f"the attention kernels take head_dim <= "
                         f"{MAX_HEAD_DIM}, got {d}")
    return B, N, C3 // 3, d


def _check_n(N, cap, what):
    if N > cap:
        raise ValueError(f"{what}: the kernel takes N <= {cap}, got {N}")


def fused_mha_bwd(qkv: torch.Tensor, do: torch.Tensor, num_heads: int,
                  scale: float) -> torch.Tensor:
    """d(qkv) of softmax(Q K^T * scale) V (K6), in the packed layout."""
    if not qkv.is_cuda:
        return reference_mha_bwd(qkv, do, num_heads, scale)
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16, torch.float32))
    _check_n(N, MAX_N, "fused_mha_bwd")
    check_tensor(do, "do", (qkv.dtype,), device=qkv.device, shape=(B, N, C))
    dqkv = torch.empty_like(qkv)
    # the rows kernel's per-row statistics (m, linv, linv * delta), read
    # by the cols kernel
    stats = torch.empty(B * num_heads * N * 3, dtype=torch.float32,
                        device=qkv.device)
    lib = _build.load_library()
    err = lib.ssmv_mha_bwd(qkv.data_ptr(), do.data_ptr(), dqkv.data_ptr(),
                           stats.data_ptr(), B, N, num_heads, d, float(scale),
                           int(qkv.dtype == torch.bfloat16),
                           torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mha_bwd")
    fused_mha_bwd.launches += 1
    return dqkv


def _mha_forward(qkv, num_heads, scale):
    if not qkv.is_cuda:
        return fused_mha_reference(qkv, num_heads, scale)
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16, torch.float32))
    _check_n(N, MAX_N, "fused_mha")
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


def flash_attention_reference(qkv: torch.Tensor, num_heads: int,
                              scale: float) -> torch.Tensor:
    """Plain version of the flash forward: the same function as
    :func:`fused_mha_reference` (f32 scores and softmax, the probabilities
    cast to v's dtype for the PV product), which is the JAX package's
    ``_xla_attention`` oracle over the packed layout."""
    return fused_mha_reference(qkv, num_heads, scale)


def _flash_forward(qkv, num_heads, scale):
    if not qkv.is_cuda:
        return flash_attention_reference(qkv, num_heads, scale)
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16, torch.float32))
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load_library()
    err = lib.ssmv_flash_fwd(qkv.data_ptr(), out.data_ptr(), B, N, num_heads,
                             d, float(scale), int(qkv.dtype == torch.bfloat16),
                             torch.cuda.current_stream().cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv)
        return _flash_forward(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        with torch.enable_grad():
            leaf = qkv.detach().requires_grad_()
            out = flash_attention_reference(leaf, ctx.num_heads, ctx.scale)
            (dqkv,) = torch.autograd.grad(out, leaf, do)
        return dqkv, None, None


def flash_attention(qkv: torch.Tensor, num_heads: int,
                    scale: float) -> torch.Tensor:
    """Online-softmax attention (K11) over packed qkv: the same function as
    :func:`fused_mha`, for any N (K5 takes N <= 1024), bf16 or f32."""
    return _FlashAttention.apply(qkv, num_heads, scale)


def fused_mha_proj_reference(qkv: torch.Tensor, wp: torch.Tensor,
                             bp: torch.Tensor, num_heads: int,
                             scale: float) -> torch.Tensor:
    """Plain version of K12, as the JAX package's ``_mha_proj_ref``:
    :func:`fused_mha_reference`, its output times Wp (cast to qkv's dtype)
    with f32 sums, rounded to qkv's dtype, plus bp rounded to qkv's
    dtype."""
    dt = qkv.dtype
    o = fused_mha_reference(qkv, num_heads, scale)
    y = torch.matmul(o.float(), wp.to(dt).float()).to(dt)
    return y + bp.to(dt)


def _check_proj(qkv, wp, bp, num_heads):
    B, N, C, d = _check_qkv(qkv, num_heads, (torch.bfloat16, torch.float32))
    _check_n(N, MAX_N, "fused_mha_proj")
    if C > K12_MAX_C:
        raise ValueError(f"fused_mha_proj: the kernel takes C <= {K12_MAX_C}, "
                         f"got {C}")
    check_tensor(wp, "wp", (qkv.dtype,), device=qkv.device, shape=(C, C))
    check_tensor(bp, "bp", (torch.float32,), device=qkv.device, shape=(C,))
    return B, N, C, d


def _mha_proj_forward(qkv, wp, bp, num_heads, scale):
    if not qkv.is_cuda:
        return fused_mha_proj_reference(qkv, wp, bp, num_heads, scale)
    wp, bp = wp.to(qkv.dtype), bp.float()  # the JAX wrapper's casts (:391)
    B, N, C, d = _check_proj(qkv, wp, bp, num_heads)
    y = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    lib = _build.load_library()
    # where the batch is too small to fill the card, or (in f32) the o tile
    # of every head does not fit in shared memory, the kernel splits the
    # heads over blocks and sums their f32 partials here
    groups = lib.ssmv_mha_proj_groups(B, N, num_heads, d, is_bf16)
    if groups < 0:
        raise RuntimeError("fused_mha_proj: cannot read the CUDA device")
    part = (torch.empty(groups * B * N * C, dtype=torch.float32,
                        device=qkv.device) if groups else None)
    err = lib.ssmv_mha_proj_fwd(qkv.data_ptr(), wp.data_ptr(), bp.data_ptr(),
                                y.data_ptr(),
                                None if part is None else part.data_ptr(),
                                B, N, num_heads, d, float(scale), is_bf16,
                                torch.cuda.current_stream().cuda_stream)
    _build.check(err, "fused_mha_proj")
    fused_mha_proj.launches += 1
    return y


class _FusedMHAProj(torch.autograd.Function):
    @staticmethod
    def forward(ctx, qkv, wp, bp, num_heads, scale):
        ctx.num_heads, ctx.scale = num_heads, scale
        ctx.save_for_backward(qkv, wp, bp)
        return _mha_proj_forward(qkv, wp, bp, num_heads, scale)

    @staticmethod
    def backward(ctx, dy):
        qkv, wp, bp = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (qkv, wp, bp)]
            y = fused_mha_proj_reference(*leaves, ctx.num_heads, ctx.scale)
            grads = torch.autograd.grad(y, leaves, dy.to(qkv.dtype))
        return (*grads, None, None)


def fused_mha_proj(qkv: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                   num_heads: int, scale: float) -> torch.Tensor:
    """softmax(Q K^T * scale) V @ Wp + bp over packed qkv in one kernel
    (K12): y = sum over heads of o_h Wp[h*d:(h+1)*d] + bp, each o_h rounded
    to qkv's dtype, f32 sums. An op, as in the JAX package: no model path
    calls it (the JAX ``Attention`` keeps the unfused proj, measured faster
    on the TPU). Its backward differentiates :func:`fused_mha_proj_reference`.

    Args:
        qkv: (B, N, 3C), as :func:`fused_mha`.
        wp: (C, C), y = o @ wp; cast to qkv's dtype.
        bp: (C,); cast to f32.
    Returns:
        (B, N, C) in qkv's dtype.
    """
    return _FusedMHAProj.apply(qkv, wp, bp, num_heads, scale)


fused_mha.launches = 0
fused_mha_bwd.launches = 0
flash_attention.launches = 0
fused_mha_proj.launches = 0
