"""The Triton LayerNorm forward kernel behind ``ops/fused_ln.py`` (K1a,
K1b, K2a). The backward (K1c, K2b) is CUDA C++, ``csrc/ln_bwd.cu``.

Imported only from inside the forward's launcher in ``fused_ln``, on the
first launch on a CUDA tensor: importing this module needs Triton, which a
CPU-only install does not have.
"""
import triton
import triton.language as tl


# One program per row of D: u = x (+ r), y = LN(u) * w + b.
@triton.jit
def ln_fwd_kernel(x_ptr, r_ptr, u_ptr, y_ptr, w_ptr, b_ptr, D, eps,
                  HAS_RESIDUAL: tl.constexpr, WRITE_SUM: tl.constexpr,
                  BLOCK_D: tl.constexpr):
    row = tl.program_id(0).to(tl.int64)
    cols = tl.arange(0, BLOCK_D)
    mask = cols < D
    offs = row * D + cols
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    if HAS_RESIDUAL:
        r = tl.load(r_ptr + offs, mask=mask, other=0.0)
        # the sum is rounded to the activation dtype BEFORE the statistics,
        # exactly as the JAX kernels form x + r in the input dtype
        u = (x.to(tl.float32) + r.to(tl.float32)).to(x_ptr.dtype.element_ty)
        if WRITE_SUM:
            tl.store(u_ptr + offs, u, mask=mask)
    else:
        u = x
    u32 = u.to(tl.float32)
    mean = tl.sum(u32, axis=0) / D
    d = tl.where(mask, u32 - mean, 0.0)
    var = tl.sum(d * d, axis=0) / D
    rstd = tl.rsqrt(var + eps)
    w = tl.load(w_ptr + cols, mask=mask, other=0.0)
    b = tl.load(b_ptr + cols, mask=mask, other=0.0)
    y = d * rstd * w + b
    tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)
