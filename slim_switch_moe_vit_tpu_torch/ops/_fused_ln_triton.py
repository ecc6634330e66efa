"""The Triton LayerNorm kernels behind ``ops/fused_ln.py``.

Imported only from inside the launchers of ``fused_ln``, on the first
launch on a CUDA tensor: importing this module needs Triton, which a
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


# One program per run of ``rows_per_prog`` rows, BLOCK_R rows at a time:
# du = (dy*w - mean(dy*w) - xhat * mean(dy*w*xhat)) * rstd (+ du_out), with
# u = a (+ b) and its statistics recomputed in f32; the program's column
# sums of dy*xhat and dy go to row ``pid`` of the (programs, 2*D) f32
# partials ([dgamma | dbeta]), which ``col_sum_kernel`` reduces.
@triton.jit
def ln_bwd_kernel(a_ptr, b_ptr, dy_ptr, duo_ptr, du_ptr, w_ptr, part_ptr,
                  n_rows, D, rows_per_prog, eps,
                  HAS_B: tl.constexpr, HAS_DU_OUT: tl.constexpr,
                  BLOCK_R: tl.constexpr, BLOCK_D: tl.constexpr):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < D
    w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
    dw_acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    db_acc = tl.zeros([BLOCK_D], dtype=tl.float32)
    row0 = pid * rows_per_prog
    row_end = tl.minimum(row0 + rows_per_prog, n_rows)
    for r0 in range(row0, row_end, BLOCK_R):
        rows = r0 + tl.arange(0, BLOCK_R)
        mask = (rows < row_end)[:, None] & cmask[None, :]
        offs = rows.to(tl.int64)[:, None] * D + cols[None, :]
        u = tl.load(a_ptr + offs, mask=mask, other=0.0)
        if HAS_B:
            bb = tl.load(b_ptr + offs, mask=mask, other=0.0)
            # the forward's sum, rounded to the activation dtype first
            u = (u.to(tl.float32) + bb.to(tl.float32)).to(
                a_ptr.dtype.element_ty)
        u32 = u.to(tl.float32)
        mean = tl.sum(u32, axis=1) / D
        d = tl.where(mask, u32 - mean[:, None], 0.0)
        var = tl.sum(d * d, axis=1) / D
        rstd = tl.rsqrt(var + eps)
        xhat = d * rstd[:, None]
        dy = tl.load(dy_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        dyg = dy * w[None, :]
        m1 = tl.sum(dyg, axis=1) / D
        m2 = tl.sum(dyg * xhat, axis=1) / D
        du = (dyg - m1[:, None] - xhat * m2[:, None]) * rstd[:, None]
        if HAS_DU_OUT:
            du += tl.load(duo_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        tl.store(du_ptr + offs, du.to(du_ptr.dtype.element_ty), mask=mask)
        dw_acc += tl.sum(dy * xhat, axis=0)
        db_acc += tl.sum(dy, axis=0)
    base = part_ptr + pid.to(tl.int64) * (2 * D)
    tl.store(base + cols, dw_acc, mask=cmask)
    tl.store(base + D + cols, db_acc, mask=cmask)


# out[c] = sum over rows p of part[p, c], in a fixed order (deterministic).
@triton.jit
def col_sum_kernel(part_ptr, out_ptr, n_parts, width,
                   BLOCK_P: tl.constexpr, BLOCK_C: tl.constexpr):
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cmask = cols < width
    acc = tl.zeros([BLOCK_C], dtype=tl.float32)
    for p0 in range(0, n_parts, BLOCK_P):
        parts = p0 + tl.arange(0, BLOCK_P)
        mask = (parts < n_parts)[:, None] & cmask[None, :]
        acc += tl.sum(tl.load(part_ptr + parts[:, None] * width + cols[None, :],
                              mask=mask, other=0.0), axis=0)
    tl.store(out_ptr + cols, acc, mask=cmask)
