"""Per-expert FFN (fc1 -> GELU -> fc2) over the tile-aligned expert layout,
forward (K3) and backward (K4), their gather-in-kernel forms (K9), their
permuted-tile forms (K10) and the deferred-dW backward (K8), for the H100.

Replaces these Pallas kernels of ``slim_switch_moe_vit_tpu/ops/fused_ffn.py``:

- K3 ``_fwd_kernel`` (:166) behind ``_fwd`` (:176) and ``fused_expert_ffn``
  (:511); K4 ``_bwd_kernel`` (:261) behind ``_bwd`` (:374) and ``_ffn_bwd``
  (:834): ``csrc/expert_ffn_fwd.cu``, ``csrc/expert_ffn_bwd.cu``;
- K9 ``_fwd_gather_kernel`` (:605) and ``_bwd_gather_kernel`` (:658) behind
  ``fused_expert_ffn_gather`` (:763): the same sources, with each layout
  row's x read through ``gather_idx`` (``SSMV_GATHER_IN_KERNEL=1``);
- K8 ``_bwd_kernel_defer`` (:312) with ``_bwd_flags`` (:285), the
  ``SSMV_DEFER_DW=1`` branch of ``_ffn_bwd``: ``csrc/expert_ffn_bwd_defer.cu``;
- K10, the ``tile_perm`` branches of ``_fwd`` (:176-214) and ``_bwd``
  (:374, :408-431, :478-499) behind ``fused_expert_ffn_permuted`` (:865):
  K3's and K4's sources with grid step i on row tile ``tile_perm[i]``
  (``SSMV_A2A_PERMUTED=1`` in the a2a expert-parallel form). As in the JAX
  package, its backward never defers (``SSMV_DEFER_DW`` does not apply)
  and runs 256-row tiles.

The sources' header notes say what bounds each kernel on the card and how
its design answers that. In short: the FFN is FLOP-bound; the forward keeps
the (rows, H) hidden activation out of device memory by streaming H in
chunks (h and GELU by one warp group into a bf16 tile in shared memory,
y summed in registers by another); the backward recomputes it as GEMM
tiles that write bf16(dh) and bf16(gelu(h)) to a (Tp, H) workspace, then
takes dx and each expert's dW1/dW2 over its consecutive tiles as GEMMs
over that workspace (K4, K9, K10), or recomputes dh on chip, once for dx
and once for the dW products over each expert's rows (K8).

Layout contract (``ops/moe.py::aligned_expert_layout``): rows are sorted by
expert and every ``TILE_ROWS``-row tile belongs to one expert,
``e_of_tile[tile]``.

Shapes and types: any D up to 768 and any H, as the JAX kernel takes any D
and (its MoE layer routes an odd H to ``'ragged'``) any even H. The kernels
are compiled for D in ``KERNEL_DIMS`` (192, 384, 768) and H a multiple of
64; every entry point runs them through :func:`pad_call`, which zero-pads D
to the next instance and H to the next multiple of 64 and slices the
outputs back (exact: the pads add zeros, and GELU(0) = 0). D past 768
raises, naming the cap. Activations and expert weights in one dtype, bf16
or f32 (the biases f32). In bf16 every kernel runs on the tensor cores at
every D (``mma.sync`` with ``cp.async`` rings): K4's backward as a dh
kernel, then one GEMM launch for dx, dW and db, the dW products split over
an expert's rows by :func:`wgrad_splits` where their tiles would not fill
the card; K8 as a dgrad kernel and a dW kernel that both recompute h and
dy . W2^T on chip, with a cluster of two blocks splitting D at D = 768. In
f32, K3, K4, K9 and K10 run on the tensor cores too, in split TF32 (three
TF32 ``mma.sync`` a product on f32 operands split into hi and lo parts,
near f32 accuracy: f32 has no exact tensor-core product): the forward with
x streamed beside W1 and g kept in f32 in shared memory, the backward in
the bf16 form's three launches with f32 tiles and f32 (Tp, H) workspaces,
and K8 in its two kernels with f32 tiles (the dgrad kernel streaming x and
dy beside the weights, as the f32 forward does; the dW kernel with a
cluster of two at D = 768, as in bf16). The arithmetic is the same in
every form. Anything else raises on a CUDA tensor.

GELU and its derivative are the exact erf forms at every dtype. The JAX
package evaluates them for bf16 with odd polynomials (``gelu_fast``, within
5.7e-4 of exact; gelu' within 1.5e-3), a TPU VPU policy that is not ported.

Dispatch: a CPU tensor takes the plain versions
(:func:`fused_expert_ffn_reference`, :func:`reference_expert_ffn_bwd`,
:func:`reference_expert_ffn_bwd_defer`; K9's are these on the gathered
rows); a CUDA tensor launches the kernels or raises. The autograd Function
saves (xs, w1, b1, w2, b2, e_of_tile), as the JAX VJP does
(fused_ffn.py:829-831); the gather form saves x and the layout instead of
xs. The JAX wrapper's promotion of the backward to 512-row tiles when every
tile pair shares an expert (:540-548, :783-790) is a TPU tiling policy and
is not ported: the backward tile is always ``TILE_ROWS``, so
``SSMV_DEFER_DW=1`` always takes K8, and K9's backward never defers, as in
the JAX package.
"""
from __future__ import annotations

import math
import os
import typing as typ

import torch

from . import _build
from ._checks import check_tensor

TILE_ROWS = 256  # layout alignment: every TILE_ROWS-row tile has one expert


def gelu_exact(h: torch.Tensor) -> torch.Tensor:
    """0.5 * h * (1 + erf(h / sqrt(2))), in h's dtype."""
    return 0.5 * h * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))


def dgelu(h: torch.Tensor) -> torch.Tensor:
    """d/dh [h * Phi(h)] = Phi(h) + h * phi(h), the exact erf form."""
    cdf = 0.5 * (1.0 + torch.erf(h * (1.0 / math.sqrt(2.0))))
    return cdf + h * torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """Exact-GELU semantics at the activation's precision: evaluated in f32
    and cast back (the JAX package's bf16 polynomial is not ported)."""
    return gelu_exact(x.float()).to(x.dtype)


def fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile):
    """Plain version: a loop over row tiles, each with the expert
    ``e_of_tile[tile]``. Products in f32 on the activation-dtype operands,
    GELU in f32, g rounded to the activation dtype, one final rounding."""
    Tp, D = xs.shape
    tile = Tp // e_of_tile.shape[0]
    y = torch.empty_like(xs)
    for i, e in enumerate(e_of_tile.tolist()):
        rows = slice(i * tile, (i + 1) * tile)
        h = xs[rows].float() @ w1[e].float() + b1[e].float()
        g = gelu_exact(h).to(xs.dtype)
        out = g.float() @ w2[e].float() + b2[e].float()
        y[rows] = out.to(xs.dtype)
    return y


def _plain_bwd(xs, w1, b1, w2, e_of_tile, dy, flags):
    """The plain backwards' loop over row tiles, step by step as the JAX
    kernels (products in f32 on the activation-dtype operands, dh rounded
    to the activation dtype for the dx and dW1 products, g for the dW2
    product, db1 from the f32 dh), with the dW products taken as the
    per-tile ``flags`` of :func:`bwd_flags` direct: at a flush tile, over
    it and, with the include bit, the tile before it; initializing the
    expert's dW at its first flush."""
    Tp, D = xs.shape
    E, _, H = w1.shape
    tile = Tp // e_of_tile.shape[0]
    dt = xs.dtype
    dx = torch.empty_like(xs)
    dw1 = torch.zeros((E, D, H), dtype=torch.float32, device=xs.device)
    dw2 = torch.zeros((E, H, D), dtype=torch.float32, device=xs.device)
    db1 = torch.zeros((E, H), dtype=torch.float32, device=xs.device)
    db2 = torch.zeros((E, D), dtype=torch.float32, device=xs.device)
    stash = [None, None]  # the pair's two halves: (x, bf16 dh, bf16 g, dy)
    for i, (e, f) in enumerate(zip(e_of_tile.tolist(), flags)):
        rows = slice(i * tile, (i + 1) * tile)
        x, d = xs[rows].float(), dy[rows].to(dt).float()
        h = x @ w1[e].float() + b1[e].float()
        dh = (d @ w2[e].float().T) * dgelu(h)
        dhb = dh.to(dt).float()
        dx[rows] = (dhb @ w1[e].float().T).to(dt)
        # each column summed along a contiguous row: the same order at any
        # width, so pad_call's zero columns leave db1 and db2 bit for bit
        db1[e] += dh.T.contiguous().sum(1)
        db2[e] += d.T.contiguous().sum(1)
        include = bool(f & 2)
        stash[int(include)] = (x, dhb, gelu_exact(h).to(dt).float(), d)
        if f & 1:
            pair = stash if include else stash[:1]
            xk, dhk, gk, dk = (torch.cat(m) for m in zip(*pair))
            pw1, pw2 = xk.T @ dhk, gk.T @ dk
            if f & 4:
                dw1[e], dw2[e] = pw1, pw2
            else:
                dw1[e] += pw1
                dw2[e] += pw2
    return dx, dw1.to(w1.dtype), db1, dw2.to(w2.dtype), db2


def reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy):
    """Plain version of the backward (K4): the dW products tile by tile.
    Returns (dx, dw1, db1, dw2, db2): dx in xs's dtype, dw1/dw2 in the
    weights' dtype, the biases' f32."""
    return _plain_bwd(xs, w1, b1, w2, e_of_tile, dy,
                      [1] * e_of_tile.shape[0])


def bwd_flags(e_of_tile: torch.Tensor) -> torch.Tensor:
    """Per-tile control flags of the deferred-dW backward (K8), int32, from
    a nondecreasing ``e_of_tile`` (the JAX ``_bwd_flags``, exactly):

    - bit 0 (flush): issue the dW products at this tile (the 2nd tile of a
      pair, or the expert's last tile);
    - bit 1 (include): the previous tile, of the same expert, is the pair's
      first half: the products run over both;
    - bit 2 (first): the expert's first flush, which initializes its dW
      instead of accumulating.
    """
    e = e_of_tile.long()
    n = e.shape[0]
    idx = torch.arange(n, device=e.device)
    edge = e.new_full((1,), -1)
    prev = torch.cat([edge, e[:-1]])
    group_start = torch.cummax(torch.where(e != prev, idx, 0), dim=0).values
    pos = idx - group_start
    nxt = torch.cat([e[1:], edge])
    odd = (pos % 2) == 1
    flush = odd | (e != nxt)
    first = flush & (pos <= 1)
    return (flush.int() | (odd.int() << 1) | (first.int() << 2)).to(
        torch.int32)


def reference_expert_ffn_bwd_defer(xs, w1, b1, w2, e_of_tile, dy):
    """Plain version of K8: K4's function with the dW products taken over
    the same-expert tile pairs (K = 2 * TILE_ROWS) or single tiles that
    :func:`bwd_flags` directs. Returns (dx, dw1, db1, dw2, db2) as K4's."""
    return _plain_bwd(xs, w1, b1, w2, e_of_tile, dy,
                      bwd_flags(e_of_tile).tolist())


KERNEL_DIMS = (192, 384, 768)  # the D instances of the expert-FFN kernels
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
H_ALIGN = 64  # the kernels' hidden chunk


def kernel_dims(D: int, H: int,
                h_at_least_d: bool = False) -> typ.Tuple[int, int]:
    """(Dp, Hp): the smallest instance in ``KERNEL_DIMS`` >= D and H
    rounded up to a multiple of ``H_ALIGN`` (and to at least Dp with
    ``h_at_least_d``, as K8 needs), the shape :func:`pad_call` runs a
    kernel at. Raises for D past the widest instance."""
    if D > KERNEL_DIMS[-1]:
        raise ValueError(f"the expert-FFN kernels take D <= {KERNEL_DIMS[-1]}"
                         f", got {D}")
    Dp = next(k for k in KERNEL_DIMS if k >= D)
    Hp = -(-H // H_ALIGN) * H_ALIGN
    return Dp, max(Hp, Dp) if h_at_least_d else Hp


def _pad_to(t, shape):
    """t zero-padded at the end of each dim to ``shape`` (t itself when it
    has the shape already)."""
    if tuple(t.shape) == tuple(shape):
        return t
    pads = []
    for have, want in zip(reversed(t.shape), reversed(shape)):
        pads += [0, want - have]
    return torch.nn.functional.pad(t, pads)


def pad_call(fn, x, w1, b1, w2, b2=None, dy=None, h_at_least_d=False):
    """``fn(x, w1, b1, w2, b2, dy)`` on tensors zero-padded to
    :func:`kernel_dims` (``h_at_least_d`` passed on), its outputs sliced
    back: x's and dy's columns, W1's rows, W2's columns and b2 to Dp; W1's
    columns, b1 and W2's rows to Hp. Exact: the zero rows and columns add
    exact zeros to every sum, and GELU(0) = 0 (so do the hidden pad's h, g
    and dh). ``fn`` returns y (T, Dp), or (dx, dw1, db1, dw2, db2) of the
    padded shapes. A registered shape passes through as it is, with no
    copy."""
    if w1.dim() != 3:  # the kernel's checks raise
        return fn(x, w1, b1, w2, b2, dy)
    E, D, H = w1.shape
    Dp, Hp = kernel_dims(D, H, h_at_least_d)
    if (Dp, Hp) == (D, H):
        return fn(x, w1, b1, w2, b2, dy)
    out = fn(_pad_to(x, (x.shape[0], Dp)), _pad_to(w1, (E, Dp, Hp)),
             _pad_to(b1, (E, Hp)), _pad_to(w2, (E, Hp, Dp)),
             None if b2 is None else _pad_to(b2, (E, Dp)),
             None if dy is None else _pad_to(dy, (dy.shape[0], Dp)))
    if not isinstance(out, tuple):
        return out[:, :D].contiguous()
    dx, dw1, db1, dw2, db2 = out
    return (dx[:, :D].contiguous(), dw1[:, :D, :H].contiguous(),
            db1[:, :H].contiguous(), dw2[:, :H, :D].contiguous(),
            db2[:, :D].contiguous())


def _check_weights(Tp, D, dt, dev, w1, b1, w2, b2, e_of_tile):
    if w1.dim() != 3:
        raise ValueError(f"w1 must be (E, D, H), got {tuple(w1.shape)}")
    E, _, H = w1.shape
    if (D, H) != kernel_dims(D, H) or Tp % TILE_ROWS:
        raise ValueError(f"the expert-FFN kernels take D in {KERNEL_DIMS}, "
                         f"H a multiple of {H_ALIGN} (pad_call pads to "
                         f"them) and Tp ({Tp}) a multiple of {TILE_ROWS}; got "
                         f"D {D}, H {H}")
    check_tensor(w1, "w1", (dt,), device=dev, shape=(E, D, H))
    check_tensor(b1, "b1", (torch.float32,), device=dev, shape=(E, H))
    check_tensor(w2, "w2", (dt,), device=dev, shape=(E, H, D))
    if b2 is not None:
        check_tensor(b2, "b2", (torch.float32,), device=dev, shape=(E, D))
    check_tensor(e_of_tile, "e_of_tile", (torch.int32,), device=dev,
                 shape=(Tp // TILE_ROWS,))
    return H, E


def _check_ffn(xs, w1, b1, w2, b2, e_of_tile):
    check_tensor(xs, "xs", KERNEL_DTYPES)
    if xs.dim() != 2:
        raise ValueError(f"xs must be (Tp, D), got {tuple(xs.shape)}")
    Tp, D = xs.shape
    return (Tp, D, *_check_weights(Tp, D, xs.dtype, xs.device, w1, b1, w2,
                                   b2, e_of_tile))


def _check_gather(x, gather_idx, w1, b1, w2, b2, e_of_tile):
    check_tensor(x, "x", KERNEL_DTYPES)
    if x.dim() != 2 or gather_idx.dim() != 1:
        raise ValueError(f"x must be (T, D) and gather_idx (Tp,), got "
                         f"{tuple(x.shape)} and {tuple(gather_idx.shape)}")
    Tp, D = gather_idx.shape[0], x.shape[1]
    check_tensor(gather_idx, "gather_idx", (torch.int64,), device=x.device)
    return (Tp, D, *_check_weights(Tp, D, x.dtype, x.device, w1, b1, w2, b2,
                                   e_of_tile))


def _bwd_outputs(Tp, D, H, E, like, w1, w2):
    """(dx, dw1, db1, dw2, db2), uninitialized, for a backward kernel."""
    dev = like.device
    return (torch.empty((Tp, D), dtype=like.dtype, device=dev),
            torch.empty_like(w1),
            torch.empty((E, H), dtype=torch.float32, device=dev),
            torch.empty_like(w2),
            torch.empty((E, D), dtype=torch.float32, device=dev))


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _is_bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


# the card's SMs: the backward splits its dW products over the rows where
# their tiles would fill fewer than two waves of them
_SMS = 132
# the dW tiles of the backward kernels, (D rows, H columns): bf16 on
# mma.sync m16n8k16, f32 in split TF32 (half the H columns: f32 doubles a
# slice's bytes)
DW_TILE = {torch.bfloat16: (128, 256), torch.float32: (128, 128)}
DH_ROWS = 128  # the dh kernels' row block: one db1 partial row each


def wgrad_splits(Tp: int, D: int, H: int, E: int, dtype) -> int:
    """How many row splits the backward kernels take for their dW products:
    enough for two waves of the dtype's ``DW_TILE`` dW tiles (one block an
    SM), at most 8, and no more than the layout's 256-row tiles per
    expert."""
    td, th = DW_TILE[dtype]
    tiles = 2 * E * math.ceil(D / td) * math.ceil(H / th)
    return max(1, min(8, math.ceil(2 * _SMS / tiles), Tp // TILE_ROWS // E))


def workspace_shapes(Tp: int, D: int, H: int, E: int, dtype) -> dict:
    """The backward kernels' workspace: ``dh`` and ``g`` (Tp, H) in the
    activation dtype; ``db1`` the dh partials, one f32 row per
    ``DH_ROWS`` rows; ``dw`` the dW products' f32 partials (splits, 2, E,
    D * H) where :func:`wgrad_splits` splits them, else None."""
    splits = wgrad_splits(Tp, D, H, E, dtype)
    return {"dh": (Tp, H), "g": (Tp, H), "db1": (Tp // DH_ROWS, H),
            "dw": (splits, 2, E, D * H) if splits > 1 else None}


def _workspace(Tp, D, H, E, like):
    """(ws_dh, ws_g, ws_db1, ws_dw, splits) of :func:`workspace_shapes`."""
    shapes = workspace_shapes(Tp, D, H, E, like.dtype)
    dev = like.device
    ws_dw = (None if shapes["dw"] is None else
             torch.empty(shapes["dw"], dtype=torch.float32, device=dev))
    return (torch.empty(shapes["dh"], dtype=like.dtype, device=dev),
            torch.empty(shapes["g"], dtype=like.dtype, device=dev),
            torch.empty(shapes["db1"], dtype=torch.float32, device=dev),
            ws_dw, 1 if ws_dw is None else shapes["dw"][0])


def _ptr(t):
    return None if t is None else t.data_ptr()


def fused_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy):
    """(dx, dw1, db1, dw2, db2) of :func:`fused_expert_ffn` (K4) for the
    cotangent dy (zero at padding slots, as the combine backward gives)."""
    if not xs.is_cuda:
        return reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy)
    return pad_call(lambda xs, w1, b1, w2, _, dy: _bwd_launch(
        xs, w1, b1, w2, e_of_tile, dy), xs, w1, b1, w2, dy=dy)


def _bwd_launch(xs, w1, b1, w2, e_of_tile, dy):
    Tp, D, H, E = _check_ffn(xs, w1, b1, w2, None, e_of_tile)
    check_tensor(dy, "dy", (xs.dtype,), device=xs.device, shape=(Tp, D))
    out = _bwd_outputs(Tp, D, H, E, xs, w1, w2)
    ws_dh, ws_g, ws_db1, ws_dw, splits = _workspace(Tp, D, H, E, xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_bwd(
        xs.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), e_of_tile.data_ptr(), *(t.data_ptr() for t in out),
        ws_dh.data_ptr(), ws_g.data_ptr(), ws_db1.data_ptr(), _ptr(ws_dw),
        splits, Tp, D, H, E, TILE_ROWS, _is_bf16(xs), _stream())
    _build.check(err, "fused_expert_ffn_bwd")
    fused_expert_ffn_bwd.launches += 1
    return out


def fused_expert_ffn_bwd_defer(xs, w1, b1, w2, e_of_tile, dy):
    """K8: K4's function (:func:`fused_expert_ffn_bwd`) with no (Tp, H)
    workspace: h and dy . W2^T are recomputed on chip for dx and again for
    the dW products (over same-expert tile pairs, as :func:`bwd_flags`
    directs, in the plain version, which alone reads the flags; the
    kernels take all of the expert's rows in row order, the same sums). It
    allocates nothing but its outputs. The kernel needs H >= D, so H is
    zero-padded to at least the padded D (D = 256, H = 300 runs at 384 x
    384)."""
    if not xs.is_cuda:
        return reference_expert_ffn_bwd_defer(xs, w1, b1, w2, e_of_tile, dy)
    return pad_call(lambda xs, w1, b1, w2, _, dy: _bwd_defer_launch(
        xs, w1, b1, w2, e_of_tile, dy), xs, w1, b1, w2, dy=dy,
        h_at_least_d=True)


def _bwd_defer_launch(xs, w1, b1, w2, e_of_tile, dy):
    Tp, D, H, E = _check_ffn(xs, w1, b1, w2, None, e_of_tile)
    check_tensor(dy, "dy", (xs.dtype,), device=xs.device, shape=(Tp, D))
    if H < D:
        raise ValueError(f"the deferred-dW kernel needs H ({H}) >= D ({D})")
    out = _bwd_outputs(Tp, D, H, E, xs, w1, w2)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_bwd_defer(
        xs.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), e_of_tile.data_ptr(), *(t.data_ptr() for t in out),
        Tp, D, H, E, TILE_ROWS, _is_bf16(xs), _stream())
    _build.check(err, "fused_expert_ffn_bwd_defer")
    fused_expert_ffn_bwd_defer.launches += 1
    return out


def fused_expert_ffn_gather_bwd(x, gather_idx, w1, b1, w2, e_of_tile, dy):
    """K9's backward: (dx in slot space (Tp, D), dw1, db1, dw2, db2) of
    :func:`fused_expert_ffn_gather`, x re-read by index: K4's function on
    the rows x[gather_idx]."""
    if not x.is_cuda:
        return reference_expert_ffn_bwd(x.index_select(0, gather_idx), w1, b1,
                                        w2, e_of_tile, dy)
    return pad_call(lambda x, w1, b1, w2, _, dy: _gather_bwd_launch(
        x, gather_idx, w1, b1, w2, e_of_tile, dy), x, w1, b1, w2, dy=dy)


def _gather_bwd_launch(x, gather_idx, w1, b1, w2, e_of_tile, dy):
    Tp, D, H, E = _check_gather(x, gather_idx, w1, b1, w2, None, e_of_tile)
    check_tensor(dy, "dy", (x.dtype,), device=x.device, shape=(Tp, D))
    out = _bwd_outputs(Tp, D, H, E, x, w1, w2)
    ws_dh, ws_g, ws_db1, ws_dw, splits = _workspace(Tp, D, H, E, x)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_bwd_gather(
        x.data_ptr(), gather_idx.data_ptr(), dy.data_ptr(), w1.data_ptr(),
        b1.data_ptr(), w2.data_ptr(), e_of_tile.data_ptr(),
        *(t.data_ptr() for t in out), ws_dh.data_ptr(), ws_g.data_ptr(),
        ws_db1.data_ptr(), _ptr(ws_dw), splits, Tp, D, H, E, TILE_ROWS,
        _is_bf16(x), _stream())
    _build.check(err, "fused_expert_ffn_gather_bwd")
    fused_expert_ffn_gather_bwd.launches += 1
    return out


def permuted_rows(tile_perm: torch.Tensor) -> torch.Tensor:
    """(n_tiles * TILE_ROWS,) int64: the rows of xs in the order the grid
    steps visit them, tile ``tile_perm[i]`` at step i."""
    rows = torch.arange(TILE_ROWS, device=tile_perm.device)
    return (tile_perm.long()[:, None] * TILE_ROWS + rows).reshape(-1)


def reference_expert_ffn_permuted(xs, w1, b1, w2, b2, e_of_step, tile_perm):
    """Plain version of K10's forward: the permuted tiles gathered into step
    order, :func:`fused_expert_ffn_reference`, and the results written back
    to their own tiles."""
    rows = permuted_rows(tile_perm)
    y = torch.empty_like(xs)
    y[rows] = fused_expert_ffn_reference(xs.index_select(0, rows), w1, b1, w2,
                                         b2, e_of_step)
    return y


def reference_expert_ffn_bwd_permuted(xs, w1, b1, w2, e_of_step, tile_perm,
                                      dy):
    """Plain version of K10's backward: :func:`reference_expert_ffn_bwd` on
    the permuted tiles in step order, dx written back in xs's row order."""
    rows = permuted_rows(tile_perm)
    dxp, *grads = reference_expert_ffn_bwd(
        xs.index_select(0, rows), w1, b1, w2, e_of_step,
        dy.index_select(0, rows))
    dx = torch.empty_like(xs)
    dx[rows] = dxp
    return (dx, *grads)


def _check_perm(Tp, dev, tile_perm):
    check_tensor(tile_perm, "tile_perm", (torch.int32,), device=dev,
                 shape=(Tp // TILE_ROWS,))


def fused_expert_ffn_permuted_bwd(xs, w1, b1, w2, e_of_step, tile_perm, dy):
    """K10's backward: (dx in xs's row order, dw1, db1, dw2, db2) of
    :func:`fused_expert_ffn_permuted`; each expert's dW sums over its
    (consecutive) steps."""
    if not xs.is_cuda:
        return reference_expert_ffn_bwd_permuted(xs, w1, b1, w2, e_of_step,
                                                 tile_perm, dy)
    return pad_call(lambda xs, w1, b1, w2, _, dy: _perm_bwd_launch(
        xs, w1, b1, w2, e_of_step, tile_perm, dy), xs, w1, b1, w2, dy=dy)


def _perm_bwd_launch(xs, w1, b1, w2, e_of_step, tile_perm, dy):
    Tp, D, H, E = _check_ffn(xs, w1, b1, w2, None, e_of_step)
    _check_perm(Tp, xs.device, tile_perm)
    check_tensor(dy, "dy", (xs.dtype,), device=xs.device, shape=(Tp, D))
    out = _bwd_outputs(Tp, D, H, E, xs, w1, w2)
    ws_dh, ws_g, ws_db1, ws_dw, splits = _workspace(Tp, D, H, E, xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_bwd_perm(
        xs.data_ptr(), dy.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), e_of_step.data_ptr(), tile_perm.data_ptr(),
        *(t.data_ptr() for t in out), ws_dh.data_ptr(), ws_g.data_ptr(),
        ws_db1.data_ptr(), _ptr(ws_dw), splits, Tp, D, H, E, TILE_ROWS,
        _is_bf16(xs), _stream())
    _build.check(err, "fused_expert_ffn_permuted_bwd")
    fused_expert_ffn_permuted_bwd.launches += 1
    return out


def _defer_dw() -> bool:
    """``SSMV_DEFER_DW=1``: the fused FFN's backward launches K8 instead of
    K4. Read when the backward runs; off by default, as in the JAX
    package."""
    return os.environ.get("SSMV_DEFER_DW", "0") == "1"


def _ffn_forward(xs, w1, b1, w2, b2, e_of_tile):
    if not xs.is_cuda:
        return fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile)
    return pad_call(lambda xs, w1, b1, w2, b2, _: _fwd_launch(
        xs, w1, b1, w2, b2, e_of_tile), xs, w1, b1, w2, b2)


def _fwd_launch(xs, w1, b1, w2, b2, e_of_tile):
    Tp, D, H, _ = _check_ffn(xs, w1, b1, w2, b2, e_of_tile)
    y = torch.empty_like(xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_fwd(
        xs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), e_of_tile.data_ptr(), y.data_ptr(), Tp, D, H,
        TILE_ROWS, _is_bf16(xs), _stream())
    _build.check(err, "fused_expert_ffn")
    fused_expert_ffn.launches += 1
    return y


def _ffn_gather_forward(x, gather_idx, w1, b1, w2, b2, e_of_tile):
    if not x.is_cuda:
        return fused_expert_ffn_reference(x.index_select(0, gather_idx), w1,
                                          b1, w2, b2, e_of_tile)
    return pad_call(lambda x, w1, b1, w2, b2, _: _gather_fwd_launch(
        x, gather_idx, w1, b1, w2, b2, e_of_tile), x, w1, b1, w2, b2)


def _gather_fwd_launch(x, gather_idx, w1, b1, w2, b2, e_of_tile):
    Tp, D, H, _ = _check_gather(x, gather_idx, w1, b1, w2, b2, e_of_tile)
    y = torch.empty((Tp, D), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_fwd_gather(
        x.data_ptr(), gather_idx.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), e_of_tile.data_ptr(), y.data_ptr(), Tp,
        D, H, TILE_ROWS, _is_bf16(x), _stream())
    _build.check(err, "fused_expert_ffn_gather")
    fused_expert_ffn_gather.launches += 1
    return y


def _ffn_perm_forward(xs, w1, b1, w2, b2, e_of_step, tile_perm):
    if not xs.is_cuda:
        return reference_expert_ffn_permuted(xs, w1, b1, w2, b2, e_of_step,
                                             tile_perm)
    return pad_call(lambda xs, w1, b1, w2, b2, _: _perm_fwd_launch(
        xs, w1, b1, w2, b2, e_of_step, tile_perm), xs, w1, b1, w2, b2)


def _perm_fwd_launch(xs, w1, b1, w2, b2, e_of_step, tile_perm):
    Tp, D, H, _ = _check_ffn(xs, w1, b1, w2, b2, e_of_step)
    _check_perm(Tp, xs.device, tile_perm)
    y = torch.empty_like(xs)
    lib = _build.load_library()
    err = lib.ssmv_expert_ffn_fwd_perm(
        xs.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), e_of_step.data_ptr(), tile_perm.data_ptr(),
        y.data_ptr(), Tp, D, H, TILE_ROWS, _is_bf16(xs), _stream())
    _build.check(err, "fused_expert_ffn_permuted")
    fused_expert_ffn_permuted.launches += 1
    return y


class _FusedExpertFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w1, b1, w2, b2, e_of_tile):
        ctx.save_for_backward(xs, w1, b1, w2, b2, e_of_tile)
        return _ffn_forward(xs, w1, b1, w2, b2, e_of_tile)

    @staticmethod
    def backward(ctx, dy):
        xs, w1, b1, w2, _, e_of_tile = ctx.saved_tensors
        bwd = (fused_expert_ffn_bwd_defer if _defer_dw()
               else fused_expert_ffn_bwd)
        grads = bwd(xs, w1, b1, w2, e_of_tile, dy.to(xs.dtype).contiguous())
        return (*grads, None)


def fused_expert_ffn(xs: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                     w2: torch.Tensor, b2: torch.Tensor,
                     e_of_tile: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(xs))) with per-tile expert weights.

    Args:
        xs: (Tp, D) tokens sorted by expert, groups TILE_ROWS-aligned.
        w1/b1/w2/b2: (E, D, H) / (E, H) / (E, H, D) / (E, D); w1 and w2 in
            xs's dtype, the biases f32.
        e_of_tile: (Tp // TILE_ROWS,) int32, owning expert of each row tile.
    Returns:
        (Tp, D) in xs's dtype.
    """
    return _FusedExpertFFN.apply(xs, w1, b1, w2, b2, e_of_tile)


class _FusedExpertFFNPermuted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w1, b1, w2, b2, e_of_step, tile_perm):
        ctx.save_for_backward(xs, w1, b1, w2, e_of_step, tile_perm)
        return _ffn_perm_forward(xs, w1, b1, w2, b2, e_of_step, tile_perm)

    @staticmethod
    def backward(ctx, dy):
        xs, w1, b1, w2, e_of_step, tile_perm = ctx.saved_tensors
        grads = fused_expert_ffn_permuted_bwd(
            xs, w1, b1, w2, e_of_step, tile_perm, dy.to(xs.dtype).contiguous())
        return (*grads, None, None)


def fused_expert_ffn_permuted(xs: torch.Tensor, w1: torch.Tensor,
                              b1: torch.Tensor, w2: torch.Tensor,
                              b2: torch.Tensor, e_of_step: torch.Tensor,
                              tile_perm: torch.Tensor) -> torch.Tensor:
    """:func:`fused_expert_ffn` whose grid visits the row tiles in a
    caller's order (K10): step i reads row tile ``tile_perm[i]`` of xs and
    writes the same tile of y, so y keeps xs's row order.

    Args:
        xs: (Tp, D) rows in any tile-interleaved order, each TILE_ROWS tile
            of one expert.
        w1/b1/w2/b2: as :func:`fused_expert_ffn`.
        e_of_step: (Tp // TILE_ROWS,) int32, the expert of the tile visited
            at step i; nondecreasing (each expert's steps consecutive).
        tile_perm: (Tp // TILE_ROWS,) int32, a permutation of the tiles.
    Returns:
        (Tp, D) in xs's dtype and row order.
    """
    return _FusedExpertFFNPermuted.apply(xs, w1, b1, w2, b2, e_of_step,
                                         tile_perm)


def gather_slots_to_tokens(dxs: torch.Tensor, pair_slot: torch.Tensor,
                           keep: typ.Optional[torch.Tensor] = None):
    """dx[t] = sum_k dxs[pair_slot[t, k]] (* keep[t, k]): each token owns
    exactly its k slots and padding slots carry zero cotangents, so k row
    gathers replace a scatter-add; a dropped pair points at a padding slot
    whose cotangent is arbitrary, so it is masked to zero."""
    dx = None
    for kk in range(pair_slot.shape[1]):
        g = dxs.index_select(0, pair_slot[:, kk])
        if keep is not None:
            g = g * keep[:, kk:kk + 1].to(g.dtype)
        dx = g if dx is None else dx + g
    return dx


class _FusedExpertFFNGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gather_idx, pair_slot, keep, w1, b1, w2, b2,
                e_of_tile):
        ctx.save_for_backward(x, gather_idx, pair_slot, keep, w1, b1, w2,
                              e_of_tile)
        return _ffn_gather_forward(x, gather_idx, w1, b1, w2, b2, e_of_tile)

    @staticmethod
    def backward(ctx, dy):
        x, gather_idx, pair_slot, keep, w1, b1, w2, e_of_tile = \
            ctx.saved_tensors
        dx_slots, *grads = fused_expert_ffn_gather_bwd(
            x, gather_idx, w1, b1, w2, e_of_tile,
            dy.to(x.dtype).contiguous())
        # token-space dx: k row gathers, glue outside the kernel as in JAX
        dx = gather_slots_to_tokens(dx_slots, pair_slot, keep)
        return (dx, None, None, None, *grads, None)


def fused_expert_ffn_gather(x: torch.Tensor, gather_idx: torch.Tensor,
                            pair_slot: torch.Tensor,
                            keep: typ.Optional[torch.Tensor],
                            w1: torch.Tensor, b1: torch.Tensor,
                            w2: torch.Tensor, b2: torch.Tensor,
                            e_of_tile: torch.Tensor) -> torch.Tensor:
    """fc2(GELU(fc1(x[gather_idx]))) with per-tile expert weights (K9): the
    dispatch gather folded into the kernels' x loads, so the expanded xs is
    never written. Replaces ``dispatch_gather`` + :func:`fused_expert_ffn`.

    Args:
        x: (T, D) tokens (not expanded).
        gather_idx: (Tp,) int64 source token of each layout slot.
        pair_slot: (T, k) slot of each (token, choice) pair, for the
            backward's token-space dx (k row gathers).
        keep: (T, k) bool capacity mask of those gathers, or None.
        w1/b1/w2/b2/e_of_tile: as :func:`fused_expert_ffn`.
    Returns:
        (Tp, D) in x's dtype, as ``fused_expert_ffn(x[gather_idx], ...)``.
    """
    return _FusedExpertFFNGather.apply(x, gather_idx, pair_slot, keep, w1, b1,
                                       w2, b2, e_of_tile)


fused_expert_ffn.launches = 0
fused_expert_ffn_bwd.launches = 0
fused_expert_ffn_gather.launches = 0
fused_expert_ffn_gather_bwd.launches = 0
fused_expert_ffn_bwd_defer.launches = 0
fused_expert_ffn_permuted.launches = 0
fused_expert_ffn_permuted_bwd.launches = 0
