"""Kernel wrappers of the PyTorch port: dispatch, argument checks, counters.

Imports torch and the port only (no JAX), so the ``cuda``-marked tests also
run on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On a CPU-only host those skip, and the CPU tests check that a CPU tensor
takes the plain version and counts no launch.
"""
import contextlib

import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu_torch import ops
from slim_switch_moe_vit_tpu_torch.ops import _build
from slim_switch_moe_vit_tpu_torch.ops import attention as attn_ops
from slim_switch_moe_vit_tpu_torch.ops import fused_adamw as adamw_ops
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as ffn_ops
from slim_switch_moe_vit_tpu_torch.ops import fused_ln as ln_ops
from slim_switch_moe_vit_tpu_torch.ops import moe as moe_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(rs, *shape, scale=1.0, dtype=torch.float32, device="cpu"):
    return torch.from_numpy(rs.randn(*shape).astype(np.float32) * scale).to(
        device, dtype)


def _ffn_case(rs, T, D, H, E, dtype, device):
    x = _rand(rs, T, D, dtype=dtype, device=device)
    logits = _rand(rs, T, E, device=device)
    _, eidx = moe_ops.naive_topk_gate(logits, 2)
    gather_idx, pair_slot, e_of_tile, _, _ = moe_ops.aligned_expert_layout(
        eidx, E)
    xs = moe_ops.dispatch_gather(x, gather_idx, pair_slot)
    w1 = _rand(rs, E, D, H, scale=D ** -0.5, dtype=dtype, device=device)
    b1 = _rand(rs, E, H, scale=0.1, device=device)
    w2 = _rand(rs, E, H, D, scale=H ** -0.5, dtype=dtype, device=device)
    b2 = _rand(rs, E, D, scale=0.1, device=device)
    return xs, w1, b1, w2, b2, e_of_tile


def _adamw_case(rs, shapes, device):
    """(params, grads, mus, nus, emas) lists of f32 leaves."""
    def leaf(shape, scale):
        return _rand(rs, *shape, scale=scale, device=device)
    params = [leaf(s, 0.1) for s in shapes]
    return (params, [leaf(s, 1e-2) for s in shapes],
            [leaf(s, 1e-3) for s in shapes],
            [leaf(s, 1e-3).abs() * 1e-3 for s in shapes],
            [p + leaf(p.shape, 1e-3) for p in params])


def test_cpu_tensors_take_the_plain_versions():
    """No launch is counted when the tensors lie on the CPU, and the result
    is the plain version's."""
    rs = np.random.RandomState(0)
    ops.reset_launch_counts()
    x, r = _rand(rs, 2, 5, 64), _rand(rs, 2, 5, 64)
    g, b = _rand(rs, 64), _rand(rs, 64)
    u, y = ln_ops.fused_add_ln(x, r, g, b)
    u0, y0 = ln_ops.reference_add_ln(x, r, g, b)
    assert torch.equal(u, u0) and torch.equal(y, y0)
    assert torch.equal(ln_ops.fused_ln(x, g, b),
                       ln_ops.reference_add_ln(x, None, g, b)[1])
    assert torch.equal(ln_ops.fused_sum_ln(x, r, g, b), y0)
    qkv = _rand(rs, 2, 9, 3 * 64)
    assert torch.equal(attn_ops.fused_mha(qkv, 2, 0.125),
                       attn_ops.fused_mha_reference(qkv, 2, 0.125))
    case = _ffn_case(rs, 20, 32, 64, 4, torch.float32, "cpu")
    assert torch.equal(ffn_ops.fused_expert_ffn(*case),
                       ffn_ops.fused_expert_ffn_reference(*case))
    ident = torch.arange(case[0].shape[0])
    assert torch.equal(
        ffn_ops.fused_expert_ffn_gather(case[0], ident, ident[:, None], None,
                                        *case[1:]),
        ffn_ops.fused_expert_ffn_reference(*case))
    dy = torch.ones_like(case[0])
    bwd_case = (*case[:4], case[5], dy)
    for a, b in zip(ffn_ops.fused_expert_ffn_bwd_defer(*bwd_case),
                    ffn_ops.reference_expert_ffn_bwd_defer(*bwd_case)):
        assert torch.equal(a, b)
    perm = torch.arange(case[5].shape[0], dtype=torch.int32).flip(0)
    assert torch.equal(
        ffn_ops.fused_expert_ffn_permuted(*case, perm),
        ffn_ops.reference_expert_ffn_permuted(*case, perm))
    perm_case = (*case[:4], case[5], perm, dy)
    for a, b in zip(ffn_ops.fused_expert_ffn_permuted_bwd(*perm_case),
                    ffn_ops.reference_expert_ffn_bwd_permuted(*perm_case)):
        assert torch.equal(a, b)
    assert torch.equal(attn_ops.flash_attention(qkv, 2, 0.125),
                       attn_ops.flash_attention_reference(qkv, 2, 0.125))
    leaves = _adamw_case(rs, [(7, 3), (64,)], "cpu")
    copies = [[t.clone() for t in group] for group in leaves]
    kw = dict(lr_base=1e-3, lr_gate=2e-3, bc1=10.0, bc2=1000.0,
              ema_decay=0.9)
    adamw_ops.fused_adamw_ema(*leaves, [True, False], [False, True], **kw)
    adamw_ops.fused_adamw_ema_reference(*copies, [True, False],
                                        [False, True], **kw)
    for got, want in zip(leaves, copies):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert ops.launch_counts() == {
        "fused_ln": 0, "fused_add_ln": 0, "fused_sum_ln": 0, "fused_mha": 0,
        "fused_expert_ffn": 0, "fused_ln_bwd": 0, "fused_add_ln_bwd": 0,
        "fused_sum_ln_bwd": 0, "fused_mha_bwd": 0, "fused_expert_ffn_bwd": 0,
        "fused_adamw_ema": 0, "flash_attention": 0,
        "fused_expert_ffn_gather": 0, "fused_expert_ffn_gather_bwd": 0,
        "fused_expert_ffn_bwd_defer": 0, "fused_expert_ffn_permuted": 0,
        "fused_expert_ffn_permuted_bwd": 0, "fused_mha_proj": 0,
        "gather_rows": 0, "scatter_add_rows": 0}


def test_reference_add_ln_rounds_the_sum_first():
    """bf16: the residual sum is rounded to bf16 before the statistics."""
    rs = np.random.RandomState(1)
    x = _rand(rs, 3, 128, dtype=torch.bfloat16)
    r = _rand(rs, 3, 128, scale=1e-3, dtype=torch.bfloat16)
    g, b = torch.ones(128), torch.zeros(128)
    u, y = ln_ops.reference_add_ln(x, r, g, b)
    assert u.dtype == torch.bfloat16 and torch.equal(u, x + r)
    assert torch.equal(y, ln_ops.reference_add_ln(u, None, g, b)[1])


def test_build_key_tracks_sources_and_flags():
    key = _build.build_key()
    assert len(key) == 16 and key == _build.build_key()
    srcs = [p.rsplit("/", 1)[-1] for p in _build._sources()]
    assert {"mha_fwd.cu", "mha_bwd.cu", "expert_ffn_fwd.cu",
            "expert_ffn_bwd.cu", "expert_ffn_bwd_defer.cu",
            "expert_ffn_dgrad.cuh", "flash_fwd.cu", "fused_adamw.cu",
            "common.cuh", "mma_sync.cuh"} <= set(srcs)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_check_raises_on_cuda_error():
    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "kernel")


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
def test_ln_kernels_match_plain(cuda, dtype, tol):
    rs = np.random.RandomState(2)
    x = _rand(rs, 4, 197, 384, dtype=dtype, device=cuda)
    r = _rand(rs, 4, 197, 384, dtype=dtype, device=cuda)
    g = _rand(rs, 384, scale=0.1, device=cuda) + 1.0
    b = _rand(rs, 384, scale=0.1, device=cuda)
    ops.reset_launch_counts()
    u, y = ln_ops.fused_add_ln(x, r, g, b)
    u0, y0 = ln_ops.reference_add_ln(x, r, g, b)
    assert torch.equal(u, u0)
    torch.testing.assert_close(y.float(), y0.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(ln_ops.fused_sum_ln(x, r, g, b).float(),
                               y0.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(
        ln_ops.fused_ln(x, g, b).float(),
        ln_ops.reference_add_ln(x, None, g, b)[1].float(), atol=tol, rtol=tol)
    counts = ops.launch_counts()
    assert (counts["fused_ln"], counts["fused_add_ln"],
            counts["fused_sum_ln"]) == (1, 1, 1)


# the attention kernels' head widths and lengths on the card: each compiled
# width (32, 64, 128), a width between two (80, vit_huge's), one that is not
# a multiple of 8 (20: scalar loads and stores), and N at 1, a ragged tile,
# ViT-S/16 at 224 px (197), either side of a 16-row step (208, 209), 384 px
# (577) and the JAX kernel rule's cap (1024)
HEAD_DIMS = [32, 64, 80, 128, 20]
LENGTHS = [1, 17, 197, 208, 209, 577, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("N", LENGTHS)
def test_mha_kernel_matches_plain(cuda, dtype, tol, N, d):
    """K5 against its plain version: bf16 on the tensor cores (e rounds
    to bf16 before e.V, the plain version rounds the normalized
    probabilities), f32 on the CUDA cores; one launch."""
    H = 3
    rs = np.random.RandomState(3)
    qkv = _rand(rs, 2, N, 3 * H * d, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.fused_mha(qkv, H, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mha"] == 1
    want = attn_ops.fused_mha_reference(qkv, H, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# (T, D, H, E, skew) of the forward kernels: each width's tiling (D = 192,
# 384, 768); skew None routes at random, "edges" gives the last expert no
# token (one all-padding tile) and the one before it a single tile
FWD_CASES = [(300, 384, 1536, 8, None), (40, 192, 768, 4, None),
             (300, 768, 3072, 4, None), (600, 192, 768, 4, "edges"),
             (600, 384, 1536, 4, "edges"), (300, 768, 3072, 4, "edges")]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E,skew", FWD_CASES,
                         ids=["-".join(map(str, c[:4])) + ("-edges" if c[4]
                                                           else "")
                              for c in FWD_CASES])
def test_expert_ffn_kernel_matches_plain(cuda, T, D, H, E, skew):
    """K3 on a routed layout, and K9's and K10's forward forms on the same
    rows (x read by index; the row tiles visited in reverse), against the
    plain version: y finite and elementwise within 1.6e-2; one launch
    each."""
    rs = np.random.RandomState(4)
    _, w1, b1, w2, b2, _ = _ffn_case(rs, T, D, H, E, torch.bfloat16, cuda)
    x = _rand(rs, T, D, dtype=torch.bfloat16, device=cuda)
    logits = _rand(rs, T, E, device=cuda)
    if skew:
        logits[:, E - 1] = -1e9
        logits[:, E - 2] -= 2.5
    _, eidx = moe_ops.naive_topk_gate(logits, 2)
    gather_idx, pair_slot, e_of_tile, _, _ = moe_ops.aligned_expert_layout(
        eidx, E)
    xs = moe_ops.dispatch_gather(x, gather_idx, pair_slot)
    if skew:
        tiles = torch.bincount(e_of_tile.long(), minlength=E).tolist()
        assert (eidx == E - 1).sum().item() == 0 and tiles[E - 2] == 1, tiles
        assert (eidx == E - 2).sum().item() > 0
    perm = torch.arange(xs.shape[0] // ffn_ops.TILE_ROWS, dtype=torch.int32,
                        device=cuda).flip(0)
    rows = ffn_ops.permuted_rows(perm)
    xp = torch.empty_like(xs)
    xp[rows] = xs  # step i's rows in tile perm[i]
    ops.reset_launch_counts()
    got = {"k3": ffn_ops.fused_expert_ffn(xs, w1, b1, w2, b2, e_of_tile),
           "k9": ffn_ops.fused_expert_ffn_gather(x, gather_idx, pair_slot,
                                                 None, w1, b1, w2, b2,
                                                 e_of_tile),
           "k10": ffn_ops.fused_expert_ffn_permuted(xp, w1, b1, w2, b2,
                                                    e_of_tile, perm)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_expert_ffn"], counts["fused_expert_ffn_gather"],
            counts["fused_expert_ffn_permuted"]) == (1, 1, 1)
    want = ffn_ops.fused_expert_ffn_reference(xs, w1, b1, w2, b2, e_of_tile)
    got["k10"] = got["k10"][rows]
    for form, y in got.items():
        assert torch.isfinite(y.float()).all(), form
        torch.testing.assert_close(y.float(), want.float(), atol=1.6e-2,
                                   rtol=1.6e-2, msg=form)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rs = np.random.RandomState(5)
    for dtype in (torch.bfloat16, torch.float32):  # head_dim <= 128
        qkv = _rand(rs, 2, 10, 3 * 2 * 144, dtype=dtype, device=cuda)
        do = _rand(rs, 2, 10, 2 * 144, dtype=dtype, device=cuda)
        for call in (lambda: attn_ops.fused_mha(qkv, 2, 0.1),
                     lambda: attn_ops.fused_mha_bwd(qkv, do, 2, 0.1),
                     lambda: attn_ops.flash_attention(qkv, 2, 0.1),
                     lambda: attn_ops.fused_mha_proj(
                         qkv, _rand(rs, 288, 288, dtype=dtype, device=cuda),
                         torch.zeros(288, device=cuda), 2, 0.1)):
            with pytest.raises(ValueError, match="head_dim <= 128"):
                call()
    case = list(_ffn_case(rs, 20, 192, 128, 2, torch.bfloat16, cuda))
    case[0] = case[0].half()
    with pytest.raises(TypeError):  # bf16 and f32 only
        ffn_ops.fused_expert_ffn(*case)
    case = _ffn_case(rs, 20, 256, 128, 2, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="D in"):  # D in (192, 384, 768)
        ffn_ops.fused_expert_ffn(*case)
    case = list(_ffn_case(rs, 20, 192, 128, 2, torch.float32, cuda))
    case[1] = case[1].bfloat16()
    with pytest.raises(TypeError):  # weights in the activation dtype
        ffn_ops.fused_expert_ffn(*case)
    with pytest.raises(TypeError):  # the MHA backward kernel: bf16 and f32
        attn_ops.fused_mha_bwd(_rand(rs, 2, 10, 3 * 128, device=cuda).half(),
                               _rand(rs, 2, 10, 128, device=cuda).half(), 2,
                               0.125)
    for dtype in (torch.bfloat16, torch.float32):  # N <= 1024, as JAX's rule
        with pytest.raises(ValueError, match="N <= 1024"):
            attn_ops.fused_mha_bwd(
                _rand(rs, 1, 1025, 3 * 64, dtype=dtype, device=cuda),
                _rand(rs, 1, 1025, 64, dtype=dtype, device=cuda), 1, 0.125)
        with pytest.raises(ValueError, match="N <= 1024"):
            attn_ops.fused_mha(_rand(rs, 1, 1025, 3 * 64, dtype=dtype,
                                     device=cuda), 1, 0.125)
    # a CPU tensor that requires grad goes through the plain backward
    ops.reset_launch_counts()
    x = _rand(rs, 4, 64).requires_grad_()
    g, b = torch.ones(64), torch.zeros(64)
    dy = _rand(rs, 4, 64)
    ln_ops.fused_ln(x, g, b).backward(dy)
    torch.testing.assert_close(x.grad,
                               ln_ops.reference_ln_bwd(x.detach(), dy, None, g)[0])
    assert sum(ops.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# on the card: each backward kernel against its plain version
# ---------------------------------------------------------------------------

def _rel_close(got, want, rel, what):
    """|got - want| <= rel * max |want| (f32 reductions over many rows)."""
    d = (got.float() - want.float()).abs().max().item()
    assert d <= rel * want.float().abs().max().item(), f"{what}: max |d| {d}"


def _ln_bwd_cases(a, b, dy, du, g):
    """{wrapper name: (kernel call, plain call)} of K1c's two forms and
    K2b."""
    return {
        "fused_ln_bwd": (lambda: ln_ops.fused_ln_bwd(a, dy, g),
                         lambda: ln_ops.reference_ln_bwd(a, dy, None, g)),
        "fused_add_ln_bwd": (lambda: ln_ops.fused_add_ln_bwd(a, dy, du, g),
                             lambda: ln_ops.reference_ln_bwd(a, dy, du, g)),
        "fused_sum_ln_bwd": (lambda: ln_ops.fused_sum_ln_bwd(a, b, dy, g),
                             lambda: ln_ops.reference_ln_bwd(a + b, dy, None,
                                                             g)),
    }


def _ln_bwd_inputs(rs, shape, dtype, device):
    a, b, dy, du = (_rand(rs, *shape, dtype=dtype, device=device)
                    for _ in range(4))
    g = _rand(rs, shape[-1], scale=0.1, device=device) + 1.0
    return a, b, dy, du, g


# 2,531 rows: no ring stage of 8, 16 or 32 rows divides them; D = 100 takes
# the kernel's scalar form (its bf16 rows are not a multiple of 16 bytes),
# 1,280 is vit_huge's width
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(4, 197, 384), (37, 192), (2531, 100),
                                   (2531, 192), (2531, 384), (2531, 768),
                                   (2531, 1280)])
def test_ln_bwd_kernels_match_plain(cuda, dtype, tol, shape):
    """K1c in both forms and K2b: du elementwise within tol; dgamma/dbeta
    (f32 sums over the rows, in other orders) within 1e-4 of max |ref|."""
    rs = np.random.RandomState(6)
    cases = _ln_bwd_cases(*_ln_bwd_inputs(rs, shape, dtype, cuda))
    ops.reset_launch_counts()
    for name, (kernel, plain) in cases.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        assert got[0].dtype == dtype
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                                   rtol=tol, msg=name)
        for gt, w in zip(got[1:], want[1:]):
            _rel_close(gt, w, 1e-4, name)
        assert ops.launch_counts()[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [100, 384])
def test_ln_bwd_kernels_deterministic(cuda, dtype, D):
    """dgamma and dbeta are summed in a fixed order (lane, warp, block,
    group): two calls on the same inputs give bit-identical du, dgamma and
    dbeta."""
    rs = np.random.RandomState(7)
    for name, (kernel, _) in _ln_bwd_cases(
            *_ln_bwd_inputs(rs, (2531, D), dtype, cuda)).items():
        first, second = kernel(), kernel()
        for x, y in zip(first, second):
            assert torch.equal(x, y), name


@pytest.mark.cuda
def test_ln_bwd_kernel_refuses_wide_rows(cuda):
    """A row wider than MAX_BWD_DIM raises on a CUDA tensor, naming the
    cap; the widest row it takes runs."""
    rs = np.random.RandomState(8)
    for D in (ln_ops.MAX_BWD_DIM + 1, ln_ops.MAX_BWD_DIM + 128):
        a, b, dy, du, g = _ln_bwd_inputs(rs, (4, D), torch.bfloat16, cuda)
        for name, (kernel, _) in _ln_bwd_cases(a, b, dy, du, g).items():
            with pytest.raises(ValueError, match=str(ln_ops.MAX_BWD_DIM)):
                kernel()
    a, b, dy, du, g = _ln_bwd_inputs(rs, (33, ln_ops.MAX_BWD_DIM),
                                     torch.float32, cuda)
    for name, (kernel, plain) in _ln_bwd_cases(a, b, dy, du, g).items():
        got, want = kernel(), plain()
        torch.testing.assert_close(got[0], want[0], atol=1e-5, rtol=1e-5,
                                   msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("N", LENGTHS + [50])
def test_mha_bwd_kernel_matches_plain(cuda, N, d):
    """K6, bf16 (the rows and cols kernels on the tensor cores): e, ds and
    do*linv round to bf16 on both sides in other summation orders, so a
    flipped rounding moves a term by one ulp. The outputs are ~0.07 an
    element, so elementwise within one bf16 ulp at 0.5-1 (4e-3) + 1.6e-2
    |ref|, the smoke's limit for K6."""
    H = 3
    rs = np.random.RandomState(7)
    qkv = _rand(rs, 2, N, 3 * H * d, dtype=torch.bfloat16, device=cuda)
    do = _rand(rs, 2, N, H * d, dtype=torch.bfloat16, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.fused_mha_bwd(qkv, do, H, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mha_bwd"] == 1
    want = attn_ops.reference_mha_bwd(qkv, do, H, d ** -0.5)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=1.6e-2, msg="dqkv")


# (T, D, H, E, skew): skew None routes at random; "edges" starves the last
# expert (no token: one all-padding tile) and gives the one before it a
# single tile. (1200, 192, 768, 4) splits the dW products over the rows
# (too few 128 x 128 dW tiles to fill the card).
BWD_CASES = [(300, 384, 1536, 8, None), (40, 192, 768, 4, None),
             (300, 768, 3072, 4, None), (600, 384, 1536, 4, "edges"),
             (300, 768, 3072, 4, "edges"), (1200, 192, 768, 4, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E,skew", BWD_CASES,
                         ids=["-".join(map(str, c[:4])) + ("-edges" if c[4]
                                                           else "")
                              for c in BWD_CASES])
def test_expert_ffn_bwd_kernel_matches_plain(cuda, T, D, H, E, skew):
    """K4 on a routed layout, dy zero at padding slots, and K9's and K10's
    backward forms on the same rows (x read by index; the row tiles visited
    in reverse): dx elementwise within 1.6e-2; dW (bf16 out) and db (f32)
    within 1e-2 of max |ref|; a starved expert's dW exactly zero."""
    rs = np.random.RandomState(8)
    _, w1, b1, w2, _, _ = _ffn_case(rs, T, D, H, E, torch.bfloat16, cuda)
    x = _rand(rs, T, D, dtype=torch.bfloat16, device=cuda)
    logits = _rand(rs, T, E, device=cuda)
    if skew:
        logits[:, E - 1] = -1e9
        logits[:, E - 2] -= 2.5
    _, eidx = moe_ops.naive_topk_gate(logits, 2)
    gather_idx, pair_slot, e_of_tile, w_slot, _ = \
        moe_ops.aligned_expert_layout(eidx, E, gate_w=torch.ones(T, 2,
                                                                 device=cuda))
    xs = moe_ops.dispatch_gather(x, gather_idx, pair_slot)
    dy = _rand(rs, xs.shape[0], D, dtype=torch.bfloat16, device=cuda) * \
        w_slot[:, None]
    Tp = xs.shape[0]
    if skew:
        tiles = torch.bincount(e_of_tile.long(), minlength=E).tolist()
        assert (eidx == E - 1).sum().item() == 0 and tiles[E - 2] == 1, tiles
        assert (eidx == E - 2).sum().item() > 0
    if (T, D, E) == (1200, 192, 4):
        assert ffn_ops.wgrad_splits(Tp, D, H, E, torch.bfloat16) > 1
    perm = torch.arange(Tp // ffn_ops.TILE_ROWS, dtype=torch.int32,
                        device=cuda).flip(0)
    rows = ffn_ops.permuted_rows(perm)
    xp, dyp = torch.empty_like(xs), torch.empty_like(dy)
    xp[rows], dyp[rows] = xs, dy  # step i's rows in tile perm[i]
    ops.reset_launch_counts()
    got = {"k4": ffn_ops.fused_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy),
           "k9": ffn_ops.fused_expert_ffn_gather_bwd(x, gather_idx, w1, b1,
                                                     w2, e_of_tile, dy),
           "k10": ffn_ops.fused_expert_ffn_permuted_bwd(xp, w1, b1, w2,
                                                        e_of_tile, perm, dyp)}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_expert_ffn_bwd"],
            counts["fused_expert_ffn_gather_bwd"],
            counts["fused_expert_ffn_permuted_bwd"]) == (1, 1, 1)
    want = ffn_ops.reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy)
    got["k10"] = (got["k10"][0][rows], *got["k10"][1:])
    for form, g in got.items():
        torch.testing.assert_close(g[0].float(), want[0].float(),
                                   atol=1.6e-2, rtol=1.6e-2, msg=form)
        for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], g[1:], want[1:]):
            assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all(), \
                (form, name)
            _rel_close(gt, w, 1e-2, f"{form} {name}")
        if skew:
            assert g[1][E - 1].abs().max().item() == 0.0, form
            assert g[3][E - 1].abs().max().item() == 0.0, form


@pytest.mark.cuda
def test_train_step_runs_through_the_kernels(cuda):
    """A bf16 train step of a small ViT-S-width model on the card launches
    every forward and backward kernel, and its loss is finite."""
    from slim_switch_moe_vit_tpu_torch import create_model, losses, optim
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    model = create_model("moe_small_patch16_224_expert8", img_size=64,
                         num_classes=10, dtype=torch.bfloat16)
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, opt_init=opt_init, use_ema=True)
    step = make_train_step(model, opt_update,
                           losses.make_base_criterion(False, 0.1, False),
                           ema_decay=0.99996)
    rs = np.random.RandomState(9)
    x = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    ops.reset_launch_counts()
    state, metrics = step(state, x, y, 1e-3, 1e-3)
    assert torch.isfinite(metrics["loss"]).item()
    assert ops.launch_counts() == {
        "fused_ln": 1, "fused_add_ln": 23, "fused_sum_ln": 1, "fused_mha": 12,
        "fused_expert_ffn": 12, "fused_ln_bwd": 1, "fused_add_ln_bwd": 23,
        "fused_sum_ln_bwd": 1, "fused_mha_bwd": 12, "fused_expert_ffn_bwd": 12,
        "fused_adamw_ema": 0, "flash_attention": 0,
        "fused_expert_ffn_gather": 0, "fused_expert_ffn_gather_bwd": 0,
        "fused_expert_ffn_bwd_defer": 0, "fused_expert_ffn_permuted": 0,
        "fused_expert_ffn_permuted_bwd": 0, "fused_mha_proj": 0,
        "gather_rows": 0, "scatter_add_rows": 0}


# ---------------------------------------------------------------------------
# on the card: the fused optimizer (K7) and the flash forward (K11)
# ---------------------------------------------------------------------------

# K7 vs its plain version, f32: the same operations in the same order, but
# nvcc contracts a*b + c into one FMA where torch rounds twice, so a value
# may be off by an ulp or two of its operands (b1*mu + (1-b1)*g can cancel
# to far below them): |d| <= 4 ulps (4 * 2^-23) of |ref| + max |ref| over
# the leaf
ADAMW_ULPS = 4 * 2.0 ** -23


@pytest.mark.cuda
@pytest.mark.parametrize("with_ema", [True, False])
@pytest.mark.parametrize("t", [1, 3])
def test_fused_adamw_kernel_matches_plain(cuda, with_ema, t):
    """K7 over odd-sized and large leaves, decay and gate flags mixed, at
    step t, within ADAMW_ULPS of the plain version; one launch."""
    rs = np.random.RandomState(10)
    shapes = [(1,), (5, 7), (384, 1536), (197, 384), (3,), (70000,)]
    leaves = _adamw_case(rs, shapes, cuda)
    if not with_ema:
        leaves = leaves[:4] + (None,)
    copies = [None if g is None else [x.clone() for x in g] for g in leaves]
    wd = [True, False, True, True, False, True]
    gate = [False, True, False, True, False, False]
    bc1, bc2 = adamw_ops.bias_corrections(0.9, 0.999, t)
    kw = dict(lr_base=1e-3, lr_gate=5e-4, bc1=bc1, bc2=bc2,
              ema_decay=0.99996 if with_ema else None)
    ops.reset_launch_counts()
    adamw_ops.fused_adamw_ema(*leaves, wd, gate, **kw)
    torch.cuda.synchronize()
    adamw_ops.fused_adamw_ema_reference(*copies, wd, gate, **kw)
    assert ops.launch_counts()["fused_adamw_ema"] == 1
    for name, got, want in zip(("p", "g", "mu", "nu", "ema"), leaves, copies):
        for a, b in zip(got or (), want or ()):
            torch.testing.assert_close(a, b, rtol=ADAMW_ULPS,
                                       atol=ADAMW_ULPS * b.abs().max().item(),
                                       msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("B,N", [(3, 197), (2, 577), (2, 77), (1, 1),
                                 # either side of one and two 64-key
                                 # tiles, and lengths where the K / V
                                 # ring wraps many times
                                 (2, 63), (2, 64), (2, 65), (2, 128),
                                 (1, 1025), (1, 2000)])
def test_flash_kernel_matches_plain(cuda, B, N):
    """K11, bf16: P rounds to bf16 before P.V (the plain version rounds the
    normalized probabilities), within the global bf16 limit 1.6e-2."""
    rs = np.random.RandomState(11)
    qkv = _rand(rs, B, N, 3 * 6 * 64, dtype=torch.bfloat16, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.flash_attention(qkv, 6, 0.125)
    torch.cuda.synchronize()
    want = attn_ops.flash_attention_reference(qkv, 6, 0.125)
    assert ops.launch_counts()["flash_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                               rtol=1.6e-2)
    if N <= 208:  # against K5 on the same input, to K5's limit
        torch.testing.assert_close(got.float(),
                                   attn_ops.fused_mha(qkv, 6, 0.125).float(),
                                   atol=1.6e-2, rtol=1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 64), (torch.float32, 80),
                                     (torch.float32, 20),
                                     (torch.bfloat16, 80),
                                     (torch.bfloat16, 128),
                                     (torch.bfloat16, 20)])
@pytest.mark.parametrize("N", [197, 577, 1])
def test_flash_kernel_head_dims_and_f32(cuda, dtype, d, N):
    """K11 beyond head_dim 64 and in f32 (the JAX kernel's online softmax
    on the CUDA cores): f32 within F32_TOL of the exact-f32 plain version
    (the same function, the softmax rescaled tile by tile), bf16 within
    the global limit."""
    H = 3
    rs = np.random.RandomState(21)
    qkv = _rand(rs, 2, N, 3 * H * d, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.flash_attention(qkv, H, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == 1
    _close(got, attn_ops.flash_attention_reference(qkv, H, d ** -0.5), dtype,
           "out")


@pytest.mark.cuda
def test_resmoe_train_step_launch_counts(cuda):
    """A bf16 train step of a small ResMoE at ViT-S width with the fused
    optimizer: 1 plain LN + 24 slim LN, 12 MHA, 12 expert FFN, their
    backwards and one K7 launch; an eval forward with use_flash launches 12
    K11 and no K5."""
    from slim_switch_moe_vit_tpu_torch import create_model, losses, optim
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    model = create_model("resmoe_small_patch16_224_expert8", img_size=64,
                         num_classes=10, dtype=torch.bfloat16,
                         target_threshold=0.5)
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, opt_init=opt_init, use_ema=True)
    step = make_train_step(model, opt_update,
                           losses.make_base_criterion(False, 0.1, False),
                           ema_decay=0.99996, use_fused_optimizer=True)
    rs = np.random.RandomState(12)
    x = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    ops.reset_launch_counts()
    state, metrics = step(state, x, y, 1e-3, 1e-3)
    assert torch.isfinite(metrics["loss"]).item()
    assert "skip_fraction" in metrics
    assert ops.launch_counts() == {
        "fused_ln": 1, "fused_add_ln": 0, "fused_sum_ln": 24, "fused_mha": 12,
        "fused_expert_ffn": 12, "fused_ln_bwd": 1, "fused_add_ln_bwd": 0,
        "fused_sum_ln_bwd": 24, "fused_mha_bwd": 12, "fused_expert_ffn_bwd": 12,
        "fused_adamw_ema": 1, "flash_attention": 0,
        "fused_expert_ffn_gather": 0, "fused_expert_ffn_gather_bwd": 0,
        "fused_expert_ffn_bwd_defer": 0, "fused_expert_ffn_permuted": 0,
        "fused_expert_ffn_permuted_bwd": 0, "fused_mha_proj": 0,
        "gather_rows": 0, "scatter_add_rows": 0}
    for blk in model.blocks:
        blk.attn.use_flash = True
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model.eval()(x.to(cuda))
    assert torch.isfinite(logits).all()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["fused_mha"]) == (12, 0)


# ---------------------------------------------------------------------------
# on the card: the gather-in-kernel FFN (K9) and the deferred-dW backward (K8)
# ---------------------------------------------------------------------------

def _routed_case(rs, T, D, H, E, capacity, device):
    """Tokens routed with expert 0 favoured and expert E-1 starved (no
    token: one all-padding tile dropless), the layout (with ``capacity``:
    static regions, the overflow of expert 0 dropped), the expert weights,
    and a cotangent zero at padding slots as the combine backward gives."""
    x = _rand(rs, T, D, dtype=torch.bfloat16, device=device)
    logits = _rand(rs, T, E, device=device)
    logits[:, 0] += 1.0
    logits[:, E - 1] = -1e9
    gate_w, eidx = moe_ops.naive_topk_gate(logits, 2)
    gather_idx, pair_slot, e_of_tile, w_slot, keep = \
        moe_ops.aligned_expert_layout(eidx, E, gate_w=gate_w,
                                      capacity=capacity)
    w1 = _rand(rs, E, D, H, scale=D ** -0.5, dtype=torch.bfloat16,
               device=device)
    b1 = _rand(rs, E, H, scale=0.1, device=device)
    w2 = _rand(rs, E, H, D, scale=H ** -0.5, dtype=torch.bfloat16,
               device=device)
    b2 = _rand(rs, E, D, scale=0.1, device=device)
    dy = _rand(rs, gather_idx.shape[0], D, dtype=torch.bfloat16,
               device=device) * w_slot[:, None]
    return x, gather_idx, pair_slot, keep, (w1, b1, w2, b2), e_of_tile, dy


# (T, D, H, E, capacity): dropless with a starved expert and odd tile
# counts; capacity with dropped pairs (3 tiles an expert); ViT-Ti widths,
# where the starved last expert also owns the layout's trailing slack tile
# (2 tiles an expert: K8 flushes pairs only)
ROUTED = [(600, 384, 1536, 4, None), (600, 384, 1536, 4, 520),
          (300, 192, 768, 3, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E,capacity", ROUTED)
def test_gather_ffn_kernels_match_plain(cuda, T, D, H, E, capacity):
    """K9 forward on the live slots within 1.6e-2 elementwise (padding
    slots finite); K9 backward: dx in slot space elementwise, dW and db
    within 1e-2 of max |ref|; the starved expert's dW exactly zero; one
    launch each."""
    rs = np.random.RandomState(13)
    x, gidx, pslot, keep, (w1, b1, w2, b2), eot, dy = _routed_case(
        rs, T, D, H, E, capacity, cuda)
    if capacity is not None:
        assert not keep.all()
    ops.reset_launch_counts()
    got = ffn_ops.fused_expert_ffn_gather(x, gidx, pslot, keep, w1, b1, w2,
                                          b2, eot)
    gb = ffn_ops.fused_expert_ffn_gather_bwd(x, gidx, w1, b1, w2, eot, dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_expert_ffn_gather"],
            counts["fused_expert_ffn_gather_bwd"],
            counts["fused_expert_ffn"]) == (1, 1, 0)
    xs = x.index_select(0, gidx)
    want = ffn_ops.fused_expert_ffn_reference(xs, w1, b1, w2, b2, eot)
    live = torch.zeros(gidx.shape[0], dtype=torch.bool, device=cuda)
    live[pslot[keep]] = True
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got[live].float(), want[live].float(),
                               atol=1.6e-2, rtol=1.6e-2)
    wb = ffn_ops.reference_expert_ffn_bwd(xs, w1, b1, w2, eot, dy)
    torch.testing.assert_close(gb[0].float(), wb[0].float(), atol=1.6e-2,
                               rtol=1.6e-2)
    for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], gb[1:], wb[1:]):
        assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all(), name
        _rel_close(gt, w, 1e-2, name)
    assert gb[1][E - 1].abs().max().item() == 0.0


# K8 beyond ROUTED: bf16 at D = 768 on routed layouts (a favoured and a
# starved expert; H = 3072 and H = D), and a
# hand-made layout (T None) at each width: expert 0
# owns three tiles (a single-tile flush), expert 2 one all-padding tile
# (dy zero), expert 3 two, experts 1 and 4 none at all
DEFER = ROUTED + [(300, 768, 3072, 4, None), (600, 768, 768, 3, None),
                  (None, 192, 768, 5, None), (None, 384, 1536, 5, None),
                  (None, 768, 3072, 5, None)]
HAND_TILES = [0, 0, 0, 2, 3, 3]


def _hand_case(rs, D, H, E, device):
    """K8's inputs on the HAND_TILES layout: random rows, dy zero on the
    all-padding tile of expert 2."""
    tile = ffn_ops.TILE_ROWS
    eot = torch.tensor(HAND_TILES, dtype=torch.int32, device=device)
    Tp = len(HAND_TILES) * tile
    xs = _rand(rs, Tp, D, dtype=torch.bfloat16, device=device)
    dy = _rand(rs, Tp, D, dtype=torch.bfloat16, device=device)
    dy[HAND_TILES.index(2) * tile:(HAND_TILES.index(2) + 1) * tile] = 0
    w1 = _rand(rs, E, D, H, scale=D ** -0.5, dtype=torch.bfloat16,
               device=device)
    b1 = _rand(rs, E, H, scale=0.1, device=device)
    w2 = _rand(rs, E, H, D, scale=H ** -0.5, dtype=torch.bfloat16,
               device=device)
    return xs, (w1, b1, w2), eot, dy


def test_defer_plain_hand_layout():
    """K8's plain version (what the wrapper takes on the CPU) on the
    HAND_TILES layout: the experts with no tile (1, 4) and with one
    all-padding tile (2) get exact zeros for dW and db, and all of it
    agrees with K4's plain version (the same function, its dW summed
    without the tile pairs)."""
    rs = np.random.RandomState(14)
    D, H, E = 192, 768, 5
    xs, (w1, b1, w2), eot, dy = _hand_case(rs, D, H, E, "cpu")
    got = ffn_ops.fused_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
    want = ffn_ops.reference_expert_ffn_bwd(xs, w1, b1, w2, eot, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1.6e-2,
                               rtol=1.6e-2)
    for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], got[1:], want[1:]):
        assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all()
        _rel_close(gt, w, 1e-2, name)
        for e in (1, 2, 4):
            assert gt[e].abs().max().item() == 0.0, (e, name)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E,capacity", DEFER)
def test_defer_dw_kernel_matches_plain(cuda, T, D, H, E, capacity):
    """K8 against its plain version and against K4 on the same inputs: dx
    elementwise within 1.6e-2, dW and db within 1e-2 of max |ref|; an
    expert with no token (one all-padding tile) or no tile at all gets
    exact zeros for dW and db; a second call bit-identical; one launch;
    no (Tp, H) workspace: the allocator's peak during the call exceeds
    what the returned outputs hold by no more than 2 MiB (the rounding of
    one large block)."""
    rs = np.random.RandomState(14)
    if T is None:
        xs, (w1, b1, w2), eot, dy = _hand_case(rs, D, H, E, cuda)
        zero = [1, 2, 4]  # no tile; one all-padding tile; no tile
    else:
        x, gidx, pslot, keep, (w1, b1, w2, _), eot, dy = _routed_case(
            rs, T, D, H, E, capacity, cuda)
        xs = moe_ops.dispatch_gather(x, gidx, pslot, keep)
        zero = [E - 1]  # no token
    flags = ffn_ops.bwd_flags(eot)
    single = (flags & 1).bool() & ~(flags & 2).bool()
    if D != 768 and T is not None:
        assert single.any() == (D == 384)  # single-tile flushes where odd
    if T is None:
        assert single.any()
    allowed = 2 * 2 ** 20
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    got = ffn_ops.fused_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - \
        torch.cuda.memory_allocated()
    assert transient <= allowed, transient
    assert ops.launch_counts()["fused_expert_ffn_bwd_defer"] == 1
    again = ffn_ops.fused_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
    for name, a, b in zip(["dx", "dw1", "db1", "dw2", "db2"], got, again):
        assert torch.equal(a, b), name
    k4 = ffn_ops.fused_expert_ffn_bwd(xs, w1, b1, w2, eot, dy)
    want = ffn_ops.reference_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy)
    for ref in (want, k4):
        torch.testing.assert_close(got[0].float(), ref[0].float(),
                                   atol=1.6e-2, rtol=1.6e-2)
        for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], got[1:],
                               ref[1:]):
            assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all()
            _rel_close(gt, w, 1e-2, name)
    for e in zero:
        for name, gt in zip(["dw1", "db1", "dw2", "db2"], got[1:]):
            assert gt[e].abs().max().item() == 0.0, (e, name)


def _perm_case(rs, src, E, n_per, D, H, device):
    """Source-major rows as the a2a expert-parallel form receives them:
    src blocks of E experts x n_per tiles; the tile permutation that visits
    them expert-major, and the expert of each step."""
    tile = ffn_ops.TILE_ROWS
    Tp = src * E * n_per * tile
    xs = _rand(rs, Tp, D, dtype=torch.bfloat16, device=device)
    dy = _rand(rs, Tp, D, dtype=torch.bfloat16, device=device)
    w1 = _rand(rs, E, D, H, scale=D ** -0.5, dtype=torch.bfloat16,
               device=device)
    b1 = _rand(rs, E, H, scale=0.1, device=device)
    w2 = _rand(rs, E, H, D, scale=H ** -0.5, dtype=torch.bfloat16,
               device=device)
    b2 = _rand(rs, E, D, scale=0.1, device=device)
    perm = torch.arange(src * E * n_per, dtype=torch.int32).reshape(
        src, E, n_per).transpose(0, 1).reshape(-1).to(device)
    e_of_step = torch.arange(E, dtype=torch.int32).repeat_interleave(
        src * n_per).to(device)
    return xs, (w1, b1, w2, b2), e_of_step, perm, dy


@pytest.mark.cuda
@pytest.mark.parametrize("src,E,n_per,D,H", [(4, 2, 2, 384, 1536),
                                             (3, 3, 1, 192, 768)])
def test_permuted_ffn_kernels_match_plain(cuda, src, E, n_per, D, H):
    """K10 forward and backward against their plain versions and against
    the expert-major relayout + K3/K4 on the same rows, with a permutation
    that is not the identity: y and dx elementwise within 1.6e-2 (in xs's
    row order), dW and db within 1e-2 of max |ref|; one launch each."""
    rs = np.random.RandomState(15)
    xs, (w1, b1, w2, b2), e_of_step, perm, dy = _perm_case(
        rs, src, E, n_per, D, H, cuda)
    assert not torch.equal(perm.cpu(), torch.arange(perm.shape[0],
                                                    dtype=torch.int32))
    ops.reset_launch_counts()
    y = ffn_ops.fused_expert_ffn_permuted(xs, w1, b1, w2, b2, e_of_step, perm)
    g = ffn_ops.fused_expert_ffn_permuted_bwd(xs, w1, b1, w2, e_of_step,
                                              perm, dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert (counts["fused_expert_ffn_permuted"],
            counts["fused_expert_ffn_permuted_bwd"]) == (1, 1)
    rows = ffn_ops.permuted_rows(perm)
    y_k3 = torch.empty_like(xs)
    y_k3[rows] = ffn_ops.fused_expert_ffn(xs[rows], w1, b1, w2, b2, e_of_step)
    k4 = ffn_ops.fused_expert_ffn_bwd(xs[rows], w1, b1, w2, e_of_step,
                                      dy[rows].contiguous())
    dx_k4 = torch.empty_like(xs)
    dx_k4[rows] = k4[0]
    plain = ffn_ops.reference_expert_ffn_permuted(xs, w1, b1, w2, b2,
                                                  e_of_step, perm)
    plain_bwd = ffn_ops.reference_expert_ffn_bwd_permuted(
        xs, w1, b1, w2, e_of_step, perm, dy)
    for ref_y, ref_g in ((plain, plain_bwd), (y_k3, (dx_k4, *k4[1:]))):
        torch.testing.assert_close(y.float(), ref_y.float(), atol=1.6e-2,
                                   rtol=1.6e-2)
        torch.testing.assert_close(g[0].float(), ref_g[0].float(),
                                   atol=1.6e-2, rtol=1.6e-2)
        for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], g[1:],
                               ref_g[1:]):
            assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all()
            _rel_close(gt, w, 1e-2, name)


@pytest.mark.cuda
@pytest.mark.parametrize("knob,per_step", [
    (None, {"fused_expert_ffn": 12, "fused_expert_ffn_bwd": 12}),
    ("SSMV_GATHER_IN_KERNEL", {"fused_expert_ffn_gather": 12,
                               "fused_expert_ffn_gather_bwd": 12}),
    ("SSMV_DEFER_DW", {"fused_expert_ffn": 12,
                       "fused_expert_ffn_bwd_defer": 12})])
def test_capacity_train_step_launch_counts(cuda, knob, per_step, monkeypatch):
    """A bf16 train step of a small ViT-S-width capacity_fused model at
    factor 1.25: the expert-FFN launches of each knob form exactly, the
    rest as the dropless step, a finite loss and a drop_fraction."""
    from slim_switch_moe_vit_tpu_torch import create_model, losses, optim
    from slim_switch_moe_vit_tpu_torch.engine import make_train_step
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

    if knob:
        monkeypatch.setenv(knob, "1")
    model = create_model("moe_small_patch16_224_expert8", img_size=64,
                         num_classes=10, dtype=torch.bfloat16,
                         dispatch_mode="capacity_fused", capacity_factor=1.25)
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, opt_init=opt_init, use_ema=True)
    step = make_train_step(model, opt_update,
                           losses.make_base_criterion(False, 0.1, False),
                           ema_decay=0.99996)
    rs = np.random.RandomState(15)
    x = torch.from_numpy(rs.randn(4, 64, 64, 3).astype(np.float32))
    y = torch.from_numpy(rs.randint(0, 10, 4))
    ops.reset_launch_counts()
    state, metrics = step(state, x, y, 1e-3, 1e-3)
    assert torch.isfinite(metrics["loss"]).item()
    assert 0.0 <= metrics["drop_fraction"].item() < 1.0
    want = {"fused_ln": 1, "fused_add_ln": 23, "fused_sum_ln": 1,
            "fused_mha": 12, "fused_ln_bwd": 1, "fused_add_ln_bwd": 23,
            "fused_sum_ln_bwd": 1, "fused_mha_bwd": 12, **per_step}
    assert ops.launch_counts() == {k: want.get(k, 0)
                                   for k in ops.launch_counts()}


# ---------------------------------------------------------------------------
# on the card: f32 and D = 768 (the SIMT forms), K12 and K13
# ---------------------------------------------------------------------------

# f32 kernels vs their plain versions, which are exact f32 on the card
# (TF32 off): the same function in other summation orders,
# |d| <= 1e-4 + 1e-4 |ref| elementwise, sums over rows included
F32_TOL = (1e-4, 1e-4)


def _close(got, want, dtype, what, sums=False):
    """f32: F32_TOL elementwise; bf16: 1.6e-2 elementwise, or for f32 sums
    over rows in other orders (``sums``) 1e-2 of max |ref|."""
    assert got.dtype == want.dtype and torch.isfinite(got.float()).all(), what
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=F32_TOL[0],
                                   rtol=F32_TOL[1], msg=what)
    elif sums:
        _rel_close(got, want, 1e-2, what)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                                   rtol=1.6e-2, msg=what)


@pytest.mark.cuda
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("N", LENGTHS + [50])
def test_mha_bwd_f32_kernel_matches_plain(cuda, N, d):
    """K6's f32 forms (one block per (head, sample) at N <= 208 and
    d <= 64, the rows and cols kernels beyond) against the exact-f32 plain
    backward, within F32_TOL."""
    rs = np.random.RandomState(16)
    qkv = _rand(rs, 2, N, 3 * 3 * d, device=cuda)
    do = _rand(rs, 2, N, 3 * d, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.fused_mha_bwd(qkv, do, 3, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mha_bwd"] == 1
    _close(got, attn_ops.reference_mha_bwd(qkv, do, 3, d ** -0.5),
           torch.float32, "dqkv")


# (dtype, T, D, H, E): f32 at each width (the SIMT forms), bf16 at D = 768
WIDE = [(torch.float32, 300, 384, 1536, 4),
        (torch.float32, 200, 192, 768, 3),
        (torch.float32, 150, 768, 1024, 3),
        (torch.bfloat16, 300, 768, 3072, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,D,H,E", WIDE)
def test_expert_ffn_family_f32_and_d768(cuda, dtype, T, D, H, E):
    """K3, K4, K8, K9 and K10 against their plain versions on one routed
    layout (a favoured and a starved expert): in f32 every form's SIMT
    kernel; in bf16 at D = 768 the tensor-core forward and backward forms
    of K3, K4, K9 and K10 and K8's SIMT form. y and dx elementwise, dW and
    db elementwise in f32 and within 1e-2 of max |ref| in bf16; one launch
    each."""
    rs = np.random.RandomState(17)
    x, gidx, pslot, keep, (w1, b1, w2, b2), eot, dy = _routed_case(
        rs, T, D, H, E, None, cuda)
    x, w1, w2, dy = (t.to(dtype) for t in (x, w1, w2, dy))
    xs = moe_ops.dispatch_gather(x, gidx, pslot, keep)
    n_tiles = eot.shape[0]
    perm = torch.arange(n_tiles, dtype=torch.int32, device=cuda).flip(0)
    ops.reset_launch_counts()
    got = {
        "fwd": ffn_ops.fused_expert_ffn(xs, w1, b1, w2, b2, eot),
        "bwd": ffn_ops.fused_expert_ffn_bwd(xs, w1, b1, w2, eot, dy),
        "defer": ffn_ops.fused_expert_ffn_bwd_defer(xs, w1, b1, w2, eot, dy),
        "gather": ffn_ops.fused_expert_ffn_gather(x, gidx, pslot, keep, w1,
                                                  b1, w2, b2, eot),
        "gather_bwd": ffn_ops.fused_expert_ffn_gather_bwd(x, gidx, w1, b1, w2,
                                                          eot, dy),
        "perm": ffn_ops.fused_expert_ffn_permuted(xs, w1, b1, w2, b2, eot,
                                                  perm),
        "perm_bwd": ffn_ops.fused_expert_ffn_permuted_bwd(xs, w1, b1, w2, eot,
                                                          perm, dy)}
    torch.cuda.synchronize()
    assert all(v == 1 for k, v in ops.launch_counts().items()
               if k.startswith("fused_expert_ffn")), ops.launch_counts()
    xg = x.index_select(0, gidx)
    want = {
        "fwd": ffn_ops.fused_expert_ffn_reference(xs, w1, b1, w2, b2, eot),
        "bwd": ffn_ops.reference_expert_ffn_bwd(xs, w1, b1, w2, eot, dy),
        "defer": ffn_ops.reference_expert_ffn_bwd_defer(xs, w1, b1, w2, eot,
                                                        dy),
        "gather": ffn_ops.fused_expert_ffn_reference(xg, w1, b1, w2, b2, eot),
        "gather_bwd": ffn_ops.reference_expert_ffn_bwd(xg, w1, b1, w2, eot,
                                                       dy),
        "perm": ffn_ops.reference_expert_ffn_permuted(xs, w1, b1, w2, b2, eot,
                                                      perm),
        "perm_bwd": ffn_ops.reference_expert_ffn_bwd_permuted(
            xs, w1, b1, w2, eot, perm, dy)}
    live = torch.zeros(gidx.shape[0], dtype=torch.bool, device=cuda)
    live[pslot[keep]] = True
    for name in got:
        g, w = got[name], want[name]
        if not isinstance(g, tuple):
            rows = live if name == "gather" else slice(None)
            _close(g[rows], w[rows], dtype, name)
            continue
        _close(g[0], w[0], dtype, name + " dx")
        for part, gt, wt in zip(["dw1", "db1", "dw2", "db2"], g[1:], w[1:]):
            _close(gt, wt, dtype, f"{name} {part}", sums=True)
        if name != "perm_bwd":  # the flipped steps give it real rows
            assert g[1][E - 1].abs().max().item() == 0.0  # starved expert


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,N,H,d", [(4, 197, 3, 64), (2, 197, 6, 64),
                                     (2, 50, 12, 64), (1, 272, 2, 64),
                                     (1, 417, 16, 64), (1, 577, 16, 64),
                                     (1, 417, 20, 64), (1, 577, 16, 80),
                                     (1, 1024, 16, 64), (1, 1024, 20, 64),
                                     (2, 33, 3, 20),
                                     # C = 1280 at B = 1: the bf16 form
                                     # splits the heads over blocks (so do
                                     # the cases above, where fewer than
                                     # 132 query tiles leave SMs idle)
                                     (1, 577, 20, 64),
                                     # 160 query tiles: one group of 6 heads
                                     (40, 197, 6, 64),
                                     # C = 1280 at head_dim 128: the o
                                     # tile holds 8 of the 10 heads at most
                                     # (groups of 8 and 2)
                                     (1, 197, 10, 128), (40, 197, 10, 128),
                                     # an odd head width and C
                                     (3, 70, 5, 13)])
def test_mha_proj_kernel_matches_plain(cuda, dtype, B, N, H, d):
    """K12 against its plain version (K5's function, then the proj product
    rounded as the JAX reference): bf16 within 1.6e-2 + 1.6e-2 |ref| (the
    plain side rounds o.Wp and adds bp in bf16, the kernel rounds once),
    f32 within F32_TOL; one launch counted (in bf16, a head split adds a
    second kernel that sums the groups)."""
    rs = np.random.RandomState(18)
    C = H * d
    qkv = _rand(rs, B, N, 3 * C, dtype=dtype, device=cuda)
    wp = _rand(rs, C, C, scale=C ** -0.5, dtype=dtype, device=cuda)
    bp = _rand(rs, C, scale=0.1, device=cuda)
    ops.reset_launch_counts()
    got = attn_ops.fused_mha_proj(qkv, wp, bp, H, d ** -0.5)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_mha_proj"] == 1
    _close(got, attn_ops.fused_mha_proj_reference(qkv, wp, bp, H, d ** -0.5),
           dtype, "y")


@pytest.mark.cuda
def test_mha_proj_refuses_what_it_does_not_take(cuda):
    rs = np.random.RandomState(19)
    for B, N, H, dtype in ((1, 1025, 2, torch.bfloat16),  # N <= 1024
                           (1, 1025, 2, torch.float32),
                           (1, 20, 21, torch.float32)):  # C = 1344 > 1280
        C = H * 64
        qkv = _rand(rs, B, N, 3 * C, dtype=dtype, device=cuda)
        wp = _rand(rs, C, C, dtype=dtype, device=cuda)
        with pytest.raises(ValueError):
            attn_ops.fused_mha_proj(qkv, wp, torch.zeros(C, device=cuda), H,
                                    0.125)


def _scatter_idx(rs, kind, N, M):
    """Destination rows: "random", M of them in [0, N); "hot", one row of
    3,000 sources among rows of 0-2; "two_hot", two neighbouring rows of
    1,500 each; "threshold", one row of exactly LONG_ROW sources and
    its neighbour of LONG_ROW + 1; "out_of_range", random with a tenth of
    them below 0 or at N and beyond. Shuffled, so each row's sources
    interleave with the others'."""
    from slim_switch_moe_vit_tpu_torch.ops import gather as gops

    if kind in ("random", "out_of_range"):
        idx = rs.randint(0, N, M)
        if kind == "out_of_range":
            bad = rs.rand(M) < 0.1
            idx[bad] = rs.choice([-3, -1, N, N + 7], bad.sum())
        return idx
    few = np.repeat(np.arange(N), rs.randint(0, 3, N))  # 0-2 a row
    big = {"hot": [(N // 3, 3000)],
           "two_hot": [(N // 2, 1500), (N // 2 + 1, 1500)],
           "threshold": [(5, gops.LONG_ROW), (6, gops.LONG_ROW + 1)]}[kind]
    few = few[~np.isin(few, [r for r, _ in big])]
    return rs.permutation(np.concatenate([few] + [np.full(n, r)
                                                  for r, n in big]))


# (N, D, M, idx_dtype, kind), M the sources of "random" and
# "out_of_range" (the others make their own); D = 7 takes the scalar path
# (a row is not a multiple of 16 bytes)
SCATTER_CASES = [(1000, 192, 2048, torch.int32, "random"),
                 (500, 384, 1700, torch.int64, "random"),
                 (300, 7, 999, torch.int64, "random"),
                 (2000, 384, None, torch.int64, "hot"),
                 (1000, 192, None, torch.int32, "two_hot"),
                 (500, 384, None, torch.int64, "threshold"),
                 (500, 384, 1700, torch.int64, "out_of_range"),
                 (300, 7, None, torch.int64, "hot")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,D,M,idx_dtype,kind", SCATTER_CASES)
def test_gather_scatter_kernels_match_plain(cuda, dtype, N, D, M, idx_dtype,
                                            kind):
    """K13: the gather equals index_select bit for bit (16-byte vectors, and
    the scalar path where a row is not a multiple of 16 bytes); the
    scatter-add equals its plain version (index-order f32 sums, one
    rounding) bit for bit, in f32 also np.add.at's sum (indices outside
    [0, N) add nowhere), with hot rows past the long-row threshold; their
    autograd directions launch each other."""
    from slim_switch_moe_vit_tpu_torch.ops import gather as gops

    rs = np.random.RandomState(20)
    x = _rand(rs, N, D, dtype=dtype, device=cuda)
    idx_np = _scatter_idx(rs, kind, N, M)
    idx = torch.from_numpy(idx_np).to(cuda, idx_dtype)
    g = _rand(rs, idx_np.shape[0], D, dtype=dtype, device=cuda)
    ops.reset_launch_counts()
    acc = gops.scatter_add_rows(g, idx, N)
    torch.cuda.synchronize()
    assert torch.equal(acc, gops.reference_scatter_add_rows(g, idx, N))
    if dtype == torch.float32:
        ref = np.zeros((N, D), np.float32)
        inside = (idx_np >= 0) & (idx_np < N)
        np.add.at(ref, idx_np[inside], g.cpu().numpy()[inside])
        assert np.array_equal(acc.cpu().numpy(), ref)
    if kind == "out_of_range":  # the gather takes indices in [0, N) only
        assert ops.launch_counts()["scatter_add_rows"] == 1
        return
    out = gops.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(out, gops.reference_gather_rows(x, idx))
    xl = x.detach().requires_grad_()
    gops.gather_rows(xl, idx).backward(g)
    gl = g.detach().requires_grad_()
    gops.scatter_add_rows(gl, idx, N).backward(x)
    assert torch.equal(xl.grad, acc)
    assert torch.equal(gl.grad, out)
    counts = ops.launch_counts()  # two forwards each, one backward each
    assert (counts["gather_rows"], counts["scatter_add_rows"]) == (3, 3)


@pytest.mark.cuda
def test_gather_scatter_refuse_what_they_do_not_take(cuda):
    from slim_switch_moe_vit_tpu_torch.ops import gather as gops

    x = torch.zeros(10, 8, device=cuda, dtype=torch.float16)
    idx = torch.zeros(4, dtype=torch.int64, device=cuda)
    with pytest.raises(TypeError):
        gops.gather_rows(x, idx)
    with pytest.raises(TypeError):  # index dtype
        gops.gather_rows(x.float(), idx.to(torch.int16))
    with pytest.raises(ValueError):  # idx one per row of g
        gops.scatter_add_rows(torch.zeros(5, 8, device=cuda), idx, 10)


# ---------------------------------------------------------------------------
# on the card: the switchable and sparse ViTs, the RegNet teacher, the
# asynchronous checkpoint and the profiler
# ---------------------------------------------------------------------------

def _sw_model(device, dtype=torch.float32):
    """deit_sw_tiny at 64 px (N = 17), 4 buckets with centroids from the
    pre-router tokens, route_capacity 8; seed-0 weights."""
    from slim_switch_moe_vit_tpu_torch import create_model

    m = create_model("deit_sw_tiny_patch16_224", num_classes=10, img_size=64,
                     buckets=4, route_capacity=8, dtype=dtype).to(device)
    x = _rand(np.random.RandomState(30), 4, 64, 64, 3, device=device)
    with torch.no_grad():
        pre = m.forward_pre(x).float().reshape(-1, 192)
    m.router.set_centroids(pre[[1, 20, 40, 66]])
    return m, x


@pytest.mark.cuda
def test_switchable_routed_forward_and_step_on_the_kernels(cuda):
    """deit_sw_tiny routed (threshold 1, capacity 8 of 17) in f32 on the
    card: the 11 mid blocks see N = 8, every block runs its two LNs on K1a
    and its attention on K5 (K1c and K6 added by the backward), the logits
    within 1e-4 + 1e-4 |ref| of the CPU plain path's, and every parameter's
    gradient of the routed backward within 1e-4 of its max |ref| of the
    CPU plain path's (the same f32 function, summed in other orders)."""
    from slim_switch_moe_vit_tpu_torch.models import vit

    m, x = _sw_model(cuda)
    seen = []
    hooks = [blk.attn.register_forward_hook(
        lambda mod, i, o: seen.append(i[0].shape[1])) for blk in m.blocks]
    ops.reset_launch_counts()
    vit.ROUTE_COUNTS.clear()
    with torch.no_grad():
        got = m.eval()(x, threshold=1, routing=True)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"fused_ln": 25, "fused_mha": 12}
    assert dict(vit.ROUTE_COUNTS) == {"k5": 12}
    assert seen == [8] * 11 + [17]
    for h in hooks:
        h.remove()
    cpu = _sw_model("cpu")[0]
    cpu.load_state_dict({k: v.cpu() for k, v in m.state_dict().items()})
    with torch.no_grad():
        want = cpu.eval()(x.cpu(), threshold=1, routing=True)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=1e-4)
    ops.reset_launch_counts()
    m.train()
    m(x, torch.Generator(cuda), threshold=1, routing=True).sum().backward()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"fused_ln": 25, "fused_mha": 12, "fused_ln_bwd": 25,
                      "fused_mha_bwd": 12}
    cpu.train()
    cpu(x.cpu(), torch.Generator(), threshold=1,
        routing=True).sum().backward()
    worst = {}
    for (name, p), q in zip(m.named_parameters(), cpu.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if q.grad is not None:
            worst[name] = ((p.grad.cpu() - q.grad).abs().max()
                           / q.grad.abs().max().clamp_min(1e-30)).item()
    assert max(worst.values()) <= 1e-4, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


@pytest.mark.cuda
def test_sparse_model_launches_only_its_final_norm(cuda):
    """sparse_deit_tiny at 32 px on the card: the sparse blocks keep plain
    norms and their own attention, so a forward launches only the final
    norm's K1a and a backward its K1c; the logits within 1e-4 + 1e-4 |ref|
    of the CPU's; compress gives the CPU's masks."""
    from slim_switch_moe_vit_tpu_torch import create_model
    from slim_switch_moe_vit_tpu_torch.models import sparse

    cpu = create_model("sparse_deit_tiny_patch16_224", num_classes=10,
                       img_size=32)
    with torch.no_grad():
        g = torch.Generator().manual_seed(3)
        for _, mod, _ in sparse.sparse_modules(cpu):
            mod.zeta.copy_(torch.rand(mod.zeta.shape, generator=g))
    m = create_model("sparse_deit_tiny_patch16_224", num_classes=10,
                     img_size=32).to(cuda)
    m.load_state_dict(cpu.state_dict())
    x = _rand(np.random.RandomState(31), 8, 32, 32, 3)
    ops.reset_launch_counts()
    m.train()
    out = m(x.to(cuda), torch.Generator(cuda))
    out.sum().backward()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"fused_ln": 1, "fused_ln_bwd": 1}
    torch.testing.assert_close(out.detach().cpu(), cpu.train()(x).detach(),
                               atol=1e-4, rtol=1e-4)
    assert sparse.compress(m, 0.5, 0.5, 0.5) == sparse.compress(cpu, 0.5,
                                                                0.5, 0.5)
    for name, t in cpu.state_dict().items():
        if "searched" in name:
            assert torch.equal(m.state_dict()[name].cpu(), t), name


@contextlib.contextmanager
def _cudnn_tf32(allow):
    """cuDNN's TF32 switch set to ``allow`` inside, restored after (the
    ``cuda`` fixture turns it off)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


# regnety_040's eval logits at 64 px on the card vs the CPU f32, in max |d|
# over max |ref|: TF32 convolutions (the teacher's precision) within this,
# the same weights with bf16 activations outside it (NVIDIA H100 80GB HBM3
# at 700 W: TF32 3.781e-4, bf16 5.287e-3, full f32 5.587e-7); the limit of
# chip_smoke.py's TEACHER_REL
REGNET_TF32_REL = 1e-3


@pytest.mark.cuda
def test_regnet_on_the_card_matches_the_cpu(cuda):
    """regnety_040 at 64 px, f32: eval logits in TF32 (PyTorch's default,
    the teacher's precision) within REGNET_TF32_REL of max |ref| of the CPU
    f32 logits, the bf16-activation model of the same weights outside it,
    in full f32 within 1e-4 of it; train-mode running statistics in full
    f32 within 1e-4 + 1e-4 |ref|; no kernel of the port launched; the
    channels-last weights."""
    from slim_switch_moe_vit_tpu_torch import create_model

    cpu = create_model("regnety_040", num_classes=10)
    m = create_model("regnety_040", num_classes=10).to(cuda)
    low = create_model("regnety_040", num_classes=10,
                       dtype=torch.bfloat16).to(cuda)
    low.load_state_dict(m.state_dict())
    assert m.stem.conv.weight.is_contiguous(
        memory_format=torch.channels_last)
    x = _rand(np.random.RandomState(32), 4, 64, 64, 3)
    with torch.no_grad():
        want = cpu.eval()(x)
        ops.reset_launch_counts()
        with _cudnn_tf32(True):
            tf32 = m.eval()(x.to(cuda)).cpu()
            bf16 = low.eval()(x.to(cuda)).cpu()
        assert not any(ops.launch_counts().values())
        full = m(x.to(cuda)).cpu()
        ref = want.abs().max()
        rel = [((t - want).abs().max() / ref).item()
               for t in (tf32, bf16, full)]
        assert rel[0] <= REGNET_TF32_REL < rel[1], rel
        assert rel[2] <= 1e-4, rel
        m.train()(x.to(cuda))
        cpu.train()(x)
    for name, t in cpu.state_dict().items():
        if "running" in name:
            torch.testing.assert_close(m.state_dict()[name].cpu(), t,
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_async_checkpoint_snapshots_a_cuda_state(cuda, tmp_path):
    """An asynchronous save of a state on the card holds the values of the
    call, not the values a later in-place update leaves."""
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils import checkpoint

    model = torch.nn.Linear(256, 256)
    state = create_train_state(model, device="cuda")
    before = model.weight.detach().cpu().clone()
    checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, 0,
                               use_async=True)
    with torch.no_grad():
        model.weight.add_(1.0)
    checkpoint.wait_for_checkpoints()
    saved = torch.load(tmp_path / "ckpt", weights_only=True)
    assert torch.equal(saved["model"]["weight"], before)


@pytest.mark.cuda
def test_profiling_trace_reads_the_card_kernels(cuda, tmp_path):
    """``trace`` around a bf16 K5 call: ``summarize_trace`` lists its
    kernel, one launch a call."""
    from slim_switch_moe_vit_tpu_torch.utils import profiling

    qkv = _rand(np.random.RandomState(33), 2, 197, 3 * 384,
                dtype=torch.bfloat16, device=cuda)
    attn_ops.fused_mha(qkv, 6, 0.125)
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            attn_ops.fused_mha(qkv, 6, 0.125)
    rows = profiling.summarize_trace(str(tmp_path), steps=3)
    mha = [r for r in rows if "mha_fwd" in r[2]]
    assert len(mha) == 1 and mha[0][1] == 3 and mha[0][0] > 0
