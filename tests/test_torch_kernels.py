"""Kernel wrappers of the PyTorch port: dispatch, argument checks, counters.

Imports torch and the port only (no JAX), so the ``cuda``-marked tests also
run on a GPU host without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

On a CPU-only host those skip, and the CPU tests check that a CPU tensor
takes the plain version and counts no launch.
"""
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
    gather_idx, pair_slot, e_of_tile, _ = moe_ops.aligned_expert_layout(eidx, E)
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
        "fused_adamw_ema": 0, "flash_attention": 0}


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
            "expert_ffn_bwd.cu", "flash_fwd.cu", "fused_adamw.cu",
            "common.cuh"} <= set(srcs)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("N,H,d", [(197, 6, 64), (50, 3, 64), (1, 2, 64)])
def test_mha_kernel_matches_plain(cuda, dtype, tol, N, H, d):
    rs = np.random.RandomState(3)
    qkv = _rand(rs, 3, N, 3 * H * d, dtype=dtype, device=cuda)
    got = attn_ops.fused_mha(qkv, H, d ** -0.5)
    torch.cuda.synchronize()
    want = attn_ops.fused_mha_reference(qkv, H, d ** -0.5)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E", [(300, 384, 1536, 8), (40, 192, 768, 4)])
def test_expert_ffn_kernel_matches_plain(cuda, T, D, H, E):
    rs = np.random.RandomState(4)
    case = _ffn_case(rs, T, D, H, E, torch.bfloat16, cuda)
    got = ffn_ops.fused_expert_ffn(*case)
    torch.cuda.synchronize()
    want = ffn_ops.fused_expert_ffn_reference(*case)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2,
                               rtol=1.6e-2)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    rs = np.random.RandomState(5)
    qkv = _rand(rs, 2, 10, 3 * 64, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn_ops.fused_mha(qkv, 2, 0.1)  # d = 32
    case = list(_ffn_case(rs, 20, 192, 128, 2, torch.bfloat16, cuda))
    case[0] = case[0].float()
    with pytest.raises(TypeError):
        ffn_ops.fused_expert_ffn(*case)
    with pytest.raises(TypeError):  # the MHA backward kernel is bf16 only
        attn_ops.fused_mha_bwd(_rand(rs, 2, 10, 3 * 128, device=cuda),
                               _rand(rs, 2, 10, 128, device=cuda), 2, 0.125)
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("shape", [(4, 197, 384), (37, 192)])
def test_ln_bwd_kernels_match_plain(cuda, dtype, tol, shape):
    """K1c in both forms and K2b: du elementwise within tol; dgamma/dbeta
    (f32 sums over the rows, in other orders) within 1e-4 of max |ref|."""
    rs = np.random.RandomState(6)
    a, b, dy, du = (_rand(rs, *shape, dtype=dtype, device=cuda)
                    for _ in range(4))
    g = _rand(rs, shape[-1], scale=0.1, device=cuda) + 1.0
    ops.reset_launch_counts()
    cases = {
        "fused_ln_bwd": (ln_ops.fused_ln_bwd(a, dy, g),
                         ln_ops.reference_ln_bwd(a, dy, None, g)),
        "fused_add_ln_bwd": (ln_ops.fused_add_ln_bwd(a, dy, du, g),
                             ln_ops.reference_ln_bwd(a, dy, du, g)),
        "fused_sum_ln_bwd": (ln_ops.fused_sum_ln_bwd(a, b, dy, g),
                             ln_ops.reference_ln_bwd(a + b, dy, None, g)),
    }
    torch.cuda.synchronize()
    for name, (got, want) in cases.items():
        assert got[0].dtype == dtype
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=tol,
                                   rtol=tol, msg=name)
        for gt, w in zip(got[1:], want[1:]):
            _rel_close(gt, w, 1e-4, name)
        assert ops.launch_counts()[name] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N", [197, 50, 17])
def test_mha_bwd_kernel_matches_plain(cuda, N):
    """K6, bf16: e, ds and do*linv round to bf16 on both sides in other
    summation orders, so a flipped rounding moves a term by one ulp. The
    outputs are ~0.07 an element, so elementwise within one bf16 ulp at
    0.5-1 (4e-3) + 1.6e-2 |ref|, the smoke's limit for K6."""
    rs = np.random.RandomState(7)
    qkv = _rand(rs, 3, N, 3 * 6 * 64, dtype=torch.bfloat16, device=cuda)
    do = _rand(rs, 3, N, 6 * 64, dtype=torch.bfloat16, device=cuda)
    got = attn_ops.fused_mha_bwd(qkv, do, 6, 0.125)
    torch.cuda.synchronize()
    want = attn_ops.reference_mha_bwd(qkv, do, 6, 0.125)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want.float(), atol=4e-3,
                               rtol=1.6e-2, msg="dqkv")


@pytest.mark.cuda
@pytest.mark.parametrize("T,D,H,E", [(300, 384, 1536, 8), (40, 192, 768, 4)])
def test_expert_ffn_bwd_kernel_matches_plain(cuda, T, D, H, E):
    """K4 on a routed layout, dy zero at padding slots: dx elementwise
    within 1.6e-2; dW (bf16 out) and db (f32) within 1e-2 of max |ref|."""
    rs = np.random.RandomState(8)
    _, w1, b1, w2, _, _ = _ffn_case(rs, T, D, H, E, torch.bfloat16, cuda)
    x = _rand(rs, T, D, dtype=torch.bfloat16, device=cuda)
    _, eidx = moe_ops.naive_topk_gate(_rand(rs, T, E, device=cuda), 2)
    gather_idx, pair_slot, e_of_tile, w_slot = moe_ops.aligned_expert_layout(
        eidx, E, gate_w=torch.ones(T, 2, device=cuda))
    xs = moe_ops.dispatch_gather(x, gather_idx, pair_slot)
    dy = _rand(rs, xs.shape[0], D, dtype=torch.bfloat16, device=cuda) * \
        w_slot[:, None]
    got = ffn_ops.fused_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy)
    torch.cuda.synchronize()
    want = ffn_ops.reference_expert_ffn_bwd(xs, w1, b1, w2, e_of_tile, dy)
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=1.6e-2,
                               rtol=1.6e-2)
    for name, gt, w in zip(["dw1", "db1", "dw2", "db2"], got[1:], want[1:]):
        assert gt.dtype == w.dtype and torch.isfinite(gt.float()).all(), name
        _rel_close(gt, w, 1e-2, name)


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
        "fused_adamw_ema": 0, "flash_attention": 0}


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
@pytest.mark.parametrize("B,N", [(3, 197), (2, 577), (2, 77), (1, 1)])
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
        "fused_adamw_ema": 1, "flash_attention": 0}
    for blk in model.blocks:
        blk.attn.use_flash = True
    ops.reset_launch_counts()
    with torch.no_grad():
        logits = model.eval()(x.to(cuda))
    assert torch.isfinite(logits).all()
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["fused_mha"]) == (12, 0)
