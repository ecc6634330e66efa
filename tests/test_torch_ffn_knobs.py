"""The two MoE kernel knobs of the port vs the JAX package's, on the plain
versions (CPU tensors): ``SSMV_GATHER_IN_KERNEL=1`` (K9) end to end, and
``SSMV_DEFER_DW=1``'s deferred-dW backward (K8) with its flags.

Same seeded numpy inputs through both packages, in f32, the JAX Pallas
kernels in interpret mode and its knobs set through ``monkeypatch``, as
tests/test_fused_ffn.py and tests/test_moe_ops.py run them:

- ``moe_forward_fused`` at capacity factor 0.75 with
  ``SSMV_GATHER_IN_KERNEL=1`` in both packages: the loss within rtol 1e-6
  and the gradients of x and w1 within atol 3e-5 / rtol 1e-4 of JAX's and
  of the port's own default path (dropless too, port only);
- ``bwd_flags`` exactly against ``_bwd_flags`` on nondecreasing tile
  owners with single-tile, odd and even groups;
- K8's plain version against JAX's ``_bwd(defer_dw=True)`` for capacity
  None and 700 (3 tiles an expert: odd groups, single-tile flushes), with
  an expert skewed to several tiles and one starved to its single padding
  tile: dx, dW and db within 2e-5 of max |ref| (the JAX test's 2e-5), the
  starved expert's dW exactly zero, and ``SSMV_DEFER_DW=1`` taking it in
  the autograd backward.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn
from slim_switch_moe_vit_tpu_torch.ops import moe as torch_moe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rs, E, d, h):
    return [np.asarray(a, np.float32) for a in (
        rs.randn(d, E) * 0.1, rs.randn(E) * 0.01, rs.randn(E, d, h) * 0.05,
        rs.randn(E, h) * 0.01, rs.randn(E, h, d) * 0.05,
        rs.randn(E, d) * 0.01)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("capacity_factor", [None, 0.75])
def test_gather_in_kernel_knob_end_to_end(capacity_factor, monkeypatch):
    """moe_forward_fused with SSMV_GATHER_IN_KERNEL=1: the port's loss and
    gradients of x and w1 against its own default path, and at factor 0.75
    against the JAX package with the same knob (one interpreted compile)."""
    rs = np.random.RandomState(4)
    T, d, h, E, k = 96, 32, 64, 4, 2
    p = _params(rs, E, d, h)
    x = rs.randn(T, d).astype(np.float32)
    calls = []
    real = torch_ffn._FusedExpertFFNGather.apply

    def spy(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(torch_ffn._FusedExpertFFNGather, "apply", spy)

    def jloss(x, w1):
        y, _ = jax_moe.moe_forward_fused(x, p[0], p[1], w1, *p[3:], top_k=k,
                                         capacity_factor=capacity_factor)
        return jnp.sum(y * y)

    def tgrads():
        xt, w1t = _t(x).requires_grad_(), _t(p[2]).requires_grad_()
        y, _ = torch_moe.moe_forward_fused(
            xt, _t(p[0]), _t(p[1]), w1t, *map(_t, p[3:]), top_k=k,
            capacity_factor=capacity_factor)
        loss = (y * y).sum()
        loss.backward()
        return loss.item(), xt.grad, w1t.grad

    base = tgrads()
    assert not calls
    monkeypatch.setenv("SSMV_GATHER_IN_KERNEL", "1")
    got = tgrads()
    assert calls == [1]
    np.testing.assert_allclose(got[0], base[0], rtol=1e-6)
    for g, b in zip(got[1:], base[1:]):
        np.testing.assert_allclose(g.numpy(), b.numpy(), atol=3e-5,
                                   rtol=1e-4)
    if capacity_factor is None:
        return
    lj, gj = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(x, p[2])
    np.testing.assert_allclose(got[0], float(lj), rtol=1e-6)
    for g, w in zip(got[1:], gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("owners", [
    [0], [0, 0], [0, 0, 0], [0, 1, 2, 3], [0, 0, 0, 1, 2, 2, 2, 2, 3],
    [1, 1, 1, 1, 1, 2, 3, 3, 3], [0] * 7 + [1] * 31 + [2] * 2 + [5]])
def test_bwd_flags_match_jax(owners):
    e = np.asarray(owners, np.int32)
    want = jax_ffn._bwd_flags(jnp.asarray(e), len(e))
    got = torch_ffn.bwd_flags(torch.from_numpy(e))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("capacity", [None, 700])
def test_defer_dw_backward_matches_jax(capacity, monkeypatch):
    """Expert 0 skewed to several tiles (paired flushes), expert 2 starved
    (its single padding tile: a single-tile flush)."""
    rs = np.random.RandomState(31)
    T, d, h, E = 400, 16, 32, 3
    router_w, _, w1, b1, w2, b2 = _params(rs, E, d, h)
    router_b = np.asarray([4.0, 0.0, -1e9], np.float32)
    x = rs.randn(T, d).astype(np.float32)
    logits = jnp.dot(jnp.asarray(x), router_w) + router_b
    gate_w, eidx = jax_moe.naive_topk_gate(logits, 2)
    gather_idx, _, e_of_tile, w_slot, _ = jax_moe.aligned_expert_layout(
        eidx, E, gate_w=gate_w, weight_dtype=jnp.float32, capacity=capacity)
    xs = x[np.asarray(gather_idx)]
    dy = (rs.randn(*xs.shape) * np.asarray(w_slot)[:, None]).astype(np.float32)
    flags = np.asarray(jax_ffn._bwd_flags(e_of_tile, e_of_tile.shape[0]))
    assert (flags & 2).any() and ((flags & 1) & ~(flags >> 1)).any()
    want = jax_ffn._bwd(jnp.asarray(dy), jnp.asarray(xs), w1, b1, w2,
                        e_of_tile, defer_dw=True)
    args = [_t(a) for a in (xs, w1, b1, w2, e_of_tile)] + [_t(dy)]
    got = torch_ffn.fused_expert_ffn_bwd_defer(*args)
    base = torch_ffn.reference_expert_ffn_bwd(*args)
    for name, g, w, b in zip(("dx", "dw1", "db1", "dw2", "db2"), got, want,
                             base):
        w = np.asarray(w)
        tol = 2e-5 * np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, atol=tol, err_msg=name)
        np.testing.assert_allclose(g.numpy(), b.numpy(), atol=tol,
                                   err_msg=name)
    assert float(got[1][2].abs().max()) == 0.0  # the starved expert

    # SSMV_DEFER_DW=1 sends the fused FFN's backward to K8
    seen = []
    real = torch_ffn.reference_expert_ffn_bwd_defer

    def spy(*a):
        seen.append(1)
        return real(*a)

    monkeypatch.setattr(torch_ffn, "reference_expert_ffn_bwd_defer", spy)
    xs_t = _t(xs).requires_grad_()
    leaves = [_t(a).requires_grad_() for a in (w1, b1, w2, b2)]

    def grads():
        out = torch_ffn.fused_expert_ffn(xs_t, *leaves, _t(e_of_tile))
        return torch.autograd.grad((out * _t(dy)).sum(), [xs_t, *leaves])

    g_base = grads()
    assert not seen
    monkeypatch.setenv("SSMV_DEFER_DW", "1")
    g_defer = grads()
    assert seen == [1]
    for a, b in zip(g_defer, g_base):
        torch.testing.assert_close(a, b, atol=2e-5 * b.abs().max().item(),
                                   rtol=0)
