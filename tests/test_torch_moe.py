"""PyTorch port's MoE dispatch and expert FFN vs the JAX package.

Same seeded numpy inputs through the JAX functions (the fused expert-FFN
Pallas kernel in interpret mode, as tests/test_fused_ffn.py runs it) and
the port's CPU path. Tolerances: f32 2e-5 (as test_fused_ffn.py); bf16 3e-2
(the JAX kernel's bf16 GELU is a polynomial within 5.7e-4 of the exact GELU
the port uses, before the bf16 roundings of g and y).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.moe import MoEMlp as JaxMoEMlp
from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn
from slim_switch_moe_vit_tpu_torch.ops import moe as torch_moe
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rs, E, d, h):
    return [rs.randn(d, E) * 0.1, rs.randn(E) * 0.01,
            rs.randn(E, d, h) * 0.05, rs.randn(E, h) * 0.01,
            rs.randn(E, h, d) * 0.05, rs.randn(E, d) * 0.01]


def _both(arrays, dtype="float32"):
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return ([jnp.asarray(a, jnp.dtype(dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def test_topk_gate_matches_jax_including_ties():
    rs = np.random.RandomState(0)
    logits = rs.randn(64, 8).astype(np.float32)
    logits[:8, 3] = logits[:8, 5] = 9.0   # tie for first: index 3 wins
    logits[8:16, 1] = 7.0
    logits[8:16, 6] = 7.0                  # tie for first: index 1 wins
    wj, ij = jax_moe.naive_topk_gate(jnp.asarray(logits), 2)
    wt, it = torch_moe.naive_topk_gate(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-6)
    assert (it[:8, 0] == 3).all() and (it[:8, 1] == 5).all()


@pytest.mark.parametrize("T,E", [(37, 4), (300, 8), (5, 8)])
def test_aligned_layout_matches_jax(T, E):
    """Same slots, same gathered tokens, same tile owners; Tp and the
    one-tile-per-expert minimum included (T=5 leaves experts empty)."""
    eidx = np.random.RandomState(T).randint(0, E, (T, 2)).astype(np.int32)
    gj, pj, ej, _, kj = jax.jit(jax_moe.aligned_expert_layout,
                                static_argnums=1)(jnp.asarray(eidx), E)
    gt, pt, et, wt, kt = torch_moe.aligned_expert_layout(
        torch.from_numpy(eidx).long(), E)
    assert wt is None and kt.all()
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    assert et.dtype == torch.int32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_ffn_matches_jax_kernel(dtype):
    rs = np.random.RandomState(1)
    E, d, h, T = 4, 32, 64, 150
    eidx = rs.randint(0, E, (T, 2)).astype(np.int32)
    gather_idx, _, e_of_tile, _, _ = jax_moe.aligned_expert_layout(
        jnp.asarray(eidx), E)
    x = rs.randn(T, d).astype(np.float32)
    xs = x[np.asarray(gather_idx)]
    _, _, w1, b1, w2, b2 = _params(rs, E, d, h)
    (jxs, jw1, jw2), (txs, tw1, tw2) = _both([xs, w1, w2], dtype)
    (jb1, jb2), (tb1, tb2) = _both([b1, b2])
    want = jax.jit(jax_ffn.fused_expert_ffn)(jxs, jw1, jb1, jw2, jb2,
                                             e_of_tile)
    got = torch_ffn.fused_expert_ffn(
        txs, tw1, tb1, tw2, tb2, torch.tensor(np.asarray(e_of_tile)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_fused_matches_jax(dtype):
    rs = np.random.RandomState(2)
    T, d, h, E = 200, 24, 48, 8
    x = rs.randn(T, d)
    (jx,), (tx,) = _both([x], dtype)
    jp, tp = _both(_params(rs, E, d, h))
    want, _ = jax.jit(partial(jax_moe.moe_forward_fused, top_k=2))(jx, *jp)
    got, _ = torch_moe.moe_forward_fused(tx, *tp, top_k=2)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_plain_oracles_match_jax_and_the_fused_path():
    rs = np.random.RandomState(3)
    T, d, h, E = 96, 32, 64, 4
    (jx,), (tx,) = _both([rs.randn(T, d)])
    jp, tp = _both(_params(rs, E, d, h))
    dense_j = np.asarray(jax.jit(partial(jax_moe.moe_dense, top_k=2))(jx, *jp))
    ragged_j, _ = jax.jit(partial(jax_moe.moe_forward_ragged, top_k=2))(
        jx, *jp)
    for fn in (torch_moe.moe_dense, torch_moe.moe_forward_ragged,
               torch_moe.moe_forward_fused):
        got, _ = fn(tx, *tp, top_k=2)
        np.testing.assert_allclose(got.numpy(), dense_j, atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(
        torch_moe.moe_forward_ragged(tx, *tp, top_k=2)[0].numpy(),
        np.asarray(ragged_j), atol=2e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_moe_mlp():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 17, 32).astype(np.float32)
    jm = JaxMoEMlp(num_experts=4, top_k=2, hidden_features=64,
                   dispatch_mode="fused")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return x, variables, jax.jit(jm.apply)(variables, jnp.asarray(x))


@pytest.mark.parametrize("mode", ["auto", "fused", "ragged", "dense",
                                  "capacity", "capacity_fused",
                                  "capacity_fused_a2a"])
def test_moe_mlp_module_matches_jax(jax_moe_mlp, mode):
    """The module with the JAX module's weights, every ported mode (the
    capacity modes at the default factor 2.0, which drops nothing here)."""
    x, variables, want = jax_moe_mlp
    m = MoEMlp(32, 64, num_experts=4, top_k=2, dispatch_mode=mode)
    m.load_state_dict(from_jax_params(variables["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("mode", ["expert_choice"])
def test_unported_dispatch_modes_raise(mode):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MoEMlp(32, 64, dispatch_mode=mode)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w_slot_and_balance_loss_match_jax(dtype):
    """The layout's combine weight per slot (bf16 at bf16 activations, as
    the JAX package's packed table gives it), the balance loss and aux."""
    rs = np.random.RandomState(5)
    T, d, h, E = 90, 16, 32, 4
    logits = rs.randn(T, E).astype(np.float32)
    gw, ei = jax_moe.naive_topk_gate(jnp.asarray(logits), 2)
    _, _, _, wj, _ = jax_moe.aligned_expert_layout(
        ei, E, gate_w=gw, weight_dtype=jnp.dtype(dtype))
    tg, ti = torch_moe.naive_topk_gate(torch.from_numpy(logits), 2)
    *_, wt, _ = torch_moe.aligned_expert_layout(
        ti, E, gate_w=tg, weight_dtype=getattr(torch, dtype))
    assert wt.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(wt.float().numpy(), np.asarray(wj, np.float32),
                               rtol=1e-6)
    np.testing.assert_allclose(
        torch_moe.load_balance_loss(torch.from_numpy(logits), ti, E).numpy(),
        np.asarray(jax_moe.load_balance_loss(jnp.asarray(logits), ei, E)),
        rtol=1e-6)
    x = rs.randn(T, d)
    (jx,), (tx,) = _both([x], dtype)
    jp, tp = _both(_params(rs, E, d, h))
    _, ja = jax.jit(partial(jax_moe.moe_forward_fused, top_k=2))(jx, *jp)
    _, ta = torch_moe.moe_forward_fused(tx, *tp, top_k=2)
    assert ta.keys() == ja.keys() == {"balance_loss", "drop_fraction"}
    for k in ja:
        assert ta[k].dtype == torch.float32 and ta[k].dim() == 0
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]),
                                   rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_moe_forward_fused_gradients_match_jax(dtype, tol):
    """jax.grad of sum(y * c) + 0.1 * balance_loss through the JAX fused
    dispatch (custom backwards of the gather and combine, the Pallas FFN
    backward in interpret mode) vs the port's autograd, for x, the router
    and every expert parameter. Each gradient within tol * its max |ref|
    (bf16: the JAX package's polynomial GELU/GELU', the bf16 rowsum of
    d_gate in another order)."""
    rs = np.random.RandomState(6)
    T, d, h, E = 120, 32, 64, 4
    x, c = rs.randn(T, d), rs.randn(T, d)
    (jx,), (tx,) = _both([x], dtype)
    jp, tp = _both(_params(rs, E, d, h))
    jc = jnp.asarray(c, jnp.dtype(dtype))

    def jloss(x, *p):
        y, aux = jax_moe.moe_forward_fused(x, *p, top_k=2)
        return (y.astype(jnp.float32) * jc.astype(jnp.float32)).sum() \
            + 0.1 * aux["balance_loss"]

    want = jax.jit(jax.grad(jloss, argnums=tuple(range(7))))(jx, *jp)
    tx.requires_grad_()
    for p in tp:
        p.requires_grad_()
    y, aux = torch_moe.moe_forward_fused(tx, *tp, top_k=2)
    loss = (y.float() * torch.from_numpy(c.astype(np.float32)).to(
        y.dtype).float()).sum() + 0.1 * aux["balance_loss"]
    got = torch.autograd.grad(loss, [tx, *tp])
    names = ["x", "router_w", "router_b", "w1", "b1", "w2", "b2"]
    for name, g, w in zip(names, got, want):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=tol * np.abs(w).max(), err_msg=name)
