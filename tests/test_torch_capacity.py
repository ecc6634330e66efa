"""The port's capacity dispatch vs the JAX package's.

Same seeded numpy inputs through both packages on the CPU, in f32:

- exact equality for ``compute_capacity``, ``make_dispatch`` (token-major,
  then choice-order priority) and the capacity form of
  ``aligned_expert_layout`` (all five outputs, dropped pairs pointing at the
  always-padding last slot and absent from the slot table);
- the scatter-buffer ``moe_forward`` and the fused capacity form
  ``moe_forward_fused(capacity_factor=...)`` (its FFN on the expert-FFN
  kernels' plain versions) against JAX's ``moe_forward`` at factors 2.0
  (nothing dropped), 0.75 and 0.25: y within atol 2e-5, ``drop_fraction``
  within 1e-6, the gradients dx, dW1 and db2 within atol 5e-5, the JAX
  package's own limits for its fused capacity form
  (tests/test_moe_ops.py::test_capacity_fused_matches_scatter_capacity);
- ``MoEMlp`` in the three capacity modes with the JAX module's weights,
  the train factor in training mode and the eval factor otherwise, against
  the JAX module with ``deterministic`` False and True.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.moe import MoEMlp as JaxMoEMlp
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.ops import moe as torch_moe
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rs, E, d, h):
    return [rs.randn(d, E) * 0.2, rs.randn(E) * 0.01,
            rs.randn(E, d, h) * 0.2, rs.randn(E, h) * 0.1,
            rs.randn(E, h, d) * 0.2, rs.randn(E, d) * 0.1]


def _both(arrays):
    arrays = [np.asarray(a, np.float32) for a in arrays]
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("tokens,E,k,factor", [
    (25_216, 8, 2, 1.25), (25_216, 8, 2, 2.0), (37, 4, 2, 0.75),
    (37, 4, 2, 0.25), (5, 8, 2, 2.0), (100, 3, 1, 1.1)])
def test_compute_capacity_matches_jax(tokens, E, k, factor):
    want = jax_moe.compute_capacity(tokens, E, k, factor)
    assert torch_moe.compute_capacity(tokens, E, k, factor) == want
    if (tokens, factor) == (25_216, 1.25):  # bench.py's cfg4
        assert want == 7_888
        assert torch_moe.capacity_region_rows(want) == 7_936


@pytest.mark.parametrize("T,E,capacity", [(37, 4, 8), (200, 8, 40),
                                          (64, 4, 100)])
def test_make_dispatch_matches_jax(T, E, capacity):
    eidx = np.random.RandomState(T).randint(0, E, (T, 2)).astype(np.int32)
    dj, kj = jax_moe.make_dispatch(jnp.asarray(eidx), E, capacity)
    dt, kt = torch_moe.make_dispatch(torch.from_numpy(eidx).long(), E,
                                     capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))


@pytest.mark.parametrize("T,E,capacity", [(37, 4, 8), (300, 3, 130),
                                          (40, 8, 300)])
def test_capacity_layout_matches_jax(T, E, capacity):
    """All five outputs exactly, with a router skewed to expert 0 so that
    its pairs overflow the capacity (both sides take JAX's gate weights:
    the two softmaxes may differ by an ulp)."""
    rs = np.random.RandomState(capacity)
    logits = rs.randn(T, E).astype(np.float32)
    logits[:, 0] += 1.5
    gj, ej = jax_moe.naive_topk_gate(jnp.asarray(logits), 2)
    want = jax_moe.aligned_expert_layout(ej, E, gate_w=gj,
                                         weight_dtype=jnp.float32,
                                         capacity=capacity)
    _, et = torch_moe.naive_topk_gate(torch.from_numpy(logits), 2)
    gt = torch.from_numpy(np.array(gj))
    got = torch_moe.aligned_expert_layout(et, E, gate_w=gt,
                                          weight_dtype=torch.float32,
                                          capacity=capacity)
    for name, a, b in zip(("gather_idx", "pair_slot", "e_of_tile", "w_slot",
                           "keep"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert got[2].dtype == torch.int32
    keep = got[4]
    if capacity < T:
        assert not keep.all()  # the skew overflows expert 0
    assert (got[1][~keep] == got[0].shape[0] - 1).all()
    assert got[3][-1] == 0  # the last slot stays padding


@pytest.mark.parametrize("factor", [2.0, 0.75, 0.25])
def test_capacity_forms_match_jax_moe_forward(factor):
    rs = np.random.RandomState(11)
    T, d, h, E = 37, 16, 32, 4
    (jx,), (tx,) = _both([rs.randn(T, d)])
    jp, tp = _both(_params(rs, E, d, h))
    yj, aj = jax.jit(partial(jax_moe.moe_forward, top_k=2,
                             capacity_factor=factor))(jx, *jp)

    def jloss(x, w1, b2):
        y, _ = jax_moe.moe_forward(x, jp[0], jp[1], w1, jp[3], jp[4], b2,
                                   top_k=2, capacity_factor=factor)
        return jnp.sum(y ** 2)

    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jx, jp[2], jp[5])
    for fn in (torch_moe.moe_forward, torch_moe.moe_forward_fused):
        x, w1, b2 = (t.clone().requires_grad_() for t in (tx, tp[2], tp[5]))
        y, aux = fn(x, tp[0], tp[1], w1, tp[3], tp[4], b2, top_k=2,
                    capacity_factor=factor)
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj),
                                   atol=2e-5, err_msg=fn.__name__)
        np.testing.assert_allclose(aux["drop_fraction"].item(),
                                   float(aj["drop_fraction"]), atol=1e-6)
        np.testing.assert_allclose(aux["balance_loss"].item(),
                                   float(aj["balance_loss"]), rtol=1e-5)
        y.square().sum().backward()
        for name, g, w in zip(("dx", "dW1", "db2"), (x, w1, b2), gj):
            np.testing.assert_allclose(g.grad.numpy(), np.asarray(w),
                                       atol=5e-5,
                                       err_msg=f"{fn.__name__} {name}")
    # f32 1 - mean(keep) is within an ulp of 0 when nothing drops
    assert (abs(float(aj["drop_fraction"])) < 1e-6) == (factor == 2.0)


@pytest.mark.parametrize("mode", ["capacity", "capacity_fused",
                                  "capacity_fused_a2a"])
def test_moe_mlp_capacity_modes_match_jax(mode):
    """Train factor 0.25 in training mode (capacity 8 of 34 tokens), eval
    factor 0.75 otherwise (capacity 16): both drop pairs here, by different
    amounts."""
    rs = np.random.RandomState(12)
    x = rs.randn(2, 17, 16).astype(np.float32)
    jm = JaxMoEMlp(num_experts=4, top_k=2, hidden_features=32,
                   dispatch_mode=mode, capacity_factor=0.25,
                   eval_capacity_factor=0.75)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    m = MoEMlp(16, 32, num_experts=4, top_k=2, dispatch_mode=mode,
               capacity_factor=0.25, eval_capacity_factor=0.75)
    m.load_state_dict(from_jax_params(variables["params"]))
    drops = []
    for train in (True, False):
        want, sown = jax.jit(partial(jm.apply, deterministic=not train,
                                     mutable=["moe_metrics"]))(
            variables, jnp.asarray(x))
        m.train(train)
        with torch.no_grad():
            got = m(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   err_msg=f"train={train}")
        drop = float(sown["moe_metrics"]["drop_fraction"])
        np.testing.assert_allclose(m.aux["drop_fraction"].item(), drop,
                                   atol=1e-6)
        drops.append(drop)
    assert drops[0] > drops[1] > 1e-3


@pytest.mark.parametrize("mode,falls_to", [("fused", "ragged"),
                                           ("capacity_fused", "capacity"),
                                           ("capacity_fused_a2a", "capacity")])
def test_odd_hidden_falls_back_as_jax(mode, falls_to):
    """An odd hidden size sends the fused modes to their plain forms, as the
    JAX module does; the outputs agree with the JAX module's."""
    rs = np.random.RandomState(13)
    x = rs.randn(2, 9, 16).astype(np.float32)
    jm = JaxMoEMlp(num_experts=4, top_k=2, hidden_features=33,
                   dispatch_mode=mode, capacity_factor=0.75)
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x))
    want = jax.jit(partial(jm.apply, deterministic=False))(
        variables, jnp.asarray(x))
    m = MoEMlp(16, 33, num_experts=4, top_k=2, dispatch_mode=mode,
               capacity_factor=0.75)
    assert m.mode == falls_to
    m.load_state_dict(from_jax_params(variables["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
