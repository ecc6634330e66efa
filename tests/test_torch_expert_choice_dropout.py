"""The port's ``expert_choice`` dispatch and expert dropout vs the JAX
package's.

Seeded numpy tokens and weights (T=96, d=16, h=32, E=4, f32) go through
the JAX functions and the port's. ``moe_forward_expert_choice``: y, aux and
the gradients of sum(y * c) by x and every parameter within 2e-5.
Expert dropout, each path with the mask the JAX function draws
(``jax.random.bernoulli(rng, 1 - p, h.shape)``, computed here from the
same key and imposed on the port's ``expert_dropout_mask``): the ragged
form ((T*k, h) in sorted order), the capacity form ((E, C, h)) and
``expert_choice`` ((E, C, h)), y and gradients within 2e-5. The draw's
kept share over 2**20 elements lies within 5 binomial standard deviations
of 1 - p. ``MoEMlp`` routes a training forward under dropout off the
fused kernels as the JAX module does, and runs ``expert_choice`` with the
JAX module's weights.
"""
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

T, D, H, E, K = 96, 16, 32, 4, 2
TOL = 2e-5
P = 0.25
PARAMS = ("router_w", "router_b", "w1", "b1", "w2", "b2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return dict(
        router_w=(rs.randn(D, E) * 0.5).astype(np.float32),
        router_b=(rs.randn(E) * 0.1).astype(np.float32),
        w1=(rs.randn(E, D, H) * 0.1).astype(np.float32),
        b1=(rs.randn(E, H) * 0.1).astype(np.float32),
        w2=(rs.randn(E, H, D) * 0.1).astype(np.float32),
        b2=(rs.randn(E, D) * 0.1).astype(np.float32),
        x=rs.randn(T, D).astype(np.float32),
        c=rs.randn(T, D).astype(np.float32))


def _jax(fn, data, **kw):
    w = {k: jnp.asarray(data[k]) for k in PARAMS}
    c = jnp.asarray(data["c"])

    def loss(x, w):
        y, aux = fn(x, *(w[k] for k in PARAMS), **kw)
        return jnp.sum(y * c), (y, aux)

    (_, (y, aux)), (dx, dw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(data["x"]), w)
    out = {"y": y, "dx": dx, **aux, **{"d" + k: v for k, v in dw.items()}}
    return {k: np.asarray(v) for k, v in out.items()}


def _port(fn, data, **kw):
    x = torch.from_numpy(data["x"]).requires_grad_()
    w = {k: torch.from_numpy(data[k]).requires_grad_() for k in PARAMS}
    y, aux = fn(x, *w.values(), **kw)
    (y * torch.from_numpy(data["c"])).sum().backward()
    out = {"y": y.detach(), "dx": x.grad, **aux,
           **{"d" + k: v.grad for k, v in w.items()}}
    return {k: v.detach().numpy() for k, v in out.items()}


def _match(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=TOL, rtol=0, err_msg=k)


def _impose(monkeypatch, key, shape_want):
    """The port draws the mask JAX draws from ``key``; returns it."""
    mask = np.asarray(jax.random.bernoulli(key, 1.0 - P, shape_want))
    drawn = []

    def fake(shape, drop_rate, device):
        assert tuple(shape) == tuple(shape_want) and drop_rate == P
        drawn.append(shape)
        return torch.from_numpy(mask.copy())

    monkeypatch.setattr(torch_moe, "expert_dropout_mask", fake)
    return mask, drawn


@pytest.mark.parametrize("factor", [2.0, 0.5])
def test_expert_choice_matches_jax(factor):
    """At factor 2.0 (C = 56 of 96 tokens per expert) and 0.5 (C = 16,
    most tokens unserved: drop_fraction well above 0)."""
    data = _inputs(0)
    want = _jax(jax_moe.moe_forward_expert_choice, data,
                capacity_factor=factor)
    got = _port(torch_moe.moe_forward_expert_choice, data,
                capacity_factor=factor)
    _match(got, want)
    assert got["balance_loss"] == 0.0
    assert (got["drop_fraction"] > 0.3) == (factor == 0.5)
    assert torch_moe.expert_choice_capacity(T, E, factor) == (
        56 if factor == 2.0 else 16)


def test_ragged_dropout_matches_jax(monkeypatch):
    data = _inputs(1)
    key = jax.random.PRNGKey(3)
    mask, drawn = _impose(monkeypatch, key, (T * K, H))
    want = _jax(jax_moe.moe_forward_ragged, data, top_k=K, dropout_rng=key,
                drop_rate=P)
    got = _port(torch_moe.moe_forward_ragged, data, top_k=K, drop_rate=P)
    _match(got, want)
    assert len(drawn) == 1 and 0.6 < mask.mean() < 0.9


def test_capacity_dropout_matches_jax(monkeypatch):
    data = _inputs(2)
    key = jax.random.PRNGKey(4)
    C = torch_moe.compute_capacity(T, E, K, 0.5)
    _, drawn = _impose(monkeypatch, key, (E, C, H))
    want = _jax(jax_moe.moe_forward, data, top_k=K, capacity_factor=0.5,
                dropout_rng=key, drop_rate=P)
    got = _port(torch_moe.moe_forward, data, top_k=K, capacity_factor=0.5,
                drop_rate=P)
    _match(got, want)
    assert len(drawn) == 1 and got["drop_fraction"] > 0.0


def test_expert_choice_dropout_matches_jax(monkeypatch):
    data = _inputs(3)
    key = jax.random.PRNGKey(5)
    C = torch_moe.expert_choice_capacity(T, E, 2.0)
    _, drawn = _impose(monkeypatch, key, (E, C, H))
    want = _jax(jax_moe.moe_forward_expert_choice, data, capacity_factor=2.0,
                dropout_rng=key, drop_rate=P)
    got = _port(torch_moe.moe_forward_expert_choice, data,
                capacity_factor=2.0, drop_rate=P)
    _match(got, want)
    assert len(drawn) == 1


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_draw_keeps_one_minus_p(p):
    """The kept share of 2**20 draws is within 5 binomial standard
    deviations of 1 - p, and a second draw is another mask."""
    n = 1 << 20
    torch.manual_seed(0)
    a = torch_moe.expert_dropout_mask((1024, 1024), p, torch.device("cpu"))
    b = torch_moe.expert_dropout_mask((1024, 1024), p, torch.device("cpu"))
    sd = np.sqrt(n * p * (1 - p))
    assert abs(float(a.sum()) - n * (1 - p)) < 5 * sd
    assert a.dtype == torch.bool and not torch.equal(a, b)


@pytest.mark.parametrize("mode,training,drop,runs", [
    ("fused", True, 0.1, "ragged"), ("capacity_fused", True, 0.1, "capacity"),
    ("capacity_fused_a2a", True, 0.1, "capacity"),
    ("fused", False, 0.1, "fused"), ("fused", True, 0.0, "fused"),
    ("expert_choice", True, 0.1, "expert_choice"),
    ("capacity", True, 0.1, "capacity")])
def test_moe_mlp_routes_dropout_off_the_fused_kernels(mode, training, drop,
                                                      runs):
    """JAX ``MoEMlp`` (:95-102): the fused forms have no dropout path, so a
    training forward under dropout runs 'ragged' (dropless) or
    'capacity'; eval forwards and drop 0 keep the fused form."""
    m = MoEMlp(D, H, num_experts=E, top_k=K, drop=drop, dispatch_mode=mode)
    m.init_weights(torch.Generator().manual_seed(0))
    m.train(training)
    assert m.dispatch() == runs
    y = m(torch.randn(2, 9, D))
    assert y.shape == (2, 9, D) and torch.isfinite(y).all()


def test_moe_mlp_expert_choice_matches_jax_module():
    rs = np.random.RandomState(4)
    x = rs.randn(2, 17, 32).astype(np.float32)
    jm = JaxMoEMlp(num_experts=4, top_k=2, hidden_features=64,
                   dispatch_mode="expert_choice")
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    m = MoEMlp(32, 64, num_experts=4, top_k=2, dispatch_mode="expert_choice")
    m.load_state_dict(from_jax_params(variables["params"]))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
