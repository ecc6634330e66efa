"""The port's token-skip gates vs the JAX package's.

``TokenGate`` forward values and straight-through gradients against the JAX
module on the same numpy-seeded inputs and head weights, for enabled 0 and
1 and for training (the annealed threshold) and eval (the target). Both
sides compute sigmoid(x . w + b) in f32 with sums in other orders, so the
masks agree within 1e-6 (their STE values are a + b - b in f32, 1 +- an ulp
or 0 +- an ulp) and the gradients within 1e-5 of each one's largest |ref|.
The hard decisions must agree exactly: the inputs are drawn so that no
probability lies within 1e-4 of a threshold (checked).

The trainer-side functions (``build_anneal_plan``, ``anneal``,
``apply_epoch_anneal``, ``disable_all``, ``set_enabled``) must give
bit-identical f32 buffers, in the JAX package's gate order, over every
gate of ``resmoe_tiny_patch16_224_expert8``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models import create_model as jax_create_model
from slim_switch_moe_vit_tpu.models import gates as jax_gates
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.models import gates
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    to_jax_tree,
)

B, N, D = 2, 9, 16
THR, TARGET = 0.6, 0.4
MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, N, D).astype(np.float32)
    params = {"head": {"kernel": (rs.randn(D, 1) * 0.3).astype(np.float32),
                       "bias": np.array([0.1], np.float32)}}
    ct = rs.randn(B, N, 2).astype(np.float32)
    return x, params, ct


def _gate_vars(enabled):
    return {"threshold": np.float32(THR), "target_threshold": np.float32(TARGET),
            "enabled": np.float32(enabled)}


def _jax(x, params, ct, enabled, train):
    gate = jax_gates.TokenGate(starting_threshold=THR, target_threshold=TARGET)

    def f(p, x):
        out, mut = gate.apply({"params": p, "gates": _gate_vars(enabled)}, x,
                              deterministic=not train,
                              mutable=["moe_metrics"])
        return out, mut["moe_metrics"]["skip_fraction"]

    (out, skip), vjp = jax.vjp(f, params, jnp.asarray(x))
    dp, dx = vjp((jnp.asarray(ct), jnp.zeros_like(skip)))
    return np.asarray(out), float(skip), dp, np.asarray(dx)


def _torch(x, params, ct, enabled, train):
    gate = gates.TokenGate(D, THR, TARGET)
    gate.load_state_dict(from_jax_params(params, _gate_vars(enabled)))
    gate.train(train)
    xt = torch.from_numpy(x).requires_grad_()
    out = gate(xt)
    out.backward(torch.from_numpy(ct))
    dp = to_jax_tree({n: p.grad for n, p in gate.named_parameters()})
    with torch.no_grad():
        prob = torch.sigmoid(gate.head(xt))
    return (out.detach().numpy(), float(gate.skip_fraction), dp,
            xt.grad.numpy(), prob.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("enabled", [0.0, 1.0])
@pytest.mark.parametrize("train", [True, False])
def test_token_gate_matches_jax(enabled, train, dtype):
    x, params, ct = _case(0)
    if dtype == "bfloat16":  # the gate casts its input to f32 on both sides
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want, want_skip, want_dp, want_dx = _jax(x, params, ct, enabled, train)
    got, got_skip, got_dp, got_dx, prob = _torch(x, params, ct, enabled,
                                                 train)
    thr = THR if train else TARGET
    assert np.abs(prob - thr).min() > MARGIN  # no decision near the line
    hard = (prob[..., 0] > thr).astype(np.float32)
    assert 0 < hard.mean() < 1  # both decisions occur
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.round(got), np.round(want))
    if enabled:
        np.testing.assert_array_equal(np.round(got[..., 0]), hard)
    else:
        np.testing.assert_array_equal(got, np.stack(
            [np.zeros_like(hard), np.ones_like(hard)], -1))
    np.testing.assert_allclose(got_skip, want_skip, rtol=0, atol=1e-7)
    for k in ("kernel", "bias"):
        w = np.asarray(want_dp["head"][k])
        np.testing.assert_allclose(got_dp["head"][k], w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0,
                               atol=1e-5 * np.abs(want_dx).max())
    if enabled:  # the STE carries d(keep) = -dprob, d(skip) = +dprob
        assert np.abs(want_dp["head"]["kernel"]).max() > 0


def _jax_gate_vars():
    """The JAX model's own ``gates`` collection (shapes from eval_shape,
    values as its initializers give them)."""
    m = jax_create_model("resmoe_tiny_patch16_224_expert8", num_classes=10,
                         img_size=32, starting_threshold=1.0,
                         target_threshold=0.9)
    shapes = jax.eval_shape(
        lambda x: m.init({"params": jax.random.PRNGKey(0)}, x,
                         deterministic=True),
        jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32))["gates"]
    init = {"threshold": 1.0, "target_threshold": 0.9, "enabled": 1.0}
    return jax.tree_util.tree_map_with_path(
        lambda p, s: jnp.asarray(init[p[-1].key], s.dtype), shapes)


def _port_gate_vars(model):
    out = {}
    for path, g in gates.gate_modules(model).items():
        node = out
        for k in path:
            node = node.setdefault(k, {})
        node.update({k: np.float32(getattr(g, k).item())
                     for k in ("threshold", "target_threshold", "enabled")})
    return out


def _assert_same(jax_vars, model):
    want = jax.tree_util.tree_map(lambda a: np.float32(np.asarray(a)),
                                  jax_vars)
    got = _port_gate_vars(model)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.tobytes() == w.tobytes(), (g, w)


@pytest.fixture(scope="module")
def tiny():
    return create_model("resmoe_tiny_patch16_224_expert8", num_classes=10,
                        img_size=32, starting_threshold=1.0,
                        target_threshold=0.9)


@pytest.mark.parametrize("epochs,warmup,offset", [(5, 1, 0.5), (2, 0, 0.0),
                                                  (3, 0, 10.0)])
def test_anneal_plan_and_schedule_match_jax_exactly(tiny, epochs, warmup,
                                                     offset):
    jv = _jax_gate_vars()
    model = tiny
    for g in gates.gate_modules(model).values():  # as built
        g.threshold.fill_(1.0)
        g.enabled.fill_(1.0)
    assert gates.gate_paths(model) == jax_gates.gate_paths(jv)
    assert len(gates.gate_paths(model)) == 24
    _assert_same(jv, model)
    for task in range(2):  # the driver's per-task sequence
        want_plan = jax_gates.build_anneal_plan(jv, epochs, warmup, offset)
        plan = gates.build_anneal_plan(model, epochs, warmup, offset)
        assert plan == want_plan
        jv = jax_gates.disable_all(jv)
        gates.disable_all(model)
        _assert_same(jv, model)
        for epoch in range(epochs):
            jv = jax_gates.apply_epoch_anneal(jv, want_plan, epoch)
            gates.apply_epoch_anneal(model, plan, epoch)
            _assert_same(jv, model)
    path = gates.gate_paths(model)[3]
    jv = jax_gates.set_enabled(jv, path, 0.0)
    gates.set_enabled(model, path, 0.0)
    jv = jax_gates.anneal(jv, path, 0.03125)
    gates.anneal(model, path, 0.03125)
    _assert_same(jv, model)
