"""The port's fused AdamW + EMA (K7) vs the JAX package's, and the state it
shares with ``torch.optim.AdamW``.

1. ``fused_adamw_ema`` on CPU tensors (its plain version) against the JAX
   ``fused_adamw_ema`` (its Pallas kernel in interpret mode for the leaves
   that fill whole 1024-lane rows, its plain jnp math for the others), on
   the same numpy-seeded leaves: odd and row-sized shapes, weight-decay and
   gate-lr flags mixed, with and without an EMA, at steps t = 1 and 3. Both
   sides do the same f32 operations in the same order: bit-identical but
   for an FMA contraction XLA may make, so within 2 ulps (2^-22) of each
   leaf's largest |ref|. The bias corrections 1/(1-b^t) are JAX's, in f32.
2. The fused step (``update_fn.fused_apply``) and ``torch.optim.AdamW``'s
   own step (with the engine's ``ema_update``) read and write the same
   state (``exp_avg``, ``exp_avg_sq``, ``step``). From the same state and
   the same gradients, at a fresh state and after two steps, one step of
   each lands in the same place; so does a run that switches paths between
   steps; and a ``state_dict`` written on the fused path loads into a fresh
   AdamW unchanged. torch's AdamW decays p first and divides by
   sqrt(nu)/sqrt(bc2) + eps, and lerps the first moment; the JAX math adds
   wd*p to the Adam update and forms b1*mu + (1-b1)*g. The same function in
   another order, a few roundings apart per element: moments within 8
   ulps (2^-20) of each leaf's largest |ref|. The JAX math also takes its
   bias corrections in f32, where 1 - 0.999^t keeps up to ~3e-5/t of
   relative error (torch's are double), so each step's update u, |u| <~ 1,
   differs by up to that fraction: parameters and EMA within 8 ulps of the
   leaf's largest |ref| plus 1e-4 * lr per step (6.6e-6 * lr measured at
   t = 1).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_adamw as jax_fused
from slim_switch_moe_vit_tpu_torch import engine, optim
from slim_switch_moe_vit_tpu_torch.models.resmoe import ResMoEBlock
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.ops import fused_adamw
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state

SHAPES = {"a": (8, 1024), "b": (7, 3), "c": (16, 1024), "d": (33,),
          "e": (3, 1024), "f": (1,)}
WD = {"a": True, "b": False, "c": True, "d": True, "e": False, "f": True}
GATE = {"a": False, "b": True, "c": True, "d": False, "e": False, "f": True}
KERNEL_ULPS = 2.0 ** -22
PATH_ULPS = 2.0 ** -20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(seed):
    rs = np.random.RandomState(seed)

    def tree(scale, positive=False):
        t = {k: (rs.randn(*s) * scale).astype(np.float32)
             for k, s in SHAPES.items()}
        return {k: np.abs(v) for k, v in t.items()} if positive else t

    p = tree(0.1)
    return p, tree(1e-2), tree(1e-3), tree(1e-5, True), {
        k: v + rs.randn(*v.shape).astype(np.float32) * 1e-3
        for k, v in p.items()}


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("with_ema", [True, False])
def test_plain_version_matches_jax_fused_adamw(t, with_ema):
    p, g, mu, nu, ema = _leaves(t)
    if t == 1:  # a fresh state
        mu = {k: np.zeros_like(v) for k, v in mu.items()}
        nu = {k: np.zeros_like(v) for k, v in nu.items()}
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.05,
              ema_decay=0.99 if with_ema else None)
    j = lambda tree: {k: jnp.asarray(v) for k, v in tree.items()}  # noqa: E731
    want = jax_fused.fused_adamw_ema(
        j(p), j(g), j(mu), j(nu), j(ema) if with_ema else None,
        jnp.asarray(t - 1, jnp.int32), jnp.float32(1e-3), jnp.float32(3e-3),
        WD, GATE, **kw)
    assert int(want[4]) == t
    names = sorted(SHAPES)
    tt = lambda tree: [torch.from_numpy(tree[k].copy()) for k in names]  # noqa: E731
    got = [tt(p), tt(g), tt(mu), tt(nu), tt(ema) if with_ema else None]
    bc1, bc2 = fused_adamw.bias_corrections(0.9, 0.999, t)
    tf = jnp.float32(t)
    assert (np.float32(bc1), np.float32(bc2)) == (
        np.float32(1.0 / (1.0 - 0.9 ** tf)), np.float32(1.0 / (1.0 - 0.999 ** tf)))
    fused_adamw.fused_adamw_ema(
        *got, [WD[k] for k in names], [GATE[k] for k in names], lr_base=1e-3,
        lr_gate=3e-3, bc1=bc1, bc2=bc2, **kw)
    for what, g_leaves, w_tree in zip(("p", "mu", "nu", "ema"),
                                      (got[0], got[2], got[3], got[4]),
                                      want[:4]):
        if w_tree is None:
            assert g_leaves is None
            continue
        for k, a in zip(names, g_leaves):
            w = np.asarray(w_tree[k])
            np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                       atol=KERNEL_ULPS * np.abs(w).max(),
                                       err_msg=f"{what} {k}")


CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
LR, LR_GATE, EMA = 1e-3, 3e-3, 0.9
BC_REL = 1e-4


def _model():
    def block(idx, **bk):
        return ResMoEBlock(num_experts=4, top_k=2, **bk)

    model = VisionTransformer(block_factory=block, **CFG)
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _set_grads(model, seed):
    rs = np.random.RandomState(seed)
    for _, p in model.named_parameters():
        p.grad = torch.from_numpy(
            (rs.randn(*p.shape) * 1e-2).astype(np.float32))


def _state(warm_steps):
    """A model, its AdamW (the port's four groups) and EMA after
    ``warm_steps`` torch steps on seeded gradients."""
    model = _model()
    opt_init, update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cpu", opt_init=opt_init,
                               use_ema=True)
    for i in range(warm_steps):
        _set_grads(model, 100 + i)
        _step(False, update, state)
    return model, state, update, opt_init


def _step(fused, update, state):
    if fused:
        update.fused_apply(state.model, state.optimizer, state.ema_params, LR,
                           LR_GATE, EMA)
    else:
        update(state.optimizer, LR, LR_GATE)
        engine.ema_update(state.ema_params, state.model, EMA)


def _snapshot(state):
    out = {"param": {n: p.detach().clone()
                     for n, p in state.model.named_parameters()},
           "ema": {n: e.clone() for n, e in state.ema_params.items()}}
    for key in ("exp_avg", "exp_avg_sq"):
        out[key] = {n: state.optimizer.state[p][key].clone()
                    for n, p in state.model.named_parameters()}
    out["step"] = {n: float(state.optimizer.state[p]["step"])
                   for n, p in state.model.named_parameters()}
    return out


def _close(got, want, steps):
    assert got["step"] == want["step"]
    for what in ("param", "ema", "exp_avg", "exp_avg_sq"):
        bc = steps * BC_REL * LR_GATE if what in ("param", "ema") else 0.0
        for k, w in want[what].items():
            np.testing.assert_allclose(
                got[what][k].numpy(), w.numpy(), rtol=0,
                atol=PATH_ULPS * w.abs().max().item() + bc,
                err_msg=f"{what} {k}")


def _run(paths, warm_steps):
    model, state, update, _ = _state(warm_steps)
    for i, fused in enumerate(paths):
        _set_grads(model, i)
        _step(fused, update, state)
    return _snapshot(state), state


@pytest.mark.parametrize("warm_steps", [0, 2])
def test_one_fused_step_equals_one_torch_adamw_step(warm_steps):
    want, _ = _run((False,), warm_steps)
    got, state = _run((True,), warm_steps)
    _close(got, want, 1)
    assert all(v == warm_steps + 1 for v in got["step"].values())
    for n, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}, n
        assert st["step"].device.type == "cpu" and st["step"].dim() == 0
    gate_groups = [g for g in state.optimizer.param_groups if g["gate"]]
    assert gate_groups and all(g["lr"] == LR_GATE for g in gate_groups)


@pytest.mark.parametrize("paths", [(True, False, True), (False, True, False)])
def test_runs_switch_between_the_fused_and_torch_paths(paths):
    want, _ = _run((False,) * len(paths), 0)
    got, _ = _run(paths, 0)
    _close(got, want, len(paths))


def test_fused_state_dict_loads_into_a_fresh_adamw():
    _, state = _run((True, True), 0)
    model, _, _, opt_init = _state(0)
    model.load_state_dict(state.model.state_dict())
    fresh = opt_init(model)
    fresh.load_state_dict(state.optimizer.state_dict())
    for (n, p), q in zip(state.model.named_parameters(), model.parameters()):
        a, b = state.optimizer.state[p], fresh.state[q]
        assert set(a) == set(b) == {"step", "exp_avg", "exp_avg_sq"}, n
        for key in a:
            assert torch.equal(a[key], b[key]), (n, key)
