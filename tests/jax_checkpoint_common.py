"""Shared pieces of the tests of carrying a JAX run to the port
(``tests/test_torch_jax_checkpoint*.py``): a run of the JAX trainer's own
train step and ``save_checkpoint`` on ``resmoe_tiny_patch16_224_expert8``
at 32 px with 10 classes, the converter
(``scripts/jax_checkpoint_to_npz.py``), the port's state to import it
into, and the checks of the import and of one more step.

The model runs with 2 experts (the driver's ``--num-experts 2``, as
tests/test_torch_driver_surface.py runs it): a checkpoint with 8 is ~490
MB of arrays, and writing, converting and reading it took
tests/test_torch_jax_checkpoint.py to 67 s alone on the CPU (35-40 s with
2), where the mapping is the same for any expert count. Both
packages' weights start from the port's seeded init, carried into the JAX
tree by ``to_jax_tree`` (the JAX init compiles for ~13 s on the CPU).
Dropout and drop path are 0 and both sides dispatch ``'ragged'``, so a
step on a given batch is the same function on both sides.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from slim_switch_moe_vit_tpu import engine as jax_engine
from slim_switch_moe_vit_tpu import losses as jax_losses
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.models import create_model as jax_create_model
from slim_switch_moe_vit_tpu.train_state import TrainState as JaxTrainState
from slim_switch_moe_vit_tpu.utils import checkpoint as jax_checkpoint
from slim_switch_moe_vit_tpu_torch import create_model, engine, losses, optim
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import to_jax_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "resmoe_tiny_patch16_224_expert8"
KW = dict(num_classes=10, img_size=32, drop_rate=0.0, drop_path_rate=0.0,
          dispatch_mode="ragged")
EXPERTS = 2
B, LR, GATE_LR, WD, EMA, BALANCE = 4, 1e-3, 2e-3, 0.05, 0.99, 0.01
GATE_LEAVES = ("threshold", "target_threshold", "enabled")
# the f32 parity limits of tests/test_torch_train.py: the loss within rtol
# 1e-4, each leaf's move from the shared weights within MOVE_REL of its
# largest JAX move
LOSS_RTOL, MOVE_REL = 1e-4, 5e-2


def converter():
    """``scripts/jax_checkpoint_to_npz.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_npz",
        os.path.join(REPO, "scripts", "jax_checkpoint_to_npz.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def batch(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(B, 32, 32, 3).astype(np.float32),
            rs.randint(0, 10, B).astype(np.int32))


def port_model(seed=0):
    return create_model(MODEL, num_experts=EXPERTS,
                        generator=torch.Generator().manual_seed(seed), **KW)


def jax_trees(model):
    """(params, gates) of the JAX package's layout from a port model."""
    sd = model.state_dict()
    gates = {k: v for k, v in sd.items() if k.split(".")[-1] in GATE_LEAVES}
    params = {k: v for k, v in sd.items() if k not in gates}
    return (jax.tree.map(jnp.asarray, to_jax_tree(params)),
            jax.tree.map(jnp.asarray, to_jax_tree(gates)))


def jax_state(model, opt="adamw", clip_grad=None):
    """The JAX train state of ``model``'s weights with an EMA, and its
    update function."""
    params, gates = jax_trees(model)
    init, update = jax_optim.make_optimizer(params, opt=opt, weight_decay=WD,
                                            clip_grad=clip_grad)
    state = JaxTrainState(
        params=params, opt_state=init(params), gates=gates,
        ema_params=jax.tree.map(jnp.copy, params),
        rng=jax.random.PRNGKey(7), step=jnp.asarray(0, jnp.int32))
    return state, update


def jax_train_step(update):
    """The JAX package's own train step (``engine.make_train_step``)."""
    model = jax_create_model(MODEL, num_experts=EXPERTS, **KW)
    return jax_engine.make_train_step(
        model, update, jax_losses.make_base_criterion(False, 0.0, False),
        ema_decay=EMA, moe_balance_weight=BALANCE, donate=False)


def jax_step(step, state, x, y):
    state, metrics = step(state, jnp.asarray(x), jnp.asarray(y),
                          jnp.float32(LR), jnp.float32(GATE_LR))
    return state, float(metrics["loss"])


def save_and_convert(state, tmp, epoch=4, extra=None):
    """The JAX ``save_checkpoint`` of ``state``, converted; returns the
    ``.npz`` path."""
    ckpt = str(tmp / "checkpoint")
    jax_checkpoint.save_checkpoint(ckpt, state, epoch, extra=extra)
    out = str(tmp / "run.npz")
    converter().convert(ckpt, out)
    return out


def port_state(opt="adamw", clip_grad=None):
    """A fresh port state of the same model with an EMA (other weights:
    the import must overwrite them), and its update function."""
    init, update = optim.make_optimizer(opt=opt, weight_decay=WD,
                                        clip_grad=clip_grad)
    state = create_train_state(port_model(seed=1), device="cpu",
                               opt_init=init, use_ema=True)
    return state, update


def port_train_step(model, update, fused=False):
    return engine.make_train_step(
        model, update, losses.make_base_criterion(False, 0.0, False),
        ema_decay=EMA, moe_balance_weight=BALANCE, use_fused_optimizer=fused)


def port_step(step, state, x, y):
    state, metrics = step(state, torch.from_numpy(x),
                          torch.from_numpy(y.astype(np.int64)), LR, GATE_LR)
    return state, float(metrics["loss"])


def leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def assert_trees_equal(got, want, what):
    """Leaf by leaf, bit for bit."""
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys(), what
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=f"{what} {k}")


def assert_moves_match(got, want, base, what):
    """Each leaf's move from ``base`` within MOVE_REL of the largest JAX
    move (tests/test_torch_train.py's f32 limit), plus one f32 spacing of
    the leaf's largest value: a move is a difference of two f32 values, so
    it is known to no better than that (an sgd step moves a LayerNorm
    scale near 1.0 by ~20 spacings, and its EMA by ~0.2 of one)."""
    got, want, base = leaves(got), leaves(want), leaves(base)
    assert got.keys() == want.keys() == base.keys(), what
    for k, w in want.items():
        b = base[k].astype(np.float64)
        wm = w.astype(np.float64) - b
        ulp = float(np.spacing(np.abs(w).max().astype(np.float32)))
        np.testing.assert_allclose(got[k] - b, wm, rtol=0,
                                   atol=MOVE_REL * np.abs(wm).max() + ulp,
                                   err_msg=f"{what} move {k}")


def moments(state):
    """The port optimizer's per-parameter state as JAX-layout trees by
    field name, and the ``step`` counts."""
    named = dict(state.model.named_parameters())
    fields = {}
    steps = set()
    for name, p in named.items():
        for k, v in state.optimizer.state[p].items():
            if k == "step":
                steps.add(float(v))
            elif v.dim() > 0:
                fields.setdefault(k, {})[name] = v
    return {k: to_jax_tree(v) for k, v in fields.items()}, steps


# the torch field of each JAX moment, per chain entry kind
MOMENTS = {"adamw": {"exp_avg": "mu", "exp_avg_sq": "nu"},
           "sgd": {"momentum_buffer": "trace"}}


def jax_run(tmp, opt="adamw", clip_grad=None):
    """Two JAX steps with an EMA on one batch, saved at epoch 4 with both
    sidecars and converted; the JAX state after a third step on the same
    batch, and its loss."""
    state, update = jax_state(port_model(), opt=opt, clip_grad=clip_grad)
    step = jax_train_step(update)
    x, y = batch()
    for _ in range(2):
        state, _ = jax_step(step, state, x, y)
    npz = save_and_convert(state, tmp, epoch=4, extra={
        "args": {"opt": opt}, "sched": {"best": 0.5}})
    after, loss = jax_step(step, state, x, y)
    return dict(npz=npz, saved=state, after=after, loss=loss, x=x, y=y,
                opt=opt, clip_grad=clip_grad)


def check_exact_import(run):
    """The import equals the JAX state bit for bit: parameters, EMA, gate
    buffers, the moments of the chain entry (wherever it stands) and its
    count."""
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import \
        restore_checkpoint

    saved = run["saved"]
    state, _ = port_state(opt=run["opt"], clip_grad=run["clip_grad"])
    state, epoch = restore_checkpoint(run["npz"], state)
    assert epoch == 4 and state.step == 2
    assert_trees_equal(to_jax_tree(dict(state.model.named_parameters())),
                       saved.params, "params")
    assert_trees_equal(to_jax_tree(state.ema_params), saved.ema_params,
                       "ema")
    buffers = dict(state.model.named_buffers())
    assert set(buffers) == {n for n in state.model.state_dict()
                            if n.split(".")[-1] in GATE_LEAVES}
    assert_trees_equal(to_jax_tree(buffers), saved.gates, "gates")
    kind = "sgd" if run["opt"] in ("sgd", "nesterov", "momentum") else "adamw"
    entry, = [e for e in saved.opt_state
              if hasattr(e, "_fields") and set(MOMENTS[kind].values())
              <= set(e._fields)]
    got, steps = moments(state)
    assert got.keys() == MOMENTS[kind].keys()
    for field, jax_field in MOMENTS[kind].items():
        assert_trees_equal(got[field], getattr(entry, jax_field), field)
    assert steps == ({float(entry.count)} if kind == "adamw" else set())
    for st in state.optimizer.state.values():
        if "step" in st:
            assert st["step"].device.type == "cpu"
            assert st["step"].dtype == torch.float32
    return state


def check_one_more_step(run, fused=False):
    """One more step on the port from the import, against the JAX third
    step: the loss and every parameter's and EMA leaf's move within the f32
    parity limits."""
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import \
        import_jax_checkpoint

    state, update = port_state(opt=run["opt"], clip_grad=run["clip_grad"])
    state, _ = import_jax_checkpoint(run["npz"], state)
    step = port_train_step(state.model, update, fused=fused)
    state, loss = port_step(step, state, run["x"], run["y"])
    np.testing.assert_allclose(loss, run["loss"], rtol=LOSS_RTOL)
    assert state.step == 3
    base = run["saved"]
    assert_moves_match(to_jax_tree(dict(state.model.named_parameters())),
                       run["after"].params, base.params, "params")
    assert_moves_match(to_jax_tree(state.ema_params),
                       run["after"].ema_params, base.ema_params, "ema")
