"""Every ``--opt`` of the JAX package carried to the port through its
checkpoint, and the import's refusals.

A small gated ResMoE ViT (img 32, patch 8, D=64, 2 blocks, 4 experts: the
model of tests/test_torch_optim_surface.py, all four parameter groups and
the expert tensors) and seeded numpy gradients. For each ``--opt`` the JAX
``make_optimizer`` chain takes two steps, the JAX ``save_checkpoint``
writes the state, ``scripts/jax_checkpoint_to_npz.py`` converts it and
``restore_checkpoint`` reads the ``.npz`` into the port's optimizer:

- every torch field equals its JAX field bit for bit in the parameter's
  layout (adam's ``mu`` / ``nu`` as ``exp_avg`` / ``exp_avg_sq``, nadam's
  ``m``, ``v`` and ``mu_product``, radam's ``m`` / ``v``, adadelta's ``v``
  / ``u`` as ``square_avg`` / ``acc_delta``, rmsprop's ``v`` / ``buf`` as
  ``square_avg`` / ``momentum_buffer``, the sgd family's ``trace`` as
  ``momentum_buffer``), ``step`` equals the chain's ``count`` (the run's
  step where the chain keeps none);
- a third step on both sides lands every parameter within the tolerance of
  tests/test_torch_optim_surface.py (1e-6 of the leaf's largest |ref| plus
  1e-4 lr).

Refusals: a run with an EMA and a file without one (the export CLI's
``--use-ema`` too), a leaf of either side without a counterpart, another
``--opt``'s state, an unfinished Orbax directory and a tree without
``params``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

import jax_checkpoint_common as jc
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.train_state import TrainState as JaxTrainState
from slim_switch_moe_vit_tpu.utils import checkpoint as jax_checkpoint
from slim_switch_moe_vit_tpu_torch import optim
from slim_switch_moe_vit_tpu_torch.models.resmoe import ResMoEBlock
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.serving import export
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    import_jax_checkpoint,
    restore_checkpoint,
    to_jax_tree,
)
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
LR, GATE_LR, WD, MOMENTUM = 1e-3, 2e-3, 0.05, 0.9
REL, SLACK = 1e-6, 1e-4
EPS = {"adadelta": 1e-6}  # the JAX chain fixes it (test_torch_optim_surface)
# the torch field of each JAX field, and where the torch step comes from
FIELDS = {
    "adamw": ({"exp_avg": "mu", "exp_avg_sq": "nu"}, "count"),
    "adam": ({"exp_avg": "mu", "exp_avg_sq": "nu"}, "count"),
    "lamb": ({"exp_avg": "mu", "exp_avg_sq": "nu"}, "count"),
    "nadam": ({"exp_avg": "m", "exp_avg_sq": "v", "mu_product": "mu_product"},
              "count"),
    "radam": ({"exp_avg": "m", "exp_avg_sq": "v"}, "count"),
    "adadelta": ({"square_avg": "v", "acc_delta": "u"}, "run"),
    "rmsprop": ({"square_avg": "v", "momentum_buffer": "buf"}, "run"),
    "sgd": ({"momentum_buffer": "trace"}, None),
    "nesterov": ({"momentum_buffer": "trace"}, None),
    "momentum": ({"momentum_buffer": "trace"}, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0):
    def block(idx, **bk):
        return ResMoEBlock(num_experts=4, top_k=2, **bk)

    model = VisionTransformer(dtype=torch.float32, block_factory=block, **CFG)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def _grads(tree, seed):
    rs = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (rs.randn(*p.shape) * 0.1).astype(np.float32), tree)


def _jax_run(tmp, opt, ema=True, steps=2):
    """``steps`` JAX updates, saved and converted; the chain's state, the
    update and the parameters after the steps."""
    params, gates = jc.jax_trees(_model())
    init, update = jax_optim.make_optimizer(
        params, opt=opt, weight_decay=WD, momentum=MOMENTUM,
        eps=EPS.get(opt, 1e-8))
    opt_state = init(params)
    for s in range(steps):
        g = jax.tree.map(jnp.asarray, _grads(params, 10 + s))
        updates, opt_state = update(g, opt_state, params, LR, GATE_LR)
        params = optax.apply_updates(params, updates)
    state = JaxTrainState(
        params=params, opt_state=opt_state, gates=gates,
        ema_params=(jax.tree.map(lambda p: p * 0.5, params) if ema
                    else None),
        rng=jax.random.PRNGKey(3), step=jnp.asarray(steps, jnp.int32))
    ckpt = str(tmp / f"{opt}_ckpt")
    jax_checkpoint.save_checkpoint(ckpt, state, 1)
    npz = str(tmp / f"{opt}.npz")
    jc.converter().convert(ckpt, npz)
    return dict(npz=npz, state=state, update=update)


def _port_state(opt, ema=True):
    init, update = optim.make_optimizer(opt=opt, weight_decay=WD,
                                        momentum=MOMENTUM,
                                        eps=EPS.get(opt, 1e-8))
    state = create_train_state(_model(seed=1), device="cpu", opt_init=init,
                               use_ema=ema)
    return state, update


@pytest.fixture(scope="module")
def adamw(tmp_path_factory):
    return _jax_run(tmp_path_factory.mktemp("adamw"), "adamw")


@pytest.mark.parametrize("opt", optim.SUPPORTED_OPTIMIZERS)
def test_optimizer_state_imports_and_steps_as_jax(opt, tmp_path):
    run = _jax_run(tmp_path, opt)
    saved = run["state"]
    state, update = _port_state(opt)
    state, epoch = restore_checkpoint(run["npz"], state)
    assert epoch == 1 and state.step == 2
    jc.assert_trees_equal(to_jax_tree(dict(state.model.named_parameters())),
                          saved.params, "params")
    fields, step_from = FIELDS[opt]
    entry, = [e for e in saved.opt_state if hasattr(e, "_fields")
              and set(fields.values()) <= set(e._fields)]
    named = dict(state.model.named_parameters())
    for tf, jf in fields.items():
        want = getattr(entry, jf)
        if tf == "mu_product":
            for p in named.values():
                assert float(state.optimizer.state[p][tf]) == float(want)
            continue
        got = {n: state.optimizer.state[p][tf] for n, p in named.items()}
        jc.assert_trees_equal(to_jax_tree(got), want, tf)
    steps = {float(st["step"]) for st in state.optimizer.state.values()
             if "step" in st}
    if step_from == "count":
        assert steps == {float(entry.count)}
    else:
        assert steps == ({2.0} if step_from == "run" else set())
    for p in named.values():
        assert set(state.optimizer.state[p]) == set(fields) | (
            {"step"} if step_from else set())

    g = _grads(saved.params, 12)
    updates, _ = run["update"](jax.tree.map(jnp.asarray, g),
                               saved.opt_state, saved.params, LR, GATE_LR)
    want = jax.tree.map(np.asarray, optax.apply_updates(saved.params,
                                                        updates))
    tg = from_jax_params(g)
    for n, p in named.items():
        p.grad = tg[n].clone()
    update(state.optimizer, LR, GATE_LR)
    got = jc.leaves(to_jax_tree(named))
    for k, w in jc.leaves(want).items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=REL * np.abs(w).max() + SLACK * LR,
                                   err_msg=f"{opt} {k}")


def _rewrite(npz, out, drop=(), add=None):
    with np.load(npz) as z:
        arrays = {k: z[k] for k in z.files
                  if not any(k.startswith(d) for d in drop)}
    arrays.update(add or {})
    np.savez(out, **arrays)
    return out


def test_the_ema_rule(adamw, tmp_path, capsys):
    """A run with an EMA refuses a file without one (so does the export
    CLI's --use-ema); a file's EMA is passed over, with a note, by a run
    without one."""
    no_ema = _rewrite(adamw["npz"], str(tmp_path / "no_ema.npz"),
                      drop=("ema_params/",))
    state, _ = _port_state("adamw")
    with pytest.raises(ValueError, match="keeps an EMA"):
        import_jax_checkpoint(no_ema, state)
    with pytest.raises(ValueError, match="no EMA"):
        export.checkpoint_state(no_ema, state.model, use_ema=True)
    plain, _ = _port_state("adamw", ema=False)
    import_jax_checkpoint(adamw["npz"], plain)
    assert "EMA is not read" in capsys.readouterr().out
    jc.assert_trees_equal(to_jax_tree(dict(plain.model.named_parameters())),
                          adamw["state"].params, "params")


def test_names_must_match_both_ways(adamw, tmp_path):
    state, _ = _port_state("adamw")
    extra = _rewrite(adamw["npz"], str(tmp_path / "extra.npz"), add={
        "params/blocks_0/attn/extra_bias": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="blocks_0/attn/extra_bias"):
        import_jax_checkpoint(extra, state)
    missing = _rewrite(adamw["npz"], str(tmp_path / "missing.npz"),
                       drop=("params/norm/scale",))
    with pytest.raises(ValueError, match=r"'norm\.weight'"):
        import_jax_checkpoint(missing, state)
    moment = _rewrite(adamw["npz"], str(tmp_path / "moment.npz"),
                      drop=("opt_state/0/mu/head/",))
    with pytest.raises(ValueError, match=r"head\.weight"):
        import_jax_checkpoint(moment, state)


def test_another_optimizers_state_is_refused(adamw):
    for opt in ("sgd", "rmsprop", "nadam"):
        state, _ = _port_state(opt)
        with pytest.raises(ValueError, match=f"--opt {opt}"):
            import_jax_checkpoint(adamw["npz"], state)


def test_converter_refusals(tmp_path):
    conv = jc.converter()
    ckptr = ocp.PyTreeCheckpointer()
    unfinished = tmp_path / "checkpoint.orbax-checkpoint-tmp-1700000000"
    ckptr.save(str(tmp_path / "done"), {"params": {"w": np.ones(3)}})
    os.rename(tmp_path / "done", unfinished)
    with pytest.raises(ValueError, match="commit never finished"):
        conv.convert(str(unfinished), str(tmp_path / "a.npz"))
    ckptr.save(str(tmp_path / "no_params"), {"opt_state": np.ones(3)})
    with pytest.raises(ValueError, match="no 'params'"):
        conv.convert(str(tmp_path / "no_params"), str(tmp_path / "b.npz"))
    assert not os.path.exists(tmp_path / "a.npz")
    assert not os.path.exists(tmp_path / "b.npz")


def test_the_generator_is_seeded_from_the_key(adamw, tmp_path):
    """A JAX key cannot become a torch generator's state: the import seeds
    the generator from it, the same key the same seed, another key
    another."""
    states = []
    for rng in (None, None, np.asarray([0, 11], np.uint32)):
        path = adamw["npz"] if rng is None else _rewrite(
            adamw["npz"], str(tmp_path / "rng.npz"), add={"rng": rng})
        state, _ = _port_state("adamw")
        import_jax_checkpoint(path, state)
        states.append(torch.randint(0, 1 << 30, (4,),
                                    generator=state.generator))
    assert torch.equal(states[0], states[1])
    assert not torch.equal(states[0], states[2])
