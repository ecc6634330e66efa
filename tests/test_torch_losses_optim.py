"""The port's losses and AdamW (+ EMA) vs the JAX package's.

Seeded numpy logits, labels and gradients go through both packages.
Tolerances: losses 1e-6 relative (the same f32 math); params and EMA after
two AdamW + EMA updates within 1e-6 of each leaf's largest |ref| plus
1e-4 lr (optax's and torch's AdamW order the same f32 operations
differently: 1.7e-8 = 1.7e-5 lr measured on the zero-initialized biases).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slim_switch_moe_vit_tpu import losses as jax_losses
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.models.moe import MoEMlp as JaxMoEMlp
from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu_torch import engine, losses, optim
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    to_jax_tree,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)


def _logits_and_labels(seed=0, n=6, c=10):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, c).astype(np.float32) * 3,
            rs.randint(0, c, n), rs.randn(n, c).astype(np.float32) * 3,
            rs.dirichlet(np.ones(c), n).astype(np.float32))


def _check(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("criterion", [
    (False, 0.0, False), (False, 0.1, False), (True, 0.1, False),
    (False, 0.0, True)])
def test_base_criteria_match_jax(criterion):
    """Plain CE, label smoothing, soft targets (mixup) and BCE, each picked
    by make_base_criterion as the JAX package picks it."""
    logits, labels, _, soft = _logits_and_labels()
    mixup = criterion[0]
    t_target = torch.from_numpy(soft if mixup else labels)
    j_target = jnp.asarray(soft if mixup else labels)
    if criterion[2]:  # BCE takes one-hot (or soft) targets
        t_target = torch.nn.functional.one_hot(torch.from_numpy(labels), 10)
        j_target = jax.nn.one_hot(jnp.asarray(labels), 10)
    _check(losses.make_base_criterion(*criterion)(torch.from_numpy(logits),
                                                  t_target),
           jax_losses.make_base_criterion(*criterion)(jnp.asarray(logits),
                                                      j_target))


@pytest.mark.parametrize("kind", ["none", "soft", "hard"])
def test_distillation_loss_matches_jax(kind):
    logits, labels, teacher, _ = _logits_and_labels(1)
    kd = logits[::-1].copy()
    base_t = losses.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels))
    base_j = jax_losses.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    _check(base_t, base_j)
    _check(losses.distillation_loss(base_t, torch.from_numpy(kd),
                                    torch.from_numpy(teacher), kind, 0.5, 3.0),
           jax_losses.distillation_loss(base_j, jnp.asarray(kd),
                                        jnp.asarray(teacher), kind, 0.5, 3.0))


def test_accuracy_topk_matches_jax():
    logits, labels, _, _ = _logits_and_labels(2, n=40)
    for got, want in zip(
            losses.accuracy_topk(torch.from_numpy(logits),
                                 torch.from_numpy(labels)),
            jax_losses.accuracy_topk(jnp.asarray(logits), jnp.asarray(labels))):
        _check(got, want)


@pytest.fixture(scope="module")
def models():
    def jfactory(idx, dim, ratio, drop, dt):
        return JaxMoEMlp(num_experts=4, top_k=2,
                         hidden_features=int(dim * ratio), name="mlp",
                         dispatch_mode="fused")

    def tfactory(idx, dim, ratio, drop, dt):
        return MoEMlp(dim, int(dim * ratio), num_experts=4, top_k=2)

    jm = JaxVisionTransformer(block_mlp_factory=jfactory, **CFG)
    params = jax.jit(lambda x: jm.init(jax.random.PRNGKey(0), x,
                                       deterministic=True))(
        jnp.zeros((1, 32, 32, 3)))["params"]
    tm = VisionTransformer(block_mlp_factory=tfactory, **CFG)
    tm.load_state_dict(from_jax_params(params))
    return params, tm


def test_wd_mask_is_the_jax_mask(models):
    """The decayed set equals the JAX wd_mask mapped through
    from_jax_params; the expert biases b1/b2 are not decayed."""
    params, tm = models
    want = {k: bool(v) for k, v in from_jax_params(jax.tree.map(
        lambda m: np.float32(m), jax_optim.wd_mask(params))).items()}
    got = optim.wd_mask(tm.named_parameters())
    assert got == want
    assert not got["blocks.0.mlp.b1"] and not got["blocks.0.mlp.b2"]
    assert got["blocks.0.mlp.w1"] and not got["pos_embed"]
    assert not any(optim.gate_mask(tm.named_parameters()).values())


def test_unported_optimizers_raise():
    """A name neither package implements raises; every JAX name is
    accepted (their parity: tests/test_torch_optim_surface.py)."""
    with pytest.raises(ValueError, match="not implemented"):
        optim.make_optimizer(opt="adagrad")
    assert optim.SUPPORTED_OPTIMIZERS == jax_optim.SUPPORTED_OPTIMIZERS
    for name in optim.SUPPORTED_OPTIMIZERS:
        optim.make_optimizer(opt=name)


def test_adamw_and_ema_update_matches_jax(models):
    """Two AdamW updates (the second exercises the moment and bias
    corrections) and ``engine.ema_update`` after each, against the JAX
    optimizer and the JAX engine's EMA, e = d*e + (1-d)*p. At decay 0.9
    the EMA moves ~1e-4 a step, 100x the tolerance."""
    params, tm = models
    rs = np.random.RandomState(3)
    lr, decay = 1e-3, 0.9
    opt_init, opt_update = jax_optim.make_optimizer(params, weight_decay=0.05)
    jstate, jp, je = opt_init(params), params, params
    t_init, t_update = optim.make_optimizer(weight_decay=0.05)
    topt = t_init(tm)
    # built in reverse order: the engine pairs EMA and params by name
    tema = {n: p.detach().clone()
            for n, p in reversed(list(tm.named_parameters()))}
    for _ in range(2):
        grads = jax.tree.map(
            lambda p: rs.randn(*p.shape).astype(np.float32), params)
        updates, jstate = opt_update(grads, jstate, jp, lr, lr)
        jp = optax.apply_updates(jp, updates)
        je = jax.tree.map(lambda e, p: e * decay + p * (1.0 - decay), je, jp)
        tgrads = from_jax_params(grads)
        for n, p in tm.named_parameters():
            p.grad = tgrads[n].clone()
        t_update(topt, lr, lr)
        engine.ema_update(tema, tm, decay)
    for got_tree, want_tree in (
            (to_jax_tree(dict(tm.named_parameters())), jp),
            (to_jax_tree(tema), je)):
        jax.tree.map(lambda g, w: np.testing.assert_allclose(
            g, np.asarray(w), rtol=0, atol=1e-6 * np.abs(w).max() + 1e-4 * lr),
            got_tree, want_tree)
