"""The port's switchable ViT (``models/switchable.py``) vs the JAX package.

- ``SwitchableLayerNorm`` with 4 buckets at D = 32: one bucket for every
  token, a bucket per token, and the buckets chosen by the least L2
  distance to the centroids (the selection equal element for element,
  ties included: two equal centroids send their tokens to the first).
- ``SwitchableVisionTransformer`` at 3 blocks of D = 32 (2 heads, 32 px,
  patch 8: N = 17), 4 buckets with centroids set: the unrouted forward,
  the routed forward (threshold 1, ``route_capacity`` 8, with tokens past
  the capacity) and a routed training forward's distilled pair, with the
  pre-router embeddings, and its gradients. Seeded JAX weights carried over
  by ``from_jax_params`` (``block_<i>`` to ``blocks.<i>``, the
  ``centroids`` collection to the buffer); f32 outputs within 1e-5 + 1e-4
  |ref|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models import switchable as jax_sw
from slim_switch_moe_vit_tpu_torch.models import registry, switchable
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

ATOL, RTOL = 1e-5, 1e-4
CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=32, depth=3,
           num_heads=2, buckets=4, route_capacity=8)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _jitter(tree, rs):
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.2 * rs.randn(*a.shape).astype(np.float32),
        tree)


def test_router_norm_and_centroid_selection_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 32).astype(np.float32)
    jln = jax_sw.SwitchableLayerNorm(features=32, switchable_buckets=4)
    v = jln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = _jitter(v["params"], rs)
    cent = x.reshape(-1, 32)[[0, 4, 4, 9]].copy()  # buckets 1 and 2 tie
    cent[3] += 0.01
    variables = {"params": params, "centroids": {"centroids": cent}}
    pln = switchable.SwitchableLayerNorm(32, switchable_buckets=4)
    pln.load_state_dict(from_jax_params(params, centroids={"centroids": cent}))
    per_token = rs.randint(0, 4, (3, 5))
    for buckets in (2, per_token, None):
        jy, jsel = jln.apply(variables, jnp.asarray(x), buckets)
        py, psel = pln(torch.from_numpy(x), None if buckets is None
                       else torch.as_tensor(buckets))
        _close(py.detach(), jy, f"buckets {buckets}")
        np.testing.assert_array_equal(psel.numpy(), np.asarray(jsel))
    assert not (psel == 2).any() and (psel == 1).any()  # the tie to bucket 1
    with pytest.raises(ValueError, match="must match"):
        pln.set_centroids(torch.zeros(3, 32))


@pytest.fixture(scope="module")
def pair():
    rs = np.random.RandomState(1)
    jm = jax_sw.SwitchableVisionTransformer(**CFG, distilled=True,
                                            collect_embeddings=True)
    x = rs.randn(4, 32, 32, 3).astype(np.float32)
    v = jax.jit(functools.partial(jm.init, deterministic=True))(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    params = _jitter(v["params"], rs)
    # centroids: tokens of a forward's pre-router activations, spread
    _, pre = jax.jit(functools.partial(jm.apply, deterministic=True))(
        {"params": params, "centroids": v["centroids"]}, jnp.asarray(x))
    cent = np.asarray(pre).reshape(-1, 32)[[3, 20, 40, 61]]
    variables = {"params": params, "centroids": {"router": {"centroids": cent}}}
    pm = switchable.SwitchableVisionTransformer(**CFG, distilled=True,
                                                collect_embeddings=True)
    pm.load_state_dict(from_jax_params(params,
                                       centroids=variables["centroids"]))
    return jm, variables, pm, x


@pytest.mark.parametrize("routing", [False, True])
def test_forward_matches_jax(pair, routing):
    jm, variables, pm, x = pair
    want, jpre = jax.jit(functools.partial(
        jm.apply, threshold=1, routing=routing, deterministic=True))(
            variables, jnp.asarray(x))
    with torch.no_grad():
        got, ppre = pm.eval()(torch.from_numpy(x), threshold=1,
                              routing=routing)
    _close(got, want, "eval logits")
    _close(ppre, jpre, "pre-router embeddings")
    if routing:  # the case is not vacuous: some pass, some are cut
        _, sel = pm.router(ppre)
        passing = (sel >= 1).sum(1)
        assert (passing > 0).all() and (passing > CFG["route_capacity"]).any()


def test_routed_training_pair_and_gradients_match_jax(pair):
    jm, variables, pm, x = pair

    def loss_fn(params):
        (logits, dist), _ = jm.apply(
            {**variables, "params": params}, jnp.asarray(x), threshold=1,
            routing=True, deterministic=False)
        return jnp.sum(logits * logits) + jnp.sum(jnp.sin(dist))

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    pm.train()
    pm.zero_grad()
    (logits, dist), _ = pm(torch.from_numpy(x), torch.Generator(),
                           threshold=1, routing=True)
    ploss = (logits * logits).sum() + torch.sin(dist).sum()
    ploss.backward()
    _close(ploss.detach(), jloss, "loss")
    want = from_jax_params(jgrads)
    for name, p in pm.named_parameters():
        _close(p.grad, want[name], name)


def test_registered_deit_sw_tiny():
    with torch.device("meta"):
        pm = registry._REGISTRY["deit_sw_tiny_patch16_224"](
            buckets=4, route_capacity=98, num_classes=1000)
    pre, mid, post = pm.groups()
    assert (len(pre), len(mid), len(post)) == (0, 11, 1)
    assert pm.router.centroids.shape == (4, 192)
    assert pm.pos_embed.shape == (1, 197, 192) and pm.route_capacity == 98
