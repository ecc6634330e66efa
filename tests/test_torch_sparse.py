"""The port's zeta-masked structured pruning (``models/sparse.py``) and FLOP
accounting (``ops/flops.py``) vs the JAX package.

``sparse_deit_tiny_patch16_224`` at 32 px (12 blocks of D = 192, N = 5,
10 classes) with the zetas spread over [0, 1) (the JAX golden test's
jittered init, so the thresholds bite), seeded JAX weights carried over by
``from_jax_params`` (the ``pruning`` collection to the buffers):

- a search step's loss (label-smoothed CE + 2e-4 x the L1 zeta loss) and
  every gradient, within 1e-5 + 1e-4 |ref| in f32; then two AdamW steps on
  each side (optax and ``torch.optim.AdamW``);
- ``compress`` at budgets (0.5, 0.6, 0.3): the thresholds, and every
  ``searched_zeta`` and OR-propagated ``searched_patch_zeta`` element for
  element; the compressed forward; ``get_remaining``; ``decompress`` back
  to the soft forward;
- the analytic counts of ``ops/flops.py``, ``sparse_attention_flops`` and
  ``sparse_mlp_params_count`` exactly equal to the JAX functions', and
  ``cost_analysis`` counting a GEMM's 2 M N K.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu import create_model as jax_create_model
from slim_switch_moe_vit_tpu import losses as jax_losses
from slim_switch_moe_vit_tpu.models import sparse as jax_sp
from slim_switch_moe_vit_tpu.ops import flops as jax_flops
from slim_switch_moe_vit_tpu_torch import create_model, losses
from slim_switch_moe_vit_tpu_torch.models import sparse
from slim_switch_moe_vit_tpu_torch.ops import flops
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (from_jax_params,
                                                             to_jax_tree)

ATOL, RTOL = 1e-5, 1e-4
LR, W_SPARSE, STEPS = 1e-3, 2e-4, 2
BUDGETS = (0.5, 0.6, 0.3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


def _jitter_zetas(tree, rng):
    return {k: (_jitter_zetas(v, rng) if isinstance(v, dict) else
                jnp.asarray(rng.rand(*v.shape).astype(np.float32))
                if k in ("zeta", "patch_zeta") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def searched():
    """Both models after the search steps: (JAX model, params, pruning,
    port model, images, the first step's (JAX, port) loss and gradients)."""
    import optax

    jm = jax_create_model("sparse_deit_tiny_patch16_224", num_classes=10,
                          img_size=32)
    rs = np.random.RandomState(11)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 8)
    # the JAX trees from the port's seeded model (the flax names and
    # layouts by to_jax_tree; the buffers are the pruning collection)
    pm = create_model("sparse_deit_tiny_patch16_224", num_classes=10,
                      img_size=32)
    params = _jitter_zetas(to_jax_tree(dict(pm.named_parameters())),
                           np.random.RandomState(5))
    pruning = jax.tree.map(jnp.asarray, to_jax_tree(dict(pm.named_buffers())))
    pm.load_state_dict(from_jax_params(params, pruning=pruning))

    crit = jax_losses.make_base_criterion(False, 0.1, False)

    def loss_fn(p):
        logits = jm.apply({"params": p, jax_sp.PRUNING_COLLECTION: pruning},
                          jnp.asarray(x), deterministic=True)
        return crit(logits, jnp.asarray(y)) + W_SPARSE * sum(
            jax_sp.get_sparsity_loss(p))

    tx = optax.adamw(LR, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0)

    @jax.jit
    def step(p, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss, grads

    opt_state = tx.init(params)
    pcrit = losses.make_base_criterion(False, 0.1, False)
    popt = torch.optim.AdamW(pm.parameters(), lr=LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=0.0, foreach=False)
    first = None
    for _ in range(STEPS):
        params, opt_state, jloss, jgrads = step(params, opt_state)
        pm.eval()
        popt.zero_grad()
        ploss = pcrit(pm(torch.from_numpy(x)), torch.from_numpy(y))
        ploss = ploss + W_SPARSE * sum(sparse.get_sparsity_loss(pm))
        ploss.backward()
        if first is None:
            first = (jloss, jgrads, ploss.detach(),
                     {n: p.grad.clone() for n, p in pm.named_parameters()})
        popt.step()
    return jm, params, pruning, pm, x, first


def test_search_step_loss_and_gradients_match_jax(searched):
    *_, (jloss, jgrads, ploss, pgrads) = searched
    _close(ploss, jloss, "search loss")
    want = from_jax_params(jgrads)
    assert want.keys() == pgrads.keys()
    for name, g in pgrads.items():
        _close(g, want[name], name)


def test_compress_masks_exact_and_forward(searched):
    jm, params, pruning, pm, x, _ = searched
    jx = jnp.asarray(x)
    pm.eval()
    new_pruning, jthr = jax_sp.compress(params, pruning, *BUDGETS)
    pthr = sparse.compress(pm, *BUDGETS)
    np.testing.assert_allclose(pthr, jthr, rtol=1e-5)  # ~1 ulp of drift
    got = pm.state_dict()
    want = from_jax_params({}, pruning=new_pruning)
    assert len(want) == 12 * 5
    for name, t in want.items():
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                      err_msg=name)
    masks = [got[f"blocks.{i}.attn.searched_patch_zeta"] for i in range(12)]
    assert all((a >= b).all() for a, b in zip(masks, masks[1:]))  # OR, last->first
    assert 0 < float(masks[-1].mean()) < 1
    apply = jax.jit(functools.partial(jm.apply, deterministic=True))
    # the forward on JAX's trained weights (the two optimizers drift by ulps)
    pm.load_state_dict(from_jax_params(params), strict=False)
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), apply(
            {"params": params, jax_sp.PRUNING_COLLECTION: new_pruning}, jx),
            "compressed forward")
    np.testing.assert_allclose(
        sparse.get_remaining(pm, 5),
        jax_sp.get_remaining(params, new_pruning, 5), rtol=1e-6)
    # decompress: the JAX collection's switches, and the soft forward again
    sparse.decompress(pm)
    with torch.no_grad():
        soft = pm(torch.from_numpy(x))
    _close(soft, apply({"params": params, jax_sp.PRUNING_COLLECTION:
                        jax_sp.decompress(new_pruning)}, jx), "soft forward")
    back = from_jax_params({}, pruning=jax_sp.decompress(new_pruning))
    for name, t in back.items():
        np.testing.assert_array_equal(pm.state_dict()[name].numpy(),
                                      t.numpy(), err_msg=name)
    np.testing.assert_allclose(
        sparse.get_remaining(pm, 5),
        jax_sp.get_remaining(params, jax_sp.decompress(new_pruning), 5),
        rtol=1e-6)
    sparse.compress(pm, *BUDGETS)  # leave it compressed for the FLOP test


def test_flop_counts_equal_jax(searched):
    *_, pm, _, _ = searched
    for args in ((128, 197, 384, 1536, 8, 2), (2, 50, 192, 768, 4, 1, 0.5,
                                               0.75)):
        assert (flops.resmoe_block_flops(*args)
                == jax_flops.resmoe_block_flops(*args))
    for kw in (dict(), dict(moe=True), dict(num_tokens=2, num_classes=10)):
        assert (flops.vit_flops(128, 224, 16, 384, 12, **kw)
                == jax_flops.vit_flops(128, 224, 16, 384, 12, **kw))
    assert flops.expert_ffn_flops(10, 4, 16, 2) == \
        jax_flops.expert_ffn_flops(10, 4, 16, 2)
    blk = pm.blocks[3]
    sz = blk.attn.searched_zeta.numpy()
    for hs, us in ((False, False), (True, False), (False, True)):
        assert (sparse.sparse_attention_flops(192, 3, sz, 5, 3.0, hs, us)
                == jax_sp.sparse_attention_flops(192, 3, sz, 5, 3.0, hs, us))
    mz = blk.mlp.searched_zeta.numpy()
    assert (sparse.sparse_mlp_params_count(192, 768, mz)
            == jax_sp.sparse_mlp_params_count(192, 768, mz))
    dense = torch.nn.Linear(64, 32, bias=False)
    cost = flops.cost_analysis(dense, torch.zeros(5, 64))
    assert cost["flops"] == 2 * 5 * 64 * 32
