"""The port's optimizer surface vs the JAX package's ``make_optimizer``.

A small gated ResMoE ViT of the port (img 32, patch 8, D=64, 2 blocks, 4
experts top-2) gives the parameter names of all four groups (weight decay
or none x the base or the gate learning rate) and the expert tensors. Its
f32 weights and seeded numpy gradients go through both packages' updates
from the same numpy arrays: each ``--opt`` name for three steps at a base
lr of 1e-3 and a gate lr of 2e-3, weight decay 0.05 and momentum 0.9,
``--clip-grad`` below and above the gradients' global norm, and
``--attn-only``. Every parameter lands within 1e-6 of its leaf's largest
|ref| plus 1e-4 lr, the tolerance of tests/test_torch_losses_optim.py's
AdamW case: torch's Adam-family classes take the bias corrections in f64,
optax in f32, where 0.999 moves 1 - b2 by 1.3e-5 of itself (at most 0.47
of the limit measured, rmsprop; lamb, written here with optax's f32
corrections, 0.11).

Two choices of the port differ from the JAX chain, and are held here to
``torch.optim`` instead: adadelta takes ``--opt-eps`` (the JAX chain fixes
1e-6) and radam adds eps to sqrt(v) before the bias correction (the JAX
chain after it). The JAX cases run where the two agree: adadelta at eps
1e-6, radam over its first three steps, which its rectifier leaves out
(rho_t <= 5 at b2 = 0.999). From step 6 on, the JAX chain's rectifier,
taken in f32, is 1e-3 of itself away from the f64 one; eight radam steps
are held to ``torch.optim.RAdam``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu_torch import optim
from slim_switch_moe_vit_tpu_torch.models.resmoe import ResMoEBlock
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    restore_checkpoint,
    save_checkpoint,
    to_jax_tree,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
LR, GATE_LR, WD, MOMENTUM = 1e-3, 2e-3, 0.05, 0.9
REL = 1e-6
SLACK = 1e-4
EPS = {"adadelta": 1e-6}


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


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in jax.tree.leaves(tree))))


def _run_jax(tree, grads, steps, **kw):
    params = jax.tree.map(jnp.asarray, tree)
    init, update = jax_optim.make_optimizer(params, weight_decay=WD,
                                            momentum=MOMENTUM, **kw)
    state = init(params)
    for g in grads[:steps]:
        updates, state = update(jax.tree.map(jnp.asarray, g), state, params,
                                LR, GATE_LR)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, params)


def _run_port(model, grads, steps, **kw):
    init, update = optim.make_optimizer(weight_decay=WD, momentum=MOMENTUM,
                                        **kw)
    opt = init(model)
    for g in grads[:steps]:
        tg = from_jax_params(g)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        update(opt, LR, GATE_LR)
    return to_jax_tree(dict(model.named_parameters()))


def _close(got_tree, want_tree, rel=REL):
    got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=0,
                                   atol=rel * np.abs(w).max() + SLACK * LR,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def setup():
    tree = to_jax_tree(dict(_model().named_parameters()))
    return tree, [_grads(tree, 10 + s) for s in range(8)]


def test_the_groups_cover_all_four_and_the_experts(setup):
    """The small model gives every group: decayed and not, base and gate
    learning rate, expert and dense tensors."""
    opt = optim.make_optimizer(opt="sgd")[0](_model())
    kinds = {(g["weight_decay"] != 0, g["gate"], g["expert"])
             for g in opt.param_groups}
    assert {(wd, gate) for wd, gate, _ in kinds} == {
        (True, False), (True, True), (False, False), (False, True)}
    assert {(True, False, True), (False, False, True)} <= kinds


@pytest.mark.parametrize("opt", optim.SUPPORTED_OPTIMIZERS)
def test_optimizer_matches_jax(setup, opt):
    """Three steps of each optimizer over all four groups."""
    tree, grads = setup
    eps = EPS.get(opt, 1e-8)
    want = _run_jax(tree, grads, 3, opt=opt, eps=eps)
    got = _run_port(_model(), grads, 3, opt=opt, eps=eps)
    _close(got, want)


@pytest.mark.parametrize("opt", ["adamw", "lamb", "sgd"])
@pytest.mark.parametrize("side", ["below", "above"])
def test_clip_grad_matches_jax(setup, opt, side):
    """``--clip-grad`` at twice the largest of three steps' global
    gradient norms, and at 0.5 (below Lamb's own rescale to 1.0, and below
    half the smallest norm): the first leaves the gradients, the second
    clips every step's. The steps' gradients are scaled by 1, 4 and 1/4,
    so that clipping them to one norm moves even the scale-free Adam."""
    tree, grads = setup
    grads = [jax.tree.map(lambda g, f=f: g * np.float32(f), g)
             for g, f in zip(grads, (1.0, 4.0, 0.25))]
    norms = [_global_norm(g) for g in grads]
    assert min(norms) > 1.0
    clip = max(norms) * 2.0 if side == "below" else 0.5
    want = _run_jax(tree, grads, 3, opt=opt, clip_grad=clip)
    got = _run_port(_model(), grads, 3, opt=opt, clip_grad=clip)
    _close(got, want)
    unclipped = _run_jax(tree, grads, 3, opt=opt)
    moved = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(
        jax.tree.leaves(unclipped), jax.tree.leaves(want)))
    assert (moved > 1e-3) == (side == "above"), moved


def test_attn_only_mask_is_the_jax_mask(setup):
    tree, _ = setup
    model = _model()
    want = {k: bool(v) for k, v in from_jax_params(jax.tree.map(
        lambda m: np.float32(m), jax_optim.attn_only_mask(tree))).items()}
    got = optim.attn_only_mask(model.named_parameters())
    assert got == want
    assert got["pos_embed"] and got["head.weight"]
    assert got["blocks.0.attn.qkv.weight"]
    assert not got["patch_embed.proj.weight"] and not got["cls_token"]
    assert not got["blocks.0.mlp.w1"] and not got["blocks.0.norm1.weight"]


@pytest.mark.parametrize("opt,clip", [("adamw", None), ("lamb", 0.05),
                                      ("momentum", None)])
def test_attn_only_matches_jax(setup, opt, clip):
    """``--attn-only``: the trained parameters land where JAX's do (with
    lamb and a clip, the norms over the trained gradients only), and every
    frozen one is bit-identical to its start."""
    tree, grads = setup
    want = _run_jax(tree, grads, 3, opt=opt, clip_grad=clip,
                    trainable_mask=jax_optim.attn_only_mask)
    model = _model()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    got = _run_port(model, grads, 3, opt=opt, clip_grad=clip,
                    trainable_mask=optim.attn_only_mask)
    _close(got, want)
    trained = optim.attn_only_mask(model.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, start[n]) != trained[n], n


@pytest.mark.parametrize("opt,eps,steps,jax_differs", [
    ("adadelta", 1e-8, 3, True), ("radam", 1e-3, 8, True),
    ("radam", 1e-8, 8, False)])
def test_port_is_torch_optim_where_jax_differs(setup, opt, eps, steps,
                                               jax_differs):
    """Where the JAX chain differs (adadelta's fixed eps 1e-6; radam's eps
    after the bias correction, and its rectifier, taken in f32 from steps
    6 on at b2 = 0.999), the port is ``torch.optim``'s class built on the
    same groups by hand, within the parity tolerance; at adadelta's eps
    1e-8 and radam's 1e-3, JAX's result is away from it by more than 100
    times that."""
    tree, grads = setup
    cls, kw = {"adadelta": (torch.optim.Adadelta, dict(rho=0.9)),
               "radam": (torch.optim.RAdam,
                         dict(decoupled_weight_decay=True))}[opt]
    got = _run_port(_model(), grads, steps, opt=opt, eps=eps)
    model = _model()
    decay = optim.wd_mask(model.named_parameters())
    gate = optim.gate_mask(model.named_parameters())
    ref = cls([{"params": [p], "weight_decay": WD if decay[n] else 0.0,
                "lr": GATE_LR if gate[n] else LR}
               for n, p in model.named_parameters()], eps=eps, **kw)
    for g in grads[:steps]:
        tg = from_jax_params(g)
        for n, p in model.named_parameters():
            p.grad = tg[n].clone()
        ref.step()
    _close(got, to_jax_tree(dict(model.named_parameters())))
    if jax_differs:
        want = _run_jax(tree, grads, steps, opt=opt, eps=eps)
        assert any(np.abs(a - b).max() > 100 * REL * np.abs(b).max()
                   for a, b in zip(jax.tree.leaves(got),
                                   jax.tree.leaves(want)))


def test_global_norm_counts_every_tensor_once():
    """One process: the norm of all the tensors, expert or not."""
    ts = [torch.randn(3, 4), torch.randn(5), torch.randn(2, 2, 2)]
    want = torch.sqrt(sum((t.double() ** 2).sum() for t in ts))
    got = optim.global_norm(ts, [False, True, True])
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)


@pytest.mark.parametrize("opt", optim.SUPPORTED_OPTIMIZERS)
def test_optimizer_state_resumes_bit_for_bit(opt, tmp_path):
    """Two steps, a checkpoint, a third step: a fresh state restored from
    the checkpoint takes the same third step bit for bit (the state of
    every optimizer goes through ``save_checkpoint``)."""
    rs = np.random.RandomState(4)
    model = _model()
    grads = [{n: torch.from_numpy((rs.randn(*p.shape) * 0.1).astype(
        np.float32)) for n, p in model.named_parameters()} for _ in range(3)]
    init, update = optim.make_optimizer(opt=opt, weight_decay=WD,
                                        clip_grad=1.0 if opt == "lamb"
                                        else None)

    def step(state, g):
        for n, p in state.model.named_parameters():
            p.grad = g[n].clone()
        update(state.optimizer, LR, GATE_LR)

    state = create_train_state(model, device="cpu", opt_init=init)
    for g in grads[:2]:
        step(state, g)
    save_checkpoint(str(tmp_path / "ckpt"), state, epoch=0)
    step(state, grads[2])
    restored, _ = restore_checkpoint(
        str(tmp_path / "ckpt"),
        create_train_state(_model(seed=1), device="cpu", opt_init=init))
    step(restored, grads[2])
    for (n, p), (_, q) in zip(model.named_parameters(),
                              restored.model.named_parameters()):
        assert torch.equal(p, q), n
