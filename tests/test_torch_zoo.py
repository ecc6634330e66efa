"""The port's DeiT / timm ViT zoo and the distilled and pre-logits heads vs
the JAX package.

- Every name of the JAX ``models/zoo.py`` is registered in the port with
  the same architecture (patch, width, depth, heads, MLP ratio, qkv bias,
  image size, classes, pre-logits size, distillation), read from models
  built on the ``meta`` device (no weights allocated).
- The JAX ``VisionTransformer`` and the port's at depth 2 and width 64,
  plain, distilled (the training pair and the eval mean), with the
  pre-logits layer and without qkv bias: seeded random weights in the JAX
  tree's layout (``to_jax_tree``), read by the port through
  ``from_jax_params``; f32 outputs within 1e-5 + 1e-4 |ref|.
- ``to_jax_tree`` / ``jax_path`` give the JAX tree's paths and shapes
  (``jax.eval_shape`` of its ``init``), the distillation token,
  ``head_dist`` and ``pre_logits`` included.
- The port drops the pre-logits layer when ``num_classes`` is set to
  another count than the model's own, as the original timm registration
  does; the JAX package keeps it (its zoo.py:169), so this is asserted on
  the port's side only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models import registry as jax_registry
from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.models import registry
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    jax_path,
    to_jax_tree,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
HEADS = {"plain": {}, "distilled": dict(distilled=True),
         "pre_logits": dict(representation_size=48),
         "no_qkv_bias": dict(qkv_bias=False),
         "distilled_no_classes": dict(distilled=True, num_classes=0),
         "pre_logits_no_classes": dict(representation_size=48,
                                       num_classes=0)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_zoo_names():
    import slim_switch_moe_vit_tpu.models  # noqa: F401  (registers them)

    return sorted(n for n, fn in jax_registry._REGISTRY.items()
                  if fn.__module__.endswith("models.zoo"))


def _port_arch(m):
    return dict(
        patch_size=m.patch_embed.patch_size, embed_dim=m.cls_token.shape[-1],
        depth=len(m.blocks), num_heads=m.blocks[0].attn.num_heads,
        mlp_ratio=m.blocks[0].mlp.fc1.weight.shape[0] / m.cls_token.shape[-1],
        qkv_bias=m.blocks[0].attn.qkv.bias is not None, img_size=m.img_size,
        num_classes=m.num_classes,
        representation_size=(None if m.pre_logits is None
                             else m.pre_logits.weight.shape[0]),
        distilled=m.distilled)


def _on_meta(name, **kw):
    with torch.device("meta"):
        return registry._REGISTRY[name](**kw)


def test_every_jax_zoo_name_has_the_jax_architecture():
    names = _jax_zoo_names()
    assert len(names) == 34
    assert set(names) <= set(registry.list_models())
    for name in names:
        j = jax_registry._REGISTRY[name]()
        want = dict(
            patch_size=j.patch_size, embed_dim=j.embed_dim, depth=j.depth,
            num_heads=j.num_heads, mlp_ratio=j.mlp_ratio,
            qkv_bias=j.qkv_bias, img_size=j.img_size,
            num_classes=j.num_classes,
            representation_size=j.representation_size or None,
            distilled=j.distilled)
        m = _on_meta(name)
        assert isinstance(m, VisionTransformer), name
        assert _port_arch(m) == want, name
        assert m.pos_embed.shape[1] == (m.img_size // m.patch_embed.patch_size
                                        ) ** 2 + (2 if m.distilled else 1)


def test_pre_logits_dropped_for_a_new_head_port_only():
    for name, size in (("vit_large_patch32_224_in21k", 1024),
                       ("vit_huge_patch14_224_in21k", 1280)):
        assert _port_arch(_on_meta(name))["representation_size"] == size
        assert _port_arch(_on_meta(name, num_classes=21843))[
            "representation_size"] == size
        dropped = _on_meta(name, num_classes=10)
        assert dropped.pre_logits is None
        assert dropped.head.weight.shape == (10, dropped.cls_token.shape[-1])
    assert _on_meta("deit_base_distilled_patch16_224").pre_logits is None


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)


def _weights(kw):
    """Seeded random weights (N(0, 0.05)) in the JAX tree's layout."""
    sd = VisionTransformer(**{**CFG, **kw}).state_dict()
    rs = np.random.RandomState(4)
    return to_jax_tree({k: torch.from_numpy(
        (rs.randn(*v.shape) * 0.05).astype(np.float32))
        for k, v in sd.items()})


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("head", list(HEADS))
def test_vit_heads_match_jax(images, head, train):
    kw = HEADS[head]
    params = _weights(kw)
    jm = JaxVisionTransformer(**{**CFG, **kw})
    want = jm.apply({"params": params}, jnp.asarray(images),
                    deterministic=not train,
                    rngs={"dropout": jax.random.PRNGKey(2)})
    m = VisionTransformer(**{**CFG, **kw})
    m.load_state_dict(from_jax_params(params))
    m.train(train)
    with torch.no_grad():
        got = m(torch.from_numpy(images))
    pair = kw.get("distilled") and train and kw.get("num_classes", 10) > 0
    assert isinstance(got, tuple) == bool(pair)
    for g, w in zip(got if pair else (got,), want if pair else (want,)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.float().numpy(), w, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("head", ["distilled", "pre_logits", "no_qkv_bias"])
def test_jax_tree_round_trip(head):
    """to_jax_tree gives the JAX init's tree (paths and shapes), and
    from_jax_params reads it back leaf for leaf."""
    jm = JaxVisionTransformer(**{**CFG, **HEADS[head]})
    x = jax.ShapeDtypeStruct((1, 32, 32, 3), jnp.float32)
    shapes = jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(1)}, x, deterministic=True), x)
    want = {tuple(p.key for p in path): leaf.shape for path, leaf in
            jax.tree_util.tree_leaves_with_path(shapes["params"])}
    tree = _weights(HEADS[head])
    got = {tuple(p.key for p in path): leaf.shape for path, leaf in
           jax.tree_util.tree_leaves_with_path(tree)}
    assert got == want
    sd = from_jax_params(tree)
    back = VisionTransformer(**{**CFG, **HEADS[head]})
    back.load_state_dict(sd)
    for name, t in back.state_dict().items():
        node = tree
        for k in jax_path(name):
            node = node[k]
        leaf = node.T if jax_path(name)[-1] == "kernel" else node
        np.testing.assert_array_equal(t.numpy(), leaf, name)
    extra = {"distilled": ("dist_token", "head_dist.weight"),
             "pre_logits": ("pre_logits.weight", "pre_logits.bias"),
             "no_qkv_bias": ()}[head]
    for name in extra:
        assert name in sd
    if head == "distilled":
        assert jax_path("head_dist.weight") == ["head_dist", "kernel"]
        assert jax_path("dist_token") == ["dist_token"]
    if head == "pre_logits":
        assert jax_path("pre_logits.weight") == ["pre_logits", "kernel"]
    if head == "no_qkv_bias":
        assert "blocks.0.attn.qkv.bias" not in sd


def test_create_model_draws_the_new_tokens():
    a = create_model("deit_tiny_distilled_patch16_224", img_size=32,
                     generator=torch.Generator().manual_seed(3))
    b = create_model("deit_tiny_distilled_patch16_224", img_size=32,
                     generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.pos_embed.shape == (1, 4 + 2, 192)
    for t in (a.cls_token, a.dist_token, a.pos_embed):
        assert 0.01 < t.std() < 0.025 and t.abs().max() <= 0.04
    assert not torch.equal(a.cls_token, a.dist_token)
