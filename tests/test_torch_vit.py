"""The PyTorch port's Switch-MoE ViT forward vs the JAX package.

A small model (img 32, patch 8 -> N=17, D=64, 2 blocks, 2 heads, 4 experts
top-2) is initialized in JAX with its Pallas kernels forced on
(``ln_impl="fused"``, ``attn_impl="fused"``, ``dispatch_mode="fused"``,
interpret mode on the CPU), its weights carried across with
``from_jax_params``, and the logits compared. Tolerances: f32 1e-4; bf16
5e-2 relative to the largest logit (bf16 rounding through two blocks, plus
the JAX bf16 GELU polynomial and softmax rounding order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models import create_model as jax_create_model
from slim_switch_moe_vit_tpu.models.moe import MoEMlp as JaxMoEMlp
from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.models import resmoe
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_model(dtype, moe=True):
    factory = None
    if moe:
        def factory(idx, dim, ratio, drop, dt):
            return JaxMoEMlp(num_experts=4, top_k=2,
                             hidden_features=int(dim * ratio), dtype=dt,
                             dispatch_mode="fused", name="mlp")
    return JaxVisionTransformer(ln_impl="fused", attn_impl="fused",
                                dtype=jnp.dtype(dtype),
                                block_mlp_factory=factory, **CFG)


def _torch_model(dtype, moe=True):
    factory = None
    if moe:
        def factory(idx, dim, ratio, drop, dt):
            return MoEMlp(dim, int(dim * ratio), num_experts=4, top_k=2)
    return VisionTransformer(dtype=getattr(torch, dtype),
                             block_mlp_factory=factory, **CFG).eval()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(3, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params(images):
    m = _jax_model("float32")
    return jax.jit(lambda x: m.init({"params": jax.random.PRNGKey(0)}, x,
                                    deterministic=True))(
        jnp.asarray(images))["params"]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_moe_vit_logits_match_jax(images, jax_params, dtype, tol):
    jm = _jax_model(dtype)
    want = np.asarray(jax.jit(lambda p, x: jm.apply(
        {"params": p}, x, deterministic=True))(
        jax_params, jnp.asarray(images, jnp.dtype(dtype))), np.float32)
    m = _torch_model(dtype)
    m.load_state_dict(from_jax_params(jax_params))
    with torch.no_grad():
        got = m(torch.from_numpy(images).to(getattr(torch, dtype)))
    assert got.dtype == torch.float32 and got.shape == (3, 10)
    scale = np.abs(want).max() if dtype == "bfloat16" else 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=tol * scale,
                               rtol=tol if dtype == "float32" else 0)


def test_dense_vit_logits_match_jax(images):
    """The dense Mlp blocks (fc1 -> GELU -> fc2), f32."""
    jm = _jax_model("float32", moe=False)
    x = jnp.asarray(images)
    variables = jax.jit(lambda x: jm.init({"params": jax.random.PRNGKey(1)},
                                          x, deterministic=True))(x)
    want = jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(
        variables, x)
    m = _torch_model("float32", moe=False)
    m.load_state_dict(from_jax_params(variables["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


def test_deferred_chain_equals_plain_blocks(images):
    """forward_features (residual-deferred, fused LN forms) equals stacking
    each block's plain forward and a plain final LN."""
    torch.manual_seed(0)
    m = create_model("moe_tiny_patch16_224_expert8", img_size=32,
                     num_classes=5).eval()
    x = torch.from_numpy(images)
    with torch.no_grad():
        deferred = m.forward_features(x)
        h = m.patch_embed(x)
        h = torch.cat([m.cls_token.expand(3, -1, -1), h], 1) + m.pos_embed
        for blk in m.blocks:
            h = blk(h)
        plain = m.norm(h)
    torch.testing.assert_close(deferred, plain, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", ["moe_tiny_patch16_224_expert8",
                                  "moe_small_patch16_224_expert8"])
def test_registry_param_tree_matches_jax(name):
    """Every JAX parameter maps onto the port's model of the same name, with
    the same shape (shapes only: jax.eval_shape, and the registered
    constructor without its weight init)."""
    x = jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32)
    shapes = jax.eval_shape(
        lambda x: jax_create_model(name).init(
            {"params": jax.random.PRNGKey(0)}, x, deterministic=True), x)
    sd = getattr(resmoe, name)().state_dict()
    flat = jax.tree_util.tree_leaves_with_path(shapes["params"])
    assert len(flat) == len(sd)
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes["params"])
    mapped = from_jax_params(zeros)
    assert {k: tuple(v.shape) for k, v in mapped.items()} == \
        {k: tuple(v.shape) for k, v in sd.items()}


def test_create_model_seeds_and_options():
    a = create_model("moe_tiny_patch16_224_expert8", img_size=32,
                     generator=torch.Generator().manual_seed(3))
    b = create_model("moe_tiny_patch16_224_expert8", img_size=32,
                     generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.blocks[0].mlp.w1
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02  # trunc at 2 std
    with pytest.raises(ValueError, match="Unknown model"):
        create_model("deit_nano")
    flash = create_model("moe_tiny_patch16_224_expert8", use_flash=True)
    assert all(blk.attn.use_flash for blk in flash.blocks)
    assert not any(blk.attn.use_flash for blk in a.blocks)


def test_port_imports_neither_jax_nor_flax():
    """Importing every module of the port pulls in no JAX, flax or JAX
    package module (checked in a fresh interpreter)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import slim_switch_moe_vit_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    if not m.name.endswith('_fused_ln_triton'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'slim_switch_moe_vit_tpu')]\n"
        "assert not bad, bad\n"
        "for name in ('main', 'config', 'data.datasets', 'data.samplers',\n"
        "             'data.loader', 'data.transforms', 'data.device_aug',\n"
        "             'data.mixup', 'data.native_loader', 'models.zoo',\n"
        "             'models.gates', 'ops.fused_adamw', 'utils.memory',\n"
        "             'utils.logging'):\n"
        "    assert p.__name__ + '.' + name in sys.modules, name\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
