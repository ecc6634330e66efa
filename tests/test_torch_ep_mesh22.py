"""The port's expert-parallel MoE forms on a 2 x 2 (data, expert) layout of
gloo ranks on the CPU, against the JAX package's forms on a 2 x 2 mesh of
the conftest's virtual devices (see ``tests/test_torch_ep.py`` for the 1 x
4 layout and the tolerance): the psum and a2a forms' capacity priority is
per data shard (and per chunk), the sharded ``'capacity'`` mode's that of
the whole batch, as GSPMD computes it. Then ``moe_tiny_patch16_224_expert8``
with its experts sharded over the same layout against the JAX model on one
device (``tests/test_parallel.py:18-33``).
"""
import jax
import numpy as np
import pytest
import torch_ep_common as common

from slim_switch_moe_vit_tpu.models import create_model as jax_create_model
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.parallel import launch
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import to_jax_tree
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

DP, EP, FACTOR, T = 2, 2, 0.75, 256
FORMS = ("psum", "a2a", "a2a_perm", "sharded")


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    data = common.inputs(T, seed=5)
    out = common.run_port(tmp_path_factory.mktemp("ep22"), DP, EP, data,
                          [(f, FACTOR) for f in FORMS])
    return data, out


@pytest.mark.parametrize("form", FORMS)
def test_ep_form_matches_jax_mesh(port, form, monkeypatch):
    """y, the aux values and the gradients of sum(y * c) + balance_weight *
    balance_loss equal the JAX mesh's."""
    data, out = port
    key = f"{form}@{FACTOR}"
    want = common.run_jax(form, DP, EP, data, FACTOR, monkeypatch)
    common.assert_matches(out[key], want, key)
    common.assert_expert_group_replicated(out["ranks"], EP, key)
    assert out[key]["drop_fraction"] > 0.02  # real drops exercised


MODEL = "moe_tiny_patch16_224_expert8"
MODEL_KW = dict(num_classes=10, img_size=32, capacity_factor=8.0,
                eval_capacity_factor=8.0)


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """The port's seed-0 weights, the images, and the JAX model's logits on
    one device with those weights."""
    state = create_model(MODEL, **MODEL_KW).state_dict()
    x = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    model = jax_create_model(MODEL, dispatch_mode="capacity", **MODEL_KW)
    ref = np.asarray(jax.jit(lambda p, x: model.apply(
        {"params": p}, x, deterministic=True))(to_jax_tree(state), x))
    path = tmp_path_factory.mktemp("tiny") / "in.npz"
    np.savez(path, images=x,
             **{f"param/{k}": v.numpy() for k, v in state.items()})
    return path, ref


@pytest.mark.parametrize("mode", ["capacity", "capacity_fused_a2a"])
def test_moe_tiny_forward_matches_one_device(one_device, mode, tmp_path):
    """Logits of the model with its experts sharded 2 x 2 equal the JAX
    model's on one device (capacity factor 8: nothing drops, so the
    per-shard priority cannot part from the whole batch's)."""
    path, ref = one_device
    launch.spawn(launch.model_forward_worker, DP * EP,
                 (str(path), str(tmp_path), DP, EP, MODEL,
                  {**MODEL_KW, "dispatch_mode": mode}, "cpu"),
                 init_file=str(tmp_path / "store"), device="cpu")
    logits = [np.load(tmp_path / f"rank{r}.npz")["logits"]
              for r in range(DP * EP)]
    for r in range(DP * EP):  # the expert group's ranks agree exactly
        assert np.array_equal(logits[r], logits[(r // EP) * EP])
    got = np.concatenate([logits[i * EP] for i in range(DP)])
    np.testing.assert_allclose(got, ref, atol=common.TOL, rtol=0)
