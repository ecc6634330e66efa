"""A run of the JAX trainer carried to the port: its Orbax checkpoint,
converted by ``scripts/jax_checkpoint_to_npz.py``, read by
``utils/checkpoint.py::import_jax_checkpoint`` and served by the export
CLI's ``checkpoint_state``.

The JAX package's own ``engine.make_train_step`` takes two adamw steps with
an EMA on ``resmoe_tiny_patch16_224_expert8`` (32 px, 10 classes, 2
experts: tests/jax_checkpoint_common.py) and its own ``save_checkpoint``
writes the checkpoint:

- the import equals JAX's ``params``, ``ema_params``, ``gates``, ``mu``,
  ``nu`` and ``count`` bit for bit, after the layout mapping;
- one more step on the same batch, on both sides, agrees within the f32
  parity limits of tests/test_torch_train.py (the loss within rtol 1e-4,
  each leaf's move within 5e-2 of its largest JAX move), through
  ``torch.optim.AdamW`` and through K7's plain version (``--fused-optimizer``);
- ``checkpoint_state(npz, use_ema=True)`` gives the logits of JAX's
  ``model.apply`` on the checkpoint's ``ema_params`` within 1e-5 of their
  largest |ref|, and a bare param-tree ``.npz`` loads as before.

``--clip-grad`` (the Adam entry second in the chain) and the sgd family's
``trace``: tests/test_torch_jax_checkpoint_{clip,sgd}.py; every ``--opt``
and the refusals: tests/test_torch_jax_checkpoint_opts.py; the driver's
``--resume`` and expert parallelism:
tests/test_torch_jax_checkpoint_driver.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_checkpoint_common as jc
from slim_switch_moe_vit_tpu.models import create_model as jax_create_model
from slim_switch_moe_vit_tpu_torch.serving import export
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    flatten_tree,
    from_jax_params,
    load_npz_tree,
)
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

LOGITS_REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return jc.jax_run(tmp_path_factory.mktemp("jax_run"))


def test_import_is_exact(run):
    jc.check_exact_import(run)
    for key in ("args", "sched"):  # the sidecars, beside the .npz
        assert os.path.exists(f"{run['npz']}.{key}.json")
    with open(f"{run['npz']}.sched.json") as f:
        assert json.load(f) == {"best": 0.5}


@pytest.mark.parametrize("fused", [False, True])
def test_one_more_step_matches_jax(run, fused):
    jc.check_one_more_step(run, fused=fused)


def test_serving_the_ema_matches_jax_apply(run):
    saved = run["saved"]
    model = jc.port_model()
    model.load_state_dict(export.checkpoint_state(run["npz"], model,
                                                  use_ema=True))
    model.eval()
    x = np.random.RandomState(3).randn(2, 32, 32, 3).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    jm = jax_create_model(jc.MODEL, num_experts=jc.EXPERTS, **jc.KW)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, deterministic=True))(
        {"params": saved.ema_params, "gates": saved.gates}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGITS_REL * np.abs(want).max())
    params = export.checkpoint_state(run["npz"], model)
    for name, t in from_jax_params(jax.tree.map(np.asarray, saved.params),
                                   jax.tree.map(np.asarray,
                                                saved.gates)).items():
        assert torch.equal(params[name], t), name


def test_a_bare_param_tree_loads_as_before(run, tmp_path):
    tree = load_npz_tree(run["npz"], roots=("params",))["params"]
    bare = str(tmp_path / "bare.npz")
    np.savez(bare, **flatten_tree(tree))
    model = jc.port_model()
    got = export.checkpoint_state(bare, model)
    want = from_jax_params(tree)
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    with pytest.raises(ValueError, match="no EMA"):
        export.checkpoint_state(bare, model, use_ema=True)
