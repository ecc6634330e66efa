"""Serving a gated artifact: the port's counterpart of the JAX package's
``tests/test_serving.py::test_gated_model_export_carries_gates``.

``resmoe_tiny_patch16_224_expert8`` (32 px, 10 classes, f32, the JAX
package's seed-7 weights and gates carried across) has its gates' eval
targets lowered from 0.9 to 0.3: the gate probabilities sit near 0.5 at
init, so most tokens are skipped. The artifact (``export_model``; the
gates' ``threshold``, ``target_threshold`` and ``enabled`` are buffers of
the model's ``state_dict``) is served by ``load_predictor``, whose logits
must equal the model's eval forward with those gates (the same CPU ops:
within 1e-5) and the JAX package's served logits for the same weights
and gates (within 1e-4, f32 sums in another order). An artifact whose
gates' buffers were reset to the default targets serves other logits, and
one whose gates' buffers were dropped refuses to load.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu import create_model as jax_create_model
from slim_switch_moe_vit_tpu.serving import make_serve_fn as jax_serve_fn
from slim_switch_moe_vit_tpu.train_state import \
    create_train_state as jax_train_state
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.models import gates as port_gates
from slim_switch_moe_vit_tpu_torch.serving import (
    export_model,
    load_predictor,
    make_serve_fn,
)
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

IMG, NCLS, MODEL = 32, 10, "resmoe_tiny_patch16_224_expert8"
LOWERED = 0.3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gated(tmp_path_factory):
    jm = jax_create_model(MODEL, num_classes=NCLS, img_size=IMG,
                          dtype=jnp.float32)
    state = jax_train_state(jm, (1, IMG, IMG, 3), seed=7)
    assert state.gates, "resmoe must expose a gates collection"
    lowered = jax.tree_util.tree_map_with_path(
        lambda p, g: (jnp.asarray(LOWERED, jnp.float32)
                      if p[-1].key == "target_threshold" else g), state.gates)
    model = create_model(MODEL, num_classes=NCLS, img_size=IMG,
                         dtype=torch.float32)
    model.load_state_dict(from_jax_params(state.params, lowered))
    model.eval()
    out = str(tmp_path_factory.mktemp("gated") / "artifact")
    export_model(model, out, model_name=MODEL, batch_sizes=(2,),
                 device="cpu")
    x = np.random.RandomState(4).randint(0, 256, (2, IMG, IMG, 3)).astype(
        np.uint8)
    want_jax = np.asarray(jax.jit(jax_serve_fn(jm))(
        {"params": state.params, "gates": lowered}, jnp.asarray(x)),
        np.float32)
    return model, out, x, want_jax


def test_served_logits_are_the_eval_with_the_lowered_gates(gated):
    model, out, x, want_jax = gated
    pred = load_predictor(out, device="cpu")
    got = pred.predict(x)
    want = make_serve_fn(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_jax, rtol=1e-4, atol=1e-4)
    # the eval forward with the lowered gates skipped most tokens
    skips = [float(g.skip_fraction) for g in
             port_gates.gate_modules(model).values()]
    assert min(skips) > 0.5, skips


def _rewrite(out, tmp_path, edit):
    """A copy of the artifact with its params.pt edited."""
    import shutil

    bad = str(tmp_path / "bad")
    shutil.copytree(out, bad)
    path = os.path.join(bad, "params.pt")
    state = torch.load(path, weights_only=True)
    edit(state)
    torch.save(state, path)
    return bad


def test_reset_gates_are_detected(gated, tmp_path):
    """The gates' buffers reset to the default targets (0.9): the served
    logits move away from the lowered gates' eval."""
    model, out, x, _ = gated

    def reset(state):
        for k in state:
            if k.endswith("target_threshold"):
                state[k] = torch.tensor(0.9)

    got = load_predictor(_rewrite(out, tmp_path, reset),
                         device="cpu").predict(x)
    want = make_serve_fn(model)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() > 1e-2


def test_dropped_gates_are_detected(gated, tmp_path):
    """An artifact without the gates' buffers refuses to load."""
    _, out, _, _ = gated

    def drop(state):
        for k in [k for k in state if k.endswith(("threshold", "enabled"))]:
            del state[k]

    with pytest.raises(RuntimeError, match="threshold"):
        load_predictor(_rewrite(out, tmp_path, drop), device="cpu")
