"""The port's export CLI on its own checkpoints, and ``resize_pos_embed``
against the JAX package's.

A tiny gated ResMoE (``resmoe_tiny_patch16_224_expert8`` at 32 px, 2 x 2
patches) is saved by ``utils/checkpoint.py::save_checkpoint`` with an EMA
that differs from the parameters and a gate threshold that differs from
its initial value, then exported through the CLI at 48 px (a 3 x 3 grid):

- with ``--use-ema`` the artifact holds the EMA and the gates' buffers,
  ``pos_embed`` resized from the 2 x 2 grid to 3 x 3 as
  ``resize_pos_embed`` gives it, and serves one request;
- without it (``serving/export.py::checkpoint_state``, what the CLI loads)
  the parameters; a checkpoint saved without an EMA is refused under
  ``--use-ema``.

``resize_pos_embed`` on a 14 x 14 grid (ViT at 224 px), resized up to 24
and 37 and down to 12, matches the JAX function (``jax.image.resize``
bicubic) within 1e-5.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.vit import \
    resize_pos_embed as jax_resize_pos_embed
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.models.vit import (VisionTransformer,
                                                      resize_pos_embed)
from slim_switch_moe_vit_tpu_torch.serving import export
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import save_checkpoint
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

MODEL = "resmoe_tiny_patch16_224_expert8"
GATE = "blocks.0.moe_gate.threshold"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(path with EMA, path without, the saved model state, the EMA)."""
    tmp = tmp_path_factory.mktemp("ckpt")
    model = create_model(MODEL, num_classes=10, img_size=32)
    state = create_train_state(model, device="cpu", use_ema=True)
    with torch.no_grad():
        for t in state.ema_params.values():
            t.mul_(0.5).add_(0.01)
        model.get_buffer(GATE).fill_(0.75)
    save_checkpoint(str(tmp / "with_ema"), state, epoch=1)
    state.ema_params = None
    save_checkpoint(str(tmp / "no_ema"), state, epoch=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    ema = torch.load(tmp / "with_ema", weights_only=True)["ema_params"]
    return str(tmp / "with_ema"), str(tmp / "no_ema"), saved, ema


def test_export_serves_the_ema_of_a_port_checkpoint(checkpoints, tmp_path):
    """The CLI with --use-ema at a new --img-size: the artifact holds the
    EMA, the gates' buffers and the resized pos_embed; one request."""
    with_ema, _, saved, ema = checkpoints
    out = str(tmp_path / "artifact")
    manifest = export.main([
        "--model", MODEL, "--output", out, "--checkpoint", with_ema,
        "--use-ema", "--num-classes", "10", "--img-size", "48", "--dtype",
        "float32", "--batch-sizes", "2", "--device", "cpu"])
    assert manifest["img_size"] == 48 and manifest["use_ema"]
    got = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    want = {**saved, **ema}
    _check_state(got, want)
    pred = export.load_predictor(out, device="cpu")
    logits = pred.predict(np.random.RandomState(0).randint(
        0, 256, (3, 48, 48, 3), dtype=np.uint8))
    assert logits.shape == (3, 10) and np.isfinite(logits).all()


def _check_state(got, want):
    assert got[GATE].item() == 0.75
    assert got["pos_embed"].shape == (1, 10, 192)
    assert torch.equal(got["pos_embed"],
                       resize_pos_embed(want["pos_embed"], 1, 3))
    assert got.keys() == want.keys()
    for name, t in want.items():
        if name != "pos_embed":
            assert torch.equal(got[name].float(), t.float()), name


def test_checkpoint_state_without_ema(checkpoints):
    """What the CLI loads without --use-ema: the parameters (and gates);
    with --use-ema, a checkpoint without an EMA is refused."""
    with_ema, no_ema, saved, _ = checkpoints
    # the checkpoint is read against the model's pos_embed grid only
    template = VisionTransformer(img_size=48, embed_dim=192, depth=0,
                                 num_heads=3, num_classes=10)
    for path in (with_ema, no_ema):
        _check_state(export.checkpoint_state(path, template), saved)
    with pytest.raises(ValueError, match="no EMA"):
        export.checkpoint_state(no_ema, template, use_ema=True)


@pytest.mark.parametrize("new_grid", [24, 37, 12])
def test_resize_pos_embed_matches_jax(new_grid):
    pos = np.random.RandomState(new_grid).randn(1, 1 + 14 * 14, 64).astype(
        np.float32)
    want = np.asarray(jax_resize_pos_embed(jnp.asarray(pos), 1, new_grid))
    got = resize_pos_embed(torch.from_numpy(pos), 1, new_grid).numpy()
    assert got.shape == want.shape == (1, 1 + new_grid ** 2, 64)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
