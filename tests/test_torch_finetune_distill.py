"""Fine-tuning and distillation through the port: the foreign-weight
importers against the JAX package's, and the driver's ``--finetune`` +
``--distillation-type`` run (as ``tests/test_finetune_distill.py`` runs
the JAX driver).

- ``import_torch_checkpoint``: a DeiT / timm ``.pth`` the test writes at
  48 px (a 6 x 6 grid) into a toy ViT at 32 px (4 x 4; depth 2, width 64):
  plain, distilled (``dist_token``, ``head_dist``), with the pre-logits
  layer, with a head of another class count (dropped) and the same under
  ``strict_heads`` (raises on both sides). The port's weights equal the JAX
  importer's tree (``from_jax_params``): exactly, and the resized
  position embedding within 1e-5 (``resize_pos_embed``'s bicubic vs
  ``jax.image.resize``).
- ``import_flax_npz``: an original jax-ViT ``.npz`` with and without the
  ``opt/target/`` prefix, with a head of another shape (not loaded) and
  with the pre-logits layer, against the JAX importer the same way.
- The driver on ``deit_tiny_distilled_patch16_224`` at 32 px, 1 step at
  B = 8: ``--finetune`` of a 224 px ``.pth`` (the position embedding
  resized), ``--distillation-type hard`` with a DeiT-tiny teacher and
  ``soft`` with a ``regnety_040`` teacher (timm's names), the second with
  ``--async-checkpoint``: the step's loss finite, the teacher frozen in
  eval mode, the checkpoint written; and ``--eval --finetune`` returns the
  file's weights.
"""
import argparse
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.vit import \
    VisionTransformer as JaxVisionTransformer
from slim_switch_moe_vit_tpu.utils import checkpoint as jax_ckpt
from slim_switch_moe_vit_tpu_torch import config, create_model, main
from slim_switch_moe_vit_tpu_torch.models.regnet import RegNet
from slim_switch_moe_vit_tpu_torch.models.vit import VisionTransformer
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    from_jax_params,
    import_flax_npz,
    import_torch_checkpoint,
    read_state_dict,
)

CFG = dict(img_size=32, patch_size=8, num_classes=10, embed_dim=64, depth=2,
           num_heads=2)
CASES = {"plain": ({}, 10), "distilled": (dict(distilled=True), 10),
         "pre_logits": (dict(representation_size=48), 10),
         "head_dropped": ({}, 7), "strict_heads": ({}, 7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _jax_init(items):
    jm = JaxVisionTransformer(**CFG, **dict(items))
    params = jax.jit(functools.partial(jm.init, deterministic=True))(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 3)))["params"]
    return jm, jax.tree.map(np.asarray, params)


def _pair(extra):
    """(JAX model, its seeded params, the port model holding them)."""
    jm, params = _jax_init(tuple(sorted(extra.items())))
    pm = VisionTransformer(**CFG, **extra)
    pm.load_state_dict(from_jax_params(params))
    return jm, params, pm


def _equal_to_jax(pm, jax_params):
    want = from_jax_params(jax_params)
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for name, t in want.items():
        if name == "pos_embed":
            np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                          err_msg=name)


def _timm_sd(rs, dim=64, depth=2, grid=6, patch=8, classes=10,
             distilled=False, pre_logits=None, hidden=256):
    def t(*shape):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * 0.02)

    n_extra = 2 if distilled else 1
    sd = {"patch_embed.proj.weight": t(dim, 3, patch, patch),
          "patch_embed.proj.bias": t(dim), "cls_token": t(1, 1, dim),
          "pos_embed": t(1, grid * grid + n_extra, dim),
          "norm.weight": t(dim), "norm.bias": t(dim),
          "head.weight": t(classes, pre_logits or dim),
          "head.bias": t(classes)}
    if distilled:
        sd.update({"dist_token": t(1, 1, dim),
                   "head_dist.weight": t(classes, dim),
                   "head_dist.bias": t(classes)})
    if pre_logits:
        sd.update({"pre_logits.fc.weight": t(pre_logits, dim),
                   "pre_logits.fc.bias": t(pre_logits)})
    for i in range(depth):
        b = f"blocks.{i}"
        sd.update({
            f"{b}.norm1.weight": t(dim), f"{b}.norm1.bias": t(dim),
            f"{b}.attn.qkv.weight": t(3 * dim, dim),
            f"{b}.attn.qkv.bias": t(3 * dim),
            f"{b}.attn.proj.weight": t(dim, dim),
            f"{b}.attn.proj.bias": t(dim),
            f"{b}.norm2.weight": t(dim), f"{b}.norm2.bias": t(dim),
            f"{b}.mlp.fc1.weight": t(hidden, dim),
            f"{b}.mlp.fc1.bias": t(hidden),
            f"{b}.mlp.fc2.weight": t(dim, hidden),
            f"{b}.mlp.fc2.bias": t(dim)})
    return sd


@pytest.mark.parametrize("case", CASES)
def test_torch_checkpoint_importer_matches_jax(case, tmp_path):
    extra, classes = CASES[case]
    jm, params, pm = _pair(extra)
    sd = _timm_sd(np.random.RandomState(3), classes=classes,
                  distilled=extra.get("distilled", False),
                  pre_logits=extra.get("representation_size"))
    path = str(tmp_path / "deit.pth")
    torch.save({"model": sd}, path)
    if case == "strict_heads":
        with pytest.raises(ValueError, match="class-count"):
            jax_ckpt.import_torch_checkpoint(path, jm, params,
                                             strict_heads=True)
        with pytest.raises(ValueError, match="class-count"):
            import_torch_checkpoint(path, pm, strict_heads=True)
        return
    want = jax_ckpt.import_torch_checkpoint(path, jm, params)
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    import_torch_checkpoint(path, pm)
    _equal_to_jax(pm, want)
    got = pm.state_dict()
    if case == "head_dropped":  # the model's own head is kept
        assert torch.equal(got["head.weight"], before["head.weight"])
    else:
        assert torch.equal(got["head.weight"], sd["head.weight"])
    if case == "distilled":
        assert torch.equal(got["dist_token"], sd["dist_token"])
    np.testing.assert_array_equal(
        got["patch_embed.proj.weight"].numpy(),
        sd["patch_embed.proj.weight"].permute(0, 2, 3, 1).reshape(64, -1))


class _Payload:
    """An object that runs code when unpickled."""

    def __reduce__(self):
        return (print, ("unpickled",))


@pytest.mark.parametrize("extra,loads", [
    ({"args": argparse.Namespace(model="deit_tiny", lr=5e-4, epochs=[1])},
     True),
    ({"payload": _Payload()}, False)])
def test_torch_checkpoint_reads_without_running_code(extra, loads, tmp_path,
                                                     capsys):
    """The reference's ``args`` namespace loads; any other pickled object
    raises before it runs."""
    sd = _timm_sd(np.random.RandomState(4))
    path = str(tmp_path / "deit.pth")
    torch.save({"model": sd, **extra}, path)
    if loads:
        got = read_state_dict(path)
        assert set(got) == set(sd)
        np.testing.assert_array_equal(got["cls_token"],
                                      sd["cls_token"].numpy())
    else:
        with pytest.raises(Exception, match="[Ww]eights only load failed"):
            read_state_dict(path)
        assert "unpickled" not in capsys.readouterr().out


def _jax_vit_npz(rs, prefix, head_shape=(64, 10), pre_logits=None):
    def t(*shape):
        return (rs.randn(*shape) * 0.02).astype(np.float32)

    d, h, hd = 64, 2, 32
    w = {"embedding/kernel": t(8, 8, 3, d), "embedding/bias": t(d),
         "cls": t(1, 1, d),
         "Transformer/posembed_input/pos_embedding": t(1, 37, d),
         "Transformer/encoder_norm/scale": t(d),
         "Transformer/encoder_norm/bias": t(d),
         "head/kernel": t(*head_shape), "head/bias": t(head_shape[1])}
    if pre_logits:
        w.update({"pre_logits/kernel": t(d, pre_logits),
                  "pre_logits/bias": t(pre_logits)})
    for i in range(2):
        bp = f"Transformer/encoderblock_{i}/"
        ap = bp + "MultiHeadDotProductAttention_1/"
        for ln in ("LayerNorm_0", "LayerNorm_2"):
            w[bp + ln + "/scale"], w[bp + ln + "/bias"] = t(d), t(d)
        for n in ("query", "key", "value"):
            w[ap + n + "/kernel"], w[ap + n + "/bias"] = t(d, h, hd), t(h, hd)
        w[ap + "out/kernel"], w[ap + "out/bias"] = t(h, hd, d), t(d)
        w[bp + "MlpBlock_3/Dense_0/kernel"] = t(d, 256)
        w[bp + "MlpBlock_3/Dense_0/bias"] = t(256)
        w[bp + "MlpBlock_3/Dense_1/kernel"] = t(256, d)
        w[bp + "MlpBlock_3/Dense_1/bias"] = t(d)
    return {prefix + k: v for k, v in w.items()}


@pytest.mark.parametrize("prefix,head,pre_logits", [
    ("", (64, 10), None), ("opt/target/", (64, 10), None),
    ("", (64, 7), None), ("opt/target/", (48, 10), 48)])
def test_flax_npz_importer_matches_jax(prefix, head, pre_logits, tmp_path):
    extra = dict(representation_size=pre_logits) if pre_logits else {}
    jm, params, pm = _pair(extra)
    path = str(tmp_path / "vit.npz")
    np.savez(path, **_jax_vit_npz(np.random.RandomState(4), prefix, head,
                                  pre_logits))
    before = pm.state_dict()["head.weight"].clone()
    want = jax_ckpt.import_flax_npz(path, jm, params)
    import_flax_npz(path, pm)
    _equal_to_jax(pm, want)
    if head[1] != 10:
        assert torch.equal(pm.state_dict()["head.weight"], before)


def _parse(argv):
    return argparse.ArgumentParser(
        parents=[config.get_args_parser()]).parse_args(argv)


RUN = ["--device", "cpu", "--data-set", "SYNTH", "--synth-size", "32",
       "--input-size", "32", "--model", "deit_tiny_distilled_patch16_224",
       "--batch-size", "8", "--epochs", "1", "--warmup-epochs", "0",
       "--max-steps-per-epoch", "1", "--no-repeated-aug", "--mixup", "0",
       "--cutmix", "0", "--aa", "", "--color-jitter", "0", "--reprob", "0",
       "--num_workers", "1"]


@pytest.fixture(scope="module")
def student(tmp_path_factory):
    """A deit_tiny_distilled .pth at 224 px (14 x 14 grid, 1000 classes,
    from which the driver's 10-class SYNTH run drops the heads)."""
    path = tmp_path_factory.mktemp("student") / "student.pth"
    sd = _timm_sd(np.random.RandomState(0), dim=192, depth=12, grid=14,
                  patch=16, classes=1000, distilled=True, hidden=768)
    torch.save({"model": sd}, path)
    return str(path), sd


@pytest.mark.parametrize("kind,teacher", [
    ("hard", "deit_tiny_patch16_224"), ("soft", "regnety_040")])
def test_driver_finetunes_and_distils(kind, teacher, student, tmp_path,
                                      monkeypatch):
    t_path = tmp_path / "teacher.pth"
    if teacher.startswith("regnet"):
        t_model = create_model(teacher, num_classes=10)
        torch.save({"model": t_model.state_dict()}, t_path)
    else:
        torch.save({"model": _timm_sd(np.random.RandomState(1), dim=192,
                                      depth=12, grid=14, patch=16,
                                      hidden=768)}, t_path)
    made = {}
    real = main.engine.make_train_step

    def spy(model, update_fn, criterion, **kw):
        made.update(kw)
        return real(model, update_fn, criterion, **kw)

    monkeypatch.setattr(main.engine, "make_train_step", spy)
    out = tmp_path / "out"
    flags = RUN + ["--finetune", student[0], "--distillation-type", kind,
                   "--teacher-model", teacher, "--teacher-path", str(t_path),
                   "--output_dir", str(out)]
    if kind == "soft":
        flags.append("--async-checkpoint")
    state = main.main(_parse(flags))
    assert state.step == 1
    assert made["distillation_type"] == kind
    t = made["teacher_apply"].model
    assert isinstance(t, RegNet if kind == "soft" else VisionTransformer)
    assert not t.training and not any(p.requires_grad
                                      for p in t.parameters())
    with open(out / "log.txt") as f:
        log = [json.loads(line) for line in f]
    assert np.isfinite(log[0]["train_loss"])
    payload = torch.load(out / "checkpoint", weights_only=True)
    assert payload["step"] == 1


def test_driver_eval_finetune_holds_the_file_weights(student):
    path, sd = student
    state = main.main(_parse(RUN + ["--eval", "--finetune", path]))
    want = create_model("deit_tiny_distilled_patch16_224", num_classes=10,
                        img_size=32)
    import_torch_checkpoint(path, want)
    got = state.model.state_dict()
    for name, t in want.state_dict().items():
        assert torch.equal(got[name], t), name
    assert torch.equal(got["blocks.5.attn.qkv.weight"],
                       sd["blocks.5.attn.qkv.weight"])
    assert got["pos_embed"].shape == (1, 6, 192)


def test_distillation_needs_a_teacher_path():
    with pytest.raises(ValueError, match="teacher-path"):
        main.main(_parse(RUN + ["--distillation-type", "soft"]))
