"""The port's RegNetY teacher (``models/regnet.py``) vs the JAX package.

- A toy ``RegNet`` (two stages of widths 8 and 16, depths 1 and 2, group
  width 4, SE, a downsample in each stage's first block) at 32 px, seeded
  JAX weights carried over by ``from_jax_params`` (HWIO kernels, grouped
  ones included, to OIHW; ``batch_stats`` to the BatchNorm buffers): the
  eval logits, and in ``train()`` mode the logits and the updated running
  statistics (flax's rule: 0.9 old + 0.1 batch, the biased variance),
  within 1e-5 + 1e-4 |ref| in f32.
- ``regnety_160``'s and ``regnety_040``'s stage widths, depths and group
  widths against the JAX functions, read from models built on the
  ``meta`` device (no forward, no weights).
- ``import_torch_regnet`` on a timm-named ``.pth`` the test writes: the
  port's model equals the JAX importer's tree element for element, a
  missing name raises ``KeyError`` and a wrong shape ``ValueError``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models import regnet as jax_regnet
from slim_switch_moe_vit_tpu_torch.models import regnet, registry
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

TOY = dict(stage_widths=[8, 16], stage_depths=[1, 2], group_width=4,
           se_ratio=0.25, stem_width=8, num_classes=5)
ATOL, RTOL = 1e-5, 1e-4


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL, err_msg=what)


@pytest.fixture(scope="module")
def toy():
    """(JAX model, JAX variables with non-trivial BN statistics, port
    model with the same weights, images)."""
    jm = jax_regnet.RegNet(**TOY)
    rs = np.random.RandomState(0)
    x = rs.randn(4, 32, 32, 3).astype(np.float32)
    v = jax.jit(jm.init)({"params": jax.random.PRNGKey(0)}, jnp.asarray(x))
    leaves, tree = jax.tree_util.tree_flatten(v)
    # random scales, biases and statistics, so every path is seen
    leaves = [np.asarray(a) + 0.1 * rs.randn(*a.shape).astype(np.float32)
              if a.ndim == 1 else np.asarray(a) for a in leaves]
    v = jax.tree_util.tree_unflatten(tree, leaves)
    v = {"params": v["params"], "batch_stats": jax.tree.map(
        lambda a: np.abs(a) + 0.5 if a is not None else a,
        v["batch_stats"])}
    pm = regnet.RegNet(**TOY)
    pm.load_state_dict(from_jax_params(v["params"],
                                       batch_stats=v["batch_stats"]))
    return jm, v, pm, x


def test_toy_regnet_eval_matches_jax(toy):
    jm, v, pm, x = toy
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    _close(got, want, "eval logits")


def test_toy_regnet_train_mode_matches_jax_with_running_stats(toy):
    jm, v, pm, x = toy
    want, upd = jax.jit(functools.partial(
        jm.apply, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
    pm = regnet.RegNet(**TOY)
    pm.load_state_dict(from_jax_params(v["params"],
                                       batch_stats=v["batch_stats"]))
    with torch.no_grad():
        got = pm.train()(torch.from_numpy(x))
    _close(got, want, "train-mode logits (batch statistics)")
    stats = from_jax_params({}, batch_stats=upd["batch_stats"])
    sd = pm.state_dict()
    assert stats.keys() == {k for k in sd if k.endswith(("running_mean",
                                                         "running_var"))}
    for name, t in stats.items():
        _close(sd[name], t, name)
    # the rule is flax's (biased variance), not BatchNorm2d's (unbiased)
    n = 4 * 16 * 16  # the stem's output positions
    with torch.no_grad():
        xs = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2), pm.stem.conv.weight,
            stride=2, padding=1)
    biased = xs.var(dim=(0, 2, 3), unbiased=False)
    init_var = torch.from_numpy(np.asarray(v["batch_stats"]["stem"]["bn"]["var"]))
    _close(sd["stem.bn.running_var"], 0.9 * init_var + 0.1 * biased)
    assert not torch.allclose(sd["stem.bn.running_var"],
                              0.9 * init_var + 0.1 * biased * n / (n - 1),
                              atol=0, rtol=1e-6)


@pytest.mark.parametrize("name,args", [
    ("regnety_160", (106.23, 200, 2.48, 18, 112)),
    ("regnety_040", (31.41, 96, 2.24, 22, 64)),
])
def test_registered_widths_depths_groups_match_jax(name, args):
    wa, w0, wm, depth, gw = args
    assert (regnet.generate_regnet_widths(wa, w0, wm, depth)
            == jax_regnet.generate_regnet_widths(wa, w0, wm, depth))
    w, d = jax_regnet.generate_regnet_widths(wa, w0, wm, depth)
    assert (regnet.adjust_widths_groups(w, [gw] * len(w))
            == jax_regnet.adjust_widths_groups(w, [gw] * len(w)))
    jm = getattr(jax_regnet, name)(num_classes=1000, img_size=224)
    with torch.device("meta"):
        pm = registry._REGISTRY[name](num_classes=1000, img_size=224)
    assert pm.stage_widths == list(jm.stage_widths)
    assert pm.stage_depths == list(jm.stage_depths)
    for width, stage in zip(pm.stage_widths, pm.stages()):
        for blk in stage.values():
            assert blk.conv2.conv.groups == width // jm.group_width
            assert blk.se.fc1.out_channels > 0
    if name == "regnety_160":
        assert pm.stage_widths == [224, 448, 1232, 3024]
        assert pm.stage_depths == [2, 4, 11, 1]
    assert pm.head.fc.weight.shape == (1000, pm.stage_widths[-1])


def _timm_sd(jm, v):
    """A timm-named torch state_dict of the JAX toy's weights, as the JAX
    package's own import test writes one (OIHW kernels)."""
    p, s = v["params"], v["batch_stats"]
    sd = {}

    def cbn(pp, ss, prefix):
        sd[f"{prefix}.conv.weight"] = torch.tensor(
            np.asarray(pp["conv"]["kernel"]).transpose(3, 2, 0, 1).copy())
        sd[f"{prefix}.bn.weight"] = torch.tensor(np.asarray(pp["bn"]["scale"]))
        sd[f"{prefix}.bn.bias"] = torch.tensor(np.asarray(pp["bn"]["bias"]))
        sd[f"{prefix}.bn.running_mean"] = torch.tensor(
            np.asarray(ss["bn"]["mean"]))
        sd[f"{prefix}.bn.running_var"] = torch.tensor(
            np.asarray(ss["bn"]["var"]))
        sd[f"{prefix}.bn.num_batches_tracked"] = torch.tensor(7)

    cbn(p["stem"], s["stem"], "stem")
    for si, d in enumerate(jm.stage_depths):
        for bi in range(d):
            j, t = f"s{si + 1}_b{bi + 1}", f"s{si + 1}.b{bi + 1}"
            for cn in ("conv1", "conv2", "conv3"):
                cbn(p[j][cn], s[j][cn], f"{t}.{cn}")
            for fc in ("fc1", "fc2"):
                sd[f"{t}.se.{fc}.weight"] = torch.tensor(np.asarray(
                    p[j]["se"][fc]["kernel"]).transpose(3, 2, 0, 1).copy())
                sd[f"{t}.se.{fc}.bias"] = torch.tensor(
                    np.asarray(p[j]["se"][fc]["bias"]))
            if "downsample" in p[j]:
                cbn(p[j]["downsample"], s[j]["downsample"],
                    f"{t}.downsample")
    sd["head.fc.weight"] = torch.tensor(np.asarray(p["head_fc"]["kernel"]).T
                                        .copy())
    sd["head.fc.bias"] = torch.tensor(np.asarray(p["head_fc"]["bias"]))
    return sd


def test_import_torch_regnet_matches_jax_importer(toy, tmp_path):
    jm, v, _, x = toy
    sd = _timm_sd(jm, v)
    path = tmp_path / "regnet.pth"
    torch.save({"model": sd}, path)
    jax_vars = jax_regnet.import_torch_regnet(str(path), jm, v)
    pm = regnet.import_torch_regnet(str(path), regnet.RegNet(**TOY))
    want = from_jax_params(jax_vars["params"],
                           batch_stats=jax_vars["batch_stats"])
    got = pm.state_dict()
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy(),
                                      err_msg=name)
    with torch.no_grad():
        _close(pm.eval()(torch.from_numpy(x)), jm.apply(jax_vars,
                                                        jnp.asarray(x)))
    # round trip through the port's own state_dict (timm's names)
    again = regnet.import_torch_regnet(pm.state_dict(), regnet.RegNet(**TOY))
    for name, t in again.state_dict().items():
        assert torch.equal(t, got[name]), name
    with pytest.raises(KeyError, match="s2.b2.conv3.bn.running_var"):
        regnet.import_torch_regnet(
            {k: t for k, t in sd.items()
             if k != "s2.b2.conv3.bn.running_var"}, regnet.RegNet(**TOY))
    with pytest.raises(ValueError, match="head.fc.weight"):
        regnet.import_torch_regnet(
            sd, regnet.RegNet(**dict(TOY, num_classes=7)))
