"""The port's training driver (``main.py``) on the CPU, and the host pieces
it shares with the JAX package.

``main()`` runs ``deit_tiny_patch16_224`` at 32 px on ``SYNTH`` with every
augmentation flag at its default (RandAugment, color jitter, erasing,
mixup and cutmix), and ``resmoe_tiny_patch16_224_expert8`` at 32 px
with ``--device cpu``: 2 tasks of 2 epochs, rehearsal, ``--fused-optimizer``
(K7's plain version on CPU tensors), the gates disabled at each task's
start and annealed after each epoch, then ``--resume`` from its checkpoint
and ``--eval --use-flash-attention``. The pieces that decide what the run
sees are held to the JAX package's functions on the same inputs, exactly:
the config parser's flags and defaults (all but ``--device``, ``cuda``
here, ``tpu`` there), the per-epoch schedule values of the four schedules,
the continual-learning split indices, the sampler orders, the crop boxes
and the rehearsal picks. The crops' pixels come from the port's copy of the
JAX package's native crop library, so they equal the JAX package's native
path bit for bit.
"""
import argparse
import json
import types

import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu import config as jax_config
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.data import datasets as jax_datasets
from slim_switch_moe_vit_tpu.data import native_loader as jax_native
from slim_switch_moe_vit_tpu.data import samplers as jax_samplers
from slim_switch_moe_vit_tpu.data import transforms as jax_transforms
from slim_switch_moe_vit_tpu.utils import memory as jax_memory
from slim_switch_moe_vit_tpu_torch import config, main, optim
from slim_switch_moe_vit_tpu_torch.data import datasets, samplers, transforms
from slim_switch_moe_vit_tpu_torch.models import gates
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils import checkpoint, memory
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

RUN = ["--device", "cpu", "--data-set", "SYNTH", "--synth-size", "40",
       "--input-size", "32", "--model", "resmoe_tiny_patch16_224_expert8",
       "--batch-size", "4", "--epochs", "2", "--num-tasks", "2",
       "--rehearsal", "--rehearsal-batch-size", "4", "--fused-optimizer",
       "--warmup-epochs", "0", "--gate-epoch-offset", "0",
       "--max-steps-per-epoch", "1", "--no-repeated-aug", "--mixup", "0",
       "--cutmix", "0", "--aa", "", "--color-jitter", "0", "--reprob", "0",
       "--num_workers", "1", "--lr", "1e-3", "--moe-dispatch", "ragged",
       "--num-experts", "2"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(argv):
    return argparse.ArgumentParser(
        parents=[config.get_args_parser()]).parse_args(argv)


def _defaults(parser):
    return {a.dest: (tuple(a.option_strings), a.default)
            for a in parser._actions}


def test_config_has_every_jax_flag_with_its_default():
    want = _defaults(jax_config.get_args_parser())
    got = _defaults(config.get_args_parser())
    assert got.keys() == want.keys()
    for dest, (opts, default) in want.items():
        if dest == "device":
            assert (got[dest], default) == ((opts, "cuda"), "tpu")
            continue
        assert got[dest] == (opts, default), dest
    args = _parse(["--device", "cpu"])
    assert args.device == "cpu"
    with pytest.raises(SystemExit):
        _parse(["--device", "tpu"])


@pytest.mark.parametrize("sched", ["cosine", "tanh", "step", "plateau"])
def test_schedules_match_jax_epoch_by_epoch(sched):
    kw = dict(warmup_epochs=3, warmup_lr=1e-6, min_lr=1e-5,
              cooldown_epochs=2, decay_epochs=4, decay_rate=0.5,
              patience_epochs=1,
              noise_range=None if sched == "plateau" else [0.3, 0.8],
              noise_pct=0.5, noise_std=1.0, noise_seed=7)
    want = jax_optim.create_scheduler(sched, 4e-3, 12, **kw)
    got = optim.create_scheduler(sched, 4e-3, 12, **kw)
    assert optim.SUPPORTED_SCHEDULERS == jax_optim.SUPPORTED_SCHEDULERS
    metric = [10.0, 12.0, 12.0, 11.0, 11.0, 13.0, 13.0, 12.0, 9.0, 9.0, 9.0,
              9.0, 9.0, 9.0, 9.0]
    for epoch in range(15):
        assert got(epoch) == want(epoch), epoch
        if sched == "plateau":
            got.observe(epoch, metric[epoch])
            want.observe(epoch, metric[epoch])
            assert got.state_dict() == want.state_dict()
    assert optim.scaled_lr(5e-4, 128, 1, False) == jax_optim.scaled_lr(
        5e-4, 128, 1, False)


def _synth_args(**over):
    args = types.SimpleNamespace(data_set="SYNTH", synth_size=64,
                                 synth_classes=10, synth_learnable=False,
                                 input_size=48, seed=3, src=False,
                                 train_interpolation="bicubic",
                                 eval_crop_ratio=0.875, data_path="")
    args.__dict__.update(over)
    return args


def test_split_indices_and_sampler_orders_match_jax():
    args = _synth_args()
    for is_train in (True, False):
        for start, size in ((0, 5), (5, 5), (3, 4)):
            _, n_got, got = datasets.build_split_dataset(is_train, args, start,
                                                         size)
            _, n_want, want = jax_datasets.build_split_dataset(
                is_train, args, start, size)
            assert n_got == n_want == 10
            np.testing.assert_array_equal(got, want)
    for n in (37, 300, 600):
        pairs = [(samplers.RASampler(n, 1, 0, shuffle=True),
                  jax_samplers.RASampler(n, 1, 0, shuffle=True)),
                 (samplers.DistributedSampler(n, 1, 0, shuffle=True),
                  jax_samplers.DistributedSampler(n, 1, 0, shuffle=True)),
                 (samplers.DistributedSampler(n, 2, 1, shuffle=False),
                  jax_samplers.DistributedSampler(n, 2, 1, shuffle=False)),
                 (samplers.SequentialSampler(n),
                  jax_samplers.SequentialSampler(n))]
        for epoch in (0, 1, 5):
            for a, b in pairs:
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert len(a) == len(b) and list(a) == list(b)


def _smooth(H, W):
    y, x = np.mgrid[0:H, 0:W]
    return np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0)
                     for c in range(3)], -1).astype(np.uint8)


def test_crop_boxes_and_pixels_match_jax():
    """The same (seed, epoch, index) -> the same RandomResizedCrop box and,
    through the native library on both sides, the same pixels; the eval
    center crop too."""
    assert jax_native.native_available()  # tests/conftest.py builds it
    got_tf = transforms.TrainTransform(48, seed=3)
    want_tf = jax_transforms.TrainTransform(48, seed=3)
    noise = np.random.RandomState(0).randint(0, 256, (90, 70, 3)).astype(
        np.uint8)
    for epoch in (0, 2):
        got_tf.set_epoch(epoch)
        want_tf.set_epoch(epoch)
        for index in range(12):
            box = transforms.rrc_params(noise.shape, got_tf._rng(index))
            assert box == jax_transforms.rrc_params(noise.shape,
                                                    want_tf._rng(index))
            for img in (_smooth(90, 70), noise):
                a, b = got_tf(img, index), want_tf(img, index)
                assert a.shape == b.shape == (48, 48, 3)
                np.testing.assert_array_equal(a, b, err_msg=str(index))
    ev, want_ev = transforms.EvalTransform(48), jax_transforms.EvalTransform(48)
    for img in (_smooth(100, 80), noise):
        np.testing.assert_array_equal(ev(img), want_ev(img))
    # <= 32 px: the reflect-padded random crop (the native library's, where
    # the JAX package pads with numpy)
    small, want_small = (transforms.TrainTransform(32, seed=3),
                         jax_transforms.TrainTransform(32, seed=3))
    for index in range(6):
        np.testing.assert_array_equal(small(noise[:32, :32], index),
                                      want_small(noise[:32, :32], index))


def test_rehearsal_memory_matches_jax():
    got = memory.RehearsalMemory(6, (3, 8, 8), (10,), use_indices=True)
    want = jax_memory.RehearsalMemory(6, (3, 8, 8), (10,), use_indices=True)
    for seed, n in ((0, 4), (1, 5), (2, 3)):
        idx = np.arange(n) + 10 * seed
        np.random.seed(seed)
        got.add(idx, idx, n)
        np.random.seed(seed)
        want.add(idx, idx, n)
        assert len(got) == len(want)
        np.testing.assert_array_equal(got.batch, want.batch)
        np.testing.assert_array_equal(got.labels, want.labels)


def _log(path):
    with open(path / "log.txt") as f:
        return [json.loads(line) for line in f]


def test_driver_trains_resumes_and_evaluates(tmp_path, monkeypatch, capsys):
    after_epoch = []  # (epoch_in_task, thresholds, enabled) per anneal
    real_anneal = main.apply_epoch_anneal

    def spy_anneal(model, plan, epoch):
        real_anneal(model, plan, epoch)
        mods = gates.gate_modules(model).values()
        after_epoch.append((epoch, {float(g.threshold) for g in mods},
                            {float(g.enabled) for g in mods}))

    launches = []
    real_fused = optim.fused_adamw_ema

    def spy_fused(*a, **kw):
        launches.append(kw["lr_base"])
        return real_fused(*a, **kw)

    monkeypatch.setattr(main, "apply_epoch_anneal", spy_anneal)
    monkeypatch.setattr(optim, "fused_adamw_ema", spy_fused)
    out = tmp_path / "run"
    state = main.main(_parse(RUN + ["--output_dir", str(out)]))
    # task 1: 2 epochs x 1 step; task 2: 2 x (1 step + 1 rehearsal step)
    assert state.step == 6 and len(launches) == 6
    t95 = float(np.float32(1.0) - np.float32(0.05))
    assert after_epoch == [(0, {t95}, {1.0}), (1, {float(np.float32(0.9))},
                                               {1.0}),
                           (0, {float(np.float32(0.9))}, {1.0}),
                           (1, {float(np.float32(0.9))}, {1.0})]
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1, 2, 3]
    assert all(np.isfinite(r["train_loss"]) for r in log)
    # the gates are disabled through each task's first epoch
    assert log[0]["train_skip_fraction"] == 0.0
    assert "Rehearsal:" in capsys.readouterr().out

    # the checkpoint restores every tensor bit for bit
    args = _parse(RUN)
    fresh = main.build_model(args, 10, args.seed)
    opt_init, _ = optim.make_optimizer(weight_decay=args.weight_decay)
    restored, epoch = checkpoint.restore_checkpoint(
        str(out / "checkpoint"), create_train_state(
            fresh, device="cpu", opt_init=opt_init, use_ema=True))
    assert epoch == 3 and restored.step == state.step
    for (n, a), b in zip(state.model.state_dict().items(),
                         restored.model.state_dict().values()):
        assert torch.equal(a, b), n
    for n, e in state.ema_params.items():
        assert torch.equal(e, restored.ema_params[n]), n
    for p, q in zip(state.model.parameters(), restored.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[p][key],
                               restored.optimizer.state[q][key])
    assert torch.equal(state.generator.get_state(),
                       restored.generator.get_state())
    assert checkpoint.load_checkpoint_args(str(out / "checkpoint"))[
        "model"] == "resmoe_tiny_patch16_224_expert8"

    # --resume continues after the saved epoch: with one task of 5 epochs,
    # epoch 4 is left to train
    resumed = main.main(_parse(RUN + ["--output_dir", str(out), "--epochs",
                                      "5", "--num-tasks", "1", "--resume",
                                      str(out / "checkpoint")]))
    assert resumed.step == 7
    assert [r["epoch"] for r in _log(out)] == [0, 1, 2, 3, 4]

    # --eval through the flash forward, from the first run's checkpoint
    evaluated = main.main(_parse(RUN + ["--eval", "--use-flash-attention",
                                        "--resume",
                                        str(out / "best_checkpoint")]))
    assert all(blk.attn.use_flash for blk in evaluated.model.blocks)
    assert "Accuracy of the network on the 40 test images" in \
        capsys.readouterr().out


def test_driver_trains_with_capacity_dispatch(tmp_path):
    """``--moe-dispatch capacity_fused --capacity-factor 1.25`` runs through
    the driver (2 steps, the fused capacity form on the plain FFN), and the
    epoch logs carry each epoch's mean ``drop_fraction``."""
    out = tmp_path / "cap"
    state = main.main(_parse(RUN + [
        "--output_dir", str(out), "--num-tasks", "1", "--num-experts", "4",
        "--moe-dispatch", "capacity_fused", "--capacity-factor", "1.25"]))
    assert state.step == 2
    assert all(blk.mlp.mode == "capacity_fused"
               and blk.mlp.capacity_factor == 1.25
               for blk in state.model.blocks)
    log = _log(out)
    assert [r["epoch"] for r in log] == [0, 1]
    for r in log:
        assert np.isfinite(r["train_loss"])
        assert 0.0 <= r["train_drop_fraction"] < 1.0


@pytest.mark.parametrize("flags,error,match", [
    (["--opt", "bogus"], ValueError, "not implemented"),
    (["--opt", "adagrad"], ValueError, "not implemented"),
    # RUN has --fused-optimizer: K7 is AdamW alone, and the port raises
    # where the JAX driver warns and takes the optimizer chain
    (["--opt", "sgd"], ValueError, "--fused-optimizer .* --opt sgd"),
    (["--clip-grad", "1.0"], ValueError, "--fused-optimizer .* --clip-grad"),
    (["--attn-only"], ValueError, "--fused-optimizer .* --attn-only"),
    (["--distillation-type", "hard"], ValueError, "teacher-path"),
])
def test_driver_refuses_what_is_not_ported(flags, error, match):
    with pytest.raises(error, match=match):
        main.main(_parse(RUN + flags))


def test_driver_runs_at_its_default_augmentation(tmp_path, monkeypatch):
    """``deit_tiny_patch16_224`` at 32 px on SYNTH with every augmentation
    flag at its default (RandAugment rand-m9-mstd0.5-inc1, color jitter
    0.3, erasing 0.25, mixup 0.8 / cutmix 1.0 with smoothing 0.1,
    repeated augmentation): two steps through the mixup step and the
    soft-target loss, finite losses, and an eval."""
    made = {}
    real = main.engine.make_train_step

    def spy(model, update_fn, criterion, **kw):
        made.update(kw, criterion=criterion)
        return real(model, update_fn, criterion, **kw)

    monkeypatch.setattr(main.engine, "make_train_step", spy)
    out = tmp_path / "defaults"
    state = main.main(_parse([
        "--device", "cpu", "--data-set", "SYNTH", "--synth-size", "256",
        "--input-size", "32", "--model", "deit_tiny_patch16_224",
        "--batch-size", "8", "--epochs", "1", "--max-steps-per-epoch", "2",
        "--num_workers", "2", "--output_dir", str(out)]))
    assert state.step == 2
    assert made["mixup_fn"] is not None and made["augment_fn"] is not None
    assert made["criterion"].__name__ == "soft_target_cross_entropy"
    log = _log(out)
    assert len(log) == 1 and np.isfinite(log[0]["train_loss"])
    assert np.isfinite(log[0]["test_loss"])


def test_driver_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main.main(_parse([a for a in RUN if a not in ("--device", "cpu")]))
