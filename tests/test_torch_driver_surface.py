"""The port's training driver on the CPU with the flags its optimizer
surface, ``expert_choice`` and expert dropout bring: every ``--opt`` name,
``--opt lamb --clip-grad 1.0`` (its checkpoint restored bit for bit),
``--attn-only`` (every frozen parameter bit-identical after the steps),
``--moe-dispatch expert_choice`` and ``--drop 0.1`` on an MoE model (its training forwards
routed to ``'ragged'``). ``resmoe_tiny_patch16_224_expert8`` with 2
experts at 32 px on SYNTH, one step an epoch and a one-batch eval; the
update math of each flag is held to the JAX package in
``tests/test_torch_optim_surface.py`` and
``tests/test_torch_expert_choice_dropout.py``."""
import argparse
import json

import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu_torch import config, main, optim
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils import checkpoint
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

RUN = ["--device", "cpu", "--data-set", "SYNTH", "--synth-size", "24",
       "--input-size", "32", "--model", "resmoe_tiny_patch16_224_expert8",
       "--batch-size", "4", "--epochs", "1", "--warmup-epochs", "0",
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


def _log(out):
    return [json.loads(line) for line in open(out / "log.txt")]


@pytest.mark.parametrize("opt", optim.SUPPORTED_OPTIMIZERS)
def test_driver_trains_with_every_optimizer(opt, tmp_path):
    state = main.main(_parse(RUN + ["--opt", opt, "--output_dir",
                                    str(tmp_path)]))
    assert state.step == 1
    assert type(state.optimizer).__name__.lower() == {
        "nesterov": "sgd", "momentum": "sgd"}.get(opt, opt)
    assert np.isfinite(_log(tmp_path)[0]["train_loss"])


def test_driver_lamb_with_clip_grad_resumes_bit_for_bit(tmp_path):
    """``--opt lamb --clip-grad 1.0``: the checkpoint restores the
    parameters, the Lamb moments and step counts and the EMA bit for bit,
    and ``--resume`` trains the next epoch from it. (That a restored Lamb
    state takes the same step bit for bit:
    tests/test_torch_optim_surface.py.)"""
    flags = ["--opt", "lamb", "--clip-grad", "1.0", "--output_dir",
             str(tmp_path)]
    args = _parse(RUN + flags)
    state = main.main(args)
    init, _ = optim.make_optimizer(opt="lamb", clip_grad=1.0)
    restored, epoch = checkpoint.restore_checkpoint(
        str(tmp_path / "checkpoint"), create_train_state(
            main.build_model(args, 10, args.seed + 1), device="cpu",
            opt_init=init, use_ema=True))
    assert epoch == 0 and restored.step == state.step == 1
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(a, b), n
        assert torch.equal(state.ema_params[n], restored.ema_params[n]), n
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(state.optimizer.state[a][key],
                               restored.optimizer.state[b][key]), (n, key)
    resumed = main.main(_parse(RUN + flags + [
        "--epochs", "2", "--resume", str(tmp_path / "checkpoint")]))
    assert resumed.step == 2
    assert [r["epoch"] for r in _log(tmp_path)] == [0, 1]
    assert all(np.isfinite(r["train_loss"]) for r in _log(tmp_path))


def test_driver_attn_only_freezes_the_rest(tmp_path):
    args = _parse(RUN + ["--attn-only", "--epochs", "2", "--output_dir",
                         str(tmp_path)])
    start = main.build_model(args, 10, args.seed).state_dict()
    state = main.main(args)
    trained = optim.attn_only_mask(state.model.named_parameters())
    assert state.step == 2 and any(trained.values())
    for n, p in state.model.named_parameters():
        assert torch.equal(p.detach(), start[n]) != trained[n], n


def test_driver_trains_expert_choice(tmp_path):
    state = main.main(_parse(RUN + ["--moe-dispatch", "expert_choice",
                                    "--output_dir", str(tmp_path)]))
    assert all(blk.mlp.mode == "expert_choice" for blk in state.model.blocks)
    log = _log(tmp_path)[0]
    assert np.isfinite(log["train_loss"])
    assert log["train_balance_loss"] == 0.0
    assert 0.0 <= log["train_drop_fraction"] < 1.0


def test_driver_trains_with_expert_dropout(tmp_path):
    """``--drop 0.1`` at the default dispatch (``'fused'``): training
    forwards run ``'ragged'``, the fused kernels having no dropout path."""
    state = main.main(_parse(RUN + ["--drop", "0.1", "--moe-dispatch", "auto",
                                    "--output_dir", str(tmp_path)]))
    mlps = [blk.mlp for blk in state.model.blocks]
    assert all(m.mode == "fused" and m.drop == 0.1 for m in mlps)
    state.model.train()
    assert all(m.dispatch() == "ragged" for m in mlps)
    assert np.isfinite(_log(tmp_path)[0]["train_loss"])
