"""A converted JAX checkpoint through the port's driver and under expert
parallelism.

- ``python -m slim_switch_moe_vit_tpu_torch.main --resume run.npz``
  (``main.main`` in process) on SYNTH: the run starts at the stored epoch
  + 1, reads the plateau scheduler's sidecar and takes its step from the
  file's. The checkpoint is the JAX ``save_checkpoint`` of the driver's own
  model (``resmoe_tiny_patch16_224_expert8``, 32 px, 4 experts) after one
  AdamW update of the JAX chain, converted by
  ``scripts/jax_checkpoint_to_npz.py``.
- Two gloo ranks (1 x 2, ``tests/torch_ep_common.py::import_worker``)
  restore the same ``.npz`` under ``--expert-parallel 2``: each rank's
  parameters, EMA, AdamW moments and step equal the single-rank import's,
  its experts sliced, bit for bit.
"""
import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import jax_checkpoint_common as jc
import torch_ep_common as common
from slim_switch_moe_vit_tpu import optim as jax_optim
from slim_switch_moe_vit_tpu.train_state import TrainState as JaxTrainState
from slim_switch_moe_vit_tpu.utils import checkpoint as jax_checkpoint
from slim_switch_moe_vit_tpu_torch import config, create_model, main, optim
from slim_switch_moe_vit_tpu_torch.parallel import launch, sharding
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import restore_checkpoint
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

EXPERTS, EP = 4, 2
RUN = ["--device", "cpu", "--data-set", "SYNTH", "--synth-size", "24",
       "--input-size", "32", "--model", "resmoe_tiny_patch16_224_expert8",
       "--batch-size", "4", "--epochs", "2", "--warmup-epochs", "0",
       "--max-steps-per-epoch", "1", "--no-repeated-aug", "--mixup", "0",
       "--cutmix", "0", "--aa", "", "--color-jitter", "0", "--reprob", "0",
       "--num_workers", "1", "--lr", "1e-3", "--moe-dispatch", "ragged",
       "--num-experts", str(EXPERTS), "--sched", "plateau"]
SCHED = {"current_lr": 3e-4, "best": 0.25, "num_bad": 1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(argv):
    return argparse.ArgumentParser(
        parents=[config.get_args_parser()]).parse_args(argv)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    """The driver's model after one update of the JAX AdamW chain, saved
    by the JAX ``save_checkpoint`` at epoch 0 with both sidecars and
    converted."""
    tmp = tmp_path_factory.mktemp("jax_driver")
    args = _parse(RUN)
    params, gates = jc.jax_trees(main.build_model(args, 10, args.seed))
    init, update = jax_optim.make_optimizer(params, weight_decay=0.05)
    rs = np.random.RandomState(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rs.randn(*p.shape).astype(np.float32) * 0.1),
        params)
    updates, opt_state = jax.jit(update)(grads, init(params), params,
                                         1e-3, 1e-3)
    new = optax.apply_updates(params, updates)
    state = JaxTrainState(params=new, opt_state=opt_state, gates=gates,
                          ema_params=jax.tree.map(lambda p: p * 0.5, new),
                          rng=jax.random.PRNGKey(5),
                          step=jnp.asarray(1, jnp.int32))
    ckpt = str(tmp / "checkpoint")
    jax_checkpoint.save_checkpoint(ckpt, state, 0, extra={
        "args": {"model": args.model}, "sched": SCHED})
    out = str(tmp / "run.npz")
    jc.converter().convert(ckpt, out)
    return out


def test_driver_resumes_a_jax_run(npz, tmp_path, capsys):
    out = tmp_path / "out"
    state = main.main(_parse(RUN + ["--resume", npz, "--output_dir",
                                    str(out)]))
    printed = capsys.readouterr().out
    assert f"Resumed from {npz} at epoch 0" in printed
    assert f"Resumed scheduler state: {SCHED}" in printed
    log = [json.loads(line) for line in open(out / "log.txt")]
    assert [r["epoch"] for r in log] == [1]
    assert state.step == 2 and np.isfinite(log[0]["train_loss"])


def _single_rank():
    model = create_model(jc.MODEL, num_classes=10, img_size=32,
                         num_experts=EXPERTS)
    init, _ = optim.make_optimizer(weight_decay=0.05)
    return create_train_state(model, device="cpu", opt_init=init,
                              use_ema=True)


def test_expert_parallel_import_is_the_single_rank_import(npz, tmp_path):
    launch.spawn(common.import_worker, EP, (npz, str(tmp_path), EXPERTS, EP),
                 init_file=str(tmp_path / "store"), device="cpu")
    full, _ = restore_checkpoint(npz, _single_rank())
    experts = {n for n, _ in full.model.named_parameters()
               if sharding.is_expert_param(n)}
    assert experts
    for r in range(EP):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert int(got.pop("step")) == full.step == 1
        rows = slice(r * EXPERTS // EP, (r + 1) * EXPERTS // EP)
        want = {"step/" + n: np.asarray(1.0, np.float32)
                for n in dict(full.model.named_parameters())}
        for n, p in full.model.named_parameters():
            part = rows if n in experts else slice(None)
            want[f"param/{n}"] = p.detach().numpy()[part]
            want[f"ema/{n}"] = full.ema_params[n].numpy()[part]
            for k in ("exp_avg", "exp_avg_sq"):
                want[f"{k}/{n}"] = full.optimizer.state[p][k].numpy()[part]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"rank {r} {k}")
