"""The port's training driver under expert parallelism on the CPU: its
checkpoint, ``--resume``, the K10 form of the all-to-all dispatch, the
(data, expert) layout and parameter sharding, and the distributed init's
refusals.

- Two gloo ranks (dp = 1, ep = 2) train ``resmoe_tiny`` in
  ``capacity_fused_a2a`` with ``SSMV_A2A_PERMUTED=1``; the checkpoint rank 0
  writes has the keys and shapes of a single-rank save of the same model
  (the expert tensors gathered: parameters, AdamW moments, EMA), restores
  on a single rank, and ``--resume`` continues from it on the two ranks.
- A single-card checkpoint restores into ep = 2 and ep = 4 shards: each
  rank's experts of every parameter, moment and EMA tensor.
- NCCL with more ranks than the host has cards raises and names
  ``SSMV_DIST_BACKEND``; a failed init raises instead of running on alone.
"""
import argparse
import json

import pytest
import torch
from ep_driver_common import SMALL, run_ranks

from slim_switch_moe_vit_tpu_torch import config, create_model, main, optim
from slim_switch_moe_vit_tpu_torch.models.moe import MoEMlp
from slim_switch_moe_vit_tpu_torch.parallel import distributed, sharding
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils import checkpoint

A2A = ["--moe-dispatch", "capacity_fused_a2a"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _parse(argv):
    return argparse.ArgumentParser(
        parents=[config.get_args_parser()]).parse_args(argv)


def _layout(payload):
    """Keys and shapes of a checkpoint's tensors."""
    opt = {i: {k: tuple(v.shape) for k, v in st.items()}
           for i, st in payload["optimizer"]["state"].items()}
    return ({k: tuple(v.shape) for k, v in payload["model"].items()},
            {k: tuple(v.shape) for k, v in payload["ema_params"].items()},
            opt)


def test_ep_checkpoint_is_a_single_card_file_and_resumes(tmp_path):
    outs = run_ranks(SMALL + A2A + ["--expert-parallel", "2"], 2,
                     tmp_path / "ep", env={"SSMV_A2A_PERMUTED": "1"})
    assert "dense parameters bit-identical over 2 rank(s)" in outs[0]
    single = tmp_path / "single"
    single.mkdir()
    args = _parse(SMALL + A2A + ["--output_dir", str(single)])
    state = main.main(args)
    ep_file = torch.load(tmp_path / "ep" / "checkpoint", map_location="cpu",
                         weights_only=True)
    one_file = torch.load(single / "checkpoint", map_location="cpu",
                          weights_only=True)
    assert _layout(ep_file) == _layout(one_file)
    w1 = "blocks.1.mlp.w1"
    assert ep_file["model"][w1].shape[0] == 4  # every expert
    checkpoint.restore_checkpoint(str(tmp_path / "ep" / "checkpoint"), state)
    assert torch.equal(state.model.state_dict()[w1].cpu(),
                       ep_file["model"][w1].cpu())

    outs = run_ranks(SMALL + A2A + ["--expert-parallel", "2", "--epochs",
                                    "2", "--resume",
                                    str(tmp_path / "ep" / "checkpoint")], 2,
                     tmp_path / "ep", env={"SSMV_A2A_PERMUTED": "1"})
    assert "Resumed from" in outs[0]
    log = [json.loads(line) for line in open(tmp_path / "ep" / "log.txt")]
    assert [r["epoch"] for r in log] == [0, 1]


def _small_model():
    """A dense layer and an MoE MLP of 4 experts."""
    model = torch.nn.ModuleDict({
        "head": torch.nn.Linear(16, 8),
        "mlp": MoEMlp(16, 32, num_experts=4, dispatch_mode="capacity_fused")})
    model["mlp"].init_weights(torch.Generator().manual_seed(0))
    return model


def _trained_state():
    model = _small_model()
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cpu", opt_init=opt_init,
                               use_ema=True)
    for i, p in enumerate(model.parameters()):
        p.grad = torch.full_like(p, 1e-3 * (i + 1)) + torch.randn(
            p.shape, generator=torch.Generator().manual_seed(i)) * 1e-3
    opt_update(state.optimizer, 1e-3, 1e-3)
    return state


@pytest.mark.parametrize("ep", [2, 4])
def test_single_card_checkpoint_restores_into_expert_shards(ep, tmp_path):
    full = _trained_state()
    path = str(tmp_path / "checkpoint")
    checkpoint.save_checkpoint(path, full, epoch=3)
    names = [n for n, _ in full.model.named_parameters()]
    experts = [n for n in names if sharding.is_expert_param(n)]
    assert experts and all(n.split(".")[-1] in ("w1", "b1", "w2", "b2")
                           for n in experts)
    for j in range(ep):
        mesh = sharding.Mesh(1, ep, 0, j)
        model = _small_model()
        sharding.shard_params(model, mesh)
        opt_init, _ = optim.make_optimizer(weight_decay=0.05)
        state = create_train_state(model, device="cpu", opt_init=opt_init,
                                   use_ema=True)
        state, epoch = checkpoint.restore_checkpoint(path, state, mesh=mesh)
        assert epoch == 3
        rows = slice(j * 4 // ep, (j + 1) * 4 // ep)
        full_params = dict(full.model.named_parameters())
        for n, p in model.named_parameters():
            want = full_params[n].detach()
            want_ema = full.ema_params[n]
            moments = full.optimizer.state[full_params[n]]
            if n in experts:
                want, want_ema = want[rows], want_ema[rows]
                moments = {k: v[rows] if k != "step" else v
                           for k, v in moments.items()}
            assert torch.equal(p.detach(), want), n
            assert torch.equal(state.ema_params[n], want_ema), n
            for k, v in state.optimizer.state[p].items():
                assert torch.equal(v, moments[k]), (n, k)


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    monkeypatch.delenv(distributed.BACKEND_ENV, raising=False)
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    args = argparse.Namespace(device="cuda", dist_url="env://")
    with pytest.raises(RuntimeError, match="SSMV_DIST_BACKEND=gloo"):
        distributed.init_distributed_mode(args)
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv(distributed.BACKEND_ENV, "gloo")
    assert distributed.dist_backend("cuda") == "gloo"
    assert distributed.dist_backend("cpu") == "gloo"


def test_failed_distributed_init_raises(monkeypatch, tmp_path):
    for k, v in dict(RANK="0", WORLD_SIZE="1").items():
        monkeypatch.setenv(k, v)
    args = argparse.Namespace(device="cpu", dist_url="bogus://nowhere")
    with pytest.raises((RuntimeError, ValueError)):
        distributed.init_distributed_mode(args)
    assert not torch.distributed.is_initialized()
    assert not getattr(args, "distributed", False)


def test_one_process_layout_and_refusals():
    mesh = sharding.make_mesh()
    assert (mesh.n_data, mesh.n_expert, mesh.data_index,
            mesh.expert_index) == (1, 1, 0, 0)
    assert sharding.mesh_axis_size(None, sharding.EXPERT_AXIS) == 1
    with pytest.raises(ValueError, match="expert groups of 2"):
        sharding.make_mesh(n_expert=2)
    model = create_model("moe_tiny_patch16_224_expert8", num_classes=10,
                         img_size=32, dispatch_mode="fused")
    sharding.shard_params(model, sharding.Mesh(1, 2, 0, 1))
    mlp = model.blocks[0].mlp  # the dropless mode keeps its half, gathers
    assert mlp.mesh is not None and mlp.w1.shape[0] == 4


def test_a2a_form_refuses_a_token_count_the_expert_ranks_do_not_split():
    """As the JAX form (ops/moe.py:757-761), before any exchange."""
    from slim_switch_moe_vit_tpu_torch.ops import moe

    x = torch.randn(9, 16)
    w = [torch.randn(2, 16, 32), torch.zeros(2, 32), torch.randn(2, 32, 16),
         torch.zeros(2, 16)]
    with pytest.raises(ValueError, match="divisible by the expert axis"):
        moe.moe_forward_fused_ep_a2a(x, torch.randn(16, 4), torch.zeros(4),
                                     *w, mesh=sharding.Mesh(1, 2, 0, 0))
