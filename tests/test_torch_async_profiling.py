"""The port's asynchronous checkpoint saves and its profiling helpers.

- ``save_checkpoint(..., use_async=True)`` (``--async-checkpoint``): the
  state is copied to the host in the call, so a step taken right after
  does not reach the file; the file equals a synchronous save of the same
  state tensor for tensor, and ``restore_checkpoint`` (which waits for
  the save first) restores it bit for bit. Saves land one at a time in call
  order, each by an atomic rename (no temporary file is left). A failed
  save raises in ``wait_for_checkpoints`` and in the next save, never
  silently.
- ``utils/profiling.summarize_trace`` on a Chrome trace the test writes
  in ``torch.profiler``'s format (as ``tests/test_profiling.py`` checks
  the JAX parser on a Perfetto trace): only the device categories
  (``kernel``, ``gpu_memcpy``, ``gpu_memset``) count, events sum by name,
  ms per step, largest first, ``top`` rows, the newest trace read, and
  ``FileNotFoundError`` without a trace; ``trace`` writes a trace it
  reads back.
"""
import concurrent.futures
import gzip
import json
import os

import pytest
import torch

from slim_switch_moe_vit_tpu_torch import optim
from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
from slim_switch_moe_vit_tpu_torch.utils import checkpoint, profiling


def _state(seed: int = 0):
    model = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.GELU(),
                                torch.nn.Linear(32, 8))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
    state = create_train_state(model, device="cpu", opt_init=opt_init,
                               use_ema=True, seed=seed)
    return state, opt_update


def _step(state, opt_update, k: int) -> None:
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(k))
    state.optimizer.zero_grad()
    state.model(x).square().sum().backward()
    opt_update(state.optimizer, 1e-2, 1e-2)
    with torch.no_grad():
        for name, p in state.model.named_parameters():
            state.ema_params[name].lerp_(p, 0.5)
    state.step += 1


def _flat(obj, prefix=""):
    if torch.is_tensor(obj):
        return {prefix: obj}
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(obj, (list, tuple)):
        out = {}
        for i, v in enumerate(obj):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: obj}


def test_async_save_equals_sync_save_and_restores(tmp_path):
    state, opt_update = _state()
    for k in range(2):
        _step(state, opt_update, k)
    checkpoint.save_checkpoint(str(tmp_path / "sync"), state, epoch=3,
                               extra={"args": {"lr": 0.1}})
    checkpoint.save_checkpoint(str(tmp_path / "async"), state, epoch=3,
                               extra={"args": {"lr": 0.1}}, use_async=True)
    saved_model = {k: v.clone() for k, v in state.model.state_dict().items()}
    _step(state, opt_update, 7)  # must not reach the async file
    checkpoint.wait_for_checkpoints()
    sync = torch.load(tmp_path / "sync", weights_only=True)
    asyn = torch.load(tmp_path / "async", weights_only=True)
    fs, fa = _flat(sync), _flat(asyn)
    assert fs.keys() == fa.keys()
    for k in fs:
        if torch.is_tensor(fs[k]):
            assert torch.equal(fs[k], fa[k]), k
        else:
            assert fs[k] == fa[k], k
    assert checkpoint.load_checkpoint_args(str(tmp_path / "async")) == \
        {"lr": 0.1}
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]

    fresh, _ = _state(seed=1)
    fresh, epoch = checkpoint.restore_checkpoint(str(tmp_path / "async"),
                                                 fresh)
    assert epoch == 3 and fresh.step == 2
    for name, t in fresh.model.state_dict().items():
        assert torch.equal(t, saved_model[name]), name
    for k, v in _flat(fresh.optimizer.state_dict()).items():
        if torch.is_tensor(v):
            assert torch.equal(v, fs["/optimizer" + k]), k


def test_async_saves_land_in_order(tmp_path):
    state, opt_update = _state()
    for epoch in range(4):
        _step(state, opt_update, epoch)
        checkpoint.save_checkpoint(str(tmp_path / "ckpt"), state, epoch,
                                   use_async=True)
    checkpoint.wait_for_checkpoints()
    last = torch.load(tmp_path / "ckpt", weights_only=True)
    assert last["epoch"] == 3 and last["step"] == 4


def test_failed_async_save_raises(tmp_path):
    state, _ = _state()
    missing = str(tmp_path / "no_such_dir" / "ckpt")
    checkpoint.save_checkpoint(missing, state, 0, use_async=True)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        checkpoint.wait_for_checkpoints()
    checkpoint.wait_for_checkpoints()  # reported once
    checkpoint.save_checkpoint(missing, state, 0, use_async=True)
    concurrent.futures.wait(checkpoint._ASYNC_WRITER._pending, timeout=60)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        checkpoint.save_checkpoint(str(tmp_path / "ok"), state, 0,
                                   use_async=True)
    assert not os.path.exists(tmp_path / "ok")  # that call saved nothing
    checkpoint.save_checkpoint(str(tmp_path / "ok"), state, 0, use_async=True)
    checkpoint.wait_for_checkpoints()
    assert os.path.exists(tmp_path / "ok")


def _write_trace(log_dir, name, events):
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, name + profiling.TRACE_SUFFIX)
    with gzip.open(path, "wt") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return path


def test_summarize_trace_groups_and_filters(tmp_path):
    log_dir = str(tmp_path)
    old = _write_trace(log_dir, "host_1.1", [
        {"ph": "X", "cat": "kernel", "name": "stale", "dur": 5.0}])
    os.utime(old, (1, 1))
    events = [
        {"ph": "X", "cat": "kernel", "name": "mha_fwd<64>", "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "mha_fwd<64>", "dur": 3000.0},
        {"ph": "X", "cat": "kernel", "name": "ffn_fwd", "dur": 8000.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 600.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 200.0},
        # host events and non-complete events do not count
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99999.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 77777.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "dur": 55555.0},
    ]
    _write_trace(log_dir, "host_2.2", events)
    rows = profiling.summarize_trace(log_dir, top=10, steps=2)
    assert rows == [(4.0, 1, "ffn_fwd"), (2.0, 2, "mha_fwd<64>"),
                    (0.3, 1, "Memcpy HtoD"), (0.1, 1, "Memset")]
    assert profiling.summarize_trace(log_dir, top=1) == [(8.0, 1, "ffn_fwd")]


def test_summarize_trace_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "nope"))


def test_trace_writes_what_summarize_reads(tmp_path):
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (name,) = os.listdir(log_dir)
    assert name.endswith(profiling.TRACE_SUFFIX)
    with gzip.open(os.path.join(log_dir, name), "rt") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names or "aten::matmul" in names
    assert profiling.summarize_trace(log_dir) == []  # no device on the CPU
