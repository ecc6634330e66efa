"""Ranks of one host as processes, and the workers that check the
expert-parallel forms on them.

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``'s
``spawn`` method, each with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), joins them into one
process group through a ``file://`` rendezvous (a ``FileStore``, so that
concurrent runs never share a port) and runs a worker function of this
module in each. A rank that raises makes :func:`spawn` raise. The children
import this package only.

The workers read their inputs from an ``.npz`` and write each rank's
results to ``<out_dir>/rank<r>.npz`` (arrays) and ``rank<r>.json``
(launch counts, times, memory):

- :func:`moe_layer_worker`: one MoE layer through the expert-parallel
  forms, forward and backward;
- :func:`model_forward_worker`: a model's eval forward, its parameters
  sharded;
- :func:`train_steps_worker`: a few train steps of a model.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import typing as typ

import numpy as np
import torch
import torch.distributed as dist

from .distributed import init_distributed_mode
from .sharding import expert_slice, make_mesh, shard_params

# a2a forms: (dispatch function name, SSMV_A2A_PERMUTED)
EP_FORMS = {"psum": ("moe_forward_fused_ep", "0"),
            "a2a": ("moe_forward_fused_ep_a2a", "0"),
            "a2a_perm": ("moe_forward_fused_ep_a2a", "1"),
            "sharded": ("moe_forward_sharded", "0")}
_PARAMS = ("router_w", "router_b", "w1", "b1", "w2", "b2")


def spawn(fn: typ.Callable, world: int, args: tuple = (), *, init_file: str,
          device: str = "cuda", env: typ.Optional[dict] = None) -> None:
    """Run ``fn(*args)`` on ``world`` ranks of one process group, one
    process each, on ``device`` (the card unless the caller passes
    ``"cpu"``); returns when all have ended, raises if one failed.
    ``init_file`` must not exist yet (the rendezvous creates it)."""
    torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world, init_file, device, dict(env or {}), args),
        nprocs=world, join=True, start_method="spawn")


def _rank_main(local_rank, fn, world, init_file, device, env, args):
    os.environ.update(env)
    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(local_rank), LOCAL_WORLD_SIZE=str(world))
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    init_distributed_mode(argparse.Namespace(
        dist_url=f"file://{os.path.abspath(init_file)}", device=device))
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def _save(out_dir: str, arrays: dict, record: dict) -> None:
    rank = dist.get_rank()
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)


def _timed(fn, device: str, reps: int) -> typ.Optional[float]:
    """Mean ms of ``fn()`` on the card over ``reps`` calls (CUDA events),
    None on the CPU."""
    if device == "cpu" or reps == 0:
        return None
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    dist.barrier()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def moe_layer_worker(in_path: str, out_dir: str, dp: int, ep: int,
                     runs: typ.Sequence[typ.Tuple[str, float]], dtype: str,
                     device: str, timing_reps: int = 0) -> None:
    """One MoE layer through each (form, capacity factor[, router bias
    key]) of ``runs`` (forms of :data:`EP_FORMS`) on a dp x ep layout.
    Inputs (``in_path``): x (T, d), the cotangent weights c (T, d),
    router_w, router_b (or the array the run names) and the full expert
    tensors, ``top_k`` and optionally ``balance_weight`` (0 without it).
    Each rank takes its data shard of x and c and its experts, computes y
    and the aux metrics, and backpropagates its share of the whole batch's
    loss sum(y * c) + balance_weight * balance_loss: its rows' sum(y * c)
    and balance_weight / dp times the balance loss (every data shard holds
    the batch's value). Saved per run: y, dx (this data shard), the aux
    values, the router gradients and this rank's expert gradients, each
    summed over the data group (the gradient of the whole batch's loss),
    the launch counts of the checked call, its fwd+bwd time over
    ``timing_reps`` more calls and the rank's peak memory."""
    from .. import ops
    from ..ops import moe as moe_ops

    mesh = make_mesh(dp, ep)
    dev = torch.device(device, torch.cuda.current_device()) \
        if device == "cuda" else torch.device("cpu")
    data = np.load(in_path)
    T = data["x"].shape[0] // dp
    rows = slice(mesh.data_index * T, (mesh.data_index + 1) * T)
    experts = expert_slice(mesh, data["w1"].shape[0])

    def tensor(name, part=None, dt=torch.float32):
        a = data[name] if part is None else data[name][part]
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)

    act = getattr(torch, dtype)
    c = tensor("c", rows, act)
    balance_weight = (float(data["balance_weight"])
                      if "balance_weight" in data.files else 0.0)
    arrays, record = {}, {}
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for form, factor, *bias in runs:
        name, permuted = EP_FORMS[form]
        os.environ["SSMV_A2A_PERMUTED"] = permuted
        fn = getattr(moe_ops, name)
        x = tensor("x", rows, act).requires_grad_()
        sources = {**dict(zip(_PARAMS, _PARAMS)), "router_b":
                   bias[0] if bias else "router_b"}
        params = {k: tensor(sources[k], experts if k[0] in "wb" else None)
                  .requires_grad_() for k in _PARAMS}

        def step():
            y, aux = fn(x, *params.values(), mesh=mesh,
                        top_k=int(data["top_k"]), capacity_factor=factor)
            loss = (y.float() * c.float()).sum()
            if balance_weight:
                loss = loss + balance_weight / dp * aux["balance_loss"]
            loss.backward()
            return y, aux

        ops.reset_launch_counts()
        y, aux = step()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        grads = torch.cat([params[k].grad.reshape(-1) for k in _PARAMS])
        if mesh.data_group is not None:
            dist.all_reduce(grads, group=mesh.data_group)
        key = f"{form}@{factor}" + (f"/{bias[0]}" if bias else "")
        offset = 0
        for k in _PARAMS:
            n = params[k].numel()
            arrays[f"{key}/d{k}"] = grads[offset:offset + n].view_as(
                params[k]).cpu().numpy()
            offset += n
        arrays[f"{key}/y"] = y.detach().float().cpu().numpy()
        arrays[f"{key}/dx"] = x.grad.float().cpu().numpy()
        for k, v in aux.items():
            arrays[f"{key}/{k}"] = np.float64(v.item())

        def again():
            x.grad = None
            for p in params.values():
                p.grad = None
            step()

        record[key] = {"launches": counts,
                       "fwd_bwd_ms": _timed(again, device, timing_reps)}
    if device == "cuda":
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    _save(out_dir, arrays, record)


def model_forward_worker(in_path: str, out_dir: str, dp: int, ep: int,
                         model_name: str, model_kwargs: dict,
                         device: str) -> None:
    """A registered model's eval forward on this rank's data shard of the
    images (``in_path``: ``images`` (B, H, W, 3) and the full state_dict
    under ``param/<name>``), its parameters sharded over a dp x ep layout.
    Saves the shard's logits."""
    from ..models import create_model

    mesh = make_mesh(dp, ep)
    data = np.load(in_path)
    model = create_model(model_name, **model_kwargs)
    model.load_state_dict({k[len("param/"):]: torch.from_numpy(data[k])
                           for k in data.files if k.startswith("param/")})
    shard_params(model, mesh)
    images = data["images"]
    B = images.shape[0] // dp
    x = torch.from_numpy(images[mesh.data_index * B:(mesh.data_index + 1) * B])
    model.to(device).eval()
    with torch.no_grad():
        logits = model(x.to(device))
    _save(out_dir, {"logits": logits.float().cpu().numpy()}, {})


def train_steps_worker(out_dir: str, dp: int, ep: int, model_name: str,
                       model_kwargs: dict, batch: int, steps: int,
                       forms: typ.Mapping[str, tuple], device: str,
                       lr: float = 1e-3) -> None:
    """``steps`` train steps of a registered model (bf16, seed-0 weights,
    AdamW + EMA, label smoothing 0.1) on a dp x ep layout, once per form of
    ``forms`` (name -> (environment knobs to set, whether to reverse the
    batch)), from the same weights and on the same batch of each data shard
    (images and labels from numpy seeds d and d + 1 for data shard d).
    Saves per form the
    losses, each step's launch counts, the ms per step over steps 2 on
    (CUDA events), the rank's peak memory and a digest of the dense
    parameters after the last step."""
    from .. import engine, losses, ops, optim
    from ..main import dense_digest
    from ..models import create_model
    from ..train_state import create_train_state

    mesh = make_mesh(dp, ep)
    size = model_kwargs.get("img_size", 224)
    shard = mesh.data_index
    images = torch.from_numpy(np.random.RandomState(shard).randn(
        batch, size, size, 3).astype(np.float32)).to(device)
    targets = torch.from_numpy(np.random.RandomState(shard + 1).randint(
        0, model_kwargs["num_classes"], batch)).to(device)
    base = create_model(model_name, dtype=torch.bfloat16, **model_kwargs)
    record = {}
    for form, (knobs, flip) in forms.items():
        xb, yb = (images.flip(0), targets.flip(0)) if flip else (images,
                                                                 targets)
        saved = {k: os.environ.get(k) for k in knobs}
        os.environ.update(knobs)
        try:
            model = shard_params(copy.deepcopy(base), mesh)
            opt_init, opt_update = optim.make_optimizer(weight_decay=0.05)
            state = create_train_state(model, device=device, seed=shard,
                                       opt_init=opt_init, use_ema=True)
            step = engine.make_train_step(
                model, opt_update, losses.make_base_criterion(False, 0.1,
                                                              False),
                ema_decay=0.99996, mesh=mesh)
            if device == "cuda":
                torch.cuda.reset_peak_memory_stats()
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
            run, counts = [], []
            for i in range(steps):
                if i == 1 and device == "cuda":
                    dist.barrier()
                    start.record()
                ops.reset_launch_counts()
                state, m = step(state, xb, yb, lr, lr)
                counts.append({k: v for k, v in ops.launch_counts().items()
                               if v})
                run.append(m["loss"])
            rec = {"losses": torch.stack(run).tolist(), "launches": counts,
                   "dense_digest": dense_digest(model)}
            if device == "cuda":
                end.record()
                end.synchronize()
                rec["ms_per_step"] = start.elapsed_time(end) / (steps - 1)
                rec["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated()
            record[form] = rec
            del model, state, step
        finally:
            for k, v in saved.items():
                os.environ.pop(k, None)
                if v is not None:
                    os.environ[k] = v
    _save(out_dir, {}, record)
