"""Checkpoints, and weight transfer from the JAX package's parameter tree.

:func:`save_checkpoint` / :func:`restore_checkpoint` are the torch-native
form of the JAX package's ``utils/checkpoint.py`` (:59-149): one
``torch.save`` file holding the model's ``state_dict`` (the gate buffers
included), the optimizer's, the EMA, the generator's state, the step and
the epoch, with the run's ``args`` and the scheduler's state in JSON files
beside it (``<path>.args.json``, ``<path>.sched.json``), as there.

:func:`from_jax_params` turns the flax param tree of a ViT / Switch-MoE ViT
/ ResMoE ViT (nested dicts of numpy arrays, as ``variables["params"]``,
and optionally the ``gates`` collection) into this package's
``state_dict``:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
  the qkv kernel's output columns stay in their contiguous [q | k | v]
  order, which the MHA kernel reads;
- a LayerNorm ``scale`` / ``bias`` becomes ``weight`` / ``bias``;
- the MoE ``router_kernel`` (d, E) and the expert-major
  ``expert_fc{1,2}_{kernel,bias}`` keep their layout (router_weight, w1,
  b1, w2, b2): (E, d, h) / (E, h, d) is what the expert-FFN kernel reads;
- ``blocks_<i>`` becomes ``blocks.<i>``;
- the gates' ``dense_gate/head`` and ``moe_gate/head`` are Dense layers like
  any other, and the ``gates`` collection's ``threshold``,
  ``target_threshold`` and ``enabled`` become the gates' buffers of the
  same names.

:func:`to_jax_tree` is the inverse: a ``state_dict`` (or a dict of
gradients under the same names) back into the flax tree's names, layouts
and nesting, as numpy f32 arrays, so a port tensor can be held leaf by leaf
against the JAX tree.

:func:`load_npz_tree` reads such a tree from an ``.npz`` whose keys are the
tree paths joined by ``/``. Reading the JAX package's Orbax checkpoints is
not ported yet.
"""
from __future__ import annotations

import json
import os
import re
import typing as typ

import numpy as np
import torch

_RENAME = {"scale": "weight", "router_kernel": "router_weight",
           "router_bias": "router_bias", "expert_fc1_kernel": "w1",
           "expert_fc1_bias": "b1", "expert_fc2_kernel": "w2",
           "expert_fc2_bias": "b2"}


def _module_name(key: str) -> str:
    m = re.fullmatch(r"blocks_(\d+)", key)
    return f"blocks.{m.group(1)}" if m else key


def from_jax_params(params: typ.Mapping,
                    gates: typ.Optional[typ.Mapping] = None
                    ) -> typ.Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) and, for the gated models,
    the ``gates`` collection -> f32 torch state_dict."""
    out: typ.Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, typ.Mapping):
                walk(val, prefix + _module_name(key) + ".")
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                name, arr = "weight", arr.T
            else:
                name = _RENAME.get(key, key)
            out[prefix + name] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, "")
    walk(gates or {}, "")
    return out


_INVERSE = {v: k for k, v in _RENAME.items() if k != "scale"}


def jax_path(name: str) -> typ.List[str]:
    """The flax tree path of a port parameter name, e.g.
    ``blocks.0.mlp.b1`` -> ``["blocks_0", "mlp", "expert_fc1_bias"]``. A
    ``weight`` is a LayerNorm ``scale`` under a module named ``norm*``, a
    Dense ``kernel`` elsewhere."""
    parts = name.split(".")
    if parts[0] == "blocks":
        parts = [f"blocks_{parts[1]}"] + parts[2:]
    *mods, leaf = parts
    if leaf == "weight":
        leaf = "scale" if mods and mods[-1].startswith("norm") else "kernel"
    return mods + [_INVERSE.get(leaf, leaf)]


def to_jax_tree(tensors: typ.Mapping[str, torch.Tensor]) -> dict:
    """A port ``state_dict`` (or gradients by parameter name) -> the flax
    param tree: nested dicts of numpy f32 arrays, Dense kernels transposed
    back to (in, out)."""
    tree: dict = {}
    for name, val in tensors.items():
        *mods, leaf = jax_path(name)
        arr = val.detach().to("cpu", torch.float32).numpy()
        if leaf == "kernel":
            arr = arr.T
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


def flatten_tree(tree: typ.Mapping, prefix: str = "") -> typ.Dict[str, np.ndarray]:
    """{"a": {"b": x}} -> {"a/b": x} (the ``.npz`` key convention)."""
    flat = {}
    for key, val in tree.items():
        if isinstance(val, typ.Mapping):
            flat.update(flatten_tree(val, f"{prefix}{key}/"))
        else:
            flat[prefix + key] = np.asarray(val)
    return flat


def load_npz_tree(path: str) -> dict:
    """Read an ``.npz`` written from ``flatten_tree`` back into nested
    dicts."""
    tree: dict = {}
    with np.load(path) as z:
        for flat_key in z.files:
            node = tree
            *parents, leaf = flat_key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[flat_key]
    return tree


def _write_json(path: str, record) -> None:
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)


def save_checkpoint(path: str, state, epoch: int,
                    extra: typ.Optional[dict] = None,
                    is_main: bool = True) -> None:
    """Write the train state to ``path`` (rank 0 only), atomically.
    ``extra={"args": vars(args), "sched": sched.state_dict()}`` land in
    the JSON files beside it."""
    if not is_main:
        return
    payload = {
        "model": state.model.state_dict(),
        "optimizer": (state.optimizer.state_dict()
                      if state.optimizer is not None else None),
        "ema_params": state.ema_params,
        "generator": state.generator.get_state(),
        "step": state.step,
        "epoch": epoch,
    }
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    extra = dict(extra or {})
    for key in ("args", "sched"):
        if extra.get(key) is not None:
            _write_json(f"{path}.{key}.json", extra[key])


def _sidecar(path: str, key: str) -> typ.Optional[dict]:
    sidecar = f"{os.path.abspath(path)}.{key}.json"
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        return json.load(f)


def load_checkpoint_args(path: str) -> typ.Optional[dict]:
    """The args record saved beside a checkpoint, if present."""
    return _sidecar(path, "args")


def load_checkpoint_sched(path: str) -> typ.Optional[dict]:
    """The scheduler state saved beside a checkpoint, if present (the
    plateau schedule's bookkeeping)."""
    return _sidecar(path, "sched")


def restore_checkpoint(path: str, state) -> typ.Tuple[typ.Any, int]:
    """Restore into an existing state, in place (model, optimizer, EMA,
    generator, step); returns (state, epoch). Read onto the host, so the
    optimizer's ``step`` counts stay CPU tensors, as ``torch.optim.AdamW``
    keeps them."""
    payload = torch.load(os.path.abspath(path), map_location="cpu",
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    if state.optimizer is not None and payload["optimizer"] is not None:
        state.optimizer.load_state_dict(payload["optimizer"])
    if state.ema_params is not None and payload["ema_params"] is not None:
        with torch.no_grad():
            for name, t in state.ema_params.items():
                t.copy_(payload["ema_params"][name])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])
