"""Weight transfer from the JAX package's parameter tree.

:func:`from_jax_params` turns the flax param tree of a ViT / Switch-MoE ViT
(nested dicts of numpy arrays, as ``variables["params"]``) into this
package's ``state_dict``:

- a Dense ``kernel`` (in, out) becomes ``weight`` (out, in), transposed;
  the qkv kernel's output columns stay in their contiguous [q | k | v]
  order, which the MHA kernel reads;
- a LayerNorm ``scale`` / ``bias`` becomes ``weight`` / ``bias``;
- the MoE ``router_kernel`` (d, E) and the expert-major
  ``expert_fc{1,2}_{kernel,bias}`` keep their layout (router_weight, w1,
  b1, w2, b2): (E, d, h) / (E, h, d) is what the expert-FFN kernel reads;
- ``blocks_<i>`` becomes ``blocks.<i>``.

:func:`to_jax_tree` is the inverse: a ``state_dict`` (or a dict of
gradients under the same names) back into the flax tree's names, layouts
and nesting, as numpy f32 arrays, so a port tensor can be held leaf by leaf
against the JAX tree.

:func:`load_npz_tree` reads such a tree from an ``.npz`` whose keys are the
tree paths joined by ``/``. Reading the JAX package's Orbax checkpoints is
not ported yet.
"""
from __future__ import annotations

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


def from_jax_params(params: typ.Mapping) -> typ.Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) -> f32 torch state_dict."""
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
