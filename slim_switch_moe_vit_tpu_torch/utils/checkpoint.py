"""Checkpoints, and weight transfer from the JAX package's parameter tree.

:func:`save_checkpoint` / :func:`restore_checkpoint` are the torch-native
form of the JAX package's ``utils/checkpoint.py`` (:59-149): one
``torch.save`` file holding the model's ``state_dict`` (the gate buffers
included), the optimizer's, the EMA, the generator's state, the step and
the epoch, with the run's ``args`` and the scheduler's state in JSON files
beside it (``<path>.args.json``, ``<path>.sched.json``), as there. Under
expert parallelism (a ``parallel.Mesh`` with an expert group) the save
gathers every expert tensor (the parameters, their AdamW moments and their
EMA) from the expert group, so the file has the format of a single-card
file, and the restore slices this rank's experts out of it: a run saved at
one expert-parallel size resumes at any other.

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
- a Conv ``kernel`` (kh, kw, in / groups, out) becomes ``weight`` (out,
  in / groups, kh, kw), the RegNet's grouped convolutions included;
- ``blocks_<i>`` (and the switchable model's ``block_<i>``) becomes
  ``blocks.<i>``, the RegNet's ``s<i>_b<j>`` and ``head_fc`` become
  ``s<i>.b<j>`` and ``head.fc`` (timm's names);
- the DeiT ``dist_token`` and the ``head_dist`` and ``pre_logits`` Dense
  layers keep their names, like ``cls_token`` and ``head``;
- the gates' ``dense_gate/head`` and ``moe_gate/head`` are Dense layers like
  any other, and the ``gates`` collection's ``threshold``,
  ``target_threshold`` and ``enabled`` become the gates' buffers of the
  same names;
- the RegNet's ``batch_stats`` (``mean``, ``var``) become the BatchNorm
  buffers ``running_mean`` and ``running_var``; the switchable model's
  ``centroids`` collection and the sparse model's ``pruning`` collection
  become the buffers of the same names.

:func:`to_jax_tree` is the inverse: a ``state_dict`` (or a dict of
gradients under the same names) back into the flax tree's names, layouts
and nesting, as numpy f32 arrays, so a port tensor can be held leaf by leaf
against the JAX tree.

:func:`load_npz_tree` reads such a tree from an ``.npz`` whose keys are the
tree paths joined by ``/``. Reading the JAX package's Orbax checkpoints is
not ported: it needs Orbax and tensorstore, which the card's host does not
have (a JAX tree saved as an ``.npz`` loads through this function).

Foreign weights (the JAX ``utils/checkpoint.py:156-325``):
:func:`import_torch_checkpoint` loads a DeiT / timm ``.pth`` into a
``VisionTransformer`` (the patch-embedding convolution as the patch GEMM,
``dist_token``, ``pre_logits.fc``, the position embedding resized to the
model's grid by ``models/vit.py::resize_pos_embed``, a head whose class
count differs dropped unless ``strict_heads``), and
:func:`import_flax_npz` the original jax-ViT ``.npz``.

``save_checkpoint(..., use_async=True)`` (``--async-checkpoint``; the JAX
package's Orbax ``AsyncCheckpointer``, :38-56) copies the state to the
host in the call and writes the file on one background thread, one save
at a time in call order, each finishing with an atomic rename.
:func:`wait_for_checkpoints` blocks until every save has landed and raises
the first failure; a save also raises a failure of an earlier one, and
:func:`restore_checkpoint` waits first.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import re
import threading
import typing as typ

import numpy as np
import torch

_RENAME = {"scale": "weight", "router_kernel": "router_weight",
           "router_bias": "router_bias", "expert_fc1_kernel": "w1",
           "expert_fc1_bias": "b1", "expert_fc2_kernel": "w2",
           "expert_fc2_bias": "b2"}


_BATCH_STATS = {"mean": "running_mean", "var": "running_var"}


def _module_name(key: str) -> str:
    m = re.fullmatch(r"blocks?_(\d+)", key)
    if m:
        return f"blocks.{m.group(1)}"
    m = re.fullmatch(r"s(\d+)_b(\d+)", key)
    if m:
        return f"s{m.group(1)}.b{m.group(2)}"
    return "head.fc" if key == "head_fc" else key


def from_jax_params(params: typ.Mapping,
                    gates: typ.Optional[typ.Mapping] = None, *,
                    batch_stats: typ.Optional[typ.Mapping] = None,
                    centroids: typ.Optional[typ.Mapping] = None,
                    pruning: typ.Optional[typ.Mapping] = None
                    ) -> typ.Dict[str, torch.Tensor]:
    """Flax param tree (nested dicts of arrays) and the collections beside
    it (the gated models' ``gates``, the RegNet's ``batch_stats``, the
    switchable model's ``centroids``, the sparse model's ``pruning``) ->
    f32 torch state_dict."""
    out: typ.Dict[str, torch.Tensor] = {}

    def walk(tree, prefix, rename):
        for key, val in tree.items():
            if isinstance(val, typ.Mapping):
                walk(val, prefix + _module_name(key) + ".", rename)
                continue
            arr = np.asarray(val, np.float32)
            if key == "kernel":
                name = "weight"
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            else:
                name = rename.get(key, key)
            out[prefix + name] = torch.tensor(np.ascontiguousarray(arr))

    walk(params, "", _RENAME)
    for tree in (gates, centroids, pruning):
        walk(tree or {}, "", _RENAME)
    walk(batch_stats or {}, "", _BATCH_STATS)
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
    back to (in, out). The arrays are copies: a later in-place update of
    the tensors does not reach them."""
    tree: dict = {}
    for name, val in tensors.items():
        *mods, leaf = jax_path(name)
        arr = val.detach().to("cpu", torch.float32, copy=True).numpy()
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


def _expert_names(model) -> set:
    from ..parallel.sharding import is_expert_param

    return {n for n, _ in model.named_parameters() if is_expert_param(n)}


def _optimizer_names(state) -> typ.List[str]:
    """The parameter name of each index of the optimizer's state_dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for g in state.optimizer.param_groups
            for p in g["params"]]


def _map_experts(state, model_sd, opt_sd, ema, fn):
    """(model, optimizer, EMA) dicts with ``fn`` applied to every expert
    tensor: the parameters, their per-element optimizer state (not the
    0-d ones, such as ``step`` or NAdam's ``mu_product``) and their EMA."""
    experts = _expert_names(state.model)
    model_sd = {k: fn(v) if k in experts else v for k, v in model_sd.items()}
    if opt_sd is not None:
        names = _optimizer_names(state)
        opt_sd = {**opt_sd, "state": {
            i: {k: fn(v) if names[i] in experts and torch.is_tensor(v)
                and v.dim() > 0 else v for k, v in st.items()}
            for i, st in opt_sd["state"].items()}}
    if ema is not None:
        ema = {k: fn(v) if k in experts else v for k, v in ema.items()}
    return model_sd, opt_sd, ema


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to the host: a snapshot
    that the training that follows cannot change."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _write_atomic(payload: dict, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


class _AsyncWriter:
    """One background thread writing the files in call order; the first
    failure is kept and raised by the next ``submit`` or ``wait``."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ssmv-ckpt")
        self._pending: typ.List[concurrent.futures.Future] = []

    def submit(self, payload: dict, path: str) -> None:
        self._reap(block=False)
        self._pending.append(self._pool.submit(_write_atomic, payload, path))

    def wait(self) -> None:
        self._reap(block=True)

    def _reap(self, block: bool) -> None:
        done = [f for f in self._pending if block or f.done()]
        self._pending = [f for f in self._pending if f not in done]
        errors = [f.exception() for f in done]
        errors = [e for e in errors if e is not None]
        if errors:
            raise RuntimeError("an asynchronous checkpoint save failed"
                               ) from errors[0]


_ASYNC_WRITER: typ.Optional[_AsyncWriter] = None


def wait_for_checkpoints() -> None:
    """Block until every asynchronous save has landed; raises if one
    failed. Call before the process exits and before a restore."""
    if _ASYNC_WRITER is not None:
        _ASYNC_WRITER.wait()


def save_checkpoint(path: str, state, epoch: int,
                    extra: typ.Optional[dict] = None,
                    is_main: bool = True, mesh=None,
                    use_async: bool = False) -> None:
    """Write the train state to ``path`` (rank 0 only), atomically.
    ``extra={"args": vars(args), "sched": sched.state_dict()}`` land in
    the JSON files beside it, written in the call. Under an expert group
    (``mesh``) every rank must call it: the expert tensors are gathered to
    a single-card layout. With ``use_async`` the state is copied to the
    host here and the file is written on the background thread
    (:func:`wait_for_checkpoints`)."""
    global _ASYNC_WRITER
    model_sd = state.model.state_dict()
    opt_sd = (state.optimizer.state_dict() if state.optimizer is not None
              else None)
    ema = state.ema_params
    if mesh is not None and mesh.expert_group is not None:
        from ..parallel.collectives import gather_rows

        model_sd, opt_sd, ema = _map_experts(
            state, model_sd, opt_sd, ema,
            lambda t: gather_rows(t, mesh.expert_group))
    if not is_main:
        return
    payload = {
        "model": model_sd,
        "optimizer": opt_sd,
        "ema_params": ema,
        "generator": state.generator.get_state(),
        "step": state.step,
        "epoch": epoch,
    }
    path = os.path.abspath(path)
    if use_async:
        if _ASYNC_WRITER is None:
            _ASYNC_WRITER = _AsyncWriter()
        _ASYNC_WRITER.submit(_to_host(payload), path)
    else:
        _write_atomic(payload, path)
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


def restore_checkpoint(path: str, state, mesh=None) -> typ.Tuple[typ.Any,
                                                                int]:
    """Restore into an existing state, in place (model, optimizer, EMA,
    generator, step); returns (state, epoch). Read onto the host, so the
    optimizer's ``step`` counts stay CPU tensors, as ``torch.optim.AdamW``
    keeps them. With ``mesh``, this rank's experts are sliced out of every
    expert tensor of the (single-card layout) file."""
    wait_for_checkpoints()  # a save of this process may still be landing
    payload = torch.load(os.path.abspath(path), map_location="cpu",
                         weights_only=True)
    model_sd, opt_sd, ema = (payload["model"], payload["optimizer"],
                             payload["ema_params"])
    if mesh is not None:
        from ..parallel.sharding import expert_slice

        model_sd, opt_sd, ema = _map_experts(
            state, model_sd, opt_sd, ema,
            lambda t: t[expert_slice(mesh, t.shape[0])].clone())
    state.model.load_state_dict(model_sd)
    if state.optimizer is not None and opt_sd is not None:
        state.optimizer.load_state_dict(opt_sd)
    if state.ema_params is not None and ema is not None:
        with torch.no_grad():
            for name, t in state.ema_params.items():
                t.copy_(ema[name])
    state.generator.set_state(payload["generator"])
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


# ---------------------------------------------------------------------------
# Foreign weights: DeiT / timm ``.pth`` and the original jax-ViT ``.npz``
# ---------------------------------------------------------------------------

def read_state_dict(path_or_dict, wrappers: typ.Sequence[str] = ("model",)
                    ) -> typ.Dict[str, np.ndarray]:
    """A ``state_dict`` as f32 numpy arrays, from a ``.pth`` path or a
    dict; a file that wraps it under one of ``wrappers`` (the first found)
    is unwrapped. The file is read with ``weights_only=True``, so loading
    it runs no code; ``argparse.Namespace`` is the one class allowed beyond
    torch's own, because the reference's checkpoints carry an ``args``
    namespace. A file that holds any other object raises."""
    if isinstance(path_or_dict, (str, os.PathLike)):
        with torch.serialization.safe_globals([argparse.Namespace]):
            sd = torch.load(path_or_dict, map_location="cpu",
                            weights_only=True)
        sd = next((sd[w] for w in wrappers if w in sd), sd)
    else:
        sd = path_or_dict
    return {k: (v.detach().cpu().float().numpy() if torch.is_tensor(v)
                else np.asarray(v, np.float32)) for k, v in sd.items()}


class _Writer:
    """Copies arrays into a model's tensors by name, checking shapes."""

    def __init__(self, model):
        self.dst = dict(model.state_dict())

    def __contains__(self, name: str) -> bool:
        return name in self.dst

    def shape(self, name: str) -> tuple:
        return tuple(self.dst[name].shape)

    def put(self, name: str, value) -> None:
        value = torch.as_tensor(np.ascontiguousarray(value))
        if tuple(value.shape) != self.shape(name):
            raise ValueError(f"shape mismatch at {name}: {self.shape(name)} "
                             f"vs {tuple(value.shape)}")
        with torch.no_grad():
            self.dst[name].copy_(value)


def _resized_pos_embed(pos: np.ndarray, model) -> np.ndarray:
    """The checkpoint's position embedding on the model's patch grid, by
    ``models/vit.py::resize_pos_embed`` where the grids differ."""
    want = tuple(model.pos_embed.shape)
    if pos.shape == want:
        return pos
    from ..models.vit import resize_pos_embed

    num_patches = model.patch_embed.num_patches
    resized = resize_pos_embed(torch.from_numpy(pos), want[1] - num_patches,
                               int(num_patches ** 0.5))
    return resized.numpy()


def import_torch_checkpoint(path_or_dict, model, strict_heads: bool = False):
    """Load a DeiT / timm torch ``state_dict`` (a ``.pth`` path or a dict)
    into a ``VisionTransformer``, in place; returns the model.

    As the JAX importer (its utils/checkpoint.py:171-257): the patch
    embedding's convolution (D, C, kh, kw) becomes the patch GEMM's (D, kh *
    kw * C); ``dist_token`` and ``pre_logits.fc`` load where both the file
    and the model have them; the position embedding is resized to the
    model's grid when the grids differ; the blocks' norms, qkv, proj and (a
    dense MLP) fc1 / fc2 load by name; a head (``head``, ``head_dist``)
    whose class count differs from the model's is dropped, or raises with
    ``strict_heads``. Any other shape mismatch raises ``ValueError``, a
    missing name ``KeyError``."""
    sd = read_state_dict(path_or_dict)
    w = _Writer(model)

    def linear(src, dst):
        w.put(dst + ".weight", sd[src + ".weight"])
        if src + ".bias" in sd:
            w.put(dst + ".bias", sd[src + ".bias"])

    pw = sd["patch_embed.proj.weight"]
    D = pw.shape[0]
    w.put("patch_embed.proj.weight", pw.transpose(0, 2, 3, 1).reshape(D, -1))
    w.put("patch_embed.proj.bias", sd["patch_embed.proj.bias"])
    w.put("cls_token", sd["cls_token"])
    if "dist_token" in sd and "dist_token" in w:
        w.put("dist_token", sd["dist_token"])
    w.put("pos_embed", _resized_pos_embed(sd["pos_embed"], model))
    for i in range(len(model.blocks)):
        b = f"blocks.{i}"
        for part in ("norm1", "norm2", "attn.qkv", "attn.proj"):
            linear(f"{b}.{part}", f"{b}.{part}")
        if f"{b}.mlp.fc1.weight" in sd:  # a dense MLP
            for fc in ("mlp.fc1", "mlp.fc2"):
                linear(f"{b}.{fc}", f"{b}.{fc}")
    linear("norm", "norm")
    if "pre_logits.fc.weight" in sd and "pre_logits.weight" in w:
        linear("pre_logits.fc", "pre_logits")
    for head in ("head", "head_dist"):
        if f"{head}.weight" in sd and f"{head}.weight" in w:
            if sd[f"{head}.weight"].shape[0] != w.shape(f"{head}.weight")[0]:
                if strict_heads:
                    raise ValueError(f"{head} class-count mismatch")
                continue  # the reference drops it (main.py:542-548)
            linear(head, head)
    return model


def import_flax_npz(path: str, model):
    """Load an original jax-ViT ``.npz`` (with or without the
    ``opt/target/`` prefix) into a ``VisionTransformer``, in place; returns
    the model. As the JAX importer (its utils/checkpoint.py:260-325): the
    position embedding is resized to the model's grid; ``pre_logits``
    loads where the model has it and the file carries it, ``head`` where the
    model has it and the shapes agree."""
    with np.load(path) as z:
        f = {k: z[k].astype(np.float32) for k in z.files}
    prefix = "opt/target/" if "opt/target/embedding/kernel" in f else ""
    w = _Writer(model)

    def g(name):
        return f[prefix + name]

    def dense(src, dst):  # kernel (in, out) -> weight (out, in)
        w.put(dst + ".weight", g(src + "/kernel").T)
        w.put(dst + ".bias", g(src + "/bias"))

    def ln(src, dst):
        w.put(dst + ".weight", g(src + "/scale"))
        w.put(dst + ".bias", g(src + "/bias"))

    emb = g("embedding/kernel")  # (kh, kw, C, D)
    w.put("patch_embed.proj.weight", emb.reshape(-1, emb.shape[-1]).T)
    w.put("patch_embed.proj.bias", g("embedding/bias"))
    w.put("cls_token", g("cls"))
    w.put("pos_embed", _resized_pos_embed(
        g("Transformer/posembed_input/pos_embedding"), model))
    for i in range(len(model.blocks)):
        bp, dst = f"Transformer/encoderblock_{i}/", f"blocks.{i}"
        ln(bp + "LayerNorm_0", dst + ".norm1")
        ln(bp + "LayerNorm_2", dst + ".norm2")
        ap = bp + "MultiHeadDotProductAttention_1/"
        D = w.shape(dst + ".attn.qkv.weight")[1]
        qkv_k = np.stack([g(ap + f"{n}/kernel").reshape(D, -1)
                          for n in ("query", "key", "value")], axis=1)
        w.put(dst + ".attn.qkv.weight", qkv_k.reshape(D, -1).T)
        w.put(dst + ".attn.qkv.bias", np.stack(
            [g(ap + f"{n}/bias").reshape(-1)
             for n in ("query", "key", "value")]).reshape(-1))
        w.put(dst + ".attn.proj.weight", g(ap + "out/kernel").reshape(-1, D).T)
        w.put(dst + ".attn.proj.bias", g(ap + "out/bias"))
        dense(bp + "MlpBlock_3/Dense_0", dst + ".mlp.fc1")
        dense(bp + "MlpBlock_3/Dense_1", dst + ".mlp.fc2")
    ln("Transformer/encoder_norm", "norm")
    if prefix + "pre_logits/kernel" in f and "pre_logits.weight" in w:
        dense("pre_logits", "pre_logits")
    if prefix + "head/kernel" in f and "head.weight" in w:
        if g("head/kernel").T.shape == w.shape("head.weight"):
            dense("head", "head")
    return model
