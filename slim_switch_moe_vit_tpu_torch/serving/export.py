"""Model export + serving predictor, in PyTorch.

Port of ``slim_switch_moe_vit_tpu/serving/export.py`` (:59-311):

- :func:`export_model` writes an artifact directory: ``manifest.json``
  (the JAX manifest's keys, with ``platform`` = ``cuda`` or ``cpu`` and
  ``torch_version``) and ``params.pt``, the model's f32 ``state_dict``.
- :func:`load_predictor` rebuilds the model from the manifest's
  ``model_name`` through this package's registry and loads the weights.
  Unlike the JAX package's StableHLO artifact, loading therefore needs this
  package's code (its modules and CUDA kernel sources), not only the
  artifact.
- :class:`Predictor` serves any request size with the JAX bucket semantics:
  full chunks go to the largest bucket, the tail is padded into the
  smallest bucket that fits, padding rows are sliced off.

A request carries raw uint8 NHWC images; the serving forward normalizes
them on the device, runs the model in its compute dtype (bf16 by default)
and returns f32 logits.

The CLI (:func:`main`) takes the weights from ``--checkpoint``: this
package's ``utils/checkpoint.py::save_checkpoint`` output (the driver's
checkpoint, the gates' buffers included), with ``--use-ema`` its EMA, a
checkpoint of the JAX trainer converted by
``scripts/jax_checkpoint_to_npz.py`` (``--use-ema`` its EMA too), or a
``.npz`` of the JAX package's param tree; a ``pos_embed`` trained at
another resolution is resized to ``--img-size`` (:func:`checkpoint_state`,
as the JAX CLI, :258-311 there).

Every entry point takes its device explicitly and defaults to ``cuda``:
where CUDA is unavailable and ``cpu`` was not asked for, it raises instead
of running on the CPU. The manifest records the device the artifact was
exported for, and an artifact refuses to load on another one.
"""
from __future__ import annotations

import json
import os
import typing as typ

import numpy as np
import torch

from ..data.device_aug import build_eval_normalize
from ..models import create_model, list_models
from ..utils.device import resolve_device
from ..utils.profiling import span

SERVING_FORMAT_VERSION = 1
_MANIFEST = "manifest.json"
_PARAMS = "params.pt"


def make_serve_fn(model: torch.nn.Module,
                  with_preprocess: bool = True) -> typ.Callable:
    """The serving forward: images -> f32 logits, without autograd.

    With preprocessing, images are raw uint8 NHWC batches on the model's
    device, normalized there; without, they are already normalized arrays
    in the model's compute dtype."""
    normalize = (build_eval_normalize(dtype=model.dtype) if with_preprocess
                 else (lambda x: x))

    @torch.inference_mode()
    def serve(images: torch.Tensor) -> torch.Tensor:
        return model(normalize(images)).float()

    return serve


def export_model(model: torch.nn.Module, out_dir: str, *, model_name: str,
                 batch_sizes: typ.Sequence[int] = (1, 8, 32),
                 with_preprocess: bool = True, device: str = "cuda",
                 manifest_extra: typ.Optional[dict] = None) -> dict:
    """Write the serving artifact for ``model`` (a registered model,
    ``model_name``) into ``out_dir``, to be served on ``device``; returns
    the manifest."""
    platform = resolve_device(device)
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints: {batch_sizes}")
    if model_name not in list_models():
        raise ValueError(f"model_name '{model_name}' is not registered; the "
                         "loader rebuilds the model from it")
    state = {k: v.detach().to("cpu", torch.float32)
             for k, v in model.state_dict().items()}
    torch.save(state, os.path.join(out_dir, _PARAMS))
    compute = str(model.dtype).removeprefix("torch.")
    manifest = {
        "format_version": SERVING_FORMAT_VERSION,
        "model_name": model_name,
        "img_size": int(model.img_size),
        "num_classes": int(model.num_classes),
        "compute_dtype": compute,
        "input_dtype": "uint8" if with_preprocess else compute,
        "with_preprocess": bool(with_preprocess),
        "batch_sizes": batch_sizes,
        "platform": platform,
        "torch_version": torch.__version__,
    }
    if manifest_extra:
        manifest.update(manifest_extra)
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class Predictor:
    """Bucketed-batch inference over a loaded artifact.

    ``serve`` is the device forward (a batch tensor on ``device`` -> f32
    logits), from :func:`make_serve_fn`."""

    def __init__(self, serve: typ.Callable, manifest: dict,
                 device: torch.device):
        self.serve = serve
        self.manifest = dict(manifest)
        self._buckets = sorted(int(b) for b in self.manifest["batch_sizes"])
        self._device = torch.device(device)
        self._in_dtype = getattr(torch, self.manifest["input_dtype"])

    @property
    def batch_sizes(self) -> typ.List[int]:
        return list(self._buckets)

    def _bucket_for(self, n: int) -> int:
        fits = [b for b in self._buckets if b >= n]
        return min(fits) if fits else self._buckets[-1]

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images: (n, H, W, 3) in the manifest's input convention (raw
        uint8 when the artifact carries preprocessing). Returns (n,
        num_classes) float32 logits."""
        with span("serve.predict"):
            return self._predict(np.asarray(images))

    def _predict(self, images: np.ndarray) -> np.ndarray:
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n == 0:
            return np.zeros((0, self.manifest["num_classes"]), np.float32)
        out = []
        i = 0
        while i < n:
            with span("serve.pad"):
                b = self._bucket_for(n - i)
                take = min(n - i, b)
                chunk = images[i:i + take]
                if take < b:
                    pad = np.zeros((b - take,) + chunk.shape[1:], chunk.dtype)
                    chunk = np.concatenate([chunk, pad], axis=0)
                chunk = np.ascontiguousarray(chunk)
            with span("serve.upload"):
                x = torch.from_numpy(chunk).to(self._device, self._in_dtype)
            with span("serve.forward"):
                logits = self.serve(x)
            with span("serve.download"):
                out.append(logits.cpu().numpy()[:take])
            i += take
        with span("serve.download"):
            return np.concatenate(out, axis=0)

    def top_k(self, images: np.ndarray, k: int = 5):
        """Returns (classes (n,k) int, probs (n,k) float32) by softmax."""
        logits = self.predict(images)
        k = min(k, logits.shape[1])
        idx = np.argsort(-logits, axis=1)[:, :k]
        z = logits - logits.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        return idx, np.take_along_axis(p, idx, axis=1)


def load_predictor(path: str, device: str = "cuda") -> Predictor:
    """Load an artifact directory onto ``device`` (raises when CUDA is
    asked for and unavailable, or when the artifact was exported for
    another device).

    Needs this package's code: the model is rebuilt from ``model_name``
    through the registry, and on CUDA its kernels are built from the
    package's sources at first use."""
    path = os.path.abspath(path)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format_version"] > SERVING_FORMAT_VERSION:
        raise ValueError(
            f"artifact format {manifest['format_version']} is newer than "
            f"this library ({SERVING_FORMAT_VERSION})")
    platform = resolve_device(device)
    if manifest["platform"] != platform:
        raise ValueError(
            f"artifact was exported for platform '{manifest['platform']}' "
            f"but is being loaded on '{platform}'; re-export it with "
            f"--device {platform}")
    model = create_model(manifest["model_name"],
                         num_classes=manifest["num_classes"],
                         img_size=manifest["img_size"],
                         dtype=getattr(torch, manifest["compute_dtype"]))
    state = torch.load(os.path.join(path, _PARAMS), map_location="cpu",
                       weights_only=True)
    model.load_state_dict(state)
    model.to(platform).eval()
    serve = make_serve_fn(model, with_preprocess=manifest["with_preprocess"])
    return Predictor(serve, manifest, torch.device(platform))


# ---------------------------------------------------------------------------
# CLI: python -m slim_switch_moe_vit_tpu_torch.serving.export ...
# ---------------------------------------------------------------------------

def _cli_parser():
    import argparse

    p = argparse.ArgumentParser(
        description="Export a model's eval forward as a serving artifact")
    p.add_argument("--model", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--checkpoint", default="",
                   help="a checkpoint written by the training driver "
                        "(utils/checkpoint.py::save_checkpoint), a JAX "
                        "checkpoint converted by "
                        "scripts/jax_checkpoint_to_npz.py, or an .npz of "
                        "the JAX package's param tree, keys joined by '/' "
                        "(random weights from seed 0 when empty)")
    p.add_argument("--use-ema", action="store_true",
                   help="serve the checkpoint's EMA of the parameters; "
                        "refuses a checkpoint without one")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--img-size", type=int, default=224)
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--batch-sizes", default="1,8,32")
    p.add_argument("--no-preprocess", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device the artifact is served on")
    return p


def checkpoint_state(path: str, model: torch.nn.Module,
                     use_ema: bool = False) -> dict:
    """The ``state_dict`` to serve ``model`` with, from ``path``: the
    training driver's checkpoint (its model state, the gates' buffers
    included; with ``use_ema`` its EMA in place of the parameters), a
    checkpoint of the JAX trainer converted to an ``.npz`` by
    ``scripts/jax_checkpoint_to_npz.py`` (known by its top-level
    ``params/``: its ``params/`` or, with ``use_ema``, its ``ema_params/``,
    and its ``gates/``), or a ``.npz`` of the JAX package's bare param
    tree. A ``pos_embed`` whose grid differs from the model's is resized
    bicubically (``resize_pos_embed``), as the JAX CLI serves a checkpoint
    at another resolution."""
    from ..models.vit import resize_pos_embed

    if path.endswith(".npz"):
        from ..utils.checkpoint import from_jax_params, load_npz_tree

        with np.load(path) as z:
            converted = any(k.startswith("params/") for k in z.files)
        if converted:
            weights = "ema_params" if use_ema else "params"
            tree = load_npz_tree(path, roots=(weights, "gates"))
            if weights not in tree:
                raise ValueError(
                    "--use-ema: checkpoint has no EMA shadow (trained "
                    "without --model-ema?); refusing to silently serve the "
                    "raw weights")
            state = from_jax_params(tree[weights], tree.get("gates"))
        elif use_ema:
            raise ValueError("--use-ema: a .npz param tree has no EMA "
                             "shadow; refusing to silently serve the raw "
                             "weights")
        else:
            state = from_jax_params(load_npz_tree(path))
    else:
        payload = torch.load(os.path.abspath(path), map_location="cpu",
                             weights_only=True)
        state = dict(payload["model"])
        if use_ema:
            ema = payload.get("ema_params")
            if ema is None:
                raise ValueError(
                    "--use-ema: checkpoint has no EMA shadow (trained "
                    "without --model-ema?); refusing to silently serve the "
                    "raw weights")
            state.update(ema)
    want = getattr(model, "pos_embed", None)
    got = state.get("pos_embed")
    if want is not None and got is not None and got.shape != want.shape:
        num_patches = model.patch_embed.num_patches
        state["pos_embed"] = resize_pos_embed(
            got, want.shape[1] - num_patches, int(round(num_patches ** 0.5)))
    return state


def main(argv=None):
    args = _cli_parser().parse_args(argv)
    resolve_device(args.device)  # refuse before building the model
    model = create_model(args.model, num_classes=args.num_classes,
                         img_size=args.img_size,
                         dtype=getattr(torch, args.dtype))
    if args.checkpoint:
        model.load_state_dict(checkpoint_state(args.checkpoint, model,
                                               args.use_ema))
    batch_sizes = [int(b) for b in args.batch_sizes.split(",") if b]
    manifest = export_model(
        model, args.output, model_name=args.model, batch_sizes=batch_sizes,
        with_preprocess=not args.no_preprocess, device=args.device,
        manifest_extra={"checkpoint": args.checkpoint,
                        "use_ema": bool(args.use_ema)})
    print(json.dumps(manifest))
    return manifest


if __name__ == "__main__":
    main()
