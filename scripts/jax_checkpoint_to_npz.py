"""Convert a checkpoint of the JAX trainer (an Orbax tree written by
``slim_switch_moe_vit_tpu/utils/checkpoint.py::save_checkpoint``) into the
``.npz`` that the PyTorch port resumes and serves from.

Run it where JAX and Orbax run (the card's host has neither)::

    python scripts/jax_checkpoint_to_npz.py <run>/checkpoint run.npz

then copy ``run.npz`` and its sidecars to the card's host and pass it to the
port's ``--resume`` or to its export CLI's ``--checkpoint`` (``--use-ema``
serves the EMA).

The checkpoint is restored with no template, as the JAX export CLI does,
every leaf as a host ``np.ndarray`` (a checkpoint written on a TPU mesh
names devices that this host does not have). Each array leaf lands under
its tree path joined by ``/``, list positions as numbers: ``params/...``,
``ema_params/...`` (where the run kept an EMA), ``gates/...``, the optax
chain's state as ``opt_state/<i>/<field>/...`` (an empty entry of the
chain, such as the masked weight decay's, has no leaf and no key),
``step``, ``epoch`` and the JAX key as ``rng``. The JSON sidecars
``<checkpoint>.args.json`` and ``<checkpoint>.sched.json`` are copied to
``<out>.args.json`` and ``<out>.sched.json``, the names the port reads
beside the ``.npz``.

It refuses a directory whose commit never finished (a temporary directory
left by an asynchronous save) and a tree without ``params``.

Imports ``numpy`` and ``orbax.checkpoint`` only: not the JAX package and not
the port.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import orbax.checkpoint as ocp


def flatten_tree(tree, prefix: str = "") -> dict:
    """{"a": {"b": x}, "c": [y, None]} -> {"a/b": x, "c/0": y}: the
    ``.npz`` key convention of the port's ``utils/checkpoint.py``, with
    list positions as keys and empty leaves dropped."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple))
             else None)
    if items is None:
        return {} if tree is None else {prefix[:-1]: np.asarray(tree)}
    flat = {}
    for key, val in items:
        flat.update(flatten_tree(val, f"{prefix}{key}/"))
    return flat


def _numpy_restore_args(meta):
    """``RestoreArgs(restore_type=np.ndarray)`` at every leaf of the
    checkpoint's metadata tree, in its structure."""
    if isinstance(meta, dict):
        return {k: _numpy_restore_args(v) for k, v in meta.items()}
    if isinstance(meta, (list, tuple)):
        return type(meta)(_numpy_restore_args(v) for v in meta)
    return None if meta is None else ocp.RestoreArgs(restore_type=np.ndarray)


def read_checkpoint(path: str) -> dict:
    """The checkpoint at ``path`` as a tree of host arrays."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        raise FileNotFoundError(f"{path}: no Orbax checkpoint directory")
    if (ocp.utils.is_tmp_checkpoint(path)
            or not ocp.utils.is_checkpoint_finalized(path)):
        raise ValueError(
            f"{path}: the checkpoint's commit never finished (a temporary "
            f"directory of an asynchronous save); convert a finished one")
    ckptr = ocp.PyTreeCheckpointer()
    meta = ckptr.metadata(path).item_metadata.tree
    tree = ckptr.restore(path, restore_args=_numpy_restore_args(meta))
    if not isinstance(tree, dict) or tree.get("params") is None:
        raise ValueError(f"{path}: the tree has no 'params'; not a "
                         f"checkpoint of the JAX trainer")
    return tree


def convert(checkpoint: str, out: str) -> dict:
    """Write ``checkpoint`` as the ``.npz`` ``out`` with its sidecars;
    returns the arrays written."""
    if not out.endswith(".npz"):
        raise ValueError(f"{out}: the output's name must end in .npz")
    flat = flatten_tree(read_checkpoint(checkpoint))
    tmp = f"{out}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, out)
    for key in ("args", "sched"):
        sidecar = f"{os.path.abspath(checkpoint)}.{key}.json"
        if os.path.exists(sidecar):
            shutil.copyfile(sidecar, f"{out}.{key}.json")
    return flat


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="the Orbax checkpoint directory")
    p.add_argument("out", help="the .npz to write")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    flat = convert(args.checkpoint, args.out)
    print(f"wrote {args.out}: {len(flat)} arrays, "
          f"{os.path.getsize(args.out)} bytes in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)


if __name__ == "__main__":
    main()
