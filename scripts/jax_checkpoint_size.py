"""The size of a JAX trainer's checkpoint of a full-width model, and what
converting it for the PyTorch port takes, on this host's CPU.

Writes, with the JAX package's own ``utils/checkpoint.py::save_checkpoint``,
the checkpoint a ``--model-ema`` AdamW run of ``--model`` leaves (its
parameters, EMA, gate buffers and the optax chain's state), then times
``scripts/jax_checkpoint_to_npz.py`` on it and reads the ``.npz`` back
with the port's ``import_jax_checkpoint``. No model is traced or run: the
weights are the port's seeded init carried into the JAX tree, the moments
seeded noise. Prints one JSON line (bytes and seconds)::

    python scripts/jax_checkpoint_size.py --out /tmp/ckpt_size \\
        [--model resmoe_small_patch16_224_expert8]

The output directory is removed at the end unless ``--keep`` is given.
"""
import argparse
import importlib.util
import json
import os
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _du(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="resmoe_small_patch16_224_expert8")
    p.add_argument("--keep", action="store_true")
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import torch

    from slim_switch_moe_vit_tpu import optim as jax_optim
    from slim_switch_moe_vit_tpu.train_state import TrainState
    from slim_switch_moe_vit_tpu.utils.checkpoint import save_checkpoint
    from slim_switch_moe_vit_tpu_torch import create_model, optim
    from slim_switch_moe_vit_tpu_torch.train_state import create_train_state
    from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
        import_jax_checkpoint,
        to_jax_tree,
    )

    spec = importlib.util.spec_from_file_location(
        "jax_checkpoint_to_npz",
        os.path.join(REPO, "scripts", "jax_checkpoint_to_npz.py"))
    converter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(converter)

    os.makedirs(args.out, exist_ok=True)
    model = create_model(args.model, num_classes=1000)
    sd = model.state_dict()
    gate_names = {k for k in sd if k.split(".")[-1] in (
        "threshold", "target_threshold", "enabled")}
    params = jax.tree.map(jnp.asarray, to_jax_tree(
        {k: v for k, v in sd.items() if k not in gate_names}))
    gates = jax.tree.map(jnp.asarray,
                         to_jax_tree({k: sd[k] for k in gate_names}))
    init, _ = jax_optim.make_optimizer(params)
    rs = np.random.RandomState(0)

    def noise(x):
        return jnp.asarray(rs.standard_normal(x.shape).astype(np.float32)
                           * 1e-3) if x.ndim else x

    opt_state = jax.tree.map(noise, init(params))
    state = TrainState(params=params, opt_state=opt_state, gates=gates,
                       ema_params=jax.tree.map(jnp.copy, params),
                       rng=jax.random.PRNGKey(0),
                       step=jnp.asarray(2, jnp.int32))
    ckpt = os.path.join(args.out, "checkpoint")
    t0 = time.perf_counter()
    save_checkpoint(ckpt, state, 1)
    save_s = time.perf_counter() - t0
    del state, opt_state
    out = os.path.join(args.out, "run.npz")
    t0 = time.perf_counter()
    converter.convert(ckpt, out)
    convert_s = time.perf_counter() - t0
    opt_init, _ = optim.make_optimizer(weight_decay=0.05)
    port = create_train_state(model, device="cpu", opt_init=opt_init,
                              use_ema=True)
    t0 = time.perf_counter()
    import_jax_checkpoint(out, port)
    import_s = time.perf_counter() - t0
    record = {"model": args.model, "host": "cpu",
              "parameters": sum(p.numel() for p in model.parameters()),
              "orbax_bytes": _du(ckpt), "npz_bytes": os.path.getsize(out),
              "jax_save_s": round(save_s, 3),
              "convert_s": round(convert_s, 3),
              "import_s": round(import_s, 3),
              "torch_threads": torch.get_num_threads()}
    print(json.dumps(record))
    if not args.keep:
        shutil.rmtree(args.out, ignore_errors=True)


if __name__ == "__main__":
    main()
