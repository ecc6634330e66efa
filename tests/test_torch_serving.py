"""The PyTorch port's serving path on the CPU: normalize, export,
load_predictor, bucketed batching, the DynamicBatcher and the HTTP server.

The normalize is held against the JAX package's (exactly: same f32 ops).
The predictor is held against the model's direct forward on the same
weights (exactly: the same CPU ops on the same rows).
"""
import json
import os
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.data.device_aug import \
    build_eval_normalize as jax_normalize
from slim_switch_moe_vit_tpu_torch import create_model
from slim_switch_moe_vit_tpu_torch.data import build_eval_normalize
from slim_switch_moe_vit_tpu_torch.serving import (
    DynamicBatcher,
    load_predictor,
    make_serve_fn,
    make_server,
)
from slim_switch_moe_vit_tpu_torch.serving import export as export_mod
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import (
    flatten_tree,
    from_jax_params,
    load_npz_tree,
    to_jax_tree,
)
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401

IMG, NCLS, MODEL = 32, 10, "moe_tiny_patch16_224_expert8"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(
        0, 256, (n, IMG, IMG, 3)).astype(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_matches_jax(dtype):
    x = _images(2)
    want = np.asarray(jax_normalize(dtype=jnp.dtype(dtype))(jnp.asarray(x)),
                      np.float32)
    got = build_eval_normalize(dtype=getattr(torch, dtype))(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """Export through the CLI with a JAX-layout .npz checkpoint (random
    values in the JAX tree's shapes), f32 on the CPU."""
    out = str(tmp_path_factory.mktemp("artifact"))
    ref = create_model(MODEL, num_classes=NCLS, img_size=IMG,
                       generator=torch.Generator().manual_seed(7))
    rs = np.random.RandomState(1)
    jax_tree = to_jax_tree({  # a JAX-layout tree, random values
        k: torch.from_numpy((rs.randn(*v.shape) * 0.05).astype(np.float32))
        for k, v in ref.state_dict().items()})
    ckpt = os.path.join(out, "params.npz")
    np.savez(ckpt, **flatten_tree(jax_tree))
    manifest = export_mod.main([
        "--model", MODEL, "--output", out, "--checkpoint", ckpt,
        "--num-classes", str(NCLS), "--img-size", str(IMG),
        "--dtype", "float32", "--batch-sizes", "2,4", "--device", "cpu"])
    return out, manifest, jax_tree


def test_export_manifest_and_checkpoint(artifact):
    out, manifest, jax_tree = artifact
    assert manifest["batch_sizes"] == [2, 4]
    assert manifest["platform"] == "cpu"
    assert manifest["input_dtype"] == "uint8"
    assert manifest["compute_dtype"] == "float32"
    assert manifest["torch_version"] == torch.__version__
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == manifest
    back = load_npz_tree(os.path.join(out, "params.npz"))
    assert back.keys() == jax_tree.keys()
    saved = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    for k, v in from_jax_params(jax_tree).items():
        assert torch.equal(saved[k], v), k


def _bucketed(serve, x, buckets):
    """Oracle of the bucket rule: full chunks at the largest bucket, the
    tail zero-padded into the smallest bucket that fits."""
    out, i = [], 0
    while i < len(x):
        rest = len(x) - i
        b = min([b for b in buckets if b >= rest], default=max(buckets))
        take = min(rest, b)
        chunk = np.zeros((b,) + x.shape[1:], np.uint8)
        chunk[:take] = x[i:i + take]
        out.append(serve(torch.from_numpy(chunk))[:take].numpy())
        i += take
    return np.concatenate(out)


def test_predictor_buckets_match_direct_forward(artifact):
    out, _, jax_tree = artifact
    pred = load_predictor(out, device="cpu")
    model = create_model(MODEL, num_classes=NCLS, img_size=IMG).eval()
    model.load_state_dict(from_jax_params(jax_tree))
    serve = make_serve_fn(model)
    for n in (1, 3, 5, 9):  # pads into 2 or 4; chunks over 4
        x = _images(n, seed=n)
        got = pred.predict(x)
        want = _bucketed(serve, x, (2, 4))
        assert got.shape == (n, NCLS) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"n={n}")
    assert pred.predict(_images(1)[0]).shape == (1, NCLS)
    cls, scores = pred.top_k(_images(3), k=3)
    assert cls.shape == (3, 3) and np.all(np.diff(scores, axis=1) <= 1e-7)


def test_batcher_and_http_server(artifact):
    out, _, _ = artifact
    pred = load_predictor(out, device="cpu")
    x = _images(6, seed=11)
    want = pred.predict(x)
    batcher = DynamicBatcher(pred, max_wait_ms=20)
    try:
        results = {}

        def call(i):
            results[i] = batcher.predict(x[i:i + 2])

        threads = [threading.Thread(target=call, args=(i,)) for i in (0, 2, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        got = np.concatenate([results[i] for i in (0, 2, 4)])
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    finally:
        batcher.close()

    server, srv_batcher = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        body = json.dumps({"instances": x[:3].tolist()}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/predict",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            logits = np.asarray(json.loads(r.read())["predictions"])
        np.testing.assert_allclose(logits, want[:3], atol=1e-5, rtol=1e-5)
    finally:
        server.shutdown()
        server.server_close()
        srv_batcher.close()
        thread.join(timeout=10)


def test_platform_mismatch_refuses_to_load(artifact, tmp_path):
    out, manifest, _ = artifact
    for name in ("manifest.json", "params.pt"):
        with open(os.path.join(out, name), "rb") as src, \
                open(tmp_path / name, "wb") as dst:
            dst.write(src.read())
    other = dict(manifest, platform="cuda")
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(other, f)
    with pytest.raises(ValueError, match="platform 'cuda'"):
        load_predictor(str(tmp_path), device="cpu")


def test_export_refuses_unregistered_name(tmp_path):
    model = create_model(MODEL, num_classes=NCLS, img_size=IMG)
    with pytest.raises(ValueError, match="not registered"):
        export_mod.export_model(model, str(tmp_path), model_name="mystery",
                                device="cpu")


def test_default_device_refuses_without_cuda(artifact, tmp_path, monkeypatch):
    """The entry points default to cuda; without CUDA they raise instead of
    serving on the CPU."""
    out, _, _ = artifact
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_predictor(out)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_mod.main(["--model", MODEL, "--output", str(tmp_path),
                         "--num-classes", str(NCLS), "--img-size", str(IMG)])
    assert not os.listdir(tmp_path)  # no CPU artifact written


@pytest.mark.parametrize("name", ["deit_tiny_distilled_patch16_224",
                                  "deit_tiny_patch16_224"])
def test_export_and_serve_a_zoo_model(name, tmp_path):
    """A distilled and a dense DeiT from a JAX-layout ``.npz`` through the
    export CLI, the Predictor and one HTTP request: the logits equal the
    model's eval forward (for the distilled model the mean of its two
    heads) and the JAX model's on the same weights (f32, 1e-4)."""
    from slim_switch_moe_vit_tpu.models import create_model as jax_create

    ref = create_model(name, num_classes=NCLS, img_size=IMG)
    rs = np.random.RandomState(2)
    jax_tree = to_jax_tree({
        k: torch.from_numpy((rs.randn(*v.shape) * 0.05).astype(np.float32))
        for k, v in ref.state_dict().items()})
    ckpt = str(tmp_path / "params.npz")
    np.savez(ckpt, **flatten_tree(jax_tree))
    out = str(tmp_path / "art")
    export_mod.main(["--model", name, "--output", out, "--checkpoint", ckpt,
                     "--num-classes", str(NCLS), "--img-size", str(IMG),
                     "--dtype", "float32", "--batch-sizes", "4",
                     "--device", "cpu"])
    pred = load_predictor(out, device="cpu")
    assert pred.manifest["model_name"] == name
    x = _images(3, seed=5)
    server, batcher = make_server(pred, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        body = json.dumps({"instances": x.tolist()}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/v1/predict",
            data=body, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            served = np.asarray(json.loads(r.read())["predictions"],
                                np.float32)
    finally:
        server.shutdown()
        server.server_close()
        batcher.close()
        thread.join(timeout=10)
    ref.load_state_dict(from_jax_params(jax_tree))
    ref.eval()
    direct = _bucketed(make_serve_fn(ref), x, (4,))
    np.testing.assert_array_equal(pred.predict(x), direct)
    np.testing.assert_allclose(served, direct, atol=1e-5, rtol=1e-5)
    jm = jax_create(name, num_classes=NCLS, img_size=IMG)
    want = jm.apply({"params": jax_tree},
                    jax_normalize()(jnp.asarray(x)), deterministic=True)
    np.testing.assert_allclose(direct, np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    if "distilled" in name:
        assert ref.head_dist is not None
