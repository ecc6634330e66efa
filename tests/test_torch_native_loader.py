"""The port's native crop library (``data/native_loader.py`` over
``csrc_host/dataloader.cc``) vs the JAX package's (``native/``, built by
``tests/conftest.py``) and PIL.

- The port's crops equal the JAX package's native ones bit for bit (the
  same source and compiler flags).
- Against PIL's bicubic, the JAX test's bound: mean |d| < 0.5 and fewer
  than 2% of pixels more than 2 levels off.
- The batch form equals the single form; the reflect-pad crop equals
  ``np.pad(..., "reflect")`` and a slice exactly.
- A failed build raises (no compiler, or a source that does not compile);
  nothing falls back. Threads reaching the first build together build
  once.
- ``--train-interpolation bilinear`` (``F.interpolate`` with antialiasing,
  where the JAX package takes PIL's BILINEAR) within 1 uint8 level of PIL
  on a smooth image and on white noise (1 measured on both), mean |d| <
  0.5.
"""
import os

import numpy as np
import pytest
from PIL import Image

from slim_switch_moe_vit_tpu.data import native_loader as jax_native
from slim_switch_moe_vit_tpu.data import transforms as jax_transforms
from slim_switch_moe_vit_tpu_torch.data import native_loader, transforms
from torch_tmp import delete_module_tmp, delete_tmp_path  # noqa: F401


@pytest.fixture(scope="module")
def noise():
    return np.random.RandomState(0).randint(0, 256, (300, 400, 3), np.uint8)


def _smooth(H, W):
    y, x = np.mgrid[0:H, 0:W]
    return np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 11.0)
                     for c in range(3)], -1).astype(np.uint8)


CROPS = [(20, 30, 250, 350, 224), (0, 0, 300, 400, 64), (7, 5, 33, 41, 96),
         (100, 200, 17, 9, 32)]


@pytest.mark.parametrize("crop", CROPS)
def test_crop_resize_equals_jax_native(noise, crop):
    assert jax_native.native_available()
    for img in (noise, _smooth(300, 400)):
        np.testing.assert_array_equal(native_loader.crop_resize(img, *crop),
                                      jax_native.crop_resize(img, *crop))


def test_crop_resize_matches_pil(noise):
    got = native_loader.crop_resize(noise, 20, 30, 250, 350, 224)
    want = np.asarray(Image.fromarray(noise).crop((30, 20, 380, 270))
                      .resize((224, 224), Image.BICUBIC))
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.mean() < 0.5
    assert (diff > 2).mean() < 0.02


def test_batch_equals_single_and_jax():
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 256, (100 + 7 * i, 120, 3), np.uint8)
            for i in range(5)]
    crops = np.asarray([[0, 0, 90, 100], [3, 4, 60, 50], [10, 0, 70, 120],
                        [0, 19, 100, 101], [50, 60, 40, 30]], np.int32)
    out = native_loader.batch_crop_resize(imgs, crops, 64, num_threads=2)
    np.testing.assert_array_equal(
        out, jax_native.batch_crop_resize(imgs, crops, 64, num_threads=3))
    for i in range(5):
        np.testing.assert_array_equal(
            out[i], native_loader.crop_resize(imgs[i], *crops[i], 64))
    with pytest.raises(ValueError, match="outside"):
        native_loader.batch_crop_resize(imgs[:1], [[0, 0, 101, 10]], 8)


def test_pad_reflect_crop_is_exact():
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (32, 28, 3), np.uint8)
    padded = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="reflect")
    for y0, x0 in ((0, 0), (3, 5), (8, 8), (5, 0)):
        got = native_loader.pad_reflect_crop(img, 4, y0, x0, 28)
        np.testing.assert_array_equal(got, padded[y0:y0 + 28, x0:x0 + 28])
    with pytest.raises(ValueError, match="outside"):
        native_loader.pad_reflect_crop(img, 4, 9, 0, 32)


def test_failed_build_raises(tmp_path, monkeypatch):
    native_loader.load_native()
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed"):
        native_loader.build(str(bad), str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native_loader.build(native_loader.SOURCE, str(tmp_path / "build2"))
    # an already built library is loaded as it is, with no compiler asked
    assert native_loader.build().endswith(native_loader.LIB_NAME)


def test_concurrent_first_builds(tmp_path):
    """Threads reaching the first crop together (the loader's workers)
    build once and all get the library."""
    import concurrent.futures

    root = str(tmp_path / "build")
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(
            lambda _: native_loader.build(native_loader.SOURCE, root),
            range(16), timeout=300))
    assert len(set(paths)) == 1 and os.path.exists(paths[0])
    assert os.listdir(os.path.dirname(paths[0])) == [native_loader.LIB_NAME]


def test_bilinear_crop_near_pil(noise):
    tf = transforms.TrainTransform(48, interpolation="bilinear", seed=3)
    want_tf = jax_transforms.TrainTransform(48, interpolation="bilinear",
                                            seed=3)
    for index in range(6):
        for img in (_smooth(90, 70), noise[:90, :70]):
            a = tf(img, index).astype(int)
            b = want_tf(img, index).astype(int)  # PIL's BILINEAR
            d = np.abs(a - b)
            assert d.max() <= 1 and d.mean() < 0.5, index
    with pytest.raises(ValueError, match="bicubic or bilinear"):
        transforms.TrainTransform(48, interpolation="lanczos")(noise, 0)
