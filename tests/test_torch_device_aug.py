"""The port's on-device augmentation (``data/device_aug.py``) vs the JAX
package's.

Each op is called on the same seeded uint8 images (4 of 24 x 20, as f32)
on both sides. RandAugment's 15 ops run at fixed magnitudes of both signs
(one per image). 3-Augment, its Gaussian blur, color jitter and random
erasing draw their parameters inside the JAX ops, so the test takes the
same draws from the same keys and hands their values to the port's op.
Tolerances: the integer ops (equalize, posterize, solarize, solarize-add,
invert) and erasing equal exactly; the other ops within 1e-3 of a uint8
level (f32 arithmetic in another order), the affine ones within 1e-2
(``grid_sample``'s normalized coordinates round once more than
``map_coordinates``' pixel ones).

The port draws from a ``torch.Generator`` and the JAX package from
``jax.random``, so the sampling is held by its distribution over 30,000
draws, each bound within 5 sigma.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.data import device_aug as jax_aug
from slim_switch_moe_vit_tpu_torch.data import device_aug as aug

B, H, W = 4, 24, 20
MAGS = np.asarray([9.0, -9.0, 4.3, -2.7], np.float32)
INTEGER_OPS = {"Equalize", "Posterize", "Solarize", "SolarizeAdd", "Invert"}
AFFINE_OPS = {"Rotate", "ShearX", "ShearY", "TranslateXRel",
              "TranslateYRel"}
N_DRAWS = 30000


@pytest.fixture(scope="module")
def images():
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (B, H, W, 3)).astype(np.float32)
    imgs[1, :, :, 2] = 77.0  # a flat channel: autocontrast's and
    # equalize's degenerate branch
    return imgs


def _jax_batch(fn, imgs, *per_sample):
    return np.asarray(jax.vmap(fn)(jnp.asarray(imgs),
                                   *map(jnp.asarray, per_sample)))


def _close(got, want, what, atol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, what
    if atol == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=what)


def test_ra_ops_are_the_jax_ops_in_order():
    assert [name for name, _, _ in aug._RA_OPS] == [
        "AutoContrast", "Equalize", "Invert", "Rotate", "Posterize",
        "Solarize", "SolarizeAdd", "Color", "Contrast", "Brightness",
        "Sharpness", "ShearX", "ShearY", "TranslateXRel", "TranslateYRel"]
    assert aug.SIGNED == tuple(s for _, s in jax_aug._RA_OPS)


@pytest.mark.parametrize("k", range(15), ids=[n for n, _, _ in aug._RA_OPS])
def test_randaugment_op_matches_jax(images, k):
    name = aug._RA_OPS[k][0]
    want = _jax_batch(jax_aug._RA_OPS[k][0], images, MAGS)
    got = aug.apply_op(k, torch.from_numpy(images), torch.from_numpy(MAGS))
    atol = 0 if name in INTEGER_OPS else 1e-2 if name in AFFINE_OPS else 1e-3
    _close(got, want, name, atol)


def test_randaugment_layer_keeps_each_samples_op(images):
    """A layer computes every op on the batch and keeps, per sample, the
    one it drew (unapplied samples unchanged)."""
    x = torch.from_numpy(images)
    op = torch.tensor([3, 1, 13, 7])
    apply = torch.tensor([True, True, True, False])
    mag = torch.from_numpy(MAGS)
    out = aug._randaugment_layer(x, op, apply, mag)
    for i in range(B):
        want = (aug.apply_op(int(op[i]), x[i:i + 1], mag[i:i + 1])[0]
                if apply[i] else x[i])
        torch.testing.assert_close(out[i], want, rtol=0, atol=1e-4)


def test_three_augment_branches_match_jax(images):
    keys = jax.random.split(jax.random.PRNGKey(2), 12)
    k_choice, k_op = [], []
    for key in keys:
        kc, ko, _ = jax.random.split(key, 3)
        k_choice.append(jax.random.randint(kc, (), 0, 3))
        k_op.append(jax.random.uniform(ko, (), minval=0.1, maxval=2.0))
    choice, sigma = np.asarray(k_choice), np.asarray(k_op, np.float32)
    assert set(choice.tolist()) == {0, 1, 2}
    imgs = np.concatenate([images] * 3)
    want = np.asarray(jax.vmap(
        lambda k, im: jax_aug._three_augment_single(k, im, 0.0))(
            keys, jnp.asarray(imgs)))
    got = aug._three_augment(torch.from_numpy(imgs),
                             torch.from_numpy(choice), torch.from_numpy(sigma))
    _close(got, want, "3-Augment", 1e-3)


@pytest.mark.parametrize("sigma", [0.1, 0.7, 2.0])
def test_gaussian_blur_matches_jax_at_a_fixed_sigma(images, sigma, monkeypatch):
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **kw: jnp.float32(sigma))
    want = _jax_batch(lambda im: jax_aug._gaussian_blur(None, im), images)
    got = aug._gaussian_blur(torch.from_numpy(images),
                             torch.full((B,), sigma))
    _close(got, want, "blur", 1e-3)


def test_color_jitter_matches_jax(images):
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    factors = [[float(jax.random.uniform(k, (), minval=0.6, maxval=1.4))
                for k in jax.random.split(key, 3)] for key in keys]
    want = np.asarray(jax.vmap(
        lambda k, im: jax_aug._color_jitter(k, im, 0.4))(
            keys, jnp.asarray(images)))
    b, c, s = torch.tensor(factors).T
    got = aug._color_jitter(torch.from_numpy(images), b, c, s)
    _close(got, want, "color jitter", 1e-3)


@pytest.mark.parametrize("count", [1, 3])
def test_random_erasing_matches_jax(count):
    x = np.random.RandomState(1).randn(B, H, W, 3).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    got = torch.from_numpy(x)
    for i in range(count):
        draws = []
        for key in keys:  # the JAX op's draws for pass i, key by key
            ka, kr, ky, kx, kn, kp = jax.random.split(
                jax.random.fold_in(key, i), 6)
            draws.append((
                jax.random.uniform(kp) < 0.6,
                jax.random.uniform(ka, (), minval=0.02, maxval=1 / 3),
                jax.random.uniform(kr, (), minval=math.log(0.3),
                                   maxval=math.log(1 / 0.3)),
                jax.random.randint(ky, (), 0, H),
                jax.random.randint(kx, (), 0, W),
                jax.random.normal(kn, (H, W, 3))))
        do, area, log_r, top, left, noise = (
            torch.from_numpy(np.stack([np.asarray(d[j]) for d in draws]))
            for j in range(6))
        h, w = aug._erase_hw(area, log_r, H, W, count)
        got = aug._erase(got, do, top.long(), left.long(), h, w, noise)
    want = np.asarray(jax.vmap(
        lambda k, im: jax_aug._random_erase_single(k, im, 0.6, count))(
            keys, jnp.asarray(x)))
    assert (got.numpy() != x).any()
    _close(got, want, "erasing", 0)


def test_rand_config_parse_matches_jax():
    for aa in ("rand-m9-mstd0.5-inc1", "rand-m7-mstd1.0", "rand-m12"):
        tok = dict(m=9.0, mstd=0.5)
        for t in aa.split("-")[1:]:  # the JAX parse, :320-326
            if t.startswith("mstd"):
                tok["mstd"] = float(t[4:])
            elif t.startswith("m"):
                tok["m"] = float(t[1:])
        assert aug.parse_rand_config(aa) == (tok["m"], tok["mstd"])


def test_pipeline_runs_each_branch_deterministically():
    imgs = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (6, 32, 32, 3)).astype(np.uint8))
    for kw in (dict(), dict(aa="", three_augment=True),
               dict(aa="", color_jitter=0.4),
               dict(aa="", color_jitter=0, reprob=0, hflip=0.0)):
        fn = aug.build_device_augment(input_size=32, **kw)
        a = fn(torch.Generator().manual_seed(0), imgs)
        b = fn(torch.Generator().manual_seed(0), imgs)
        assert a.shape == (6, 32, 32, 3) and a.dtype == torch.float32
        assert torch.isfinite(a).all() and torch.equal(a, b)
    plain = aug.build_eval_normalize()(imgs)
    assert torch.equal(a, plain)  # no flip, no photometric op, no erasing


def _sigma5(count, n, p):
    assert abs(count - n * p) <= 5 * math.sqrt(n * p * (1 - p)), (count, n, p)


def _clipped_normal_moments(mu, sd, lo, hi):
    """Mean, variance and the variance of the sample variance's terms of
    clip(N(mu, sd), lo, hi), by quadrature plus the two point masses."""
    x = np.linspace(lo, hi, 200001)
    pdf = np.exp(-0.5 * ((x - mu) / sd) ** 2) / (sd * math.sqrt(2 * math.pi))
    cdf = lambda v: 0.5 * (1 + math.erf((v - mu) / (sd * math.sqrt(2))))
    p_lo, p_hi = cdf(lo), 1 - cdf(hi)

    def moment(f):
        return np.trapezoid(f(x) * pdf, x) + p_lo * f(lo) + p_hi * f(hi)
    mean = moment(lambda v: v)
    var = moment(lambda v: (v - mean) ** 2)
    m4 = moment(lambda v: (v - mean) ** 4)
    return mean, var, m4


def test_randaugment_sampling_distribution():
    gen = torch.Generator().manual_seed(11)
    layers = aug.sample_randaugment(gen, N_DRAWS, 9.0, 0.5, "cpu")
    assert len(layers) == aug.NUM_LAYERS
    op = torch.cat([layer[0] for layer in layers]).numpy()
    apply = torch.cat([layer[1] for layer in layers]).numpy()
    mag = torch.cat([layer[2] for layer in layers]).numpy()
    n = len(op)
    for k in range(15):
        _sigma5((op == k).sum(), n, 1 / 15)
    _sigma5(apply.sum(), n, 0.5)
    signed = np.asarray(aug.SIGNED)[op]
    _sigma5((mag[signed] < 0).sum(), signed.sum(), 0.5)
    assert (mag[~signed] >= 0).all()
    a = np.abs(mag)
    assert a.min() >= 0 and a.max() <= 10.0 and (a == 10.0).any()
    mean, var, m4 = _clipped_normal_moments(9.0, 0.5, 0.0, 10.0)
    assert abs(a.mean() - mean) <= 5 * math.sqrt(var / n)
    assert abs(a.var() - var) <= 5 * math.sqrt((m4 - var ** 2) / n)


def test_erase_sampling_distribution():
    gen = torch.Generator().manual_seed(12)
    Hs, Ws = 224, 160
    (do, top, left, h, w), = aug.sample_erase(gen, N_DRAWS, Hs, Ws, 0.25, 1,
                                              "cpu")
    _sigma5(do.sum().item(), N_DRAWS, 0.25)
    for v, n in ((top, Hs), (left, Ws)):  # uniform over the rows / columns
        assert 0 <= v.min() and v.max() < n
        sd = math.sqrt((n * n - 1) / 12 / N_DRAWS)
        assert abs(v.double().mean().item() - (n - 1) / 2) <= 5 * sd
    area = (h * w).double() / (Hs * Ws)
    aspect = h.double() / w.double()
    # h, w are the truncated sides of a box of area U(0.02, 1/3) and aspect
    # exp U(log 0.3, log 1/0.3): within those ranges up to the truncation
    assert area.max() <= 1 / 3 and area.max() > 0.32
    assert area.min() >= 0.016 and area.min() < 0.021
    assert aspect.min() >= 0.3 * 0.8 and aspect.min() < 0.32
    assert aspect.max() <= (1 / 0.3) / 0.8 and aspect.max() > 3.1
    hh, ww = aug._erase_hw(torch.tensor([0.3, 1e-6]), torch.tensor(
        [math.log(100.0), 0.0]), Hs, Ws, 1)
    assert hh.tolist() == [Hs - 1, 1] and ww.tolist()[1] == 1  # clamped
