"""The port's Mixup / CutMix (``data/mixup.py``) vs the JAX package's.

The JAX ``make_mixup_fn`` draws its parameters from a key; the test takes
the same draws from the same keys (apply, switch, the two lambdas, the box
centre) and hands their values to the port's ``mix`` and ``_bbox``, so
mixup at a fixed lambda and cutmix at a fixed box are held to the JAX
function within 1e-6 (the same f32 operations). The port draws from a
``torch.Generator``, so its sampling is held by its distribution over
30,000 draws, each bound within 5 sigma: Beta(a, a)'s mean and variance,
the apply and switch rates, and the minmax boxes' ranges.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from slim_switch_moe_vit_tpu.data import mixup as jax_mixup
from slim_switch_moe_vit_tpu_torch.data import mixup

B, H, W, NCLS = 6, 20, 16, 10
N_DRAWS = 30000


def test_one_hot_smooth_matches_jax():
    labels = np.asarray([0, 3, 9, 3])
    for s in (0.0, 0.1):
        np.testing.assert_allclose(
            mixup.one_hot_smooth(torch.from_numpy(labels), NCLS, s).numpy(),
            np.asarray(jax_mixup.one_hot_smooth(jnp.asarray(labels), NCLS, s)),
            rtol=0, atol=1e-7)


def _jax_draws(key, alpha_m, alpha_c, prob, switch_prob):
    """The JAX apply's draws for ``key`` (mixup.py:84-107)."""
    k_apply, k_switch, k_lam, k_box = jax.random.split(key, 4)
    ky, kx = jax.random.split(k_box)
    lam_c = jax_mixup._beta(jax.random.fold_in(k_lam, 7), alpha_c)
    return dict(
        do_apply=jax.random.uniform(k_apply) < prob,
        do_cutmix=jax.random.uniform(k_switch) < switch_prob,
        lam_m=jax_mixup._beta(k_lam, alpha_m), lam_c=lam_c,
        cy=jax.random.randint(ky, (), 0, H),
        cx=jax.random.randint(kx, (), 0, W),
        box=jax_mixup._rand_bbox(k_box, H, W, lam_c))


def _t(v, dtype=None):
    return torch.tensor(np.asarray(v), dtype=dtype)


@pytest.mark.parametrize("prob", [1.0, 0.5])
def test_mix_matches_jax_at_fixed_draws(prob):
    rs = np.random.RandomState(0)
    x = rs.randn(B, H, W, 3).astype(np.float32)
    labels = rs.randint(0, NCLS, B)
    fn = jax_mixup.make_mixup_fn(mixup_alpha=0.8, cutmix_alpha=1.0,
                                 prob=prob, switch_prob=0.5,
                                 label_smoothing=0.1, num_classes=NCLS)
    seen = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        d = _jax_draws(key, 0.8, 1.0, prob, 0.5)
        box = mixup._bbox(_t(d["cy"]), _t(d["cx"]), H, W, _t(d["lam_c"]))
        for got_v, want_v in zip(box, d["box"]):
            np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v),
                                       rtol=0, atol=1e-7)
        want_x, want_y = fn(key, jnp.asarray(x), jnp.asarray(labels))
        got_x, got_y = mixup.mix(
            torch.from_numpy(x), torch.from_numpy(labels), _t(d["do_apply"]),
            _t(d["do_cutmix"]), _t(d["lam_m"]), box, NCLS, 0.1)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_y.sum(1).numpy(), 1.0, atol=1e-6)
        seen.add("none" if not d["do_apply"] else
                 "cutmix" if d["do_cutmix"] else "mixup")
    assert seen == ({"mixup", "cutmix", "none"} if prob < 1
                    else {"mixup", "cutmix"})


def _beta_moments(a):
    dist = scipy.stats.beta(a, a)
    m, v = dist.mean(), dist.var()
    return m, v, dist.expect(lambda t: (t - m) ** 4)


@pytest.mark.parametrize("alpha", [0.3, 0.8, 1.0])
def test_beta_moments(alpha):
    lam = mixup._beta(torch.Generator().manual_seed(1), alpha, N_DRAWS,
                      "cpu").double().numpy()
    assert np.isfinite(lam).all() and (lam >= 0).all() and (lam <= 1).all()
    mean, var, m4 = _beta_moments(alpha)
    assert abs(lam.mean() - mean) <= 5 * math.sqrt(var / N_DRAWS)
    assert abs(lam.var() - var) <= 5 * math.sqrt((m4 - var ** 2) / N_DRAWS)


def _rate(flags, p):
    n = len(flags)
    count = float(np.asarray(flags).sum())
    assert abs(count - n * p) <= 5 * math.sqrt(n * p * (1 - p)), (count, p)


def test_apply_and_switch_rates():
    fn = mixup.make_mixup_fn(mixup_alpha=0.8, cutmix_alpha=1.0, prob=0.7,
                             switch_prob=0.3, num_classes=NCLS)
    do_apply, do_cutmix, lam_m, (y0, y1, x0, x1, lam_c) = fn.draw(
        torch.Generator().manual_seed(2), N_DRAWS, H, W, "cpu")
    _rate(do_apply.numpy(), 0.7)
    _rate(do_cutmix.numpy(), 0.3)
    area = ((y1 - y0) * (x1 - x0)).double().numpy()
    np.testing.assert_allclose(lam_c.double().numpy(), 1 - area / (H * W),
                               atol=1e-6)
    assert (y0 >= 0).all() and (y1 <= H).all() and (x0 >= 0).all() \
        and (x1 <= W).all()
    only_cut = mixup.make_mixup_fn(mixup_alpha=0.0, cutmix_alpha=1.0)
    assert only_cut.draw(torch.Generator(), 5, H, W, "cpu")[1].all()
    only_mix = mixup.make_mixup_fn(mixup_alpha=0.8, cutmix_alpha=0.0)
    assert not only_mix.draw(torch.Generator(), 5, H, W, "cpu")[1].any()


def test_minmax_boxes():
    minmax = (0.2, 0.8)
    fn = mixup.make_mixup_fn(mixup_alpha=0.0, cutmix_alpha=0.0,
                             cutmix_minmax=minmax, num_classes=NCLS)
    _, do_cutmix, _, (y0, y1, x0, x1, lam) = fn.draw(
        torch.Generator().manual_seed(3), N_DRAWS, H, W, "cpu")
    assert do_cutmix.all()  # minmax turns cutmix on
    for lo, hi, size in ((y0, y1, H), (x0, x1, W)):
        side = (hi - lo).numpy()
        assert side.min() == int(minmax[0] * size)
        assert side.max() == int(minmax[1] * size) - 1
        assert (lo >= 0).all() and (hi <= size).all()
        assert lo.min() == 0 and (hi == size).any()  # every offset reached
        n = side.max() - side.min() + 1  # sides uniform on their range
        for v in range(side.min(), side.max() + 1):
            _rate(side == v, 1 / n)
    np.testing.assert_allclose(
        lam.double().numpy(),
        1 - ((y1 - y0) * (x1 - x0)).double().numpy() / (H * W), atol=1e-6)


def test_batch_fn_on_a_batch():
    x = torch.from_numpy(np.random.RandomState(4).randn(B, H, W, 3).astype(
        np.float32))
    labels = torch.arange(B) % NCLS
    fn = mixup.make_mixup_fn(num_classes=NCLS)
    a = fn(torch.Generator().manual_seed(5), x, labels)
    b = fn(torch.Generator().manual_seed(5), x, labels)
    assert a[0].shape == x.shape and a[1].shape == (B, NCLS)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    torch.testing.assert_close(a[1].sum(1), torch.ones(B))
    assert mixup.mixup_active(0.8, 0.0, None)
    assert mixup.mixup_active(0.0, 0.0, (0.2, 0.8))
    assert not mixup.mixup_active(0.0, 0.0, None)
