"""The port's proj-folded attention forward (K12) vs the JAX package's.

The port's ``fused_mha_proj`` on the CPU (its plain version,
``fused_mha_proj_reference``: the unfused attention, then the proj product
and bias, rounded as the JAX ``_mha_proj_ref``) against the JAX
``fused_mha_proj`` with its Pallas kernel interpreted
(``tests/test_fused_mha.py``'s shapes: B=4, H=3, d=64, N = 197 and 64), on
the same numpy-seeded f32 inputs: within 2e-5 + 2e-5 |ref| (the same
products summed in other orders; the kernel adds each head's o_h . Wp[h]
into its accumulator, the plain side takes one (N, C) x (C, C) product).

The backward: both sides differentiate the unfused reference (the JAX
``custom_vjp`` recomputes through ``_mha_proj_ref``, the port's autograd
Function through its plain version), so dqkv, dwp and dbp of sum(y^2)
agree within 1e-5 of each one's max |ref|, at the JAX test's B=2, N=64,
H=3, d=32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops.attention import \
    fused_mha_proj as jax_fused_mha_proj
from slim_switch_moe_vit_tpu_torch.ops import attention


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, N, H, d, seed):
    C = H * d
    rs = np.random.RandomState(seed)
    return (rs.randn(B, N, 3 * C).astype(np.float32),
            (rs.randn(C, C) * 0.05).astype(np.float32),
            (rs.randn(C) * 0.1).astype(np.float32))


@pytest.mark.parametrize("N", [197, 64])
def test_mha_proj_matches_jax_kernel(N):
    B, H, d = 4, 3, 64
    qkv, wp, bp = _inputs(B, N, H, d, seed=N)
    want = np.asarray(jax_fused_mha_proj(
        jnp.asarray(qkv), jnp.asarray(wp), jnp.asarray(bp), H, d ** -0.5,
        True))
    got = attention.fused_mha_proj(torch.from_numpy(qkv),
                                   torch.from_numpy(wp),
                                   torch.from_numpy(bp), H, d ** -0.5)
    assert got.shape == (B, N, H * d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_mha_proj_grads_match_jax():
    B, N, H, d = 2, 64, 3, 32
    qkv, wp, bp = _inputs(B, N, H, d, seed=4)

    def loss(qkv, wp, bp):
        return jnp.sum(jax_fused_mha_proj(qkv, wp, bp, H, d ** -0.5,
                                          True) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(t) for t in (qkv, wp, bp)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (qkv, wp, bp)]
    (attention.fused_mha_proj(*leaves, H, d ** -0.5) ** 2).sum().backward()
    for leaf, w, name in zip(leaves, want, ("dqkv", "dwp", "dbp")):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_mha_proj_at_vit_huge_width_matches_jax_kernel():
    """K12 at C = 1280 (vit_huge's width: 16 heads of 80), N = 197, B = 1,
    f32: the port's plain version against the interpreted JAX kernel, within
    2e-5 + 2e-5 |ref| as above."""
    B, N, H, d = 1, 197, 16, 80
    qkv, wp, bp = _inputs(B, N, H, d, seed=5)
    wp = wp * (64 / 1280) ** 0.5  # keep y's scale near the cases above
    want = np.asarray(jax_fused_mha_proj(
        jnp.asarray(qkv), jnp.asarray(wp), jnp.asarray(bp), H, d ** -0.5,
        True))
    got = attention.fused_mha_proj(torch.from_numpy(qkv),
                                   torch.from_numpy(wp),
                                   torch.from_numpy(bp), H, d ** -0.5)
    assert got.shape == (B, N, H * d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
