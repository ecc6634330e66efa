"""PyTorch port's packed-qkv MHA vs the JAX package's Pallas kernel.

The JAX side runs ``fused_mha(qkv, H, scale, True)`` in interpret mode (as
tests/test_fused_mha.py does); the port's CPU path is its plain version.
Tolerances: f32 2e-4 (as test_fused_mha.py); bf16 2e-2 (the Pallas kernel
rounds the unnormalized p to bf16 and scales afterwards, the plain version
rounds the normalized p: they differ by about one bf16 ulp of p).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.vit import Attention as JaxAttention
from slim_switch_moe_vit_tpu.ops.attention import fused_mha as jax_fused_mha
from slim_switch_moe_vit_tpu_torch.models.vit import Attention
from slim_switch_moe_vit_tpu_torch.ops.attention import (fused_mha,
                                                         reference_mha_bwd)
from slim_switch_moe_vit_tpu_torch.utils.checkpoint import from_jax_params

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,H,d", [(197, 2, 32), (64, 4, 16), (197, 2, 80)])
def test_fused_mha_matches_jax(N, H, d, dtype):
    rs = np.random.RandomState(0)
    qkv = rs.randn(2, N, 3 * H * d).astype(np.float32)
    want = jax_fused_mha(jnp.asarray(qkv, jnp.dtype(dtype)), H, d ** -0.5, True)
    got = fused_mha(torch.from_numpy(qkv).to(getattr(torch, dtype)), H,
                    d ** -0.5)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_attention_module_matches_jax():
    """qkv GEMM -> MHA -> proj GEMM with the same weights (f32)."""
    B, N, C, H = 2, 17, 64, 2
    x = np.random.RandomState(1).randn(B, N, C).astype(np.float32)
    jm = JaxAttention(num_heads=H, attn_impl="fused")
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                        deterministic=True)
    want = jm.apply(variables, jnp.asarray(x), deterministic=True)
    m = Attention(C, H)
    m.load_state_dict(from_jax_params(variables["params"]))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_mha_backward_at_head_dim_80_matches_jax(dtype, tol):
    """K6's d(qkv) at vit_huge's head width (d = 80, where the scale is not
    a power of two), H = 2, N = 197: ``jax.vjp`` of the JAX ``fused_mha``
    (its Pallas backward interpreted) against the port's autograd backward
    (its plain version on the CPU), within tol of max |ref| (f32: the same
    math in other summation orders; bf16: e, ds and do*linv round on both
    sides, as tests/test_torch_backward.py at d = 64)."""
    rs = np.random.RandomState(2)
    B, N, H, d = 2, 197, 2, 80
    qkv, do = rs.randn(B, N, 3 * H * d), rs.randn(B, N, H * d)
    jq = jnp.asarray(qkv, jnp.dtype(dtype))
    _, vjp = jax.vjp(lambda t: jax_fused_mha(t, H, d ** -0.5, True), jq)
    (want,) = vjp(jnp.asarray(do, jnp.dtype(dtype)))
    want = np.asarray(want, np.float32)
    leaf = torch.from_numpy(qkv.astype(np.float32)).to(
        getattr(torch, dtype)).requires_grad_()
    fused_mha(leaf, H, d ** -0.5).backward(
        torch.from_numpy(do.astype(np.float32)).to(getattr(torch, dtype)))
    got = leaf.grad.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())
    direct = reference_mha_bwd(leaf.detach(), torch.from_numpy(
        do.astype(np.float32)), H, d ** -0.5)
    assert torch.equal(direct.float(), leaf.grad.float())
