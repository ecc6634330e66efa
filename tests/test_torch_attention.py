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
from slim_switch_moe_vit_tpu_torch.ops.attention import fused_mha
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
@pytest.mark.parametrize("N,H,d", [(197, 2, 32), (64, 4, 16)])
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
