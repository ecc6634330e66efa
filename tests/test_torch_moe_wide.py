"""The port's fused MoE layer at the base models' width (D = 768, as
``resmoe_base_patch16_224_expert8`` and ``moe_base_patch16_224_expert32``)
in f32 against the JAX package's ``moe_forward_fused`` on the CPU: the
same numpy-seeded router, experts (E=4, hidden 256) and 64 tokens, top-2.
y and the balance loss within 1e-5 of max |ref| (the same f32 products in
other summation orders). On the card the expert-FFN kernels take D = 768
in f32 in split TF32 on the tensor cores (``tests/test_torch_kernels.py``,
``cuda``-marked).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.ops import moe as torch_moe


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_moe_layer_at_d768_matches_jax():
    rs = np.random.RandomState(4)
    T, d, h, E = 64, 768, 256, 4
    x = rs.randn(T, d).astype(np.float32)
    params = [(rs.randn(d, E) * d ** -0.5).astype(np.float32),
              (rs.randn(E) * 0.1).astype(np.float32),
              (rs.randn(E, d, h) * d ** -0.5).astype(np.float32),
              (rs.randn(E, h) * 0.1).astype(np.float32),
              (rs.randn(E, h, d) * h ** -0.5).astype(np.float32),
              (rs.randn(E, d) * 0.1).astype(np.float32)]
    want, want_aux = jax.jit(partial(jax_moe.moe_forward_fused, top_k=2))(
        jnp.asarray(x), *map(jnp.asarray, params))
    got, got_aux = torch_moe.moe_forward_fused(
        torch.from_numpy(x), *map(torch.from_numpy, params), top_k=2)
    want = np.asarray(want)
    assert got.shape == (T, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got_aux["balance_loss"].item(),
                               float(want_aux["balance_loss"]), rtol=1e-5)
