"""K5 and K11 compute one f32 function.

The JAX package's two attention forwards, ``fused_mha(..., True)`` (the
Pallas ``_mha_fwd_kernel``: the exact row max first) and
``_flash_forward(..., interpret=True)`` (``_flash_kernel``: the online
softmax over 128-key blocks), both interpreted as the JAX package's own
tests run them, and the port's two plain versions,
``fused_mha_reference`` and ``flash_attention_reference``, on one
numpy-seeded f32 input. In f32 the JAX kernels differ only in the order of
the softmax (``p.astype(T)`` is the identity), so all four agree pairwise
within 2e-6 + 2e-6 |ref|: the f32 forms of K5 and K11 on the card run one
head body (``csrc/attn_mma.cuh``), and this holds them to one function.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import attention as jax_attn
from slim_switch_moe_vit_tpu_torch.ops import attention

H = 2
TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs (several pytest
    workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a ragged 17, ViT-S/16 at 224 px (197) and at 384 px (577) at head_dim
# 64, and vit_huge's head width (80: the scale is not a power of two)
@pytest.mark.parametrize("N,d", [(17, 64), (197, 64), (577, 64), (197, 80)])
def test_k5_and_k11_compute_one_f32_function(N, d):
    B, scale = 1, d ** -0.5
    qkv = np.random.RandomState(N + d).randn(B, N, 3 * H * d).astype(
        np.float32)
    q, k, v = (jnp.asarray(t.reshape(B, N, H, d))
               for t in np.split(qkv, 3, axis=-1))
    out = {
        "jax fused_mha": np.asarray(
            jax_attn.fused_mha(jnp.asarray(qkv), H, scale, True)),
        "jax _flash_forward": np.asarray(
            jax_attn._flash_forward(q, k, v, scale, interpret=True)
        ).reshape(B, N, H * d),
        "fused_mha_reference": attention.fused_mha_reference(
            torch.from_numpy(qkv), H, scale).numpy(),
        "flash_attention_reference": attention.flash_attention_reference(
            torch.from_numpy(qkv), H, scale).numpy(),
    }
    for name, o in out.items():
        assert o.dtype == np.float32 and o.shape == (B, N, H * d), name
    for (ref_name, ref), (name, got) in itertools.combinations(out.items(),
                                                               2):
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} vs {ref_name}")
