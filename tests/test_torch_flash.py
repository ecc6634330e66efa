"""The port's online-softmax attention (K11) vs the JAX package's.

The port's plain version, ``flash_attention_reference`` over the packed
(B, N, 3C) qkv, against the JAX Pallas kernel ``_flash_forward`` run in
interpret mode (as the JAX package's own tests run it) on the same
numpy-seeded q, k and v, head dim 64, at N = 197 (ViT-S/16 at 224 px) and a
ragged N = 77.

- f32: both keep every step in f32; within 2e-6 (sums in other orders).
- bf16: the JAX kernel keeps the probabilities P in f32 for the P.V
  product, the port rounds them to bf16 (as K5 and the JAX package's
  ``fused_mha`` do). Each probability moves by at most 2^-9 of itself, so
  the output moves by at most 2^-9 * max |v|, and both outputs round once
  more to bf16 (2^-8 of |o| between them): within 2^-8 * max |v| + 2^-7 *
  |ref|.

The backward recomputes through the plain version, as the JAX package's
``_fa_bwd`` differentiates its XLA oracle ``_xla_attention``: d(qkv)
against ``jax.vjp`` of that oracle, f32, within 1e-5 of max |ref|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import attention as jax_attn
from slim_switch_moe_vit_tpu_torch.ops import attention

H, HD = 2, 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(B, N, dtype):
    rs = np.random.RandomState(N)
    x = rs.randn(B, N, 3 * H * HD).astype(np.float32)
    return np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))


def _split(qkv):
    B, N, _ = qkv.shape
    return [t.reshape(B, N, H, HD) for t in np.split(qkv, 3, axis=-1)]


@pytest.mark.parametrize("N", [197, 77])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_matches_jax_kernel(N, dtype):
    B, scale = 2, HD ** -0.5
    qkv = _qkv(B, N, dtype)
    q, k, v = (jnp.asarray(t, dtype) for t in _split(qkv))
    want = np.asarray(jax_attn._flash_forward(q, k, v, scale, interpret=True),
                      np.float32).reshape(B, N, H * HD)
    got = attention.flash_attention(
        torch.from_numpy(qkv).to(getattr(torch, dtype)), H, scale)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, H * HD)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    else:
        vmax = np.abs(_split(qkv)[2]).max()
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -8 * vmax)


def test_flash_backward_matches_the_jax_oracle():
    B, N, scale = 2, 77, HD ** -0.5
    qkv = _qkv(B, N, "float32")
    do = np.random.RandomState(1).randn(B, N, H * HD).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_attn._xla_attention(q, k, v, scale),
                     *(jnp.asarray(t) for t in _split(qkv)))
    want = np.concatenate([np.asarray(g).reshape(B, N, H * HD)
                           for g in vjp(jnp.asarray(do).reshape(B, N, H, HD))],
                          -1)
    leaf = torch.from_numpy(qkv).requires_grad_()
    attention.flash_attention(leaf, H, scale).backward(torch.from_numpy(do))
    np.testing.assert_allclose(leaf.grad.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
