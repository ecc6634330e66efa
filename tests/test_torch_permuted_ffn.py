"""K10's plain version (``fused_expert_ffn_permuted`` on CPU tensors:
the permuted tiles gathered into step order, the plain expert FFN, results
written back to their own tiles) against the JAX package's
``fused_expert_ffn_permuted`` run interpreted, on the layout of
``tests/test_fused_ffn.py:237``: 4 source blocks x 3 experts x 2 tiles of
256 rows, visited expert-major. The same numpy inputs go to both; y within
2e-5 and the gradients of sum(y * cos(i)) by xs, w1, b1, w2 and b2 within
3e-5 + 1e-4 |ref| (f32, as the JAX test holds the permuted kernel to its
relayout), dx in xs's own row order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn

TILE = fused_ffn.TILE_ROWS
D, H, E, SRC, N_PER = 32, 64, 3, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed):
    rs = np.random.RandomState(seed)
    n_tiles = SRC * E * N_PER
    arrays = dict(
        xs=rs.randn(n_tiles * TILE, D).astype(np.float32),
        w1=(rs.randn(E, D, H) * 0.05).astype(np.float32),
        b1=(rs.randn(E, H) * 0.01).astype(np.float32),
        w2=(rs.randn(E, H, D) * 0.05).astype(np.float32),
        b2=(rs.randn(E, D) * 0.01).astype(np.float32))
    perm = np.arange(n_tiles, dtype=np.int32).reshape(
        SRC, E, N_PER).transpose(1, 0, 2).reshape(-1)
    e_of_step = np.repeat(np.arange(E, dtype=np.int32), SRC * N_PER)
    return arrays, e_of_step, perm


@pytest.mark.parametrize("seed", [7, 8])
def test_permuted_ffn_matches_jax_interpreted(seed):
    arrays, e_of_step, perm = _case(seed)
    assert (perm != np.arange(perm.size)).any()
    names = ("xs", "w1", "b1", "w2", "b2")
    weight = np.cos(np.arange(arrays["xs"].size, dtype=np.float32)).reshape(
        arrays["xs"].shape)

    def jax_loss(*args):
        y = jax_ffn.fused_expert_ffn_permuted(
            *args, jnp.asarray(e_of_step), jnp.asarray(perm))
        return jnp.sum(y * weight), y

    (_, want_y), want_g = jax.value_and_grad(
        jax_loss, argnums=tuple(range(5)), has_aux=True)(
        *(jnp.asarray(arrays[k]) for k in names))

    leaves = [torch.tensor(arrays[k], requires_grad=True) for k in names]
    y = fused_ffn.fused_expert_ffn_permuted(
        *leaves, torch.from_numpy(e_of_step), torch.from_numpy(perm))
    (y * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=0)
    for name, leaf, g in zip(names, leaves, want_g):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(g),
                                   atol=3e-5, rtol=1e-4, err_msg=name)


def test_permuted_ffn_equals_relayout_on_the_port():
    """On the port's plain path, K10's function is exactly the expert-major
    relayout of the rows through ``fused_expert_ffn`` and back, forward
    and gradients."""
    arrays, e_of_step, perm = _case(9)
    e_of_step, perm = torch.from_numpy(e_of_step), torch.from_numpy(perm)
    rows = fused_ffn.permuted_rows(perm)

    def run(permuted):
        leaves = [torch.tensor(arrays[k], requires_grad=True)
                  for k in ("xs", "w1", "b1", "w2", "b2")]
        if permuted:
            y = fused_ffn.fused_expert_ffn_permuted(*leaves, e_of_step, perm)
        else:
            y = torch.empty_like(leaves[0]).index_put(
                (rows,), fused_ffn.fused_expert_ffn(
                    leaves[0][rows], *leaves[1:], e_of_step))
        (y * y).sum().backward()
        return [y.detach()] + [leaf.grad for leaf in leaves]

    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)
