"""The port's row gather and scatter-add (K13) vs the JAX package's.

The port's ``gather_rows`` / ``scatter_add_rows`` on the CPU (their plain
versions) against the JAX Pallas kernels ``_gather_impl`` and
``_scatter_add_impl`` interpreted (``tests/test_gather_pallas.py``'s
shapes: a 1000 x 192 table, 2,048 indices; 1,024 rows added into 500), on
the same numpy-seeded inputs. The public JAX wrappers run the kernels
without interpretation and cannot run on the CPU.

- gather: a copy, equal bit for bit in f32 and bf16.
- scatter-add, f32: both add each row's sources in index order in f32,
  equal bit for bit (and equal to ``np.add.at``).
- scatter-add, bf16: the JAX kernel accumulates in bf16, rounding after
  every add; the port sums in f32 and rounds once (a divergence by
  design). Each rounding to bf16 (8 significant bits) moves a partial sum
  by at most 2^-8 of itself, so by at most 2^-8 of the row's sum of |g|,
  S: a row of m sources differs by at most m * 2^-8 * S.

Each autograd direction is the other op: the gather's backward against
``np.add.at`` of the cotangent, the scatter-add's against a take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops.gather_pallas import (_gather_impl,
                                                       _scatter_add_impl)
from slim_switch_moe_vit_tpu_torch.ops import gather

N, D, M = 1000, 192, 2048        # the gather's table and indices
ROWS, G_ROWS = 500, 1024         # the scatter-add's output and input rows
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as(a: np.ndarray, dtype: str):
    """(JAX array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        DTYPES[dtype][1])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_jax_kernel(dtype):
    rs = np.random.RandomState(0)
    xj, xt = _as(rs.randn(N, D), dtype)
    idx = rs.randint(0, N, M).astype(np.int32)
    want = _gather_impl(xj, jnp.asarray(idx), block_m=256, interpret=True)
    got = gather.gather_rows(xt, torch.from_numpy(idx))
    assert got.dtype == DTYPES[dtype][1]
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_matches_jax_kernel(dtype):
    rs = np.random.RandomState(1)
    idx = rs.randint(0, ROWS, G_ROWS).astype(np.int32)
    gj, gt = _as(rs.randn(G_ROWS, D), dtype)
    want = np.asarray(_scatter_add_impl(gj, jnp.asarray(idx), ROWS,
                                        block_m=256, interpret=True)
                      .astype(jnp.float32))
    got = gather.scatter_add_rows(gt, torch.from_numpy(idx), ROWS)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (ROWS, D)
    got = got.float().numpy()
    if dtype == "float32":
        exact = np.zeros((ROWS, D), np.float32)
        np.add.at(exact, idx, gt.numpy())
        assert np.array_equal(got, want) and np.array_equal(got, exact)
        return
    m = np.bincount(idx, minlength=ROWS)[:, None].astype(np.float32)
    s = np.zeros((ROWS, D), np.float32)
    np.add.at(s, idx, np.abs(gt.float().numpy()))
    assert (np.abs(got - want) <= m * 2.0 ** -8 * s).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_directions(dtype):
    """gather's backward is the scatter-add, and the scatter-add's the
    gather: against np.add.at (in f32, rounded once) and a take."""
    rs = np.random.RandomState(2)
    _, xt = _as(rs.randn(ROWS, D), dtype)
    _, ct = _as(rs.randn(G_ROWS, D), dtype)
    idx = torch.from_numpy(rs.randint(0, ROWS, G_ROWS))
    x = xt.clone().requires_grad_()
    gather.gather_rows(x, idx).backward(ct)
    want = np.zeros((ROWS, D), np.float32)
    np.add.at(want, idx.numpy(), ct.float().numpy())
    assert np.array_equal(x.grad.float().numpy(),
                          torch.from_numpy(want).to(xt.dtype).float().numpy())
    g = ct.clone().requires_grad_()
    gather.scatter_add_rows(g, idx, ROWS).backward(xt)
    assert torch.equal(g.grad, xt[idx])
