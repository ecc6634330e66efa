"""PyTorch port's LayerNorm forwards vs the JAX package's Pallas kernels.

The same seeded numpy inputs go through the JAX kernels (interpret mode on
the CPU, as tests/test_fused_ln.py runs them) and the port's CPU path.
Tolerances: f32 1e-5; bf16 1.6e-2 (two bf16 ulps at 1.0; both sides form
the same bf16 sum and f32 statistics, so they differ only where f32
summation order flips a bf16 rounding).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.models.layers import LayerNorm as JaxLayerNorm
from slim_switch_moe_vit_tpu.ops import fused_ln as jax_ln
from slim_switch_moe_vit_tpu_torch.models.layers import LayerNorm
from slim_switch_moe_vit_tpu_torch.ops import fused_ln as torch_ln

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, shape, dtype):
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    r = rs.randn(*shape).astype(np.float32)
    g = (rs.randn(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    b = (rs.randn(shape[-1]) * 0.1).astype(np.float32)
    jd = jnp.dtype(dtype)
    td = getattr(torch, dtype)
    jax_args = (jnp.asarray(x, jd), jnp.asarray(r, jd), jnp.asarray(g),
                jnp.asarray(b))
    torch_args = (torch.from_numpy(x).to(td), torch.from_numpy(r).to(td),
                  torch.from_numpy(g), torch.from_numpy(b))
    return jax_args, torch_args


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["ln", "add_ln", "sum_ln"])
def test_ln_forward_matches_jax(form, dtype):
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _inputs(0, (2, 24, 128), dtype)
    tol = TOL[dtype]
    if form == "ln":
        want, got = [jax_ln.fused_ln(jx, jg, jb)], [torch_ln.fused_ln(tx, tg, tb)]
    elif form == "add_ln":
        want = jax_ln.fused_add_ln(jx, jr, jg, jb)
        got = torch_ln.fused_add_ln(tx, tr, tg, tb)
    else:
        want = [jax_ln.fused_sum_ln(jx, jr, jg, jb)]
        got = [torch_ln.fused_sum_ln(tx, tr, tg, tb)]
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)


def test_reference_add_ln_matches_jax_reference():
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _inputs(1, (40, 384), "float32")
    for w, g in zip(jax_ln.reference_add_ln(jx, jr, jg, jb),
                    torch_ln.reference_add_ln(tx, tr, tg, tb)):
        np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_module_forms_match_jax(dtype):
    """The module's three forms (plain, residual, residual without the sum)
    against the JAX module on its fused kernels, same parameters."""
    (jx, jr, jg, jb), (tx, tr, tg, tb) = _inputs(2, (3, 17, 64), dtype)
    jm = JaxLayerNorm(impl="fused")
    params = {"params": {"scale": jg, "bias": jb}}
    m = LayerNorm(64)
    m.load_state_dict({"weight": tg, "bias": tb})
    tol = TOL[dtype]
    with torch.no_grad():
        pairs = [
            ([jm.apply(params, jx)], [m(tx)]),
            (jm.apply(params, jx, residual=jr), m(tx, residual=tr)),
            ([jm.apply(params, jx, residual=jr, emit_sum=False)],
             [m(tx, residual=tr, emit_sum=False)]),
        ]
    for want, got in pairs:
        for w, g in zip(want, got):
            np.testing.assert_allclose(_np(g), _np(w), atol=tol, rtol=tol)
