"""The port's kernel backwards (K1c, K2b, K6, K4) vs ``jax.vjp`` of the JAX
package's ops.

The same seeded numpy inputs and cotangents go through ``jax.vjp`` of the
JAX functions (their Pallas backward kernels in interpret mode, as the JAX
package's own tests run them on the CPU) and through ``torch.autograd`` of
the port's autograd Functions, whose CPU backward is the plain version.
Every input gradient and dgamma/dbeta or dW/db is compared.

Tolerances (|got - want| <= tol * max|want| per output):
- f32: 1e-5 (the same f32 math in different summation orders).
- bf16, stated per case: LN 1.6e-2 (two bf16 ulps at 1.0: the statistics
  sum in another order and du rounds once on each side); MHA 2e-2 (e, ds
  and do*linv round to bf16 on both sides, a flipped rounding moves one
  product term by an ulp); expert FFN 3e-2 (the JAX package's bf16 GELU
  and GELU' are polynomials within 5.7e-4 / 1.5e-3 of the exact forms the
  port uses, and it rounds dx twice, the port once).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import fused_ln as jax_ln
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu.ops.attention import fused_mha as jax_fused_mha
from slim_switch_moe_vit_tpu_torch import ops
from slim_switch_moe_vit_tpu_torch.ops import attention as torch_attn
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn
from slim_switch_moe_vit_tpu_torch.ops import fused_ln as torch_ln


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch's CPU ops on one thread while this module runs: the suite runs
    several pytest workers per host, and torch's oversubscribed thread pool
    made these tests ~100x slower there than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(a, dtype):
    a = np.asarray(a, np.float32)
    return (jnp.asarray(a, jnp.dtype(dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_())


def _close(got, want, tol, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _vjp_both(jax_fn, torch_fn, inputs, cots, dtypes):
    """(torch grads, jax grads) of every input for the given cotangents."""
    jin, tin = zip(*[_pair(a, d) for a, d in zip(inputs, dtypes)])
    jout, vjp = jax.vjp(jax_fn, *jin)
    tout = torch_fn(*tin)
    single = not isinstance(jout, (tuple, list))
    jout = [jout] if single else list(jout)
    tout = [tout] if single else list(tout)
    jc = [jnp.asarray(c, o.dtype) for c, o in zip(cots, jout)]
    tc = [torch.from_numpy(np.asarray(c, np.float32)).to(o.dtype)
          for c, o in zip(cots, tout)]
    want = vjp(jc[0] if single else tuple(jc))
    got = torch.autograd.grad(tout, tin, tc)
    return got, want


LN_TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}
# dgamma/dbeta: f32 sums over the rows on both sides, of bf16 dy times an
# xhat that differs by the statistics' summation order. For K2b in bf16
# 1e-2: the JAX package's interpret run of the slim kernel keeps a + b in
# f32 (XLA's excess precision for bf16), the port rounds it to bf16 first
# as its forward does, so xhat differs by up to a bf16 ulp of u (0.45% of
# max |dgamma| measured)
LN_PARAM_TOL = {"float32": 1e-5, "bfloat16": 2e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 24, 128), (40, 128), (2, 13, 100)])
@pytest.mark.parametrize("form", ["ln", "add_ln", "sum_ln"])
def test_ln_backward_matches_jax(form, shape, dtype):
    """K1c without du_out (fused_ln) and with it (fused_add_ln), K2b
    (fused_sum_ln), on 3-D and 2-D inputs, and at an odd width (D = 100,
    whose bf16 rows are not a multiple of 16 bytes)."""
    rs = np.random.RandomState(0)
    D = shape[-1]
    x, r = rs.randn(*shape), rs.randn(*shape)
    g, b = rs.randn(D) * 0.1 + 1.0, rs.randn(D) * 0.1
    dy, du = rs.randn(*shape), rs.randn(*shape)
    act = [dtype, dtype, "float32", "float32"]
    if form == "ln":
        got, want = _vjp_both(jax_ln.fused_ln, torch_ln.fused_ln,
                              [x, g, b], [dy], act[1:])
        names = ["dx", "dgamma", "dbeta"]
    elif form == "add_ln":
        got, want = _vjp_both(jax_ln.fused_add_ln, torch_ln.fused_add_ln,
                              [x, r, g, b], [du, dy], act)
        names = ["dx", "dr", "dgamma", "dbeta"]
    else:
        got, want = _vjp_both(jax_ln.fused_sum_ln, torch_ln.fused_sum_ln,
                              [x, r, g, b], [dy], act)
        names = ["da", "db", "dgamma", "dbeta"]
    for name, gt, w in zip(names, got, want):
        tol = (LN_TOL[dtype] if name not in ("dgamma", "dbeta")
               else 1e-2 if (form, dtype) == ("sum_ln", "bfloat16")
               else LN_PARAM_TOL[dtype])
        _close(gt, w, tol, f"{form} {name}")


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("N", [17, 197])
def test_mha_backward_matches_jax(N, dtype, tol):
    """K6 at the small model's length and at ViT's 197, head dim 64."""
    rs = np.random.RandomState(1)
    H, d = 2, 64
    qkv, do = rs.randn(2, N, 3 * H * d), rs.randn(2, N, H * d)
    got, want = _vjp_both(
        lambda t: jax_fused_mha(t, H, d ** -0.5, True),
        lambda t: torch_attn.fused_mha(t, H, d ** -0.5), [qkv], [do], [dtype])
    _close(got[0], want[0], tol, "dqkv")
    # the plain version called directly gives the same d(qkv)
    direct = torch_attn.reference_mha_bwd(
        torch.from_numpy(qkv.astype(np.float32)).to(getattr(torch, dtype)),
        torch.from_numpy(do.astype(np.float32)), H, d ** -0.5)
    assert torch.equal(direct, got[0])


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 3e-2)])
def test_expert_ffn_backward_matches_jax(dtype, tol):
    """K4 through fused_expert_ffn on a real routed layout in which expert 3
    gets no token (it owns one all-padding tile; its dW and db must come
    out as exact zeros), with the cotangent zero at padding slots as the
    combine backward gives it."""
    rs = np.random.RandomState(2)
    E, D, H, T = 4, 32, 64, 150
    eidx = rs.randint(0, E - 1, (T, 2)).astype(np.int32)
    gather_idx, pair_slot, e_of_tile, w_slot, _ = \
        jax_moe.aligned_expert_layout(jnp.asarray(eidx), E,
                                      gate_w=jnp.ones((T, 2)),
                                      weight_dtype=jnp.float32)
    real = np.asarray(w_slot) > 0
    xs = rs.randn(T, D)[np.asarray(gather_idx)]
    dy = rs.randn(len(xs), D) * real[:, None]
    w1, b1 = rs.randn(E, D, H) * 0.05, rs.randn(E, H) * 0.01
    w2, b2 = rs.randn(E, H, D) * 0.05, rs.randn(E, D) * 0.01
    eot = np.asarray(e_of_tile)
    assert (eot == E - 1).any() and not (eidx == E - 1).any()
    got, want = _vjp_both(
        lambda x, a, b, c, e: jax_ffn.fused_expert_ffn(x, a, b, c, e,
                                                       jnp.asarray(eot)),
        lambda x, a, b, c, e: torch_ffn.fused_expert_ffn(
            x, a, b, c, e, torch.from_numpy(eot)),
        [xs, w1, b1, w2, b2], [dy], [dtype, dtype, "float32", dtype,
                                     "float32"])
    for name, g, w in zip(["dxs", "dw1", "db1", "dw2", "db2"], got, want):
        _close(g, w, tol, name)
        if name != "dxs":
            assert not g[E - 1].any(), f"{name} of the empty expert"
    assert got[1].dtype == getattr(torch, dtype)  # dW in the weights' dtype


def test_backward_forms_count_no_launch_on_cpu():
    ops.reset_launch_counts()
    rs = np.random.RandomState(3)
    u = torch.from_numpy(rs.randn(6, 64).astype(np.float32))
    g = torch.ones(64)
    for out in (torch_ln.fused_ln_bwd(u, u, g),
                torch_ln.fused_add_ln_bwd(u, u, u, g),
                torch_ln.fused_sum_ln_bwd(u, u, u, g)):
        assert [t.shape for t in out] == [(6, 64), (64,), (64,)]
    assert sum(ops.launch_counts().values()) == 0
