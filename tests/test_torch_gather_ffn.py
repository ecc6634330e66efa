"""The port's gather-in-kernel expert FFN (K9) vs the JAX package's, on
its plain version (CPU tensors).

Same seeded numpy inputs through both packages, in f32, the JAX Pallas
kernels in interpret mode as tests/test_fused_ffn.py runs them:
``fused_expert_ffn_gather`` for capacity None, 13 and 300, the live slots'
outputs and the gradients of x and every expert tensor within atol 3e-5 /
rtol 1e-4 (tests/test_fused_ffn.py:120-161). Padding slots are not
compared: the JAX kernel leaves them as stale buffer rows, the port
computes them from token 0, and the combine never reads them. The layout
goes into the jitted JAX function as traced arguments, so its wrapper keeps
the 256-row backward tiles the port runs (with a concrete layout it would
promote capacity 300's backward to 512-row tiles, the same function).

Each JAX case compiles its interpreted kernels (256 row copies unrolled a
tile) for ~11-14 s on the CPU, so the knob's end-to-end case and K8 live in
tests/test_torch_ffn_knobs.py, to keep each file near 45 s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slim_switch_moe_vit_tpu.ops import fused_ffn as jax_ffn
from slim_switch_moe_vit_tpu.ops import moe as jax_moe
from slim_switch_moe_vit_tpu_torch.ops import fused_ffn as torch_ffn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(rs, E, d, h):
    return [np.asarray(a, np.float32) for a in (
        rs.randn(d, E) * 0.1, rs.randn(E) * 0.01, rs.randn(E, d, h) * 0.05,
        rs.randn(E, h) * 0.01, rs.randn(E, h, d) * 0.05,
        rs.randn(E, d) * 0.01)]


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("capacity", [None, 13, 300])
def test_gather_ffn_matches_jax(capacity):
    rs = np.random.RandomState(3)
    T, d, h, E, k = 160, 32, 64, 4, 2
    router_w, router_b, w1, b1, w2, b2 = _params(rs, E, d, h)
    x = rs.randn(T, d).astype(np.float32)
    logits = jnp.dot(jnp.asarray(x), router_w) + router_b
    gate_w, eidx = jax_moe.naive_topk_gate(logits, k)
    gather_idx, pair_slot, e_of_tile, _, keep = jax_moe.aligned_expert_layout(
        eidx, E, gate_w=gate_w, weight_dtype=jnp.float32, capacity=capacity)
    kp = None if capacity is None else keep
    Tp = gather_idx.shape[0]
    c = np.sin(np.arange(Tp * d, dtype=np.float32)).reshape(Tp, d)

    def jloss(x, w1, b1, w2, b2, gather_idx, pair_slot, kp, e_of_tile):
        out = jax_ffn.fused_expert_ffn_gather(
            x, gather_idx, pair_slot, kp, w1, b1, w2, b2, e_of_tile)
        return jnp.sum(out * c), out

    (_, yj), gj = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3, 4), has_aux=True))(
            x, w1, b1, w2, b2, gather_idx, pair_slot, kp, e_of_tile)
    leaves = [_t(a).requires_grad_() for a in (x, w1, b1, w2, b2)]
    yt = torch_ffn.fused_expert_ffn_gather(
        leaves[0], _t(gather_idx, torch.long), _t(pair_slot, torch.long),
        None if kp is None else _t(kp), *leaves[1:], _t(e_of_tile))
    (yt * _t(c)).sum().backward()
    live = np.zeros(Tp, bool)
    live[np.asarray(pair_slot).ravel()] = True
    if capacity is not None:
        live[-1] = False  # dropped pairs all point at the last padding slot
        assert not np.asarray(keep).all() or capacity == 300
    np.testing.assert_allclose(yt.detach().numpy()[live], np.asarray(yj)[live],
                               atol=3e-5, rtol=1e-4)
    for name, g, w in zip(("dx", "dw1", "db1", "dw2", "db2"), leaves, gj):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), atol=3e-5,
                                   rtol=1e-4, err_msg=name)
